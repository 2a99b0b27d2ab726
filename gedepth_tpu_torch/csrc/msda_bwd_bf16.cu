// The bf16 instance of kernel C (csrc/msda_bwd.cu): value, grad_out and
// d_value in __nv_bfloat16; positions, weights, d_pos and d_weight f32;
// d_value summed in f32 and rounded once. A translation unit of its own, so
// it compiles beside the f32 one.
#include <cuda_bf16.h>
#define MSDA_T __nv_bfloat16
#define MSDA_BWD_ENTRY msda_bwd_bf16
#include "msda_bwd.cu"
