// The bf16 instance of kernel B (csrc/msda.cu): value and output in
// __nv_bfloat16, positions and weights f32, sums f32, one rounding at the
// store. A translation unit of its own, so it compiles beside the f32 one.
#include <cuda_bf16.h>
#define MSDA_T __nv_bfloat16
#define MSDA_FWD_ENTRY msda_fwd_bf16
#include "msda.cu"
