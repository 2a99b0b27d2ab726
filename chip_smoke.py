#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py

(`python3 chip_smoke.py --rank-step SPEC` is one rank of phase 28 and
`python3 chip_smoke.py --serve-exported ART WORK` phase 31's serving
process, which the script starts itself.)

Phases, each printing its lines (and, per group of phases, a `[time]` line
with its host-clock seconds; at the end one more with the run's total and
its five costliest laps); any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), CUDA version and
     capability; TF32 off for matmuls and convolutions;
  2. build: the CUDA kernels of gedepth_tpu_torch/csrc with nvcc, in a
     thread while phase 23 writes its trees (its timings wait for it);
  3. kernels: each kernel against its plain PyTorch version at the
     full-width shapes of the serving slice, with the stated tolerance, the
     median CUDA-event time of both (which holds the wrapper's host time
     too), the CUDA-event time per call of 10 back-to-back kernel calls
     (`event_ms`) and the device time per call of both from
     `torch.profiler` (`device_ms`; one trace per shape);
     kernel A also at the train crop's stage 1 (batch 2), with k and v as
     views into a packed qkv as the model passes them, and beside one
     `F.scaled_dot_product_attention` call on the same inputs (a yardstick
     the port never calls); kernel B also at the train crop's shapes
     (batch 2), without the window hint, and with a share of its samples
     thrown out of their windows and levels;
  4. main path: `init_depther("gedepth_adaptive_kitti_tpu")` with a seeded
     random initialisation, then `inference_depther` on 3 synthetic
     375x1242 KITTI-shaped requests (KB crop, normalisation, flip-TTA);
     every depth map (352, 1216), finite and inside [min_depth, max_depth],
     and every kernel's launch count above 0 for this phase;
  5. whole forward: `GEDepth` on one request with the kernels and with the
     plain versions, depth held to rtol 1e-3, atol 1e-3 m;
  6. kernel C: the deformable-sampling backward against its plain twin at
     the train crop's full width (352x704, batch 2), self-attention (5,082
     queries per sample) and cross-attention (61,952): d_pos and d_weights
     rtol 2e-4, atol 2e-5; d_value, summed by atomics in any order, rtol
     2e-4 plus atol 1e-5·max|d_value|; CUDA-event medians and device times
     of both; once more with a share of the samples thrown out of their
     windows and levels;
  7. train main path: `train("gedepth_adaptive_kitti_tpu")` for 5 steps at
     352x704, batch 2, from the KITTI tree of phase 23 (the KITTI chain:
     KB crop, ratio resize, pad, rotate, flip, crop, colour) and the seeded
     initialisation; every metric finite, every parameter's gradient present
     and finite after the run, a few named ones non-zero, and kernels A, B,
     C and E launched by it: A exactly 48 times a step (24 Swin blocks, in
     the forward and again in `swin_remat`'s recompute), B and C once a
     step at each attention's query count; the loop's evaluation at the last step (the
     tree's 2 test frames KB-cropped to 352x1216, flip-TTA, f32: 24 A, 2 B
     and 1 E a forward) with the nine metrics finite (phases 11 and 18
     alike, on synthetic frames, which they keep); then `tools.test` on the
     tree through --options data.data_root=...;
  8. whole step: one train step with the kernels and one with the plain
     versions on the same weights, batch and generator seed (full Swin-L,
     synthetic frames, crop 176x352, batch 2): loss rtol 1e-4, each parameter's gradient
     ‖g − g_plain‖ <= 1e-3·‖g_plain‖ + 1e-7. The absolute term covers the
     gradients that are zero but for rounding: a LayerNorm bias that feeds
     only a conv and a train-mode BatchNorm (backbone.norm{i}.bias) shifts
     each channel by a constant the BatchNorm takes out again, so both
     sides hold noise of ~1e-8 there. The decode head's conv weights are
     the most sensitive: a relative change of 1e-7 in the window
     attention's output moves them by ~4.5e-4 relative, ~0.45 of the
     bound. Kernel A therefore rounds as its plain version does.
  9. sampling rules: kernels B and C against their plain versions at
     positions formed by the exact rule (seeded offsets around grid-centre
     and learned reference points, a share of the samples far outside every
     level), the nearest rule and the compat rule at R = 6, at the serving
     shapes (self-attention over all four levels, 35,530 queries, and
     cross-attention, 107,008) and the train crop's (2 x 20,570 and
     2 x 61,952), with the tolerances of phases 3 and 6; the bound from
     the samples that touch their level, what the compat plan stages per
     (query grid, level); exact and compat timed as phases 3 and 6 with
     one repetition of the plain version, `device_ms` by the profiler and
     `event_ms` beside it; nearest, which no preset samples, checked and
     timed by events only. The exact rule's launches run over the plan the
     card makes of their positions: for each, the planning kernel held to
     `plan_plain` integer for integer and the share of samples its plan
     stages per level printed, B's output and C's d_pos and d_w held to
     the unplanned rows bit for bit, and the unplanned launch timed beside
     it (`unplanned_device_ms`, `unplanned_event_ms`); the planning kernel
     timed alone at the train cross shape (its `kernels` row); and a
     stress row at the train cross shape with offsets of 12 level pixels,
     where the planned B and C must cost at most 1.1x the unplanned ones
     by events;
 10. presets: `init_depther` + `inference_depther` for
     `gedepth_adaptive_kitti` (exact) and `gedepth_adaptive_kitti_compat`
     (2 flip-TTA requests each) and one request each for
     `gedepth_vanilla_kitti` and `depthformer_baseline_kitti` (RGB only);
     depth (352, 1216), finite, in range; the launch counts of every preset
     exactly 24 A and 2 B a forward (B once at the self-attention's 35,530
     queries and once at the cross-attention's 107,008), 1 E a forward for
     the adaptive presets and 0 for the others; the exact preset's whole
     forward with kernels against the plain versions as phase 5;
 11. exact train path: `train("gedepth_adaptive_kitti")` for 3 steps at
     352x704, batch 2, checked as phase 7; the gradients of
     `neck.reference_points` and `neck.multi_att.sampling_offsets` non-zero;
     phases 7 and 11 hold B and C to one launch a step at the
     self-attention's query count and one at the cross-attention's;
 12. evaluation: `Evaluator` over 4 synthetic 352x1216 frames of the exact
     preset with ms_ratios (0.75, 1.0, 1.25), numpy metrics and device
     metrics (held together to rtol 1e-5), then mode='slide' with a
     352x704 tile; the time per image of each.
 13. kernels, bf16: the bf16 instances of A (stage 1 shifted, serving and
     train crop, packed qkv, bf16 bias, f32 mask), B (serving shapes under
     the windowed, compat R = 5 and exact rules) and C (the train crop's
     windowed self- and cross-attention and the exact self- and
     cross-attention, these over the plan the card makes), each
     against a float64 evaluation of the same bf16 inputs: its largest
     error at most max(2 x the plain bf16 version's, one bf16 ulp of the
     output's largest magnitude; for C's f32 outputs 1e-5 of theirs). A
     bf16 kernel rounds once where its plain version rounds alike but not
     bit for bit, so the f32 phases' bounds do not apply. Timed as phase 3,
     with the f32 instance at the same shape (`f32_device_ms`,
     `f32_event_ms`), and for A one bf16 `scaled_dot_product_attention`;
     what the compat plan stages for a bf16 value at R = 5 and 6;
 14. parity preset: `init_depther("gedepth_adaptive_kitti_parity")` (compat
     R = 5, Swin and decode head bf16, the rest f32), 3 flip-TTA requests;
     depth as phase 4; per forward exactly 24 A (bf16 instance), 1 + 1 B
     (f32: HAHI is outside the scope), 1 E; the whole forward with kernels
     against the plain versions, the mean of |d - d_plain| / max(d,
     d_plain) at most 1e-2 (a rounding that falls the other way moves
     single pixels across the prior's validity edge, 4 mm against 44 m);
 15. scopes: one forward each of `backbone`, `backbone_neck`,
     `backbone_neck_head` and whole-tree bf16 (`init_depther(bf16=True)`)
     on the windowed preset, and of the compat tree at R = 5 with
     `backbone_neck_head`; A's bf16 instance in all, B's where the neck is
     inside;
 16. accuracy on seeded weights, same weights and request: the depth of
     `backbone_neck_head` and of whole-tree bf16 on the exact tree against
     the exact f32 preset, and of the parity preset against exact and
     against its own tree in f32 (compat R = 5); the mean abs-rel
     difference printed beside the JAX package's records on converted
     weights; asserted below 2e-2 is the mean of |d - ref| / max(d, ref) of
     each bf16 model against the f32 model of its own sampling rule (see
     `phase_accuracy` for why not the plain mean, and not parity against
     exact);
 17. bf16 evaluation: `Evaluator(bf16=True)` over 2 frames, whole + flip
     and multi-ratio, 9 finite metrics; an f32 step on bf16 weights raises;
     `tools.test --bf16` once;
 18. bf16 training: `train()` with `bf16_compute` for 3 steps at 352x704,
     batch 2, checked as phase 7; the bf16 instances of A, B and C and E
     launched; parameters, gradients, AdamW moments and BatchNorm
     statistics f32 and finite; peak memory beside phase 7's;
 19. f32 beside bf16 in one process, through `tools.benchmark`'s functions,
     the configurations taking turns: serving (exact f32, parity, windowed
     f32, windowed `backbone_neck_head`, windowed whole-tree bf16; 12
     iterations each) and a train step (f32, `bf16_compute`; 6 timed steps
     each after the autotuned ones): one JSON line each with the median
     device time by events (gaps included), the busy time by the profiler,
     host ms, idle share and peak memory.
 20. checkpointed training: `train()` of the main preset at 352x704, batch 2,
     4 steps, evaluation (2 images, flip-TTA) and a checkpoint every 2
     steps, keep 1, in a temporary work dir: two `val` records with the
     nine metrics finite, one checkpoint, `best_abs_rel.npz`; the save and
     restore seconds and the checkpoint's bytes; `restore_checkpoint` into
     a fresh state bit-equal to the returned state (parameters, BatchNorm
     statistics, AdamW moments, step); then `train(resume_from=...,
     max_iters=6)`: steps 5 and 6 at the schedule's LR, finite losses,
     kernels A, B, C and E launched;
 21. weights in: one request served by `init_depther(checkpoint=
     best_abs_rel.npz)`, bit-equal to one served with `state_dict=` of the
     same weights; the weights written as a reference `.pth` (`module.`
     keys under `state_dict`, `relative_position_index` buffers), converted
     by `tools.convert_torch_checkpoint` and served, bit-equal again; the
     same with a 3-channel patch embed (padded with zeros; its twin has a
     zero 4th channel); the `.pth` converted to the parity preset's tree
     too, which reports the reference points missing;
 22. compat_check: `tools.compat_check` on that parity tree (phase-20
     weights, reference points seeded), radii 5 and 6, one image: finite
     deltas, clamp masses in [0, 1], a RECOMMENDATION line.
 23. trees: a KITTI tree (dates 2011_09_26 at 375x1242 and 2011_09_28 at
     370x1224, calibration files, RGB and 16-bit GT PNGs, a `None` pair)
     and a DDAD tree (CAMERA_01 and CAMERA_05 at 1216x1936, a calibration
     `.npz`, GT `.npz` files, a split line of a filtered camera), written
     from seeded data by `tools.make_tree` with `utils.png.write_png` and
     finished by `tools.preprocess_data_kitti` and
     `tools.preprocess_data_ddad`; the host ms a sample of the PNG decode,
     of a dataset sample and of each whole train chain;
 24. kernels at DDAD's 384x640 shapes against their plain versions, timed
     as phase 3: A at stage 1 shifted (322 windows, the mask's period;
     batch 1 and 2), B windowed (5,040 and 61,440 queries, batch 1 and 2)
     and exact (20,400 and 61,440, batch 1), C at the windowed train
     shapes, E with four camera heights in one batch and depth_scale 250;
 25. DDAD serving: `init_depther(pe_path=...)` and `inference_depther` on
     PNG paths of the tree, 3 requests of `gedepth_adaptive_ddad_tpu`
     (no flip), one each of `gedepth_adaptive_ddad` (exact) and
     `gedepth_vanilla_ddad`; depth (384, 640), finite, in range; per
     forward exactly 24 A, B once at the self-attention's queries and once
     at the cross-attention's, 1 E (0 for vanilla); the windowed preset's
     whole forward with kernels against plain, rtol 1e-3, atol 1e-3 m;
 26. DDAD training: `train("gedepth_adaptive_ddad_tpu")` for 5 steps at
     384x640, batch 2, from the tree, checked as phase 7, then the loop's
     evaluation of the tree's 2 test frames (one forward each, the
     prediction upsampled to the 1216x1936 GT); whether one prefetch
     thread keeps up with a step, KITTI and DDAD.
 27. loader workers: `TrainLoader` over the KITTI and DDAD trees at 0, 2
     and 4 workers (global batch 2, the presets' chains): the first 3
     batches bit-identical for every count, and with 2 and 4 workers the
     samples a second against the rate the f32 batch-2 step of phases 7
     and 26 takes (one thread's rate is phase 23's host ms a sample);
 28. two ranks on one card: two processes in one gloo group (gloo takes
     CUDA tensors, NCCL refuses two ranks on one card), each at batch 1 of
     the main preset at full width (352x704, f32, one step), beside one
     process at batch 2 on the same weights and batch; cuDNN off on both
     sides (ATen's im2col convolutions: no autotuner trials, no FFT
     workspace) and each rank capped at 30% of the card. Loss, its parts
     and grad_norm rtol 1e-4, every gradient within 1e-3 of its largest
     magnitude (past it only the conv and BatchNorm in front of an
     activation whose sign flipped, within 1e-3 in L2), the BatchNorm
     running statistics rtol 1e-4; A 48, B 2, C 2 and E 1 times in every
     process's step; then the time and memory of a step's DropPath and dropout
     draws for 2 rows of a global batch of 2, 16 and 32;
 29. a world of one over NCCL, as a multi-GPU user starts it:
     `python -m torch.distributed.run --nproc_per_node 1 -m
     gedepth_tpu_torch.tools.train <main preset> --multihost` for 2 steps
     from the KITTI tree, then `tools.test --multihost` on its
     best_abs_rel.npz; world 1, backend nccl, finite metrics; both at a
     cut depth (Swin-L's stages of 2 blocks, its full widths: phase 7
     holds the full depth);
 30. stage-1 pretraining: `tools.pretrain_pe_mask gedepth_adaptive_kitti`
     from the KITTI tree, 3 steps at batch 2 (HAHI on the exact rule: B and
     C at 20,570 and 61,952 queries a sample), the ground-mask IoU of 4
     more batches (A 48 times a step under remat and 24 an IoU forward),
     then one `tools.train` step with --load-backbone-from:
     the backbone before the step equals the file, every gradient finite.
 31. serving export: `apis.export.export_depther` of the main preset at
     full width (352x1216, batch 1, flip-TTA, f32, the seeded weights of
     phase 4), saved (program, weights, meta.json) and loaded by
     `load_exported` in a fresh process (`chip_smoke.py --serve-exported`)
     that imports no model or config code, no JAX and nothing of the JAX
     package: its depth of phase 4's 3 requests bit-equal to the eager
     `inference_depther`'s, 48 A, 4 B and 2 E launches a request inside the
     loaded program; the program's graph holds the port's ops as often, and
     kernel A's k and v as views of the packed qkv; export, save and load
     seconds, bytes, and the program against the eager eval step in turns
     in this process (CUDA events and host ms);
 32. bf16 serving export: `export_depther(bf16=True)` run as exported, one
     request bit-equal to the eager whole-model bf16 step, the bf16
     instances of A and B launched inside the program;
 33. serving tools with phase 20's best weights: `tools.inference` on two
     frames of the KITTI tree with --pe and --npy, `tools.test --show-dir
     --format-only` on its test frames; every PNG read back equal to its
     depth's colour render or to the prediction x 256 (uint16).
  34. remat: one f32 step of the main preset at 352x704, batch 2, from
     the KITTI tree and the seeded weights, with `swin_remat` on and off:
     loss rtol 1e-6, gradients within phase 8's bound, the generator's
     state equal after the step, A 48 times against 24, the peak memory
     lower with remat; then one step with remat at the preset's own global
     batch of 16 (`KITTI_BATCH_MAX`, the largest KITTI batch of
     `tools.memory_ladder`; it fits in f32 with remat and without), cuDNN
     off (its autotuner searches ~250 s at this batch): finite, its peak
     memory;
 35. dress rehearsal: an official-format Swin-L-384 (window 12) file
     converted by `tools.convert_torch_checkpoint --official-swin` in a
     process of its own, then the 352x1216 flip-TTA protocol step from it,
     the parity preset (compat R = 5, its bf16 scope) and exact f32: depth
     (1, 352, 1216), finite, mean and p99 abs-rel, the mean below 5e-2
     (tests/test_dress_rehearsal.py's rail).
 36. the zoo's presets, `bts_kitti` (ResNet-50 + BTS), `densedepth_kitti`
     (ResNet-50 + DenseDepth) and `dpt_kitti` (ViT-B + DPT) from the KITTI
     tree, and `adabins_nyu` (EfficientNet-b0 + AdaBins) and
     `binsformer_nyu` (Swin-T + BinsFormer) from an NYU tree of
     `tools.make_tree` (3 scenes of 4 frames at 480x640), f32 on cuDNN's
     heuristic (the autotuner patched off in `train()`, the serving and
     the timed steps: its searches took 51 s of the phase; the steps then
     time the heuristic's algorithms, dpt's ~27% slower than autotuned,
     PERF.md §5), each with the port's kernel
     counts set to 0 before its
     requests and before its training and read after (the first four run
     none of them, as in JAX, where no Pallas kernel lies on the zoo's
     path; BinsFormer as said below): `init_depther` with a seeded
     initialisation and 3 flip-TTA requests (phase 4's 375x1242 frames, KB
     crop, 352x1216; the NYU tree's test frames at 480x640, RGB alone),
     the first held against the same weights' forward on the CPU (rtol
     1e-3, atol 1e-3 m; and a decode-head module's output, rtol 1e-3, atol
     1e-3 of its largest value: the last conv before the head's ReLU,
     since at seeded weights the ReLU may zero the depth, or AdaBins'
     decoder's last conv), the request latency, the eval step's CUDA-event
     time and peak memory; `train()` for 3 steps at 352x704 (NYU: 416x544),
     batch 2, from its tree with a work dir: finite losses, the step's time
     and peak memory, the first step's time less a later step's, the
     evaluation at the last step; the `tb/`
     events read back against the JSONL where the `tensorboard` package
     imports (printed either way); `tools.test` on the tree with the run's
     best `.npz`; then the train step timed as `tools.benchmark
     --train-step` times it (5 steps by CUDA events after the first and 1
     more; peak memory); for `adabins_nyu` also one step with
     chamfer_weight 0.1 (`[zoo adabins_nyu] chamfer`: its loss terms and
     peak). `binsformer_nyu` (Swin-T + BinsFormer, from the NYU tree) runs
     the port's kernels: exactly 24 A and 12 B (at the encoder's 6,300
     queries) a flip-TTA request, and 24 A, 6 B and 6 C (at 4,641 queries)
     a train step, its own f32 step (batch 2 at 416x544 with scene
     classes: loss, loss_depth, loss_ce, aux_loss_depth_2 and _5) counted
     alone; the same step again from the same seed, the loss and the
     DropPath generator's state equal to the bit and every gradient
     within phase 8's bound; a bf16_compute step and a whole-model bf16
     request, their bf16 launches counted as many. The other four presets
     launch none.
 37. kernels at BinsFormer's shapes against their plain versions, timed
     as phase 3 with the plain versions in the trace: A at Swin-T's stage 1
     (3 heads of 32), served (414 windows) and at the train crop (2 x 300),
     f32 and bf16 (bf16 held to float64 as phase 13), each beside one
     `scaled_dot_product_attention` call; B under the exact rule at the
     deformable encoder's 6,300 serving queries and 2 x 4,641 train queries
     (3 levels, 8 heads of 8 channels); C at the train shape.
 38. the seg preset `ocrnet_hr18_kitti` (HRNet-W18 + the FCN/OCR cascade,
     OCR widths 512 and 256, the PE ground-mask task), f32 with cuDNN's
     autotuner, the port's kernel counts set to 0 before it and read after
     (the seg model reaches none of them: all stay 0): `train()` for 3
     steps at 352x704, batch 2, from phase 23's KITTI tree into a work dir,
     with the loop's `SegEvaluator` at the last step (the tree's 2 test
     frames KB-cropped to 352x1216): finite losses (loss_seg0 and _1),
     every gradient of the last step present and finite, a `val` record
     with miou, acc and iou_cls0/1 in [0, 1], `best_miou.npz` written and
     read back by `load_params_only` bit for bit; then from the trained
     weights one train step on the card and one on the CPU on the centre
     176x352 of the tree's first batch (loss rtol 1e-4, grad_norm rtol
     5e-3: f32 keeps it to ~1e-3 on either side; every gradient finite,
     within 0.1 of the CPU's in L2 plus 1e-5
     of the largest gradient's norm: two f32 runs part by up to ~3% on the
     BatchNorm biases, sums of ~1e4 terms of both signs, and a gradient
     that is 0 in exact arithmetic, such as the OCR head's key_proj.bias,
     holds rounding noise; non-zero wherever the CPU's norm is above that
     floor) and one eval forward of
     a KB-cropped test frame at 352x1216 on both (both stages' logits rtol
     1e-3, atol 1e-3 of their largest magnitude), TF32 off; the
     evaluator's ms an image on a second run (the first carries cuDNN's
     search at 352x1216), its metrics within 1e-3 of the loop's; the train
     step timed as phase 36 times the zoo's (`tools.benchmark
     --train-step`: CUDA events, busy, idle share, peak, the autotuned
     first step). The same step in float64 on the card and on the CPU:
     losses and grad_norm rtol 2e-6 (the step takes its losses on f32
     casts of the logits, as the JAX step does); the f32 steps' grad_norm
     distances from float64, card and CPU, printed beside the JAX
     package's at the weights phase 38 starts from (4.65e-4,
     tests/seg_f64_distance.py).
 39. the toolbox's extra datasets and heads: every committed JPEG fixture
     (gedepth_tpu_torch/testdata/jpeg) through the port's decoder, its
     pixels' SHA-256 that of PIL's (fixtures.json) or the refusal it
     names, decode ms a frame at 900x1600 and 530x730 beside the PNG
     reader's on the same pixels; Cityscapes (1024x2048), nuScenes
     (900x1600) and SUN RGB-D (530x730) trees and a custom folder by
     `tools.make_tree`, the host ms a sample of each dataset's read and
     whole train chain; `tools.train depthformer_baseline_kitti
     --max-iters 2 --eval-max-images 1` on the Cityscapes tree in this
     process (crop 352x704, batch 2, cuDNN's choices of phase 7 warm; the
     evaluation of one 1024x2048 frame, flip-TTA): finite losses and
     metrics, exactly 144 A, B at 20,570 and 61,952 queries twice and at
     174,080 and 524,288 twice, C at 20,570 and 61,952 twice, no E; the
     step by CUDA events, its peak; `tools.test --format-only` on the
     custom folder's PNG and JPEG: uint16 PNGs at their frames' sizes;
     `ASNDepthHeadV2` at NYU width (features (2, 60, 80, 128), x8 to
     480x640, 40 triangle samples, NYU's intrinsics) with its loss dict,
     and `ASNDepthHead` on densedepth_kitti's ResNet-50 pyramid of a
     352x1216 frame, forward and backward on the card beside the CPU
     (outputs and losses rtol 1e-4, the adaptive normals within 2e-2 and
     1e-5 on average, gradients within 2e-2 in L2: BatchNorm-fed).
The phases run in the order 1, 2, 23, 3, 6, 13, 9, 24, 37, 4, 5, 31, 32, 7,
8, 34, 20, 21, 33, 22, 35, 25, 26, 27, 10, 11, 12, 14-19, 28-30, 36, 38,
39:
every kernel check
comes before the first model, because `torch.profiler` loses device
activities as a process ages, and all of them once it has trained.
A `device_ms` that is not within a tenth of its `event_ms` (kernels of
0.5 ms and more) is printed, dropped and null in its row; `event_ms` is in
every row. Then the kernels as one JSON line. The first four rows
carry their kernel's launches over the whole of phase 7, its steps and the
evaluation at its end (`launches`, `launches_train`) and of phase 4 (`launches_serving`). The rows of phase
9's shapes carry the launches that the wrapper counted at that row's query
count on its own path: the requests of phase 10 for the serving shapes, the
3 steps of phase 11 for the train crop's; the planning kernel's row
(`msda_plan[exact train_cross]`, no TPU counterpart) the plans of those
steps' B and C launches at that count. `bound_ms` is the larger of the
call's bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s, the
H100 SXM's published peaks (for the bf16 instance of A its products over
989 TFLOP/s, the tensor cores' bf16 rate). The rows of phase 13 carry the
error against float64 as `max_abs_err` and the launches of the bf16 paths:
A from phase 14's requests and phase 18's steps, B from the forwards of
phases 15 and 16, C from phase 18. The rows of phase 24 carry the launches
of phase 25's requests (serving shapes) and of phase 26's steps and
evaluation (train shapes; E both). The rows of phase 37 carry the launches
of phase 36's `binsformer_nyu`: its f32 requests (serving shapes) and its
f32 step (train shapes), and for A's bf16 instance its bf16 request and
bf16_compute step. The first four rows also carry the
launches inside phase 31's loaded program (`launches_exported`) and those
of phase 39's Cityscapes training and evaluation (`launches_cityscapes`).
Last the device as one JSON line.
To make room for phases 13-19, phase 9 times its plain versions once
instead of twice and the nearest rule by events alone; to make room for
phase 37 and BinsFormer, phases 3 and 6 trace the plain versions of B and
C only for the shapes their rows keep (cross-attention); every check of
phases 1-12 stayed. To make room for phase 39, phase 27 no longer times
the loader without workers (phase 23's host ms a sample is that rate);
its batches are still held bit for bit. To make room for the plan's
checks, phase 9 no longer times B's exact self-attention with window
hints of 4 and 8 pixels (they did not pay; PERF.md keeps the readings).
The processes of a run share one bytecode cache (`PYTHONPYCACHEPREFIX`, a
temporary directory, written even where `PYTHONDONTWRITEBYTECODE` is set,
as on the card's machine, whose installed packages ship no `.pyc`): each
process the run starts (the `torchrun` tools, the ranks, the serving
process, the conversion, the loaders' forkserver) compiled every module
it imported again, seconds of torch and sympy a process there. To bring the
run back under its time limit with that, phase 36 runs the zoo on cuDNN's
heuristic and times 5 steps after 2 (10 after 4 before), and phase 29's
processes run at a cut depth.
Imports nothing of JAX. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

# the run's bytecode cache, set before the heavy imports: this process
# writes what it compiles there, and the processes it starts inherit it
PYCACHE = None
if __name__ == "__main__" and "PYTHONPYCACHEPREFIX" not in os.environ:
    PYCACHE = tempfile.mkdtemp(prefix="chip_smoke_pycache_")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = PYCACHE
    # the card's machine sets PYTHONDONTWRITEBYTECODE, which would keep
    # every process from writing it: the run writes to its own cache alone
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
PRESET = "gedepth_adaptive_kitti_tpu"
DDAD = "gedepth_adaptive_ddad_tpu"


def synthetic_data(**over):
    """The DataConfig of the phases that keep synthetic frames: train
    frames at the 352x704 crop, test frames at 352x1216, the KITTI chain's
    flip, crop and colour steps."""
    from gedepth_tpu_torch.configs import DataConfig

    return DataConfig(**{"dataset": "synthetic", "crop_size": (352, 704),
                         "eval_size": (352, 1216), **over})


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=10, warmup=2):
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def burst_ms(fn, calls=10, warmup=2):
    """CUDA-event time per call of `calls` back-to-back fn(): for a kernel
    that outlasts its wrapper's host time the queue never runs dry, so this
    is the card's time per call."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_times(calls):
    """Device time per call, in milliseconds, of each (fn, reps) of `calls`,
    all taken in one `torch.profiler` trace: the median over the reps of
    the summed durations of the kernels, copies and fills that the profiler
    saw on the card during the call. Every fn runs once inside the trace
    to warm up; then each call runs in its own named range that ends in a
    synchronise, and a device activity belongs to the last range that
    started before it. None for an fn of which the profiler saw nothing.
    As a process ages the profiler drops device activities, whole calls or
    parts of them: `timed` holds each reading against the event time."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, _ in calls:
            fn()
        torch.cuda.synchronize()
        for j, (fn, reps) in enumerate(calls):
            for _ in range(reps):
                with record_function(f"chip_smoke_call_{j}"):
                    fn()
                    torch.cuda.synchronize()
    events = prof.events()
    ranges = sorted((e.time_range.start, int(e.name.rsplit("_", 1)[1]))
                    for e in events
                    if e.name.startswith("chip_smoke_call_")
                    and e.device_type == DeviceType.CPU)
    if len(ranges) != sum(reps for _, reps in calls):
        return [None] * len(calls)
    starts = [start for start, _ in ranges]
    total = [0.0] * len(ranges)
    for e in events:
        if e.device_type != DeviceType.CUDA \
                or e.name.startswith("chip_smoke_call_"):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0:                      # else: the runs before the ranges
            total[i] += e.time_range.elapsed_us()
    # a call whose activities were stamped into a neighbour's range, or
    # dropped by the profiler, counts as not seen
    out = []
    for j in range(len(calls)):
        seen = [t for t, (_, k) in zip(total, ranges) if k == j and t > 0]
        out.append(statistics.median(seen) / 1e3 if seen else None)
    return out


def compare(name, got, want, rtol, atol):
    """Max abs/rel error of got vs want; fails past atol + rtol·|want|."""
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(1e-6)).max().item()
    excess = (diff - (atol + rtol * want.abs())).max().item()
    ok = bool(torch.isfinite(got).all()) and excess <= 0
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOP_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM, bf16 on the tensor cores, dense


def bound(n_bytes, n_flop, flop_per_s=F32_FLOP_PER_S):
    """(bound_ms, bound_by): the least time the card could take to move the
    call's bytes (each input read once, each output written once) or to do
    its operations at the peak rate of the unit that does them (f32 on CUDA
    cores unless said otherwise), whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flop / flop_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def n_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def timed(kernel, plain, *, reps=10, plain_reps=3, plain_warmup=1,
          library=None, extra=None, trace_plain=True):
    """Times of a kernel call and its plain version (and of a library call,
    where one computes the function): CUDA-event medians of single calls
    (`ms`, `plain_ms`, `library_ms`: they hold the wrapper's host time), the
    CUDA-event time per call of 10 back-to-back kernel calls (`event_ms`:
    the card's time for a kernel that outlasts its wrapper) and the device
    times from one profiler trace (`device_ms`, `plain_device_ms`,
    `library_device_ms`). `extra`: other calls of the kernel, by label, read
    both ways into `extra_ms[label]` = (device, event). A kernel's device
    time of 0.5 ms and more that is not within a tenth of its event time is
    a reading the profiler lost activities of: it is printed and dropped.
    trace_plain=False leaves the plain version out of the trace (its
    thousands of small launches cost the trace most): `plain_device_ms`
    None, `plain_ms` by events as always. plain_warmup=0 where the caller
    has just run the plain version; plain=None where no row keeps its
    time: `plain_ms` None."""
    extra = extra or {}
    trace_plain = trace_plain and plain is not None
    t = {"ms": cuda_ms(kernel, reps=reps),
         "plain_ms": None if plain is None else cuda_ms(
             plain, reps=plain_reps, warmup=plain_warmup),
         "event_ms": burst_ms(kernel), "library_ms": None}
    calls = [(kernel, reps)] + ([(plain, plain_reps)] if trace_plain else [])
    calls += [(fn, reps) for fn in extra.values()]
    if library is not None:
        t["library_ms"] = cuda_ms(library, reps=reps)
        calls.append((library, reps))
    times = device_times(calls)

    def sound(device, event):
        if device is None or event < 0.5 or abs(device / event - 1) <= 0.1:
            return device
        print(f"    [profiler] device time {device:.4f} ms against "
              f"{event:.4f} ms by events: activities lost, reading dropped",
              flush=True)
        return None

    t["device_ms"] = sound(times[0], t["event_ms"])
    t["plain_device_ms"] = times[1] if trace_plain else None
    t["extra_ms"] = {}
    for (label, fn), device in zip(extra.items(),
                                   times[1 + trace_plain:]):
        event = burst_ms(fn)
        t["extra_ms"][label] = (sound(device, event), event)
    if library is not None:
        t["library_device_ms"] = times[-1]
    return t


def show(t, **more):
    def f(x):
        return "not measured" if x is None else f"{x:.4f}"
    line = (f"    ms={f(t['ms'])} plain_ms={f(t['plain_ms'])} "
            f"event_ms={f(t['event_ms'])} (CUDA events) "
            f"device_ms={f(t['device_ms'])} "
            f"plain_device_ms={f(t['plain_device_ms'])} (profiler)")
    if t["library_ms"] is not None:
        line += (f" library_ms={f(t['library_ms'])} "
                 f"library_device_ms={f(t['library_device_ms'])}")
    if "bound_ms" in t:
        line += f" bound_ms={t['bound_ms']:.4f} ({t['bound_by']})"
        if t["device_ms"]:
            line += f" device/bound={t['device_ms'] / t['bound_ms']:.1f}"
    for label, (device, event) in t["extra_ms"].items():
        line += f" {label}: device_ms={f(device)} event_ms={f(event)}"
    for k, v in more.items():
        line += f" {k}={v}"
    print(line, flush=True)


def scatter(pos, g, share=0.1):
    """`share` of the samples thrown tens of pixels away, a tenth of those
    a million: out of their windows and mostly out of their levels."""
    shape = pos.shape[:-1]
    far = torch.rand(shape, generator=g, device="cuda") < share
    very = torch.rand(shape, generator=g, device="cuda") < 0.1
    kick = torch.randn(pos.shape, generator=g, device="cuda")
    kick = kick * torch.where(very, 1e6, 60.0)[..., None]
    return pos + kick * far[..., None]


SERVE_LEVELS = ((88, 304), (44, 152), (22, 76), (11, 38))
TRAIN_LEVELS = ((88, 176), (44, 88), (22, 44), (11, 22))
RADIUS = 4


def msda_inputs(randn, B, levels, grids):
    from gedepth_tpu_torch.ops import msda as msda_ops

    Nq = sum(a * b for a, b in grids)
    pos = msda_ops.windowed_positions(2.0 * randn(B, Nq, 8, 4, 8, 2),
                                      grids, levels, RADIUS)
    w = randn(B, Nq, 8, 32).softmax(-1).view(B, Nq, 8, 4, 8)
    return pos, w


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap} name {torch.cuda.get_device_name(0)}",
          flush=True)
    if cap != (9, 0):
        fail(f"the kernels are built for sm_90a, card has {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    """Phase 2 in a thread of its own, so that phase 23 writes its trees
    while nvcc's processes run; returns the call that waits for it (and
    raises what the build raised)."""
    import threading

    from gedepth_tpu_torch.ops import _lib

    failed = []

    def build():
        try:
            _lib.load()
        except BaseException as e:          # re-raised by the caller
            failed.append(e)

    thread = threading.Thread(target=build, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if failed:
            raise failed[0]
        print(f"[build] {_lib.library_path().name} in "
              f"{_lib.build_seconds:.2f} s", flush=True)
    return wait


def phase_kernels():
    import torch.nn.functional as F

    from gedepth_tpu_torch.models.swin import shifted_window_mask
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    results = {}
    # A: Swin-L stage 1 (88x304 padded to 91x308: 572 windows, 6 heads)
    # unmasked and masked, stage 3 (22x76 -> 28x77: 44 windows, 24 heads),
    # and the train crop's stage 1 at batch 2 (88x176 -> 91x182: 2 x 338
    # windows, mask period 338); k and v are views into a packed qkv. The
    # library yardstick is one scaled_dot_product_attention call with
    # bias[h] + mask[window] as its attn_mask, formed before the call.
    print("[kernels] A window attention (rtol 2e-4, atol 2e-5)")
    for label, nWB, H, grid in (("stage1", 572, 6, None),
                                ("stage1_shifted", 572, 6, (91, 308)),
                                ("stage3_shifted", 44, 24, (28, 77)),
                                ("train_stage1_shifted", 676, 6, (91, 182))):
        qkv = randn(nWB, 49, 3, H, 32)
        q, k, v = qkv[:, :, 0] * 32 ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        bias = randn(H, 49, 49)
        mask = None if grid is None else torch.as_tensor(
            shifted_window_mask(*grid, 7, 3), device="cuda")
        shape = f"({nWB},49,{H},32)" + (
            "" if mask is None else f" mask {tuple(mask.shape)}")
        want = wa.window_attention_plain(q, k, v, bias, mask)
        err = compare(f"A {label} {shape}",
                      wa.window_attention(q, k, v, bias, mask), want,
                      2e-4, 2e-5)
        attn_mask = bias[None] if mask is None else (
            bias[None] + mask.repeat(nWB // mask.shape[0], 1, 1)[:, None])
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask, scale=1.0).transpose(1, 2)

        compare(f"A {label} library call", library(), want, 2e-4, 2e-5)
        t = timed(lambda: wa.window_attention(q, k, v, bias, mask),
                  lambda: wa.window_attention_plain(q, k, v, bias, mask),
                  plain_reps=10, library=library)
        t["bound_ms"], t["bound_by"] = bound(
            n_bytes(q, k, v, bias, want) + (0 if mask is None
                                            else n_bytes(mask)),
            nWB * H * 49 * 49 * (4 * 32 + 5))
        show(t)
        if label == "stage1_shifted":   # the JSON line keeps this shape
            results["window_attention"] = dict(t, max_abs_err=err)
        del qkv, q, k, v, want, attn_mask

    # B: HAHI, value 35,530 tokens x 8 heads x 64 over 4 levels (serving)
    # and 2 x 20,570 (the train crop); 9 f32 operations per sample and
    # channel (the corner blend and the weighted sum)
    print("[kernels] B deformable sampling (rtol 2e-4, atol 2e-5)")
    for label, B, levels, grids, far in (
            ("self_attn", 1, SERVE_LEVELS, SERVE_LEVELS[1:], False),
            ("train_self_attn", 2, TRAIN_LEVELS, TRAIN_LEVELS[1:], False),
            ("train_cross_attn", 2, TRAIN_LEVELS, ((176, 352),), False),
            ("cross_attn_scattered", 1, SERVE_LEVELS, ((176, 608),), True),
            ("cross_attn", 1, SERVE_LEVELS, ((176, 608),), False)):
        value = randn(B, sum(a * b for a, b in levels), 8, 64)
        pos, w = msda_inputs(randn, B, levels, grids)
        if far:
            pos = scatter(pos, g)
        Nq = pos.shape[1]
        want = msda_ops.msda_plain(value, levels, pos, w)
        err = compare(f"B {label} {B}x{Nq} queries",
                      msda_ops.msda(value, levels, pos, w, grids, RADIUS),
                      want, 2e-4, 2e-5)
        compare(f"B {label} without the window hint",
                msda_ops.msda(value, levels, pos, w), want, 2e-4, 2e-5)
        # the plain version in the profiler's trace for the kept row only
        # (the trace of its thousands of launches costs most)
        t = timed(lambda: msda_ops.msda(value, levels, pos, w, grids, RADIUS),
                  lambda: msda_ops.msda_plain(value, levels, pos, w),
                  plain_reps=1, trace_plain=label == "cross_attn",
                  extra={"without_hint":
                         lambda: msda_ops.msda(value, levels, pos, w)})
        t["bound_ms"], t["bound_by"] = bound(
            n_bytes(value, pos, w, want), 9 * w.numel() * 64)
        show(t)
        results["msda"] = dict(t, max_abs_err=err)   # cross_attn is kept
        del value, pos, w, want

    # E: PE fusion over the full 352x1216 crop; ~100 f32 operations a pixel
    # (an 11-way softmax and the plane's depth)
    print("[kernels] E PE fusion (rtol 1e-4, atol 1e-4)")
    logits = randn(1, 352, 1216, 11)
    pe = torch.rand(1, 352, 1216, generator=g, device="cuda") * 78 + 2
    y = torch.rand(1, 352, 1216, generator=g, device="cuda")
    cam = torch.full((1,), 1.65, device="cuda")
    want = pe_ops.pe_fusion_plain(logits, pe, y, cam, 200.0)
    err = compare("E (1,352,1216,11)",
                  pe_ops.pe_fusion(logits, pe, y, cam, 200.0), want,
                  1e-4, 1e-4)
    t = timed(lambda: pe_ops.pe_fusion(logits, pe, y, cam, 200.0),
              lambda: pe_ops.pe_fusion_plain(logits, pe, y, cam, 200.0),
              plain_reps=10)
    t["bound_ms"], t["bound_by"] = bound(n_bytes(logits, pe, y, cam, want),
                                         100 * pe.numel())
    show(t)
    results["pe_fusion"] = dict(t, max_abs_err=err)
    return results


def bf16_ulp(x):
    """One bf16 unit in the last place at magnitude x (a float)."""
    return 2.0 ** (int(np.floor(np.log2(max(x, 1e-30)))) - 7)


def compare64(name, got, plain, ref, floor=None):
    """A bf16 instance against float64: the kernel's largest error against a
    float64 evaluation of the same inputs must be at most the larger of
    twice the plain version's error and `floor` (default: one bf16 ulp at
    the output's largest magnitude). Returns the kernel's error."""
    ref = ref.double()
    err = (got.double() - ref).abs().max().item()
    plain_err = (plain.double() - ref).abs().max().item()
    if floor is None:
        floor = bf16_ulp(ref.abs().max().item())
    limit = max(2 * plain_err, floor)
    ok = bool(torch.isfinite(got).all()) and err <= limit
    print(f"  {name}: err_vs_f64={err:.3e} plain_err_vs_f64={plain_err:.3e} "
          f"floor={floor:.3e} (limit max(2 x plain, floor) = {limit:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} is further from float64 than its bound")
    return err


def phase_kernels_bf16():
    """The bf16 instances of A, B and C against float64 evaluations of the
    same bf16 inputs, each beside its f32 instance at the same shape
    (`extra_ms['f32']`: device, event)."""
    import torch.nn.functional as F

    from gedepth_tpu_torch.models.swin import shifted_window_mask
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    results = {}
    # A-bf16: q, k, v views of a packed bf16 qkv, a bf16 bias (a model cast
    # to bf16 holds its table so), the f32 shift mask. Operations: the two
    # products on the tensor cores.
    print("[kernels bf16] A window attention, bf16 on the tensor cores "
          "(against float64; limit max(2 x plain's error, 1 bf16 ulp))")
    for label, nWB, H, grid in (("stage1_shifted", 572, 6, (91, 308)),
                                ("train_stage1_shifted", 676, 6, (91, 182))):
        qkv = randn(nWB, 49, 3, H, 32).to(bf)
        q, k, v = qkv[:, :, 0] * 32 ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        bias = randn(H, 49, 49).to(bf)
        mask = torch.as_tensor(shifted_window_mask(*grid, 7, 3),
                               device="cuda")
        ref = wa.window_attention_plain(q.double(), k.double(), v.double(),
                                        bias.double(), mask.double())
        got = wa.window_attention(q, k, v, bias, mask)
        plain = wa.window_attention_plain(q, k, v, bias, mask)
        err = compare64(f"A bf16 {label} ({nWB},49,{H},32)", got, plain, ref)
        attn_mask = (bias.float()[None]
                     + mask.repeat(nWB // mask.shape[0], 1, 1)[:, None]).to(bf)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask, scale=1.0).transpose(1, 2)

        print(f"  A bf16 {label} library call: err_vs_f64="
              f"{(library().double() - ref).abs().max().item():.3e} (a "
              "yardstick, not held to the bound)")
        q32, k32, v32, b32 = q.float(), k.float(), v.float(), bias.float()
        t = timed(lambda: wa.window_attention(q, k, v, bias, mask),
                  lambda: wa.window_attention_plain(q, k, v, bias, mask),
                  plain_reps=10, library=library,
                  extra={"f32": lambda: wa.window_attention(q32, k32, v32,
                                                            b32, mask)})
        t["bound_ms"], t["bound_by"] = bound(
            n_bytes(q, k, v, bias, mask, got), nWB * H * 49 * 49 * 4 * 32,
            BF16_FLOP_PER_S)
        show(t)
        results[f"window_attention[bf16 {label}]"] = dict(
            t, max_abs_err=err, kernel="window_attention_bf16")
        del qkv, q, k, v, ref, got, plain, attn_mask, q32, k32, v32

    # B-bf16 at the serving shapes under the windowed (R = 4), compat
    # (R = 5) and exact rules; C-bf16 at the train crop's. 9 (B) and 17 (C)
    # f32 operations per touching sample and channel, on CUDA cores.
    print("[kernels bf16] B deformable sampling, bf16 value (against "
          "float64; limit max(2 x plain's error, 1 bf16 ulp))")
    cases = (
        ("windowed serving_self", 1, SERVE_LEVELS, SERVE_LEVELS[1:], False),
        ("windowed serving_cross", 1, SERVE_LEVELS, ((176, 608),), False),
        ("compat5 serving_self", 1, SERVE_LEVELS, SERVE_LEVELS, False),
        ("compat5 serving_cross", 1, SERVE_LEVELS, ((176, 608),), True),
        ("exact serving_self", 1, SERVE_LEVELS, SERVE_LEVELS, False),
        ("exact serving_cross", 1, SERVE_LEVELS, ((176, 608),), True),
        ("windowed train_self", 2, TRAIN_LEVELS, TRAIN_LEVELS[1:], False),
        ("exact train_self", 2, TRAIN_LEVELS, TRAIN_LEVELS, False),
        ("windowed train_cross", 2, TRAIN_LEVELS, ((176, 352),), False),
        ("exact train_cross", 2, TRAIN_LEVELS, ((176, 352),), True))
    for label, B, levels, grids, learned in cases:
        rule, shape = label.split()
        value = randn(B, sum(a * b for a, b in levels), 8, 64)
        if rule == "windowed":
            pos, w = msda_inputs(randn, B, levels, grids)
            hint = (grids, RADIUS)
        else:
            pos, w, hint = rule_positions(
                "compat" if rule == "compat5" else "exact", randn, g, B,
                levels, grids, learned, radius=PARITY_RADIUS)
        vb = value.to(bf)
        Nq, n_touch = pos.shape[1], touching(pos, levels)
        if shape.startswith("serving"):
            ref = msda_ops.msda_plain(vb.double(), levels, pos.double(),
                                      w.double())
            got = msda_ops.msda(vb, levels, pos, w, *hint)
            plain = msda_ops.msda_plain(vb, levels, pos, w)
            err = compare64(f"B bf16 {label} {B}x{Nq} queries", got, plain,
                            ref)
            t = timed(lambda: msda_ops.msda(vb, levels, pos, w, *hint),
                      lambda: msda_ops.msda_plain(vb, levels, pos, w),
                      plain_reps=1, trace_plain=False,
                      extra={"f32": lambda: msda_ops.msda(value, levels, pos,
                                                          w, *hint)})
            t["bound_ms"], t["bound_by"] = bound(
                n_bytes(vb, pos, w, got), 9 * n_touch * 64)
            show(t, touching=f"{n_touch / w.numel():.3f}")
            results[f"msda[bf16 {label}]"] = dict(
                t, max_abs_err=err, kernel="msda_bf16", queries=Nq)
            del ref, got, plain
        else:
            gout = randn(B, Nq, 512)
            gb = gout.to(bf)
            ref = msda_ops.msda_backward_plain(
                vb.double(), levels, pos.double(), w.double(), gb.double())
            got = msda_ops.msda_backward(vb, levels, pos, w, gb, *hint)
            plain = msda_ops.msda_backward_plain(vb, levels, pos, w, gb)
            if got[0].dtype != bf or got[1].dtype != torch.float32 \
                    or got[2].dtype != torch.float32:
                fail(f"C bf16 {label}: gradient dtypes "
                     f"{[x.dtype for x in got]}")
            err = max(
                compare64(f"C bf16 {label} 2x{Nq} queries d_value", got[0],
                          plain[0], ref[0]),
                compare64(f"C bf16 {label} d_pos (f32 out)", got[1],
                          plain[1], ref[1],
                          floor=1e-5 * ref[1].abs().max().item()),
                compare64(f"C bf16 {label} d_weights (f32 out)", got[2],
                          plain[2], ref[2],
                          floor=1e-5 * ref[2].abs().max().item()))
            n_out = n_bytes(*got)
            del ref, got, plain
            args32 = (value, levels, pos, w, gout)
            t = timed(lambda: msda_ops.msda_backward(vb, levels, pos, w, gb,
                                                     *hint),
                      lambda: msda_ops.msda_backward_plain(vb, levels, pos, w,
                                                           gb),
                      plain_reps=1, trace_plain=False,
                      extra={"f32": lambda: msda_ops.msda_backward(*args32,
                                                                   *hint)})
            t["bound_ms"], t["bound_by"] = bound(
                n_bytes(vb, pos, w, gb) + n_out, 17 * n_touch * 64)
            show(t)
            results[f"msda_backward[bf16 {label}]"] = dict(
                t, max_abs_err=err, kernel="msda_backward_bf16", queries=Nq)
            del gout, gb, args32
        del value, vb, pos, w
        torch.cuda.empty_cache()
    # what the compat plan stages with the window at half the bytes
    for R in (PARITY_RADIUS, COMPAT_RADIUS):
        for name, grids in (("serving self", SERVE_LEVELS),
                            ("serving cross", ((176, 608),))):
            print(f"[kernels bf16] compat plan R = {R}, {name}: share of "
                  f"tiles staging levels 0..3 per query grid, f32 "
                  f"{staged_by_plan(grids, SERVE_LEVELS, R)}, bf16 "
                  f"{staged_by_plan(grids, SERVE_LEVELS, R, itemsize=2)}")
    return results


def phase_main_path():
    import dataclasses

    from gedepth_tpu_torch.apis import (
        inference_depther, init_depther, make_eval_step)
    from gedepth_tpu_torch.data.synthetic import synthetic_request
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    rng = np.random.default_rng(SEED)
    requests = [synthetic_request(rng) for _ in range(3)]
    t0 = time.perf_counter()
    handle = init_depther(PRESET, device="cuda", pe_raw=requests[0][1],
                          seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in handle.model.parameters())
    print(f"[main] init_depther({PRESET!r}): {n_params} parameters in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cfg = handle.cfg.model

    counters = (wa.window_attention, msda_ops.msda, pe_ops.pe_fusion)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    latencies, depths = [], []
    for rgb, _ in requests:
        t = time.perf_counter()
        depths.append(inference_depther(handle, rgb))
        latencies.append((time.perf_counter() - t) * 1e3)
    launches = dict(zip(("window_attention", "msda", "pe_fusion"),
                        (c.launches for c in counters)))
    peak = torch.cuda.max_memory_allocated()

    print(f"[main] flip-TTA request latency ms: "
          f"{[round(x, 3) for x in latencies]}")
    print(f"[main] peak device memory {peak / 2**20:.1f} MiB; launches "
          f"{launches}", flush=True)
    for i, d in enumerate(depths):
        if d.shape != (352, 1216):
            fail(f"request {i}: depth shape {d.shape}")
        if not np.isfinite(d).all():
            fail(f"request {i}: non-finite depth")
        if d.min() < cfg.min_depth - 1e-6 or d.max() > cfg.max_depth + 1e-4:
            fail(f"request {i}: depth outside [{cfg.min_depth}, "
                 f"{cfg.max_depth}]: {d.min()}..{d.max()}")
    print(f"[main] depth (352, 1216) finite in [{min(d.min() for d in depths):.4f}"
          f", {max(d.max() for d in depths):.4f}] m", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    no_flip = dataclasses.replace(
        handle, eval_step=make_eval_step(handle.model, flip_tta=False))
    lat_nf = []
    for rgb, _ in requests:
        t = time.perf_counter()
        inference_depther(no_flip, rgb)
        lat_nf.append((time.perf_counter() - t) * 1e3)
    print(f"[main] no-flip request latency ms: "
          f"{[round(x, 3) for x in lat_nf]}", flush=True)
    return handle, requests, launches


@contextlib.contextmanager
def plain_ops():
    """Route the model's three ops to their plain PyTorch versions."""
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    with mock.patch.object(wa, "window_attention",
                           wa.window_attention_plain), \
            mock.patch.object(
                msda_ops, "msda",
                lambda value, shapes, pos, weights, *window:
                msda_ops.msda_plain(value, shapes, pos, weights)), \
            mock.patch.object(pe_ops, "pe_fusion", pe_ops.pe_fusion_plain):
        yield


def phase_whole_forward(handle, requests, tag="[whole]", rtol=1e-3,
                        atol=1e-3, precision="f32, TF32 off", mean_rel=None,
                        cam_height=1.65):
    """The first request's whole forward with the kernels and with the
    plain versions. `mean_rel`: hold the mean relative difference to this
    bound instead of every element to rtol and atol (bf16: a rounding that
    falls the other way moves single pixels across the prior's validity
    edge)."""
    from gedepth_tpu_torch.geometry.plane import clip_pe_for_input

    rgb, pe = requests[0]
    pe_in = clip_pe_for_input(pe, handle.cfg.model.depth_scale)
    img = np.concatenate([rgb, pe_in[..., None], pe[..., None]], axis=-1)
    img = handle.pipeline({"img": img})["img"]
    x = torch.from_numpy(np.ascontiguousarray(img[None])).cuda()
    cam = torch.full((1,), cam_height, device="cuda")
    with torch.inference_mode():
        got = handle.model(x, cam)["depth"]
        with plain_ops():
            want = handle.model(x, cam)["depth"]
    print(f"{tag} GEDepth({handle.cfg.name!r}) depth, kernels vs plain "
          f"({precision})")
    shape = tuple(got.shape)
    if mean_rel is None:
        compare(f"depth {shape}", got.float(), want.float(), rtol, atol)
        return
    # relative to the larger of the two depths (both >= min_depth), so a
    # pixel that a rounding moved across the prior's validity edge (4 mm
    # against 44 m) counts as 1, not as 5,500
    diff = (got.float() - want.float()).abs()
    rel = diff / torch.maximum(got.float(), want.float())
    mean, beyond = rel.mean().item(), (rel > 2e-2).float().mean().item()
    ok = bool(torch.isfinite(got).all()) and mean <= mean_rel
    print(f"  depth {shape}: mean_rel_diff={mean:.3e} (bound "
          f"{mean_rel:g}) max_abs_diff={diff.max().item():.3e} share of "
          f"pixels beyond 2e-2 relative {beyond:.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("depth disagrees with the plain versions' in the mean")


def phase_kernel_c():
    from gedepth_tpu_torch.ops import msda as msda_ops

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    # 17 f32 operations per sample and channel: four corner dots, w·g, and
    # a multiply and an add into each corner of d_value
    print("[kernel C] deformable-sampling backward, value (2,20570,8,64) "
          "(d_pos, d_w: rtol 2e-4, atol 2e-5; d_value: rtol 2e-4, "
          "atol 1e-5*max|d_value|)")
    value = randn(2, sum(a * b for a, b in TRAIN_LEVELS), 8, 64)
    result = None
    for label, grids, far in (("self_attn", TRAIN_LEVELS[1:], False),
                              ("cross_attn_scattered", ((176, 352),), True),
                              ("cross_attn", ((176, 352),), False)):
        pos, w = msda_inputs(randn, 2, TRAIN_LEVELS, grids)
        if far:
            pos = scatter(pos, g)
        Nq = pos.shape[1]
        gout = randn(2, Nq, 512)
        args = (value, TRAIN_LEVELS, pos, w, gout)
        got = msda_ops.msda_backward(*args, grids, RADIUS)
        want = msda_ops.msda_backward_plain(*args)
        dv_atol = 1e-5 * want[0].abs().max().item()
        err = max(compare(f"C {label} 2x{Nq} queries d_value", got[0],
                          want[0], 2e-4, dv_atol),
                  compare(f"C {label} d_pos", got[1], want[1], 2e-4, 2e-5),
                  compare(f"C {label} d_weights", got[2], want[2],
                          2e-4, 2e-5))
        again = msda_ops.msda_backward(*args, grids, RADIUS)
        if not (torch.equal(got[1], again[1])
                and torch.equal(got[2], again[2])):
            fail(f"C {label}: d_pos or d_weights differ between two runs")
        hintless = msda_ops.msda_backward(*args)
        compare(f"C {label} d_value without the window hint", hintless[0],
                want[0], 2e-4, dv_atol)
        n_out = n_bytes(*want)
        del got, want, again, hintless
        t = timed(lambda: msda_ops.msda_backward(*args, grids, RADIUS),
                  lambda: msda_ops.msda_backward_plain(*args),
                  plain_reps=1, trace_plain=label == "cross_attn",
                  extra={"without_hint":
                         lambda: msda_ops.msda_backward(*args)})
        t["bound_ms"], t["bound_by"] = bound(
            n_bytes(value, pos, w, gout) + n_out, 17 * w.numel() * 64)
        show(t)
        result = dict(t, max_abs_err=err)    # cross_attn is kept
        del pos, w, gout, args
    torch.cuda.empty_cache()
    return result


def _kernel_counters():
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    return {"window_attention": wa.window_attention, "msda": msda_ops.msda,
            "msda_backward": msda_ops.msda_backward,
            "pe_fusion": pe_ops.pe_fusion}


def reset_counts(counters):
    for c in counters.values():
        c.launches = 0
        for by in ("launches_by_queries", "launches_by_dtype"):
            if hasattr(c, by):
                getattr(c, by).clear()


def read_dtypes(counters):
    """Launches per kernel by the dtype of its q or value ('bf16', 'f32'):
    which instance ran."""
    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    return {name: {names[k]: n for k, n in c.launches_by_dtype.items()}
            for name, c in counters.items()
            if hasattr(c, "launches_by_dtype")}


def read_counts(counters):
    """(launches per kernel; for B and C, launches per query count, which
    tells the self-attention's launches from the cross-attention's)."""
    return ({name: c.launches for name, c in counters.items()},
            {name: dict(c.launches_by_queries)
             for name, c in counters.items()
             if hasattr(c, "launches_by_queries")})


def counts_since(before, after):
    """The launches between two `read_counts`, in its form."""
    def minus(a, b):
        return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}

    return ({k: n - before[0][k] for k, n in after[0].items()},
            {k: minus(by, before[1][k]) for k, by in after[1].items()})


# kernel A a train step: 24 Swin blocks, each launching it in the forward
# and again when `swin_remat` (on in every preset, as in JAX) recomputes
# the block in the backward; 24 an evaluation forward
A_STEP = 2 * 24
A_FORWARD = 24

TRAIN_GRADS = ("backbone.stages.0.blocks.0.attn.w_msa.qkv.weight",
               "neck.self_attn.sampling_offsets.weight",
               "neck.multi_att.value_proj.weight",
               "dynamic_pe_neck.conv0.weight")


EVAL_IMAGES = 2          # the loop's evaluation at the last step: 2 images
EVAL_FORWARDS = 2 * EVAL_IMAGES              # x flip-TTA


def phase_train(data, preset=PRESET, steps=5, nonzero=TRAIN_GRADS,
                tag="[train]", queries=(5082, 61952), bf16=False,
                eval_forwards=EVAL_FORWARDS, eval_queries=None):
    """`data`: the DataConfig to train and evaluate on (a KITTI or DDAD
    tree, or synthetic frames). `queries`: the self- and the
    cross-attention's queries per sample; B and C must each have been
    launched once a step at each, A exactly A_STEP times a step (forward
    and remat). The loop's evaluation at the last step
    (EVAL_IMAGES images, `eval_forwards` forwards with flip-TTA or without,
    f32 masters) adds 24 A, 2 B and 1 E a forward at the eval size, at the
    query counts `eval_queries` (None: two other counts than `queries`,
    eval_forwards launches each). bf16:
    `TrainConfig.bf16_compute`; then the bf16 instances of A, B and C must
    have run the steps, and every parameter, gradient, AdamW moment and
    buffer must be f32 (or integer) and finite afterwards. Returns
    (launches, launches by queries, launches by dtype, the later steps'
    peak memory in MiB)."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.train.loop import train

    import dataclasses

    # the reference's per-GPU batch of 2 (its global batch spans 8 GPUs)
    cfg = get_config(preset)
    cfg = cfg.replace(data=data, train=dataclasses.replace(
        cfg.train, global_batch=2, bf16_compute=bf16))
    counters = _kernel_counters()
    # B and C plan their unhinted launches on the card: once each
    counters["msda_plan"] = msda_ops.msda_plan
    reset_counts(counters)
    t0 = time.perf_counter()
    state, history, best = train(cfg, max_iters=steps,
                                 eval_max_images=EVAL_IMAGES, device="cuda")
    wall = time.perf_counter() - t0
    launches, by_queries = read_counts(counters)
    by_dtype = read_dtypes(counters)
    vals = [r for r in history if r["mode"] == "val"]
    history = [r for r in history if r["mode"] == "train"]

    print(f"{tag} train({preset!r}, max_iters={steps}), global_batch 2, "
          f"bf16_compute {bf16}, "
          f"crop {cfg.data.crop_size}, {cfg.data.dataset} data"
          + (f" from {cfg.data.data_root}" if cfg.data.dataset != "synthetic"
             else "") + f", eval size {cfg.data.eval_size}: {wall:.2f} s "
          "including init")
    for r in history:
        print(f"{tag} iter {r['iter']} loss={r['loss']:.6f} "
              f"loss_depth={r['loss_depth']:.6f} "
              f"loss_slope={r['loss_slope']:.6f} "
              f"grad_norm={r['grad_norm']:.6f} lr={r['lr']:.6e} "
              f"step_ms={r['time'] * 1e3:.3f} "
              f"step_peak_mem_mib={r['peak_mem_mib']:.1f}", flush=True)
    print(f"{tag} peak device memory: step 1 (cuDNN's autotuner trying "
          f"algorithms) {history[0]['peak_mem_mib']:.1f} MiB, later steps "
          f"{max(r['peak_mem_mib'] for r in history[1:]):.1f} MiB; "
          f"launches {launches}, by queries per sample {by_queries}, by "
          f"dtype {by_dtype}", flush=True)
    check_val(tag, vals, steps, best, eval_forwards)
    if not cfg.model.swin_remat:
        fail(f"{preset}: swin_remat is off")
    instance = "bf16" if bf16 else "f32"
    want_dtype = {"window_attention": {instance: A_STEP * steps},
                  "msda": {instance: 2 * steps},
                  "msda_backward": {instance: 2 * steps}}
    for name, n in (("window_attention", A_FORWARD), ("msda", 2)):
        want_dtype[name]["f32"] = (want_dtype[name].get("f32", 0)
                                   + n * eval_forwards)
    if by_dtype != want_dtype:
        fail(f"{preset}: instances launched {by_dtype}, expected "
             f"{want_dtype}")
    if launches["pe_fusion"] != steps + eval_forwards:
        fail(f"{preset}: E launched {launches['pe_fusion']} times, expected "
             f"{steps + eval_forwards}")
    if bf16:
        check_f32_state(state, steps, tag)
    for r in history:
        if not all(np.isfinite(v) for k, v in r.items() if k != "mode"):
            fail(f"non-finite train metrics at iter {r['iter']}: {r}")
    missing, bad = [], []
    for name, p in state.model.named_parameters():
        if p.grad is None:
            missing.append(name)
        elif not bool(torch.isfinite(p.grad).all()):
            bad.append(name)
    if missing or bad:
        fail(f"parameters without a gradient {missing[:8]} "
             f"({len(missing)}), with a non-finite one {bad[:8]}")
    grads = dict(state.model.named_parameters())
    for name in nonzero:
        norm = grads[name].grad.norm().item()
        print(f"{tag} |grad {name}| = {norm:.6e}")
        if not norm > 0:
            fail(f"zero gradient for {name}")
    print(f"{tag} all {len(grads)} parameters have finite gradients after "
          "the last step", flush=True)
    plans = launches.pop("msda_plan")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the train path")
    unhinted = cfg.model.neck_sampling in ("bilinear", "nearest")
    if plans != (launches["msda"] + launches["msda_backward"]
                 if unhinted else 0):
        fail(f"{preset}: the planning kernel launched {plans} times with "
             f"B {launches['msda']} and C {launches['msda_backward']} "
             f"({cfg.model.neck_sampling} sampling)")
    launches["msda_plan"] = plans
    once_a_step = {q: steps for q in queries}
    if eval_queries is None:
        evals = {q: n for q, n in by_queries["msda"].items()
                 if q not in queries}
        b_ok = ({q: by_queries["msda"].get(q) for q in queries} == once_a_step
                and sorted(evals.values()) == [eval_forwards] * 2)
    else:
        want_b = dict(once_a_step)
        for q in eval_queries:
            want_b[q] = want_b.get(q, 0) + eval_forwards
        b_ok = by_queries["msda"] == want_b
    if by_queries["msda_backward"] != once_a_step or not b_ok:
        fail(f"{preset}: B and C launched {by_queries}, expected "
             f"{once_a_step} each and B {eval_forwards} times at each of "
             "the evaluation's two query counts")
    del state
    torch.cuda.empty_cache()
    step_ms = statistics.median(r["time"] for r in history[1:]) * 1e3
    print(f"{tag} median step {step_ms:.1f} ms at batch 2 "
          f"({step_ms / 2:.1f} ms a sample)", flush=True)
    return (launches, by_queries, by_dtype,
            max(r["peak_mem_mib"] for r in history[1:]), step_ms)


def check_val(tag, vals, steps, best, forwards=EVAL_FORWARDS):
    """The train loop's evaluation at the last step: one 'val' record of
    the nine metrics, finite, over EVAL_IMAGES images; it is the best."""
    metrics = ("abs_rel", "sq_rel", "rmse", "rmse_log", "log_10", "silog",
               "a1", "a2", "a3")
    if [r["iter"] for r in vals] != [steps] or any(
            r["images"] != EVAL_IMAGES
            or not all(np.isfinite(r[k]) for k in metrics) for r in vals):
        fail(f"{tag}: evaluations {vals}, expected one of {EVAL_IMAGES} "
             f"images at step {steps} with the nine metrics finite")
    if best != vals[-1]:
        fail(f"{tag}: best {best} is not the last evaluation")
    r = vals[-1]
    print(f"{tag} eval @ {steps}: " + " ".join(
        f"{k}={r[k]:.6g}" for k in metrics) + f"; {r['images']} images in "
        f"{r['time']:.2f} s ({r['time'] / r['images'] * 1e3:.1f} ms an "
        f"image, {forwards // r['images']} forward(s) an image, cuDNN's "
        "autotuner on)", flush=True)


def check_f32_state(state, steps, tag):
    """After bf16-compute steps: parameters, gradients, AdamW's moments and
    the BatchNorm statistics are f32 and finite, and the statistics moved."""
    f32 = torch.float32
    bad = [n for n, p in state.model.named_parameters()
           if p.dtype != f32 or p.grad is None or p.grad.dtype != f32
           or not bool(torch.isfinite(p.grad).all())
           or not bool(torch.isfinite(p).all())]
    moments = [t for st in state.optimizer.state.values()
               for t in st.values() if torch.is_tensor(t) and t.dim() > 0]
    bad += [f"moment {tuple(t.shape)}" for t in moments
            if t.dtype != f32 or not bool(torch.isfinite(t).all())]
    n_stats = 0
    for n, b in state.model.named_buffers():
        if b.is_floating_point():
            n_stats += 1
            if b.dtype != f32 or not bool(torch.isfinite(b).all()):
                bad.append(n)
            elif n.endswith("running_mean") and not b.abs().sum().item() > 0:
                bad.append(n + " (did not move)")
        elif n.endswith("num_batches_tracked") and b.item() != steps:
            bad.append(n)
    if bad or not moments or not n_stats:
        fail(f"bf16-compute state not f32 and finite: {bad[:8]} "
             f"({len(bad)}); {len(moments)} moments, {n_stats} statistics")
    print(f"{tag} after {steps} bf16-compute steps every parameter, gradient, "
          f"AdamW moment ({len(moments)}) and BatchNorm statistic ({n_stats}) "
          "is f32 and finite; the statistics moved", flush=True)


def check_depth(tag, d, cfg, shape=(352, 1216)):
    if d.shape != shape or not np.isfinite(d).all():
        fail(f"{tag}: depth {d.shape} not finite")
    if d.min() < cfg.min_depth - 1e-6 or d.max() > cfg.max_depth + 1e-4:
        fail(f"{tag}: depth outside [{cfg.min_depth}, {cfg.max_depth}]: "
             f"{d.min()}..{d.max()}")


def phase_parity(requests):
    """Serve the parity preset (compat R = 5; Swin and the decode head in
    bf16, HAHI, the PE necks and the fusion in f32): 3 flip-TTA requests."""
    from gedepth_tpu_torch.apis import inference_depther, init_depther

    counters = _kernel_counters()
    t0 = time.perf_counter()
    handle = init_depther(PARITY, device="cuda", pe_raw=requests[0][1],
                          seed=SEED)
    torch.cuda.synchronize()
    model, cfg = handle.model, handle.cfg.model
    dtypes = {name: {str(p.dtype) for p in getattr(model, name).parameters()}
              for name in ("backbone", "neck", "pe_mask_neck",
                           "dynamic_pe_neck", "decode_head")}
    print(f"[parity] init_depther({PARITY!r}): scope {cfg.bf16_scope!r}, "
          f"sampling {cfg.neck_sampling!r} R = {cfg.neck_window_radius}, "
          f"parameter dtypes {dtypes} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    bf, f32 = {"torch.bfloat16"}, {"torch.float32"}
    if dtypes != {"backbone": bf, "neck": f32, "pe_mask_neck": f32,
                  "dynamic_pe_neck": f32, "decode_head": bf}:
        fail(f"parity preset: scope not cast as 'backbone_head': {dtypes}")
    inference_depther(handle, requests[0][0])       # warm-up
    reset_counts(counters)
    latencies, depths = [], []
    for rgb, _ in requests:
        t = time.perf_counter()
        depths.append(inference_depther(handle, rgb))
        latencies.append((time.perf_counter() - t) * 1e3)
    launches, by_queries = read_counts(counters)
    by_dtype = read_dtypes(counters)
    for i, d in enumerate(depths):
        check_depth(f"{PARITY} request {i}", d, cfg)
    forwards = 2 * len(requests)
    print(f"[parity] flip-TTA request latency ms "
          f"{[round(x, 3) for x in latencies]}; depth in "
          f"[{min(d.min() for d in depths):.4f}, "
          f"{max(d.max() for d in depths):.4f}] m; launches {launches}, by "
          f"queries {by_queries}, by dtype {by_dtype}", flush=True)
    want = {"window_attention": 24 * forwards, "msda": 2 * forwards,
            "msda_backward": 0, "pe_fusion": forwards}
    want_dtype = {"window_attention": {"bf16": 24 * forwards},
                  "msda": {"f32": 2 * forwards}, "msda_backward": {}}
    if launches != want or by_dtype != want_dtype or by_queries["msda"] != {
            35530: forwards, 107008: forwards}:
        fail(f"{PARITY}: launches {launches}, {by_dtype}, {by_queries}; "
             f"expected {want}, {want_dtype}")
    # bf16 kernels and bf16 plain versions round alike but not bit for bit
    # (ties, and P kept wider in A), and 24 bf16 blocks carry a flipped
    # rounding on: the mean relative difference is held to 1e-2, stated
    # here and measured below, not every element to the f32 phases' 1e-3
    phase_whole_forward(handle, requests, tag="[parity]", mean_rel=1e-2,
                        precision="bf16_scope 'backbone_head'")
    del handle
    torch.cuda.empty_cache()
    return by_dtype["window_attention"]["bf16"]


def phase_scopes(requests):
    """One forward of each other scope and of whole-tree bf16 on the
    windowed preset, and of the compat tree at R = 5 with HAHI inside the
    scope: the instance of A and B that each runs. Returns B's bf16
    launches by (rule, queries)."""
    import dataclasses

    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.configs import get_config

    counters = _kernel_counters()
    counted = {}
    for preset, scope, whole in ((PRESET, "backbone", False),
                                 (PRESET, "backbone_neck", False),
                                 (PRESET, "backbone_neck_head", False),
                                 (PRESET, "none", True),
                                 (PARITY, "backbone_neck_head", False)):
        cfg = get_config(preset)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    bf16_scope=scope))
        handle = init_depther(cfg, device="cuda", pe_raw=requests[0][1],
                              seed=SEED, flip_tta=False, bf16=whole)
        reset_counts(counters)
        t = time.perf_counter()
        depth = inference_depther(handle, requests[0][0])
        ms = (time.perf_counter() - t) * 1e3
        launches, by_queries = read_counts(counters)
        by_dtype = read_dtypes(counters)
        label = "whole-tree bf16" if whole else f"bf16_scope {scope!r}"
        check_depth(f"{preset} {label}", depth, cfg.model)
        neck_bf16 = whole or "neck" in scope
        want_dtype = {"window_attention": {"bf16": 24},
                      "msda": {"bf16" if neck_bf16 else "f32": 2},
                      "msda_backward": {}}
        print(f"[scopes] {preset}, {label}: first forward {ms:.1f} ms; depth "
              f"in [{depth.min():.4f}, {depth.max():.4f}] m; launches "
              f"{launches}, by queries {by_queries}, by dtype {by_dtype}",
              flush=True)
        if by_dtype != want_dtype or launches["pe_fusion"] != 1:
            fail(f"{preset} {label}: instances {by_dtype}, E "
                 f"{launches['pe_fusion']}; expected {want_dtype}, 1")
        if neck_bf16:
            rule = "windowed" if preset == PRESET else "compat5"
            for q, n in by_queries["msda"].items():
                counted[rule, q] = counted.get((rule, q), 0) + n
        del handle
        torch.cuda.empty_cache()
    return counted


def delta_stats(d, ref):
    """(mean abs-rel, mean of |d - ref| / max(d, ref), median abs-rel, share
    of pixels beyond 2e-2 abs-rel)."""
    rel = np.abs(d - ref) / ref
    return (float(rel.mean()),
            float(np.mean(np.abs(d - ref) / np.maximum(d, ref))),
            float(np.median(rel)), float(np.mean(rel > 2e-2)))


def phase_accuracy(exact, requests):
    """What bf16 moves on seeded weights and one flip-TTA request: the depth
    of `backbone_neck_head` and of whole-tree bf16 against the exact f32
    preset (all on the exact tree), and of the parity preset against exact
    and against its own tree in f32 (compat, R = 5).

    Printed: the mean abs-rel difference (the JAX package's measure), the
    mean of |d - ref| / max(d, ref), the median abs-rel, the share of pixels
    beyond 2e-2. Asserted below 2e-2: the second, of each bf16 model against
    the f32 model of its own sampling rule. The plain mean abs-rel is not
    held: at the seeded initialisation a rounding moves single pixels across
    the prior's validity edge (4 mm against 44 m), and one such pixel in
    428,032 adds 2.6e-2 to it. The parity preset against exact is not held
    either: the compat clamp, in f32, already moves a third of the pixels
    beyond 2e-2 on these weights (it clamps 0.94 of the cross-attention's
    mass at the seeded initialisation).
    Returns the whole-tree bf16 handle and B's bf16 launches by queries."""
    import dataclasses

    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.configs import get_config

    counters = _kernel_counters()
    rgb, pe = requests[0]
    ref = inference_depther(exact, rgb)
    state = {k: v.detach().clone() for k, v in
             exact.model.state_dict().items()}
    cfg = get_config(EXACT)
    scoped = cfg.replace(model=dataclasses.replace(
        cfg.model, bf16_scope="backbone_neck_head"))
    # the JAX package's records on converted reference weights
    # (gedepth_tpu/configs/presets.py): an accuracy, not a time
    recorded = {"parity": "5.9e-4", "backbone_neck_head": "~1.0e-3",
                "whole-tree bf16": "2.2e-3"}
    counted, whole = {}, None
    parity = get_config(PARITY)
    compat_f32 = parity.replace(model=dataclasses.replace(
        parity.model, bf16_scope="none"))
    refs = {"exact": ref}
    for label, config, bf16, against in (
            ("compat R = 5 f32", compat_f32, False, "exact"),
            ("parity", PARITY, False, "exact"),
            ("parity", PARITY, False, "compat R = 5 f32"),
            ("backbone_neck_head", scoped, False, "exact"),
            ("whole-tree bf16", EXACT, True, "exact")):
        if label not in refs:
            handle = init_depther(config, device="cuda", pe_raw=pe, seed=SEED,
                                  state_dict=state, bf16=bf16)
            reset_counts(counters)
            refs[label] = inference_depther(handle, rgb)
            _, by_queries = read_counts(counters)
            check_depth(f"accuracy {label}", refs[label], cfg.model)
            if label in ("backbone_neck_head", "whole-tree bf16"):
                for q, n in by_queries["msda"].items():
                    counted["exact", q] = counted.get(("exact", q), 0) + n
            if bf16:
                whole = handle
            del handle
            torch.cuda.empty_cache()
        depth = refs[label]
        delta, sym, median, beyond = delta_stats(depth, refs[against])
        print(f"[accuracy] {label} against {against}: mean abs-rel "
              f"{delta:.3e}, mean |d - ref| / max(d, ref) {sym:.3e}, median "
              f"abs-rel {median:.3e}, share beyond 2e-2 {beyond:.3e}"
              + (f" (the JAX package records {recorded[label]} on converted "
                 "weights)" if label in recorded and against == "exact"
                 else ""), flush=True)
        if bf16 or against != "exact" or label == "backbone_neck_head":
            # a bf16 model against the f32 model of its own sampling rule
            if not sym < 2e-2:
                fail(f"accuracy {label} against {against}: mean "
                     f"|d - ref| / max(d, ref) {sym:.3e} not below 2e-2")
    return whole, counted


def phase_eval_bf16(handle):
    """`Evaluator(bf16=True)` on the whole-tree bf16 model, 2 frames, whole
    + flip and multi-ratio; a flag that disagrees with the weights raises;
    then the CLI once with --bf16."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.train.loop import build_eval_dataset
    from gedepth_tpu_torch.train.steps import make_eval_step

    cfg = get_config(EXACT, data=synthetic_data(synthetic_size=8))
    dataset = build_eval_dataset(cfg)       # 2 synthetic 352x1216 frames
    for label, kw in (("whole + flip", {}),
                      ("multi-ratio", dict(ms_ratios=(0.75, 1.0, 1.25)))):
        evaluator = Evaluator(handle.model, dataset, cfg.data, bf16=True,
                              **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg, rows = evaluator.run(max_images=2)
        per_image = (time.perf_counter() - t0) * 1e3 / 2
        if len(rows) != 2 or len(agg) != 9 \
                or not np.isfinite(np.asarray(rows)).all():
            fail(f"bf16 evaluator ({label}): {len(rows)} rows, {agg}")
        print(f"[eval bf16] Evaluator({EXACT!r}, bf16=True, {label}), 2 "
              f"frames: {per_image:.1f} ms an image; "
              + " ".join(f"{k}={v:.6f}" for k, v in agg.items()), flush=True)
    x = torch.zeros(1, 352, 1216, 5, device="cuda")
    try:
        make_eval_step(handle.model, bf16=False)(x)
    except ValueError as e:
        print(f"[eval bf16] bf16=False on bf16 weights raises: "
              f"{str(e)[:60]}...")
    else:
        fail("an f32 eval step took a bf16 model")
    t0 = time.perf_counter()
    test_cli.main([EXACT, "--bf16", "--max-images", "2", "--options",
                   "data.dataset=synthetic", "data.synthetic_size=8"])
    print(f"[eval bf16] tools.test {EXACT} --bf16 --max-images 2: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_benchmark():
    """f32 beside bf16 in one process, through `tools.benchmark`'s
    functions: serving (`predict_depth`, no flip, batch 1, 352x1216) and a
    train step (352x704, batch 2), the configurations taking turns; one
    JSON line each."""
    import dataclasses

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.tools import benchmark as bench

    def scoped(preset, scope):
        cfg = get_config(preset)
        return cfg.replace(model=dataclasses.replace(cfg.model,
                                                     bf16_scope=scope))

    def take_turns(runners, rounds, iters, warmup):
        device_ms = [[] for _ in runners]
        host_ms, peak = [0.0] * len(runners), [0.0] * len(runners)
        for r in runners:
            with r.context():
                bench.time_iterations(r, warmup)
        for _ in range(rounds):
            for i, r in enumerate(runners):
                torch.cuda.reset_peak_memory_stats()
                with r.context():
                    d, h, out = bench.time_iterations(r, iters)
                if not bool(torch.isfinite(out.float()).all()):
                    fail(f"benchmark {r.cfg.name} {r.dtype}: non-finite")
                device_ms[i] += d
                host_ms[i] += h
                peak[i] = max(peak[i],
                              torch.cuda.max_memory_allocated() / 2**20)
        records = []
        for i, r in enumerate(runners):
            with r.context():
                busy = bench.device_busy_ms(r)
            rec = bench.summarise(r, rounds * iters, device_ms[i],
                                  host_ms[i], warmup, peak_mem_mib=peak[i],
                                  busy_ms=busy)
            print("[benchmark] " + json.dumps(rec), flush=True)
            records.append(rec)
        return records

    serving = [bench.build_runner(c, bf16=b, seed=SEED) for c, b in (
        (EXACT, False), (PARITY, False), (PRESET, False),
        (scoped(PRESET, "backbone_neck_head"), False), (PRESET, True))]
    take_turns(serving, rounds=2, iters=6, warmup=2)
    binding_overhead(bench, serving[-1])
    del serving
    torch.cuda.empty_cache()
    training = [bench.build_runner(PRESET, batch=2, height=352, width=704,
                                   train_step=True, bf16=b, seed=SEED)
                for b in (False, True)]
    take_turns(training, rounds=2, iters=3, warmup=2)
    del training
    torch.cuda.empty_cache()


BINDING_ITERS = 10


def binding_overhead(bench, runner):
    """The dispatcher ops' share of the host-bound whole-tree bf16 request
    (`predict_depth`, no flip): host ms an iteration through the ops, and
    with each wrapper calling its op's CUDA implementation straight (the
    dispatcher left out, as the ctypes binding before the ops did), in
    turns: ops, direct, direct, ops, ops, direct."""
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    straight = ((wa, "window_attention_op", wa._window_attention_cuda),
                (msda_ops, "msda_op", msda_ops._msda_cuda),
                (pe_ops, "pe_fusion_op", pe_ops._pe_fusion_cuda))
    host = {"ops": [], "direct": []}
    for name in ("ops", "direct", "direct", "ops", "ops", "direct"):
        with contextlib.ExitStack() as stack:
            if name == "direct":
                for module, attr, impl in straight:
                    stack.enter_context(mock.patch.object(module, attr, impl))
            _, ms, _ = bench.time_iterations(runner, BINDING_ITERS)
        host[name].append(round(ms / BINDING_ITERS, 3))
    ops, direct = (statistics.median(host[k]) for k in ("ops", "direct"))
    print(f"[binding] whole-tree bf16 request, host ms an iteration "
          f"({BINDING_ITERS} a turn): through the ops {host['ops']}, the "
          f"CUDA implementations called straight {host['direct']}; median "
          f"{ops:.3f} against {direct:.3f} ({100 * (ops / direct - 1):+.1f}%)",
          flush=True)


def phase_whole_step():
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state, make_train_step)

    cfg = get_config(PRESET)
    data = synthetic_data(crop_size=(176, 352))      # synthetic frames
    loader = TrainLoader(SyntheticGroundDataset(size=4, height=176,
                                                width=352),
                         build_train_pipeline(data), 2, seed=SEED)
    batch = batch_to_device(loader.make_batch(0), "cuda")
    step = make_train_step(cfg.optim.sig_loss_weight,
                           cfg.optim.slope_ce_weight)
    results = []
    for use_kernels in (True, False):
        model = cfg.model.build(
            device="cuda", generator=torch.Generator().manual_seed(SEED))
        state = create_train_state(model, cfg.optim, cfg.train.max_iters,
                                   seed=SEED + 1)
        with (contextlib.nullcontext() if use_kernels else plain_ops()):
            metrics = step(state, batch)
        torch.cuda.synchronize()
        results.append((metrics["loss"].item(),
                        {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}))
        del model, state
        torch.cuda.empty_cache()
    (loss_k, grads_k), (loss_p, grads_p) = results
    print(f"[step] one train step, kernels vs plain, crop 176x352 batch 2: "
          f"loss {loss_k:.8f} vs {loss_p:.8f}")
    if not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
        fail("train-step loss disagrees with the plain versions")
    worst, worst_rel = (0.0, ""), (0.0, "")
    for name, gp in grads_p.items():
        diff, norm = (grads_k[name] - gp).norm().item(), gp.norm().item()
        bound = 1e-3 * norm + 1e-7
        if not diff <= bound:
            fail(f"gradient of {name} disagrees: |g - g_plain| {diff:.3e} > "
                 f"{bound:.3e}")
        worst = max(worst, (diff / bound, name))
        if norm > 1e-4:
            worst_rel = max(worst_rel, (diff / norm, name))
    print(f"[step] all {len(grads_p)} gradients within their bound; the "
          f"closest: {worst[1]} at {worst[0]:.3f} of it; the largest "
          f"relative error where |g_plain| > 1e-4: {worst_rel[0]:.3e} "
          f"({worst_rel[1]})", flush=True)


# the largest KITTI global batch whose f32 step fits one card with remat
# (`tools.memory_ladder`, PERF.md)
KITTI_BATCH_MAX = 16


def phase_remat(tree):
    """Phase 34: one f32 train step of PRESET at 352x704, batch 2 (global
    batch 0 of the KITTI tree), from the seeded initialisation with
    `swin_remat` on and off: the same weights, generator seed and batch.
    The loss rtol 1e-6 (bit-equal expected: the forward is deterministic),
    each gradient within phase 8's bound (‖g − g_off‖ <= 1e-3·‖g_off‖ +
    1e-7: kernel C and cuDNN's backward sum in another order on each run),
    the generator's state after the step equal, A launched A_STEP times
    with remat and 24 without, and the peak memory lower with remat. Then
    one step with remat at KITTI_BATCH_MAX, the preset's own global batch,
    with cuDNN off (phase 28's ATen convolutions: no autotuner search):
    finite loss and gradients, its peak memory and time. Returns the
    batch-2 step's (remat, no remat) peak MiB."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data import TrainLoader, build_train_pipeline
    from gedepth_tpu_torch.train.loop import (
        build_train_dataset, cudnn_autotuner)
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state, make_train_step)

    cfg = get_config(PRESET, data=tree_data(PRESET, tree))
    dataset = build_train_dataset(cfg)
    pipeline = build_train_pipeline(cfg.data, cfg.model.depth_scale)
    counters = _kernel_counters()
    # one model, its seeded weights restored before each step; remat is
    # the backbone's switch, read at every forward
    model = cfg.model.build(device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
    seeded = {k: v.clone() for k, v in model.state_dict().items()}

    def one_step(remat, batch_size, convolutions=cudnn_autotuner):
        model.load_state_dict(seeded)
        model.backbone.remat = remat
        state = create_train_state(model, cfg.optim, cfg.train.max_iters,
                                   seed=SEED + 1)
        batch = batch_to_device(TrainLoader(dataset, pipeline, batch_size,
                                            seed=SEED).make_batch(0), "cuda")
        reset_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with convolutions():
            metrics = make_train_step()(state, batch)
        torch.cuda.synchronize()
        out = {"seconds": time.perf_counter() - t0,
               "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
               "loss": metrics["loss"].item(),
               "launches": read_counts(counters)[0],
               "generator": state.generator.get_state(),
               "grads": {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}}
        model.zero_grad(set_to_none=True)
        del state, batch, metrics
        torch.cuda.empty_cache()
        return out

    on, off = one_step(True, 2), one_step(False, 2)
    if not abs(on["loss"] - off["loss"]) <= 1e-6 * abs(off["loss"]):
        fail(f"[remat] loss {on['loss']} with remat, {off['loss']} without")
    if not torch.equal(on["generator"], off["generator"]):
        fail("[remat] the generator's state after the step differs")
    worst = (0.0, "")
    for name, g in off["grads"].items():
        diff, norm = (on["grads"][name] - g).norm().item(), g.norm().item()
        bound = 1e-3 * norm + 1e-7
        if not diff <= bound:
            fail(f"[remat] gradient of {name}: |g - g_off| {diff:.3e} > "
                 f"{bound:.3e}")
        worst = max(worst, (diff / bound, name))
    want = {True: {"window_attention": A_STEP, "msda": 2, "msda_backward": 2,
                   "pe_fusion": 1},
            False: {"window_attention": A_FORWARD, "msda": 2,
                    "msda_backward": 2, "pe_fusion": 1}}
    for remat, r in ((True, on), (False, off)):
        if r["launches"] != want[remat]:
            fail(f"[remat] swin_remat={remat}: launches {r['launches']}, "
                 f"expected {want[remat]}")
    if not on["peak_mib"] < off["peak_mib"]:
        fail(f"[remat] peak {on['peak_mib']:.0f} MiB with remat, "
             f"{off['peak_mib']:.0f} without")
    print(f"[remat] {PRESET} 352x704 f32, batch 2, one step from the seeded "
          f"weights: loss {on['loss']:.8f} with remat, {off['loss']:.8f} "
          f"without (bit-equal {on['loss'] == off['loss']}); gradients "
          f"within phase 8's bound, the closest {worst[1]} at "
          f"{worst[0]:.3f} of it; generator state equal; A launched "
          f"{on['launches']['window_attention']} against "
          f"{off['launches']['window_attention']}; peak "
          f"{on['peak_mib']:.0f} MiB against {off['peak_mib']:.0f}; step "
          f"{on['seconds'] * 1e3:.0f} ms against {off['seconds'] * 1e3:.0f} "
          "(one step each, cuDNN's choices warm from phase 7)", flush=True)
    del on["grads"], off["grads"]
    # ATen's convolutions: cuDNN's autotuner takes ~250 s to search this
    # batch's shapes, and its heuristic alone picks FFT (PERF.md)
    big = one_step(True, KITTI_BATCH_MAX, cudnn_off)
    bad = [n for n, g in big["grads"].items()
           if not bool(torch.isfinite(g).all())]
    if bad or not math.isfinite(big["loss"]) \
            or big["launches"]["window_attention"] != A_STEP:
        fail(f"[remat] batch {KITTI_BATCH_MAX}: loss {big['loss']}, "
             f"non-finite gradients {bad[:4]}, launches {big['launches']}")
    print(f"[remat] {PRESET} 352x704 f32 with remat at the preset's global "
          f"batch {KITTI_BATCH_MAX} on one card: loss {big['loss']:.6f}, "
          f"gradients finite, peak {big['peak_mib']:.0f} MiB with cuDNN "
          f"off (ATen's convolutions), step {big['seconds']:.2f} s",
          flush=True)
    del big, model, seeded
    torch.cuda.empty_cache()
    return on["peak_mib"], off["peak_mib"]


SWIN_L = dict(embed=192, depths=(2, 2, 18, 2), heads=(6, 12, 24, 48))


def official_swin_l(window=12, seed=SEED):
    """An official-format (microsoft/Swin-Transformer key names) Swin-L
    state dict as swin_large_patch4_window12_384_22k.pth holds it, seeded:
    3-channel patch embed, absolute position table, window-12 tables, the
    22k head (tests/test_dress_rehearsal.py)."""
    g = torch.Generator().manual_seed(seed)
    e, depths, heads = SWIN_L["embed"], SWIN_L["depths"], SWIN_L["heads"]

    def t(*shape, scale=0.02):
        return torch.randn(*shape, generator=g) * scale

    sd = {"patch_embed.proj.weight": t(e, 3, 4, 4),
          "patch_embed.proj.bias": t(e), "patch_embed.norm.weight":
          torch.ones(e), "patch_embed.norm.bias": torch.zeros(e),
          "absolute_pos_embed": t(1, 96 * 96, e)}
    for i, depth in enumerate(depths):
        d = e * 2 ** i
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}."
            sd.update({
                b + "norm1.weight": torch.ones(d),
                b + "norm1.bias": torch.zeros(d),
                b + "attn.relative_position_bias_table": t(
                    (2 * window - 1) ** 2, heads[i]),
                b + "attn.qkv.weight": t(3 * d, d),
                b + "attn.qkv.bias": t(3 * d),
                b + "attn.proj.weight": t(d, d), b + "attn.proj.bias": t(d),
                b + "norm2.weight": torch.ones(d),
                b + "norm2.bias": torch.zeros(d),
                b + "mlp.fc1.weight": t(4 * d, d),
                b + "mlp.fc1.bias": t(4 * d),
                b + "mlp.fc2.weight": t(d, 4 * d), b + "mlp.fc2.bias": t(d)})
        if i < 3:
            sd[f"layers.{i}.downsample.norm.weight"] = torch.ones(4 * d)
            sd[f"layers.{i}.downsample.norm.bias"] = torch.zeros(4 * d)
            sd[f"layers.{i}.downsample.reduction.weight"] = t(2 * d, 4 * d)
    last = e * 2 ** (len(depths) - 1)
    sd.update({"norm.weight": torch.ones(last), "norm.bias": torch.zeros(last),
               "head.weight": t(21841, last), "head.bias": t(21841)})
    return sd


def phase_dress_rehearsal(work):
    """Phase 35: the official Swin-L-384 (window 12) file of
    `official_swin_l` converted by `python -m
    gedepth_tpu_torch.tools.convert_torch_checkpoint <pth> PARITY <npz>
    --official-swin` (a process of its own); in the .npz the window-12
    tables resized to window 7 and the patch embed padded to 4 channels.
    Then the 352x1216 flip-TTA protocol eval step on one seeded input
    (tests/test_dress_rehearsal.py's) from that .npz twice: the parity
    preset (compat R = 5, its `backbone_head` bf16 scope) and the exact
    f32 preset. Depth (1, 352, 1216) and finite on both; the mean and p99
    of |compat − exact| / max(exact, 1e-3); the mean below 5e-2, the JAX
    package's rail (only the backbone is converted: the neck keeps its
    seeded offsets, which reach far wider than a trained checkpoint's)."""
    import os
    import os.path as osp

    from gedepth_tpu_torch.apis import init_depther

    t0 = time.perf_counter()
    pth, npz = osp.join(work, "swin_l_w12_official.pth"), osp.join(
        work, "converted.npz")
    torch.save(official_swin_l(), pth)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gedepth_tpu_torch.tools.convert_torch_"
         "checkpoint", pth, PARITY, npz, "--official-swin"],
        capture_output=True, text=True, timeout=900,
        cwd=osp.dirname(osp.abspath(__file__)))
    if proc.returncode != 0:
        fail(f"[dress] conversion exited {proc.returncode}:\n"
             f"{proc.stderr[-3000:]}")
    converted = time.perf_counter() - t0
    with np.load(npz) as f:
        tables = {f[k].shape for k in f.files
                  if k.endswith("relative_position_bias_table")}
        embed = [f[k].shape for k in f.files
                 if k.endswith("patch_embed/projection/kernel")]
    if {s[0] for s in tables} != {13 * 13} or [e[2] for e in embed] != [4]:
        fail(f"[dress] tables {tables}, patch embed {embed}")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 352, 1216, 5)).astype(np.float32)
    img[..., 3] = np.abs(img[..., 3]) * 0.3
    img[..., 4] = np.abs(img[..., 4]) * 30 + 1.0
    img = torch.from_numpy(img).cuda()
    cam = torch.full((1,), 1.65, device="cuda")
    depth = {}
    for name in (PARITY, EXACT):
        handle = init_depther(name, device="cuda", checkpoint=npz,
                              flip_tta=True)
        depth[name] = handle.eval_step(img, cam).float().cpu().numpy()
        del handle
        torch.cuda.empty_cache()
    got, want = depth[PARITY], depth[EXACT]
    if got.shape != (1, 352, 1216) or want.shape != got.shape \
            or not np.isfinite(got).all() or not np.isfinite(want).all():
        fail(f"[dress] depth {got.shape}, {want.shape} or not finite")
    rel = np.abs(got - want) / np.maximum(want, 1e-3)
    print(f"[dress] official Swin-L-384 (window 12, "
          f"{os.path.getsize(pth):,} bytes) made in {made:.1f} s, converted "
          f"by tools.convert_torch_checkpoint --official-swin in "
          f"{converted:.1f} s ({os.path.getsize(npz):,} bytes; tables "
          f"{sorted(tables)}, patch embed {embed[0]}); its output: "
          + " | ".join(proc.stdout.strip().splitlines()) + "; the 352x1216 "
          f"flip-TTA step, parity preset (compat R = {PARITY_RADIUS}, "
          f"backbone_head bf16) against exact f32 on the converted backbone "
          f"and the seeded neck: mean abs-rel {rel.mean():.5f}, p99 "
          f"{np.percentile(rel, 99):.5f} (JAX on the CPU: 9.4e-3 mean; rail "
          "5e-2)", flush=True)
    if not rel.mean() < 5e-2:
        fail(f"[dress] mean abs-rel {rel.mean()} past the rail 5e-2")
    os.remove(pth)
    os.remove(npz)
    return float(rel.mean())


COMPAT_RADIUS = 6
PARITY_RADIUS = 5
EXACT = "gedepth_adaptive_kitti"
PARITY = "gedepth_adaptive_kitti_parity"
COMPAT = "gedepth_adaptive_kitti_compat"


def rule_positions(rule, randn, g, B, levels, grids, learned,
                   radius=None, spread=3.0):
    """(positions, weights, window hint) of one sampling rule at seeded
    offsets of a few level pixels. learned: one set of reference points for
    the whole batch, sigmoid(Linear(query_pos)) at the layer's seeded
    initialisation, which puts neighbouring queries far apart (the
    cross-attention); else the grid centres (the self-attention).
    A twentieth of the exact and nearest samples is thrown tens of pixels
    or a million away, out of every level. `radius`: the compat rule's
    (default COMPAT_RADIUS). `spread`: the offsets' standard deviation in
    level pixels."""
    from gedepth_tpu_torch.models.layers import sine_positional_encoding
    from gedepth_tpu_torch.ops import msda as msda_ops

    Nq, L = sum(a * b for a, b in grids), len(levels)
    off = spread * randn(B, Nq, 8, L, 8, 2)
    w = randn(B, Nq, 8, L * 8).softmax(-1).view(B, Nq, 8, L, 8)
    if learned:
        # as HAHINeck forms them: sigmoid(Linear(512 -> 2)(sine encoding)),
        # the layer's seeded xavier initialisation
        weight = torch.empty(2, 512)
        torch.nn.init.xavier_uniform_(
            weight, generator=torch.Generator().manual_seed(SEED))
        qpos = sine_positional_encoding(*grids[0], 256, device="cuda")
        ref = torch.sigmoid(qpos.reshape(1, Nq, -1) @ weight.cuda().T)
        ref = ref[:, :, None, :].expand(1, Nq, L, 2)
    else:
        ref = msda_ops.center_reference_points(levels, "cuda")[-Nq:]
    if rule == "compat":
        radius = COMPAT_RADIUS if radius is None else radius
        pos, _ = msda_ops.compat_positions(ref, off, grids, levels, radius)
        return pos, w, (grids, radius)
    off = scatter(off, g, share=0.05)
    form = (msda_ops.exact_positions if rule == "exact"
            else msda_ops.nearest_positions)
    return form(ref, off, levels), w, ()


def touching(pos, levels):
    """How many samples have at least one corner inside their level: the
    others read and add nothing."""
    n = 0
    for l, (Hl, Wl) in enumerate(levels):
        x, y = pos[:, :, :, l, :, 0], pos[:, :, :, l, :, 1]
        n += ((x > -1) & (x < Wl) & (y > -1) & (y < Hl)).sum().item()
    return n


def staged_by_plan(grids, levels, radius, itemsize=4):
    """Share of the tiles of each query grid that stage each level, for a
    value of `itemsize` bytes an element."""
    from gedepth_tpu_torch.ops import msda as msda_ops

    _, lanes = msda_ops.channel_lanes(64, itemsize=itemsize)
    plan = msda_ops.tile_plan(tuple(grids), tuple(levels), float(radius), 64,
                              msda_ops.stage_budget(64, lanes), itemsize)
    starts = np.cumsum([0] + [a * b for a, b in grids])
    rects = plan.rows[:, msda_ops.TILE_HEADER:].reshape(len(plan.rows), -1, 4)
    grid_of = np.searchsorted(starts, plan.rows[:, 0], side="right") - 1
    return {f"{grids[gi][0]}x{grids[gi][1]}": [
        round(float((rects[grid_of == gi, l, 2] > 0).mean()), 3)
        for l in range(len(levels))] for gi in range(len(grids))}


def plan_staged_share(pos, levels, plan):
    """Per level, the share of the samples touching it whose four corners
    lie in their tile's staged rectangle under `plan` (`PlanTensors`)."""
    from gedepth_tpu_torch.ops import msda as msda_ops

    B, Nq, L = pos.shape[0], pos.shape[1], len(levels)
    T = -(-Nq // msda_ops.MAX_TILE_QUERIES)
    rank = torch.empty(B, Nq, dtype=torch.long, device=pos.device)
    rank.scatter_(1, plan.perm.long(),
                  torch.arange(Nq, device=pos.device).expand(B, Nq))
    tile = (torch.arange(B, device=pos.device)[:, None] * T
            + rank // msda_ops.MAX_TILE_QUERIES)
    rects = plan.rows[:, msda_ops.TILE_HEADER:].view(-1, L, 4).long()[tile]
    shares = []
    for l, (Hl, Wl) in enumerate(levels):
        x0 = pos[:, :, :, l, :, 0].floor()
        y0 = pos[:, :, :, l, :, 1].floor()
        touch = (x0 >= -1) & (x0 < Wl) & (y0 >= -1) & (y0 < Hl)
        x0 = torch.where(touch, x0, 0).long()
        y0 = torch.where(touch, y0, 0).long()
        ry, rx, rh, rw = (rects[:, :, l, i][:, :, None, None]
                          for i in range(4))
        inside = (touch & (x0.clamp_min(0) >= rx)
                  & ((x0 + 1).clamp_max(Wl - 1) < rx + rw)
                  & (y0.clamp_min(0) >= ry)
                  & ((y0 + 1).clamp_max(Hl - 1) < ry + rh))
        shares.append(round(inside.sum().item()
                            / max(touch.sum().item(), 1), 3))
    return shares


def check_plan(label, pos, levels, itemsize=4):
    """The planning kernel against `plan_plain`, integer for integer; prints
    the share of samples its plan stages per level. Returns the plan (B's
    and C's: the same for one value)."""
    from gedepth_tpu_torch.ops import msda as msda_ops

    budget = msda_ops.stage_budget(
        64, msda_ops.channel_lanes(64, itemsize=itemsize)[1])
    got = msda_ops.msda_plan(pos, levels, 64, budget, itemsize)
    want = msda_ops.plan_plain(pos, levels, 64, budget, itemsize)
    for name in ("keys", "perm", "rows"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            fail(f"[rules] {label}: the planning kernel's {name} differ "
                 "from plan_plain's")
    print(f"  plan {label} (B's and C's) equals plan_plain; samples "
          f"staged, levels 0..3: {plan_staged_share(pos, levels, got)}",
          flush=True)
    return got


def phase_rule_kernels():
    from gedepth_tpu_torch.ops import msda as msda_ops

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    print("[rules] kernels B and C at exact, nearest and compat (R = 6) "
          "positions (B: rtol 2e-4, atol 2e-5; C as phase 6); the exact "
          "rule's launches over the plan the card makes from the positions, "
          "held to the unplanned rows bit for bit (B, C's d_pos and d_w)")
    for name, grids, levels in (
            ("serving self", SERVE_LEVELS, SERVE_LEVELS),
            ("serving cross", ((176, 608),), SERVE_LEVELS),
            ("train self", TRAIN_LEVELS, TRAIN_LEVELS),
            ("train cross", ((176, 352),), TRAIN_LEVELS)):
        print(f"[rules] compat plan, {name}: share of tiles staging levels "
              f"0..3 per query grid {staged_by_plan(grids, levels, 6)}")
    results = {}
    for shape, B, levels, grids, learned, backward, spread in (
            ("serving_self", 1, SERVE_LEVELS, SERVE_LEVELS, False, False, 3.0),
            ("serving_cross", 1, SERVE_LEVELS, ((176, 608),), True, False,
             3.0),
            ("train_self", 2, TRAIN_LEVELS, TRAIN_LEVELS, False, True, 3.0),
            ("train_cross", 2, TRAIN_LEVELS, ((176, 352),), True, True, 3.0),
            # offsets four times as wide: windows hold a quarter of the
            # samples or less; the plan must cost no more than 1.1x
            ("stress_cross", 2, TRAIN_LEVELS, ((176, 352),), True, True,
             12.0)):
        value = randn(B, sum(a * b for a, b in levels), 8, 64)
        stress = shape.startswith("stress")
        for rule in ("exact",) if stress else ("exact", "nearest", "compat"):
            pos, w, hint = rule_positions(rule, randn, g, B, levels, grids,
                                          learned, spread=spread)
            Nq, label = pos.shape[1], f"{rule} {shape}"
            n_touch = touching(pos, levels)
            want = msda_ops.msda_plain(value, levels, pos, w)
            got = msda_ops.msda(value, levels, pos, w, *hint)
            err = compare(f"B {label} {B}x{Nq} queries", got, want, 2e-4,
                          2e-5)
            kernel_b = functools.partial(msda_ops.msda, value, levels, pos, w,
                                         *hint)
            extra = {}
            if rule == "exact":
                plan = check_plan(label, pos, levels)
                if not torch.equal(got, msda_ops.msda_unplanned(
                        value, levels, pos, w)):
                    fail(f"[rules] B {label}: planned and unplanned "
                         "outputs differ")
                print("  B planned equals B unplanned bit for bit",
                      flush=True)
                extra["unplanned"] = functools.partial(
                    msda_ops.msda_unplanned, value, levels, pos, w)
                if shape == "train_cross":
                    # the finest level's positions (keys), every
                    # PLAN_SHARE_STRIDE-th query's (shares), perm and rows
                    plan_bytes = (n_bytes(pos) // len(levels)
                                  + n_bytes(pos) // msda_ops.PLAN_SHARE_STRIDE
                                  + n_bytes(plan.perm, plan.rows))
                    tp = timed(functools.partial(
                        msda_ops.msda_plan, pos, levels, 64,
                        msda_ops.stage_budget(64, 16), 4),
                        lambda: msda_ops.plan_plain(
                            pos, levels, 64, msda_ops.stage_budget(64, 16),
                            4),
                        plain_reps=1, trace_plain=False)
                    tp["bound_ms"], tp["bound_by"] = bound(plan_bytes, 0)
                    show(tp)
                    results[f"msda_plan {label}"] = dict(
                        tp, max_abs_err=0.0, queries=Nq)
                del plan
            if rule == "compat":
                extra["without_hint"] = functools.partial(
                    msda_ops.msda, value, levels, pos, w)
            if rule == "nearest":
                # no preset samples nearest: checked above, timed by events
                # only, and no row in the `kernels` line
                print(f"    event_ms={burst_ms(kernel_b):.4f} (CUDA events) "
                      f"touching={n_touch / w.numel():.3f}", flush=True)
            else:
                # the plain version ran just above (`want`); the stress
                # row keeps no plain time
                t = timed(kernel_b, None if stress else
                          lambda: msda_ops.msda_plain(value, levels, pos, w),
                          plain_reps=1, plain_warmup=0, trace_plain=False,
                          extra=extra)
                t["bound_ms"], t["bound_by"] = bound(
                    n_bytes(value, pos, w, want), 9 * n_touch * 64)
                show(t, touching=f"{n_touch / w.numel():.3f}")
                if stress:
                    hold_stress(f"B {label}", t)
                else:
                    results[f"msda {label}"] = dict(t, max_abs_err=err,
                                                    queries=Nq)
            del want, got
            if not backward:
                continue
            gout = randn(B, Nq, 512)
            args = (value, levels, pos, w, gout)
            got = msda_ops.msda_backward(*args, *hint)
            want = msda_ops.msda_backward_plain(*args)
            dv_atol = 1e-5 * want[0].abs().max().item()
            err = max(compare(f"C {label} d_value", got[0], want[0], 2e-4,
                              dv_atol),
                      compare(f"C {label} d_pos", got[1], want[1], 2e-4,
                              2e-5),
                      compare(f"C {label} d_weights", got[2], want[2], 2e-4,
                              2e-5))
            n_out = n_bytes(*want)
            extra = {}
            if rule == "exact":
                ref = msda_ops.msda_backward_unplanned(*args)
                if not (torch.equal(got[1], ref[1])
                        and torch.equal(got[2], ref[2])):
                    fail(f"[rules] C {label}: planned and unplanned d_pos or "
                         "d_weights differ")
                print("  C planned equals C unplanned bit for bit in d_pos "
                      "and d_weights", flush=True)
                del ref
                extra["unplanned"] = functools.partial(
                    msda_ops.msda_backward_unplanned, *args)
            del got, want
            kernel_c = functools.partial(msda_ops.msda_backward, *args, *hint)
            if rule == "nearest":
                print(f"    event_ms={burst_ms(kernel_c):.4f} (CUDA events)",
                      flush=True)
            else:
                if rule == "compat":
                    extra["without_hint"] = functools.partial(
                        msda_ops.msda_backward, *args)
                t = timed(kernel_c, None if stress else
                          lambda: msda_ops.msda_backward_plain(*args),
                          plain_reps=1, plain_warmup=0, trace_plain=False,
                          extra=extra)
                t["bound_ms"], t["bound_by"] = bound(
                    n_bytes(value, pos, w, gout) + n_out, 17 * n_touch * 64)
                show(t)
                if stress:
                    hold_stress(f"C {label}", t)
                else:
                    results[f"msda_backward {label}"] = dict(
                        t, max_abs_err=err, queries=Nq)
            del gout, args
        del value, pos, w
        torch.cuda.empty_cache()
    return results


def hold_stress(label, t):
    """The planned launch, its plan included, against the unplanned one at
    the stress positions, by CUDA events over back-to-back calls: at most
    1.1x."""
    ratio = t["event_ms"] / t["extra_ms"]["unplanned"][1]
    print(f"  {label}: planned {t['event_ms']:.4f} ms against unplanned "
          f"{t['extra_ms']['unplanned'][1]:.4f} ms (events): {ratio:.3f}x "
          "(limit 1.1x)", flush=True)
    if ratio > 1.1:
        fail(f"[rules] {label}: the plan costs {ratio:.3f}x the unplanned "
             "launch at the stress positions")


def phase_presets(requests):
    """Serve the four reference-semantics presets; returns the exact
    preset's handle and every preset's launches of B by query count."""
    from gedepth_tpu_torch.apis import inference_depther, init_depther

    counters = _kernel_counters()
    counted, exact = {}, None
    for preset, n_requests in ((EXACT, 2), (COMPAT, 2),
                               ("gedepth_vanilla_kitti", 1),
                               ("depthformer_baseline_kitti", 1)):
        t0 = time.perf_counter()
        handle = init_depther(preset, device="cuda", pe_raw=requests[0][1],
                              seed=SEED)
        torch.cuda.synchronize()
        cfg = handle.cfg.model
        print(f"[presets] init_depther({preset!r}): sampling "
              f"{cfg.neck_sampling!r}, pe_variant {cfg.pe_variant!r}, "
              f"{sum(p.numel() for p in handle.model.parameters())} "
              f"parameters in {time.perf_counter() - t0:.2f} s", flush=True)
        inference_depther(handle, requests[0][0])       # warm-up
        reset_counts(counters)
        latencies, depths = [], []
        for rgb, _ in requests[:n_requests]:
            t = time.perf_counter()
            depths.append(inference_depther(handle, rgb))
            latencies.append((time.perf_counter() - t) * 1e3)
        launches, by_queries = read_counts(counters)
        for i, d in enumerate(depths):
            if d.shape != (352, 1216) or not np.isfinite(d).all():
                fail(f"{preset} request {i}: depth {d.shape} not finite")
            if d.min() < cfg.min_depth - 1e-6 \
                    or d.max() > cfg.max_depth + 1e-4:
                fail(f"{preset} request {i}: depth outside [{cfg.min_depth}, "
                     f"{cfg.max_depth}]: {d.min()}..{d.max()}")
        forwards = 2 * n_requests          # flip-TTA: two forwards a request
        want = {"window_attention": 24 * forwards, "msda": 2 * forwards,
                "msda_backward": 0,
                "pe_fusion": forwards if cfg.pe_variant == "adaptive" else 0}
        print(f"[presets] {preset}: flip-TTA request latency ms "
              f"{[round(x, 3) for x in latencies]}; depth in "
              f"[{min(d.min() for d in depths):.4f}, "
              f"{max(d.max() for d in depths):.4f}] m; launches {launches}, "
              f"by queries per sample {by_queries}", flush=True)
        # every preset here attends from all four levels (35,530 queries)
        # and from the stem's 176x608 grid (107,008)
        want_by = {"msda": {35530: forwards, 107008: forwards},
                   "msda_backward": {}}
        if launches != want or by_queries != want_by:
            fail(f"{preset}: launches {launches}, {by_queries}; expected "
                 f"{want}, {want_by}")
        if cfg.neck_sampling == "windowed_compat":
            neck = handle.model.neck
            print(f"[presets] {preset}: compat_clamp_mass self "
                  f"{neck.self_attn.compat_clamp_mass.item():.6f} cross "
                  f"{neck.multi_att.compat_clamp_mass.item():.6f} (seeded "
                  "initialisation)")
        counted[preset] = by_queries
        if preset == EXACT:
            exact = handle
            phase_whole_forward(handle, requests, tag="[presets]")
        else:
            del handle
            torch.cuda.empty_cache()
    return exact, counted


def phase_evaluator(model):
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    cfg = get_config(EXACT, data=synthetic_data(synthetic_size=16))
    dataset = build_eval_dataset(cfg)       # 4 synthetic 352x1216 frames
    runs = {}
    for label, kw in (
            ("multi-ratio", dict(ms_ratios=(0.75, 1.0, 1.25))),
            ("multi-ratio, device metrics",
             dict(ms_ratios=(0.75, 1.0, 1.25), device_metrics=True)),
            ("slide 352x704", dict(mode="slide", slide_tile=(352, 704)))):
        evaluator = Evaluator(model, dataset, cfg.data, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        agg, rows = evaluator.run()
        per_image = (time.perf_counter() - t0) * 1e3 / len(dataset)
        peak = torch.cuda.max_memory_allocated() / 2**20
        if len(rows) != len(dataset) or len(agg) != 9 \
                or not np.isfinite(np.asarray(rows)).all():
            fail(f"evaluator ({label}): {len(rows)} rows, aggregate {agg}")
        print(f"[eval] Evaluator({EXACT!r}, {label}), {len(dataset)} frames: "
              f"{per_image:.1f} ms an image (the first carries cuDNN's "
              f"choice of algorithms), peak device memory {peak:.1f} MiB; "
              + " ".join(f"{k}={v:.6f}" for k, v in agg.items()), flush=True)
        runs[label] = np.asarray(rows, np.float64)
    a, b = runs["multi-ratio"], runs["multi-ratio, device metrics"]
    worst = float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12)))
    print(f"[eval] numpy vs device metrics: largest relative difference "
          f"{worst:.3e} (rtol 1e-5)", flush=True)
    if not np.allclose(b, a, rtol=1e-5, atol=1e-9):
        fail("device metrics disagree with the numpy metrics")


def _states_equal(a, b):
    """Names of what differs between two `TrainState`s, bit for bit: the
    model's parameters and buffers, AdamW's moments and step counts, and
    `step`."""
    bad = [] if a.step == b.step else ["step"]
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad += [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    if oa.keys() != ob.keys() or not oa:
        bad.append("optimizer state keys")
    bad += [f"optimizer {i} {n}" for i in oa for n, t in oa[i].items()
            if not torch.equal(t.cpu(), ob[i][n].cpu())]
    return bad


def phase_checkpoints(work):
    """Phase 20: `train()` with evaluation and checkpoints every 2 steps,
    restore, resume. Returns (the best weights' .npz, a CPU copy of the
    weights it was written from)."""
    import dataclasses
    import os
    import os.path as osp

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.train import checkpoint as ckpt
    from gedepth_tpu_torch.train import loop
    from gedepth_tpu_torch.train.optim import lr_schedule
    from gedepth_tpu_torch.train.steps import create_train_state

    cfg = get_config(PRESET, data=synthetic_data())      # synthetic frames
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, global_batch=2, eval_interval=2, checkpoint_interval=2,
        max_keep_ckpts=1))
    saves, npz_saves, best_weights = [], [], {}
    keeper_save, npz_save = ckpt.CheckpointKeeper.save, loop.save_params_only

    def timed_save(self, state, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = keeper_save(self, state, step)
        saves.append((step, time.perf_counter() - t0, os.path.getsize(path)))
        return path

    def timed_npz(path, model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        npz_save(path, model)
        npz_saves.append((time.perf_counter() - t0, os.path.getsize(path)))
        best_weights.clear()
        best_weights.update({k: v.detach().cpu().clone()
                             for k, v in model.state_dict().items()})

    counters = _kernel_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    with mock.patch.object(ckpt.CheckpointKeeper, "save", timed_save), \
            mock.patch.object(loop, "save_params_only", timed_npz):
        state, history, best = loop.train(cfg, work_dir=work, max_iters=4,
                                          eval_max_images=EVAL_IMAGES,
                                          device="cuda")
    wall = time.perf_counter() - t0
    launches, _ = read_counts(counters)
    vals = [r for r in history if r["mode"] == "val"]
    ckpts = osp.join(work, "ckpts")
    best_npz = osp.join(work, "best_abs_rel.npz")
    print(f"[ckpt] train({PRESET!r}, max_iters=4), eval and checkpoint "
          f"every 2 steps, keep 1: {wall:.2f} s including init; launches "
          f"{launches}; checkpoints {ckpt.checkpoint_steps(ckpts)}; files "
          f"{sorted(os.listdir(work))}", flush=True)
    metrics = ("abs_rel", "sq_rel", "rmse", "rmse_log", "log_10", "silog",
               "a1", "a2", "a3")
    for r in vals:
        print(f"[ckpt] eval @ {r['iter']}: " + " ".join(
            f"{k}={r[k]:.6g}" for k in metrics) + f"; {r['images']} images, "
            f"{r['time'] / r['images'] * 1e3:.1f} ms an image", flush=True)
    if [r["iter"] for r in vals] != [2, 4] or not all(
            np.isfinite(r[k]) for r in vals for k in metrics):
        fail(f"expected evaluations at steps 2 and 4, finite: {vals}")
    if ckpt.checkpoint_steps(ckpts) != [4] or not osp.exists(best_npz):
        fail("expected one checkpoint (step 4) and best_abs_rel.npz")
    if [s[0] for s in saves] != [2, 4] or not npz_saves:
        fail(f"saves {saves}, best .npz writes {npz_saves}")
    print(f"[ckpt] best abs_rel {best['abs_rel']:.6g} at step "
          f"{best['iter']}; checkpoint saves (step, s, bytes) {saves}; best "
          f".npz writes (s, bytes) {npz_saves}", flush=True)

    fresh = create_train_state(
        cfg.model.build(device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 7)),
        cfg.optim, 4, seed=cfg.train.seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(ckpts, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad = _states_equal(state, fresh)
    print(f"[ckpt] restore_checkpoint of {saves[-1][2]} bytes into a fresh "
          f"state: {restore_s:.2f} s; bit-equal parameters, buffers, AdamW "
          f"moments and step: {not bad}", flush=True)
    if bad:
        fail(f"restored state differs: {bad[:8]} ({len(bad)})")
    del state, fresh
    torch.cuda.empty_cache()

    reset_counts(counters)
    resumed, history, _ = loop.train(cfg, max_iters=6, resume_from=ckpts,
                                     eval_max_images=EVAL_IMAGES,
                                     device="cuda")
    launches, _ = read_counts(counters)
    steps = [r for r in history if r["mode"] == "train"]
    schedule = lr_schedule(cfg.optim.max_lr, 6, cfg.optim.warmup_iters,
                           cfg.optim.warmup_ratio, cfg.optim.min_lr_ratio)
    for r in steps:
        print(f"[ckpt] resumed iter {r['iter']} loss={r['loss']:.6f} "
              f"lr={r['lr']:.6e} step_ms={r['time'] * 1e3:.3f}", flush=True)
    if [r["iter"] for r in steps] != [5, 6] or resumed.step != 6:
        fail(f"resume ran iters {[r['iter'] for r in steps]}, step "
             f"{resumed.step}")
    if [r["lr"] for r in steps] != [schedule(4), schedule(5)]:
        fail(f"resumed LR {[r['lr'] for r in steps]}, the schedule gives "
             f"{[schedule(4), schedule(5)]}")
    if not all(np.isfinite(r["loss"]) for r in steps):
        fail("non-finite loss after resume")
    if min(launches.values()) <= 0:
        fail(f"resumed run launched {launches}")
    print(f"[ckpt] resumed at step 4 for steps 5-6: LR at the schedule's "
          f"4 and 5 of 6, finite losses, launches {launches}", flush=True)
    del resumed
    torch.cuda.empty_cache()
    return best_npz, best_weights


def _reference_pth(path, state_dict, window=7):
    """`state_dict` as a reference training checkpoint holds it: under
    `state_dict`, keys prefixed `module.`, with the relative_position_index
    buffers the port computes on the fly."""
    from gedepth_tpu_torch.models.swin import relative_position_index

    out = {"module." + k: v for k, v in state_dict.items()}
    index = torch.from_numpy(relative_position_index(window, window))
    for k in state_dict:
        if k.endswith("relative_position_bias_table"):
            out["module." + k.replace("bias_table", "index")] = index
    torch.save({"meta": {"iter": 4}, "state_dict": out}, path)


def phase_weights_in(work, best_npz, best_weights, requests):
    """Phase 21: serve the best .npz and the same weights by state_dict,
    then as a reference .pth through tools.convert_torch_checkpoint (with
    a 4- and a 3-channel patch embed); every depth bit-equal to its
    state_dict twin. Returns the .pth converted to the parity preset's
    tree (reference points seeded) for phase 22."""
    import os.path as osp

    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.tools import convert_torch_checkpoint

    rgb, pe = requests[0]

    def serve(**weights):
        handle = init_depther(PRESET, device="cuda", pe_raw=pe, seed=SEED,
                              **weights)
        depth = inference_depther(handle, rgb)
        del handle
        torch.cuda.empty_cache()
        check_depth("[weights]", depth, get_config_model(PRESET))
        return depth

    def same(label, a, b):
        equal = np.array_equal(a, b)
        print(f"[weights] {label}: depth bit-equal {equal} (max |diff| "
              f"{np.abs(a - b).max():.3e} m)", flush=True)
        if not equal:
            fail(f"{label}: depth differs")

    t0 = time.perf_counter()
    by_npz = serve(checkpoint=best_npz)
    print(f"[weights] init_depther(checkpoint=best_abs_rel.npz) and one "
          f"request: {time.perf_counter() - t0:.2f} s", flush=True)
    same("best_abs_rel.npz against state_dict=", by_npz,
         serve(state_dict=best_weights))

    key = "backbone.patch_embed.projection.weight"
    rgb_only = dict(best_weights)
    rgb_only[key] = best_weights[key][:, :3].clone()
    padded = dict(best_weights)
    padded[key] = torch.cat([rgb_only[key],
                             torch.zeros_like(rgb_only[key][:, :1])], dim=1)
    parity_npz = None
    for label, weights, twin in (("4-channel", best_weights, by_npz),
                                 ("3-channel", rgb_only, None)):
        pth = osp.join(work, "reference.pth")
        out = osp.join(work, "converted.npz")
        _reference_pth(pth, weights)
        t0 = time.perf_counter()
        report = convert_torch_checkpoint.main([pth, PRESET, out])
        print(f"[weights] tools.convert_torch_checkpoint ({label} patch "
              f"embed): {time.perf_counter() - t0:.2f} s, report "
              f"{report}", flush=True)
        if any(report.values()):
            fail(f"{label}: conversion report {report}")
        if twin is None:
            twin = serve(state_dict=padded)
        same(f"reference .pth ({label} patch embed) against state_dict=",
             serve(checkpoint=out), twin)
        if parity_npz is None:
            parity_npz = osp.join(work, "parity.npz")
            report = convert_torch_checkpoint.main([pth, PARITY, parity_npz])
            want = ["neck.reference_points.bias",
                    "neck.reference_points.weight"]
            if sorted(report["missing_params"]) != want \
                    or report["unmapped_torch_keys"] \
                    or report["missing_stats"]:
                fail(f"windowed .pth into the parity tree: {report}")
    return parity_npz


def get_config_model(name):
    from gedepth_tpu_torch.configs import get_config

    return get_config(name).model


def phase_compat_check(npz):
    """Phase 22: tools.compat_check on the phase-20 weights in the parity
    tree, radii 5 and 6, one image."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.tools import compat_check as cc

    cfg = get_config(PARITY)
    t0 = time.perf_counter()
    rows = cc.compat_check(cfg, npz, (5, 6), budget=1e-3, images=1,
                           seed=SEED, device="cuda")
    seconds = time.perf_counter() - t0
    print(f"[compat] compat_check({PARITY!r}, radii 5 and 6, 1 image of "
          f"{cfg.data.eval_size}): {seconds:.2f} s (seeded weights trained "
          "4 steps, reference points seeded: not a contract)")
    print(cc.format_table(rows, cfg.model.bf16_scope))
    line = cc.recommendation(rows, PARITY, cfg.model.bf16_scope, 1e-3)
    print(line, flush=True)
    for r in rows:
        masses = list(r["clamp_mass"].values())
        if not (np.isfinite(r["delta_f32"]) and np.isfinite(r["delta_scope"])
                and all(0.0 <= m <= 1.0 for m in masses)):
            fail(f"compat_check row {r}")
    if not line.startswith("RECOMMENDATION:"):
        fail("no recommendation")




KITTI_TREE_SIZE = (375, 1242)     # 2011_09_26; the second date 370x1224
DDAD_TREE_SIZE = (1216, 1936)
DDAD_LEVELS = ((96, 160), (48, 80), (24, 40), (12, 20))
DDAD_STEM = ((192, 320),)
DDAD_SELF, DDAD_CROSS, DDAD_EXACT_SELF = 5040, 61440, 20400


def tree_data(preset, tree):
    """The preset's DataConfig pointed at a tree of `phase_trees`."""
    import dataclasses

    from gedepth_tpu_torch.configs import get_config

    return dataclasses.replace(get_config(preset).data,
                               data_root=tree["root"],
                               train_split=tree["train"],
                               test_split=tree["test"])


def median_ms(fn, n):
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_trees(work, before_timing=lambda: None):
    """Phase 23: a KITTI tree (two dates, 375x1242 and 370x1224, a `None`
    pair) and a DDAD tree (CAMERA_01 and CAMERA_05 at 1216x1936, a line of
    a filtered camera) written from seeded data by `tools.make_tree` with
    `utils.png.write_png`, finished by the port's two preprocessing tools;
    the host ms a sample of the PNG decode and of each whole train chain,
    after `before_timing()` (which waits for phase 2's build). Returns
    {'kitti': tree, 'ddad': tree, 'host_ms': {...}, 'work': work}."""
    import os.path as osp

    from gedepth_tpu_torch.data import build_train_pipeline
    from gedepth_tpu_torch.tools import (
        preprocess_data_ddad, preprocess_data_kitti)
    from gedepth_tpu_torch.tools.make_tree import (
        make_ddad_tree, make_kitti_tree)
    from gedepth_tpu_torch.train.loop import (
        build_eval_dataset, build_train_dataset)
    from gedepth_tpu_torch.utils.png import load_depth_png, read_rgb

    t0 = time.perf_counter()
    kroot, droot = osp.join(work, "kitti"), osp.join(work, "ddad")
    kitti = dict(make_kitti_tree(kroot, KITTI_TREE_SIZE, frames=5,
                                 seed=SEED), root=kroot)
    ddad = dict(make_ddad_tree(droot, DDAD_TREE_SIZE, frames=4, seed=SEED),
                root=droot)
    made = time.perf_counter() - t0
    preprocess_data_kitti.main(["--data-root", kroot, "--split",
                                kitti["train"], "--workers", "1"])
    preprocess_data_ddad.main(["--data-root", droot, "--calib-npz",
                               ddad["calib"], "--split", ddad["train"],
                               "--workers", "1"])
    print(f"[trees] KITTI and DDAD trees written in {made:.1f} s, "
          f"preprocessed in {time.perf_counter() - t0 - made:.1f} s",
          flush=True)
    before_timing()        # nothing else takes the host's cores now
    host = {}
    for name, preset, tree in (("kitti", PRESET, kitti),
                               ("ddad", DDAD, ddad)):
        from gedepth_tpu_torch.configs import get_config

        cfg = get_config(preset, data=tree_data(preset, tree))
        train, test = build_train_dataset(cfg), build_eval_dataset(cfg)
        chain = build_train_pipeline(cfg.data, cfg.model.depth_scale)
        info = (f"{len(train)} train, {len(test)} test frames"
                + (f", {test.invalid_depth_num} None pair(s) filtered"
                   if name == "kitti" else ""))
        sample = chain(train[0], np.random.default_rng(0))
        if sample["img"].shape != (*cfg.data.crop_size, 5) or not all(
                np.isfinite(sample[k]).all() for k in ("img", "depth_gt")):
            fail(f"{name} train chain: {sample['img'].shape}, non-finite")
        frame = osp.join(getattr(train, "img_dir", tree["root"]),
                         train.infos[0]["filename"])
        host[f"{name}_decode_rgb"] = median_ms(lambda i: read_rgb(frame), 5)
        if name == "kitti":
            host["kitti_decode_gt"] = median_ms(
                lambda i: load_depth_png(train.gt_path(0), 256.0), 5)
        host[f"{name}_load"] = median_ms(lambda i: train[i % len(train)], 6)
        host[f"{name}_load_and_chain"] = median_ms(
            lambda i: chain(train[i % len(train)],
                            np.random.default_rng(i)), 8)
        print(f"[trees] {name}: {info}; train sample {sample['img'].shape}",
              flush=True)
    print("[trees] host ms a sample (median, torch "
          f"{torch.get_num_threads()} threads): "
          + " ".join(f"{k}={v:.1f}" for k, v in host.items()), flush=True)
    return {"kitti": kitti, "ddad": ddad, "host_ms": host, "work": work}


def phase_kernels_ddad():
    """Phase 24: kernels A, B, C and E at DDAD's 384x640 shapes against
    their plain versions, timed as phase 3 (plain versions of B and C once),
    A beside one `F.scaled_dot_product_attention` call."""
    import torch.nn.functional as F

    from gedepth_tpu_torch.models.swin import shifted_window_mask
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    results = {}
    # A: stage 1 of 96x160, padded to 98x161: 14x23 = 322 windows, the
    # shift mask's period; batch 1 (serving) and 2 (training)
    print("[kernels ddad] A window attention at stage 1 (rtol 2e-4, atol "
          "2e-5)")
    mask = torch.as_tensor(shifted_window_mask(98, 161, 7, 3), device="cuda")
    for label, nWB in (("stage1_shifted", 322), ("train_stage1_shifted",
                                                 644)):
        qkv = randn(nWB, 49, 3, 6, 32)
        q, k, v = qkv[:, :, 0] * 32 ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        bias = randn(6, 49, 49)
        want = wa.window_attention_plain(q, k, v, bias, mask)
        err = compare(f"A ddad {label} ({nWB},49,6,32) mask "
                      f"{tuple(mask.shape)}",
                      wa.window_attention(q, k, v, bias, mask), want, 2e-4,
                      2e-5)
        attn_mask = bias[None] + mask.repeat(nWB // 322, 1, 1)[:, None]
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask, scale=1.0).transpose(1, 2)

        compare(f"A ddad {label} library call", library(), want, 2e-4, 2e-5)
        t = timed(lambda: wa.window_attention(q, k, v, bias, mask),
                  lambda: wa.window_attention_plain(q, k, v, bias, mask),
                  plain_reps=3, library=library)
        t["bound_ms"], t["bound_by"] = bound(
            n_bytes(q, k, v, bias, want, mask), nWB * 6 * 49 * 49 * (4 * 32
                                                                      + 5))
        show(t)
        results[f"window_attention {label}"] = dict(t, max_abs_err=err)
        del qkv, q, k, v, want, attn_mask
    # B: HAHI over DDAD's levels (20,400 tokens): windowed self-attention
    # from level 1 (5,040 queries) and cross-attention from the 192x320
    # stem (61,440), batch 1 and 2; the exact rule's self-attention over
    # all levels and its cross-attention, batch 1
    print("[kernels ddad] B deformable sampling (rtol 2e-4, atol 2e-5)")
    for label, B, rule, grids in (
            ("windowed serving_self", 1, "windowed", DDAD_LEVELS[1:]),
            ("windowed serving_cross", 1, "windowed", DDAD_STEM),
            ("windowed train_self", 2, "windowed", DDAD_LEVELS[1:]),
            ("windowed train_cross", 2, "windowed", DDAD_STEM),
            ("exact serving_self", 1, "exact", DDAD_LEVELS),
            ("exact serving_cross", 1, "exact", DDAD_STEM)):
        value = randn(B, sum(a * b for a, b in DDAD_LEVELS), 8, 64)
        if rule == "windowed":
            pos, w = msda_inputs(randn, B, DDAD_LEVELS, grids)
            hint = (grids, RADIUS)
            n_touch = w.numel()
        else:
            pos, w, hint = rule_positions("exact", randn, g, B, DDAD_LEVELS,
                                          grids, grids == DDAD_STEM)
            n_touch = touching(pos, DDAD_LEVELS)
        Nq = pos.shape[1]
        want = msda_ops.msda_plain(value, DDAD_LEVELS, pos, w)
        err = compare(f"B ddad {label} {B}x{Nq} queries",
                      msda_ops.msda(value, DDAD_LEVELS, pos, w, *hint), want,
                      2e-4, 2e-5)
        t = timed(lambda: msda_ops.msda(value, DDAD_LEVELS, pos, w, *hint),
                  lambda: msda_ops.msda_plain(value, DDAD_LEVELS, pos, w),
                  plain_reps=1, trace_plain=False)
        t["bound_ms"], t["bound_by"] = bound(n_bytes(value, pos, w, want),
                                             9 * n_touch * 64)
        show(t)
        results[f"msda {label}"] = dict(t, max_abs_err=err, queries=Nq)
        if label.startswith("windowed train"):
            # C at the train shapes, on the same inputs
            gout = randn(B, Nq, 512)
            args = (value, DDAD_LEVELS, pos, w, gout)
            got = msda_ops.msda_backward(*args, *hint)
            want_c = msda_ops.msda_backward_plain(*args)
            dv_atol = 1e-5 * want_c[0].abs().max().item()
            err = max(compare(f"C ddad {label} d_value", got[0], want_c[0],
                              2e-4, dv_atol),
                      compare(f"C ddad {label} d_pos", got[1], want_c[1],
                              2e-4, 2e-5),
                      compare(f"C ddad {label} d_weights", got[2], want_c[2],
                              2e-4, 2e-5))
            n_out = n_bytes(*want_c)
            del got, want_c
            t = timed(lambda: msda_ops.msda_backward(*args, *hint),
                      lambda: msda_ops.msda_backward_plain(*args),
                      plain_reps=1, trace_plain=False)
            t["bound_ms"], t["bound_by"] = bound(
                n_bytes(value, pos, w, gout) + n_out, 17 * w.numel() * 64)
            show(t)
            results[f"msda_backward {label}"] = dict(t, max_abs_err=err,
                                                     queries=Nq)
            del gout, args
        del value, pos, w, want
        torch.cuda.empty_cache()
    # E: four samples of 384x640 at DDAD's four camera heights, depth_scale
    # 250 (the validity window (0, 250])
    print("[kernels ddad] E PE fusion, heights 1.53-1.57 m, depth_scale 250 "
          "(rtol 1e-4, atol 1e-4)")
    logits = randn(4, 384, 640, 11)
    pe = torch.rand(4, 384, 640, generator=g, device="cuda") * 240 + 2
    y = torch.rand(4, 384, 640, generator=g, device="cuda")
    cam = torch.tensor([1.56, 1.57, 1.53, 1.55], device="cuda")
    want = pe_ops.pe_fusion_plain(logits, pe, y, cam, 250.0)
    err = compare("E ddad (4,384,640,11)",
                  pe_ops.pe_fusion(logits, pe, y, cam, 250.0), want, 1e-4,
                  1e-4)
    per_sample = pe_ops.pe_fusion_plain(logits[:1], pe[:1], y[:1], cam[:1],
                                        250.0)
    if not torch.equal(want[:1], per_sample):
        fail("E's plain version is not per sample")
    t = timed(lambda: pe_ops.pe_fusion(logits, pe, y, cam, 250.0),
              lambda: pe_ops.pe_fusion_plain(logits, pe, y, cam, 250.0),
              plain_reps=3)
    t["bound_ms"], t["bound_by"] = bound(n_bytes(logits, pe, y, cam, want),
                                         100 * pe.numel())
    show(t)
    results["pe_fusion heights"] = dict(t, max_abs_err=err)
    return results


def phase_ddad_serving(tree):
    """Phase 25: `init_depther(pe_path=...)` and `inference_depther` on
    PNG paths of the DDAD tree (CAMERA_01, 1.56 m): 3 requests of the
    windowed preset, one each of the exact and the vanilla presets; depth
    (384, 640), finite, in range; per forward exactly 24 A, B once at the
    self-attention's queries and once at the cross-attention's, 1 E for the
    adaptive presets and 0 for vanilla. Returns the launches by preset."""
    import os.path as osp

    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.utils.png import read_rgb

    cam = "CAMERA_01"
    pe_path = osp.join(tree["root"], "pe_public_debug", cam, "ddad_pe.npz")
    images = [osp.join(tree["root"], "rgb", cam, f"{i:06d}.png")
              for i in range(3)]
    counters = _kernel_counters()
    counted = {}
    for preset, n, self_q in ((DDAD, 3, DDAD_SELF),
                              ("gedepth_adaptive_ddad", 1, DDAD_EXACT_SELF),
                              ("gedepth_vanilla_ddad", 1, DDAD_EXACT_SELF)):
        handle = init_depther(preset, device="cuda", pe_path=pe_path,
                              seed=SEED)
        cfg = handle.cfg.model
        inference_depther(handle, images[0], cam_height=1.56)   # warm-up
        reset_counts(counters)
        latencies, depths = [], []
        for path in images[:n]:
            t = time.perf_counter()
            depths.append(inference_depther(handle, path, cam_height=1.56))
            latencies.append((time.perf_counter() - t) * 1e3)
        launches, by_queries = read_counts(counters)
        for i, d in enumerate(depths):
            if d.shape != (384, 640) or not np.isfinite(d).all():
                fail(f"{preset} request {i}: depth {d.shape} not finite")
            if d.min() < cfg.min_depth - 1e-6 \
                    or d.max() > cfg.max_depth + 1e-4:
                fail(f"{preset} request {i}: depth outside "
                     f"[{cfg.min_depth}, {cfg.max_depth}]")
        want = {"window_attention": 24 * n, "msda": 2 * n,
                "msda_backward": 0,
                "pe_fusion": n if cfg.pe_variant == "adaptive" else 0}
        want_by = {"msda": {self_q: n, DDAD_CROSS: n}, "msda_backward": {}}
        print(f"[ddad serve] {preset}: request latency ms (PNG decode, "
              f"resize, forward, no flip) "
              f"{[round(x, 3) for x in latencies]}; depth in "
              f"[{min(d.min() for d in depths):.4f}, "
              f"{max(d.max() for d in depths):.4f}] m; launches {launches}, "
              f"by queries {by_queries}", flush=True)
        if launches != want or by_queries != want_by:
            fail(f"{preset}: launches {launches}, {by_queries}; expected "
                 f"{want}, {want_by}")
        counted[preset] = (launches, by_queries)
        if preset == DDAD:
            phase_whole_forward(handle, [(read_rgb(images[0]),
                                          handle.pe_raw)], tag="[ddad serve]",
                                cam_height=1.56)
        del handle
        torch.cuda.empty_cache()
    return counted



def ddad_rows(row, results, serving, launches, by_queries):
    """The `kernels` rows of phase 24's DDAD shapes, each with the launches
    that phase 25's windowed or exact preset (serving shapes) or phase 26's
    steps and evaluation (train shapes; E both) made at its query count."""
    served = {"windowed": serving[DDAD],
              "exact": serving["gedepth_adaptive_ddad"]}
    rows = []
    for name, t in results.items():
        kernel, label = name.split(" ", 1)
        if kernel == "pe_fusion":
            n_train = launches[kernel]
            n_serving = served["windowed"][0][kernel]
        elif kernel == "window_attention":
            n_train, n_serving = (launches[kernel], 0) if "train" in label \
                else (0, served["windowed"][0][kernel])
        elif "train" in label:
            n_train, n_serving = by_queries[kernel].get(t["queries"], 0), 0
        else:
            n_train = 0
            n_serving = served[label.split()[0]][1][kernel].get(t["queries"],
                                                                0)
        rows.append(row(f"{kernel}[ddad {label}]", kernel, t, n_train,
                        n_serving))
    return rows


# ---- phase 37: the kernels at BinsFormer's shapes ----

BINSFORMER = "binsformer_nyu"
# BinsFormer's deformable encoder over the skip projections of Swin-T's
# /8, /16 and /32 levels: the 480x640 NYU frame and the 416x544 train crop
BINS_SERVE_LEVELS = ((60, 80), (30, 40), (15, 20))      # 6,300 queries
BINS_TRAIN_LEVELS = ((52, 68), (26, 34), (13, 17))      # 4,641 a sample
BINS_SERVE_Q, BINS_TRAIN_Q = 6300, 4641
# Swin-T's stage 1 (3 heads of 32): 120x160 padded to 126x161 (414
# windows) when served, 104x136 padded to 105x140 (300) a train sample
BINS_WINDOWS = (("serving_stage1_shifted", 414, (126, 161)),
                ("train_stage1_shifted", 600, (105, 140)))
# launches: Swin-T's 12 blocks and 6 encoder layers a forward; a flip-TTA
# request runs two forwards, a train step one and remat's recompute of the
# blocks
BINS_PER_REQUEST = {"window_attention": 24, "msda": 12, "msda_backward": 0,
                    "pe_fusion": 0}
BINS_PER_STEP = {"window_attention": 24, "msda": 6, "msda_backward": 6,
                 "pe_fusion": 0}


def phase_kernels_binsformer():
    """Phase 37: kernels A (f32 and bf16), B and C at BinsFormer's shapes
    against their plain versions, timed as phase 3 (the plain versions in
    the trace too): A at Swin-T's stage 1, served and at the train crop
    (3 heads of 32), beside one `F.scaled_dot_product_attention` call; B
    under the exact rule at the encoder's 6,300 serving queries and 2 x
    4,641 train queries (3 levels, 8 heads of 8 channels, 8 points; the
    self-attention's grid-centre reference points, a twentieth of the
    samples thrown far); C at the train shape."""
    import torch.nn.functional as F

    from gedepth_tpu_torch.models.swin import shifted_window_mask
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    results = {}
    print("[kernels binsformer] A window attention at Swin-T's stage 1 "
          "(f32: rtol 2e-4, atol 2e-5; bf16: against float64, limit max(2 x "
          "plain's error, 1 bf16 ulp))")
    for label, nWB, grid in BINS_WINDOWS:
        qkv = randn(nWB, 49, 3, 3, 32)
        q, k, v = qkv[:, :, 0] * 32 ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        bias = randn(3, 49, 49)
        mask = torch.as_tensor(shifted_window_mask(*grid, 7, 3),
                               device="cuda")
        want = wa.window_attention_plain(q, k, v, bias, mask)
        err = compare(f"A binsformer {label} ({nWB},49,3,32) mask "
                      f"{tuple(mask.shape)}",
                      wa.window_attention(q, k, v, bias, mask), want, 2e-4,
                      2e-5)
        attn_mask = bias[None] + mask.repeat(nWB // mask.shape[0], 1,
                                             1)[:, None]
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask, scale=1.0).transpose(1, 2)

        compare(f"A binsformer {label} library call", library(), want, 2e-4,
                2e-5)
        t = timed(lambda: wa.window_attention(q, k, v, bias, mask),
                  lambda: wa.window_attention_plain(q, k, v, bias, mask),
                  plain_reps=3, library=library)
        t["bound_ms"], t["bound_by"] = bound(
            n_bytes(q, k, v, bias, mask, want),
            nWB * 3 * 49 * 49 * (4 * 32 + 5))
        show(t)
        results[f"window_attention {label}"] = dict(t, max_abs_err=err)

        qkv_b, bias_b = qkv.to(bf), bias.to(bf)
        qb, kb, vb = (qkv_b[:, :, 0] * 32 ** -0.5, qkv_b[:, :, 1],
                      qkv_b[:, :, 2])
        ref = wa.window_attention_plain(qb.double(), kb.double(),
                                        vb.double(), bias_b.double(),
                                        mask.double())
        got = wa.window_attention(qb, kb, vb, bias_b, mask)
        err = compare64(f"A bf16 binsformer {label}", got,
                        wa.window_attention_plain(qb, kb, vb, bias_b, mask),
                        ref)
        attn_b = (bias_b.float()[None] + mask.repeat(
            nWB // mask.shape[0], 1, 1)[:, None]).to(bf)
        qbh, kbh, vbh = (t.transpose(1, 2) for t in (qb, kb, vb))

        def library_b():
            return F.scaled_dot_product_attention(
                qbh, kbh, vbh, attn_mask=attn_b, scale=1.0).transpose(1, 2)

        t = timed(lambda: wa.window_attention(qb, kb, vb, bias_b, mask),
                  lambda: wa.window_attention_plain(qb, kb, vb, bias_b, mask),
                  plain_reps=3, library=library_b,
                  extra={"f32": lambda: wa.window_attention(q, k, v, bias,
                                                            mask)})
        t["bound_ms"], t["bound_by"] = bound(
            n_bytes(qb, kb, vb, bias_b, mask, got),
            nWB * 3 * 49 * 49 * 4 * 32, BF16_FLOP_PER_S)
        show(t)
        results[f"window_attention_bf16 {label}"] = dict(t, max_abs_err=err)
        del qkv, q, k, v, want, attn_mask, qkv_b, qb, kb, vb, ref, got, attn_b

    print("[kernels binsformer] B and C under the exact rule, 3 levels, 8 "
          "heads of 8 channels (B: rtol 2e-4, atol 2e-5; C as phase 6)")
    for label, B, levels in (("exact serving_self", 1, BINS_SERVE_LEVELS),
                             ("exact train_self", 2, BINS_TRAIN_LEVELS)):
        value = randn(B, sum(a * b for a, b in levels), 8, 8)
        pos, w, _ = rule_positions("exact", randn, g, B, levels, levels,
                                   False)
        Nq, n_touch = pos.shape[1], touching(pos, levels)
        want = msda_ops.msda_plain(value, levels, pos, w)
        err = compare(f"B binsformer {label} {B}x{Nq} queries",
                      msda_ops.msda(value, levels, pos, w), want, 2e-4, 2e-5)
        t = timed(lambda: msda_ops.msda(value, levels, pos, w),
                  lambda: msda_ops.msda_plain(value, levels, pos, w),
                  plain_reps=1)
        t["bound_ms"], t["bound_by"] = bound(n_bytes(value, pos, w, want),
                                             9 * n_touch * 8)
        show(t, touching=f"{n_touch / w.numel():.3f}")
        results[f"msda {label}"] = dict(t, max_abs_err=err, queries=Nq)
        del want
        if B == 2:
            gout = randn(B, Nq, 64)
            args = (value, levels, pos, w, gout)
            got = msda_ops.msda_backward(*args)
            want = msda_ops.msda_backward_plain(*args)
            dv_atol = 1e-5 * want[0].abs().max().item()
            err = max(compare(f"C binsformer {label} d_value", got[0],
                              want[0], 2e-4, dv_atol),
                      compare(f"C binsformer {label} d_pos", got[1], want[1],
                              2e-4, 2e-5),
                      compare(f"C binsformer {label} d_weights", got[2],
                              want[2], 2e-4, 2e-5))
            n_out = n_bytes(*want)
            del got, want
            t = timed(lambda: msda_ops.msda_backward(*args),
                      lambda: msda_ops.msda_backward_plain(*args),
                      plain_reps=1)
            t["bound_ms"], t["bound_by"] = bound(
                n_bytes(value, pos, w, gout) + n_out, 17 * n_touch * 8)
            show(t)
            results[f"msda_backward {label}"] = dict(t, max_abs_err=err,
                                                     queries=Nq)
            del gout, args
        del value, pos, w
        torch.cuda.empty_cache()
    return results


def binsformer_rows(row, results, counted):
    """The `kernels` rows of phase 37's shapes, each with the launches that
    phase 36's `binsformer_nyu` run made there: A f32 and B from its f32
    flip-TTA requests (serving shapes) and its f32 train step (train
    shapes); A bf16 from its bf16 request and its bf16_compute step; C
    from the f32 step."""
    rows = []
    for name, t in results.items():
        kernel, label = name.split(" ", 1)
        train = "train" in label
        if kernel == "window_attention_bf16":
            n = counted["bf16_step" if train else "bf16_request"].get(
                "window_attention", 0)
        elif kernel == "window_attention":
            n = counted["step" if train else "requests"][0][kernel]
        else:
            n = counted["step" if train else "requests"][1][kernel].get(
                t["queries"], 0)
        r = row(f"{kernel}[binsformer {label}]", kernel, t,
                n if train else 0, 0 if train else n)
        if kernel == "window_attention_bf16":
            r["against"] = "float64"
            r["f32_device_ms"], r["f32_event_ms"] = t["extra_ms"]["f32"]
        rows.append(r)
    return rows


def phase_tools_test(tree):
    """`tools.test` of the main preset pointed at the KITTI tree by
    --options: 2 images, KB crop, flip-TTA, nine finite metrics."""
    import contextlib as cl
    import io

    from gedepth_tpu_torch.tools import test as test_cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with cl.redirect_stdout(out):
        test_cli.main([PRESET, "--max-images", "2", "--options",
                       f"data.data_root={tree['root']}",
                       f"data.test_split={tree['test']}"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    if line["images"] != 2 or not all(
            np.isfinite(line[k]) for k in ("abs_rel", "rmse", "a1")):
        fail(f"tools.test on the KITTI tree: {line}")
    print(f"[tools.test] {PRESET} --options data.data_root=<KITTI tree>: "
          f"{time.perf_counter() - t0:.1f} s; {json.dumps(line)}",
          flush=True)


# ---- phases 27-30: loader workers, two ranks, NCCL, stage-1 pretraining ----

LOADER_WORKERS = (0, 2, 4)
LOADER_KEEP = 3           # batches held bit for bit across worker counts


def first_batches(loader, n):
    """The first n batches of `loader`, its workers stopped after."""
    with contextlib.closing(iter(loader)) as batches:
        return [next(batches) for _ in range(n)]


def phase_loader_workers(trees, step_ms):
    """Phase 27: `TrainLoader` over the KITTI and DDAD trees of phase 23 at
    0, 2 and 4 workers, global batch 2, the presets' chains: the first
    LOADER_KEEP batches bit-identical for every worker count; with workers,
    samples a second over `bench_loader.window_batches` (four times the
    batches in flight, at least 16), timed after those in flight when the
    first came (`bench_loader.warm_batches`), against what this run's f32
    batch-2 step (phases 7, 26) takes. One thread is not timed again: phase
    23's host ms a sample of the whole chain is its rate. Returns
    {(dataset, workers): samples a second}."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data import TrainLoader, build_train_pipeline
    from gedepth_tpu_torch.tools.bench_loader import loader_rate
    from gedepth_tpu_torch.train.loop import build_train_dataset

    rates = {}
    for name, preset in (("kitti", PRESET), ("ddad", DDAD)):
        cfg = get_config(preset, data=tree_data(preset, trees[name]))
        dataset = build_train_dataset(cfg)
        chain = build_train_pipeline(cfg.data, cfg.model.depth_scale)
        need = 2 / (step_ms[name] / 1e3)
        first = None
        for w in LOADER_WORKERS:
            loader = TrainLoader(dataset, chain, 2, seed=SEED, num_workers=w,
                                 sampling=cfg.train.sampling)
            if w == 0:
                kept = first_batches(loader, LOADER_KEEP)
            else:
                rate, kept = loader_rate(loader, keep=LOADER_KEEP)
            kept = [{k: np.asarray(v) for k, v in b.items()} for b in kept]
            if first is None:
                first = kept
            elif any(a.keys() != b.keys() or any(
                    a[k].dtype != b[k].dtype
                    or a[k].tobytes() != b[k].tobytes() for k in a)
                    for a, b in zip(first, kept)):
                fail(f"[loader] {name}: {w} workers gave other batches than "
                     "one thread")
            if w == 0:
                continue
            sps = rate["samples_per_s"]
            rates[(name, w)] = sps
            print(f"[loader] {name} {w} workers: {sps:.2f} samples/s "
                  f"(first batch after {rate['first_batch_s']:.2f} s; "
                  f"{rate['window_batches']} batches of 2 timed after "
                  f"{rate['warm_batches']}) against "
                  f"{need:.2f} samples/s for the {step_ms[name]:.1f} ms f32 "
                  "batch-2 step: "
                  + ("the loader keeps up" if sps >= need
                     else "the loader bounds training"), flush=True)
        print(f"[loader] {name}: the first {LOADER_KEEP} batches "
              f"bit-identical at {LOADER_WORKERS} workers", flush=True)
    return rates


RANK_MEMORY_FRACTION = 0.3    # of the card, each of the two ranks


@contextlib.contextmanager
def cudnn_off():
    """ATen's own convolutions (im2col and GEMM) in place of cuDNN's: no
    workspace, and the same algorithms at any batch."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def activation_signs(model):
    """Forward hooks that keep, in forward order, where every ReLU and
    LeakyReLU of `model` sees a positive input (the ConvModules with an
    activation, the stem's ReLU, the depth conv's ReLU). Returns (names,
    signs, owners): the next forward fills `names` with each site's module
    name and `signs` with its bool tensor; owners[name] are the prefixes of
    the parameters that make that site's input (the conv and BatchNorm in
    front of the activation), whose gradients a flipped sign there moves
    by a step."""
    from gedepth_tpu_torch.models.layers import ConvModule

    names, signs = [], []
    module_names = {m: n for n, m in model.named_modules()}

    def keep(module, args, out):
        names.append(module_names[module])
        signs.append(out.detach() > 0)

    owners = {n: (n + ".",) for n, m in model.named_modules()
              if isinstance(m, ConvModule) and m.act is not None}
    owners["backbone.bn1"] = ("backbone.bn1.", "backbone.conv1.")
    owners["decode_head.conv_depth"] = ("decode_head.conv_depth.",)
    for n, m in model.named_modules():
        if n in owners:
            m.register_forward_hook(keep)
    return names, signs, owners


def stochastic_draws(model):
    """Forward pre-hooks that keep, in call order, the input shape of every
    DropPath and Dropout of `model` that draws in training (rate > 0):
    (kind, shape) pairs that the next forward fills."""
    from gedepth_tpu_torch.models.layers import Stochastic

    draws = []

    def keep(module, args):
        draws.append((type(module).__name__, tuple(args[0].shape)))

    for m in model.modules():
        if isinstance(m, Stochastic) and m.rate > 0:
            m.register_forward_pre_hook(keep)
    return draws


def global_batch_step(tree):
    """One f32 `make_train_step` of PRESET at full width, 352x704, on this
    process's rows of global batch 0 of the KITTI tree (both rows without a
    process group), from the seeded initialisation; the gradients, losses,
    BatchNorm statistics, launches, activation signs (`activation_signs`,
    bit-packed per sample) and random draws (`stochastic_draws`) on the
    host."""
    import dataclasses

    from gedepth_tpu_torch import parallel
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data import TrainLoader, build_train_pipeline
    from gedepth_tpu_torch.train.loop import build_train_dataset
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state, make_train_step)

    cfg = get_config(PRESET, data=tree_data(PRESET, tree))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, global_batch=2))
    model = cfg.model.build(device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(model, cfg.optim, cfg.train.max_iters,
                               seed=SEED + 1)
    batch = TrainLoader(build_train_dataset(cfg),
                        build_train_pipeline(cfg.data, cfg.model.depth_scale),
                        2, seed=SEED, shard_index=parallel.rank(),
                        shard_count=parallel.world()).make_batch(0)
    sites, signs, owners = activation_signs(model)
    draws = stochastic_draws(model)
    counters = _kernel_counters()
    reset_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = make_train_step()(state, batch_to_device(batch, "cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, _ = read_counts(counters)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "signs": [[np.packbits(t[i].cpu().numpy()) for i in range(len(t))]
                      for t in signs],
            "sites": sites, "owners": owners, "draws": draws,
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "launches": launches, "index": batch["index"].tolist(),
            "seconds": seconds, "world": parallel.world(),
            "backend": parallel.backend(),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def rank_step_worker(spec_path):
    """One rank of phase 28 (`chip_smoke.py --rank-step SPEC`): joins the
    gloo group of the environment on the card, capped at
    RANK_MEMORY_FRACTION of it, and saves `global_batch_step`."""
    from gedepth_tpu_torch import parallel
    from gedepth_tpu_torch.utils.env import disable_tf32

    with open(spec_path) as f:
        spec = json.load(f)
    disable_tf32()
    torch.cuda.set_per_process_memory_fraction(RANK_MEMORY_FRACTION)
    parallel.init_from_env("cuda", backend="gloo")
    try:
        with cudnn_off():
            result = global_batch_step(spec["tree"])
        torch.save(result, spec["out"].format(rank=parallel.rank()))
    finally:
        parallel.shutdown()
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def hold_two_ranks(ref, ranks):
    """Phase 28's comparison of each rank's `global_batch_step` with one
    process's (see `phase_two_ranks`); fails on the first miss. Returns
    (worst relative errors, {site: flipped signs by rank}, gradients past
    1e-3 of their maximum beside a flip at their site, tensors zero but for
    rounding)."""
    worst, flips, kinks = {}, {}, []
    for r, got in enumerate(ranks):
        if got["world"] != 2 or got["backend"] != "gloo" \
                or got["index"] != ref["index"][r:r + 1]:
            fail(f"[two ranks] rank {r}: world {got['world']}, backend "
                 f"{got['backend']}, rows {got['index']} of {ref['index']}")
        if got["sites"] != ref["sites"]:
            fail(f"[two ranks] rank {r} ran other activation sites")
        want = {"window_attention": A_STEP, "msda": 2, "msda_backward": 2,
                "pe_fusion": 1}
        if got["launches"] != want or ref["launches"] != want:
            fail(f"[two ranks] launches: rank {r} {got['launches']}, one "
                 f"process {ref['launches']}; a step launches {want}")
        for key in ("loss", "loss_depth", "loss_slope", "grad_norm"):
            rel = abs(got["metrics"][key] - ref["metrics"][key]) / abs(
                ref["metrics"][key])
            worst[key] = max(worst.get(key, 0.0), rel)
            if not rel <= 1e-4:
                fail(f"[two ranks] rank {r} {key} {got['metrics'][key]} "
                     f"against {ref['metrics'][key]} (rel {rel:.2e})")
        for site, a, b in zip(ref["sites"], (s[0] for s in got["signs"]),
                              ref["signs"]):
            n = int(np.unpackbits(a ^ b[r]).sum())
            if n:
                flips.setdefault(site, [0] * len(ranks))[r] += n
    # the ranks average their gradients: a flip in either moves both
    moved = tuple(p for site in flips for p in ref["owners"][site])
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    zero = 0
    for r, got in enumerate(ranks):
        for name, g in got["grads"].items():
            want = ref["grads"][name]
            scale = float(want.abs().max())
            if scale < 1e-6 * top:
                zero += 1
                if not float(g.abs().max()) < 1e-6 * top:
                    fail(f"[two ranks] {name}: {float(g.abs().max())} where "
                         f"one process has ~0 ({scale})")
                continue
            ratio = float((g - want).abs().max()) / scale
            worst["grad"] = max(worst.get("grad", 0.0), ratio)
            if ratio <= 1e-3:
                continue
            l2 = float((g - want).norm() / want.norm())
            if not (name.startswith(moved) and l2 <= 1e-3):
                fail(f"[two ranks] rank {r} gradient {name}: max |diff| "
                     f"{ratio:.2e} of its max |g| {scale:.3e}, "
                     f"||diff|| / ||g|| {l2:.2e}; activation signs that "
                     f"differ, by site and rank: {flips}")
            kinks.append((r, name, ratio, l2))
        for name, v in got["stats"].items():
            want = ref["stats"][name]
            err = float(((v - want).abs() / (want.abs() + 1e-2)).max())
            worst["stats"] = max(worst.get("stats", 0.0), err)
            if not torch.allclose(v, want, rtol=1e-4, atol=1e-6):
                fail(f"[two ranks] rank {r} {name} differs from one process")
    zero //= len(ranks)
    return worst, flips, kinks, zero


def phase_two_ranks(tree):
    """Phase 28: two processes in one gloo group on the one card (gloo
    takes CUDA tensors; NCCL refuses two ranks on one card), each at batch
    1 of PRESET at full width, f32, one step; one process at batch 2 on the
    same weights and batch beside them. Both sides run ATen's convolutions
    (cuDNN off: its autotuner peaks at ~77 GB a process and its heuristic
    picks FFT workspaces of ~65 GiB at batch 2) and each rank is capped at
    RANK_MEMORY_FRACTION of the card. Held: loss, its parts and grad_norm
    rtol 1e-4; every gradient within 1e-3 of its largest magnitude (those
    that are zero but for rounding, below 1e-6 of the model's largest
    gradient, held below that on both sides); the BatchNorm running
    statistics rtol 1e-4, atol 1e-6; the two ranks' gradients equal; A, B,
    C and E launched in every process.

    An f32 rounding that moves a ReLU or LeakyReLU input across 0 changes
    that element's derivative by a step, not by a rounding: one of 371,712
    LeakyReLU inputs at the decode head's coarsest block (11x22 pixels),
    flipped by a 2e-6 difference in the neck's output, moved that block's
    weight gradient by 4.8e-3 of its largest element in a CPU rehearsal at
    smoke widths. So the activations' signs are compared too
    (`hold_two_ranks`): a gradient past the 1e-3 bound passes only when it
    belongs to a module in front of an activation whose sign differs
    between the two runs (that site's conv and BatchNorm,
    `activation_signs`'s owners) and it still holds the whole-step bound of phase 8, ||g - g_ref|| <= 1e-3
    ||g_ref||; every other gradient is held to 1e-3 of its maximum. The
    flips by site and such tensors are printed. Last, what the global
    batch costs the ranks' random draws (`dropout_draw_cost`)."""
    import os
    import os.path as osp

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        spec = osp.join(work, "spec.json")
        with open(spec, "w") as f:
            json.dump({"tree": tree, "out": osp.join(work, "rank{rank}.pt")},
                      f)
        env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, osp.abspath(__file__), "--rank-step", spec],
            env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            with cudnn_off():
                ref = global_batch_step(tree)
            torch.cuda.empty_cache()
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            _close(procs)
        wall = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"[two ranks] rank {r} exited {p.returncode}:\n"
                     f"{log[-3000:]}")
        ranks = [torch.load(osp.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    worst, flips, kinks, zero = hold_two_ranks(ref, ranks)
    a, b = (rk["grads"] for rk in ranks)
    if not all(torch.equal(a[n], b[n]) for n in a):
        fail("[two ranks] the ranks' averaged gradients differ")
    print(f"[two ranks] {PRESET} 352x704 f32, TF32 and cuDNN off: 2 gloo "
          f"ranks at batch 1 against 1 process at batch 2: loss "
          f"{ref['metrics']['loss']:.6f}, worst relative errors "
          + " ".join(f"{k}={v:.3e}" for k, v in worst.items())
          + f" (gradients: max |diff| / max |g| per tensor; {zero} tensors "
          f"zero but for rounding); activation signs that differ from one "
          f"process's, by site and rank: {flips}; past 1e-3 of their max "
          f"at a flipped site (rank, tensor, max ratio, L2 ratio): {kinks}; "
          f"launches a rank {ranks[0]['launches']}, "
          f"one process {ref['launches']}; first-step seconds: ranks "
          f"{ranks[0]['seconds']:.2f}, {ranks[1]['seconds']:.2f} (sharing "
          f"the card), one process {ref['seconds']:.2f}; peak MiB: ranks "
          f"{ranks[0]['peak_mib']:.0f}, {ranks[1]['peak_mib']:.0f} (cap "
          f"{RANK_MEMORY_FRACTION:.0%} of the card), one process "
          f"{ref['peak_mib']:.0f}; {wall:.1f} s in all", flush=True)
    dropout_draw_cost(ref["draws"])
    return worst


DRAW_GLOBAL_BATCHES = (2, 16, 32)   # one process; 8 cards x 2; DDAD's 32


def dropout_draw_cost(draws, rows=2):
    """The random draws of one f32 step of PRESET at 352x704 (`draws`, the
    (kind, input shape) of each DropPath and Dropout call, from
    `global_batch_step`) made by the layers' own code for a process that
    keeps `rows` rows of a global batch of G (world G / rows, rank 0):
    CUDA-event ms of the step's draws and the largest transient above the
    inputs, for G in DRAW_GLOBAL_BATCHES on this one card. Every process
    draws the global batch's masks and keeps its rows
    (`layers.Stochastic._keep`), so the draw grows with the world."""
    from gedepth_tpu_torch import parallel
    from gedepth_tpu_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    calls = []
    for kind, shape in draws:
        layer = getattr(layers, kind)(0.1).cuda().train()
        layer.generator = gen
        calls.append((layer, torch.ones((rows,) + shape[1:], device="cuda")))

    def step():
        for layer, x in calls:
            layer(x)

    out = {}
    for g in DRAW_GLOBAL_BATCHES:
        with mock.patch.object(parallel, "world", lambda: g // rows):
            ms = cuda_ms(step, reps=5, warmup=1)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        out[g] = (ms, peak)
    kinds = collections.Counter(kind for kind, _ in draws)
    big = max(draws, key=lambda d: math.prod(d[1]))
    print(f"[dropout draw] {PRESET} 352x704 f32, {dict(kinds)} draws a step "
          f"(largest: {big[0]} of {big[1]} at batch {rows}) made for {rows} "
          "rows of a global batch of G: "
          + "; ".join(f"G={g}: {ms:.3f} ms, {peak:.0f} MiB transient"
                      for g, (ms, peak) in out.items()), flush=True)
    del calls
    torch.cuda.empty_cache()
    return out


def _json_tail(text):
    return json.loads([line for line in text.splitlines()
                       if line.startswith("{")][-1])


# Swin-L's blocks a stage in phase 29's processes (the preset's: 2, 2, 18, 2)
NCCL_DEPTHS = (2, 2, 2, 2)


def phase_nccl_world_one(tree):
    """Phase 29: `python -m torch.distributed.run --nproc_per_node 1 -m
    gedepth_tpu_torch.tools.train PRESET --multihost` for 2 steps from the
    KITTI tree at global batch 2, crop 176x352, no loader workers (NCCL, a
    world of one), then
    `tools.test --multihost` on its best_abs_rel.npz: both report world 1
    over NCCL and finite metrics. Both at a cut depth, Swin-L's stages of
    2 blocks each at its full widths: phase 7 trains and evaluates the
    preset at full depth, and what this phase shows is the process
    group."""
    import os.path as osp

    here = osp.dirname(osp.abspath(__file__))
    opts = ["--options", f"data.data_root={tree['root']}",
            f"data.train_split={tree['train']}",
            f"data.test_split={tree['test']}", "train.global_batch=2",
            f"model.depths={NCCL_DEPTHS}"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        lines = {}
        for tool, args, more in (
                # a 176x352 crop and the prefetch thread: what this phase
                # shows is the process group, and the autotuner's search of
                # the full crop's shapes costs ~30 s in a fresh process
                ("train", ["--max-iters", "2", "--eval-max-images", "1",
                           "--work-dir", work],
                 ["data.crop_size=(176,352)", "train.num_workers=0"]),
                ("test", [osp.join(work, "best_abs_rel.npz"),
                          "--max-images", "1"], [])):
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
                   "--master_port", str(_free_port()), "-m",
                   f"gedepth_tpu_torch.tools.{tool}", PRESET, *args,
                   "--multihost", *opts, *more]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900, cwd=here)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"[nccl] tools.{tool} --multihost exited "
                     f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                     f"{proc.stderr[-3000:]}")
            line = lines[tool] = _json_tail(proc.stdout)
            if line["world"] != 1 or line["backend"] != "nccl" or not all(
                    np.isfinite(line[k]) for k in ("abs_rel", "rmse", "a1")):
                fail(f"[nccl] tools.{tool} --multihost: {line}")
            print(f"[nccl] torchrun --nproc_per_node 1 tools.{tool} "
                  f"--multihost: {seconds:.1f} s; {json.dumps(line)}",
                  flush=True)
        if lines["train"]["iter"] != 2 or lines["test"]["images"] != 1:
            fail(f"[nccl] {lines}")


PRETRAIN_STEPS = 3


def phase_pretrain(tree):
    """Phase 30: `tools.pretrain_pe_mask gedepth_adaptive_kitti` from the
    KITTI tree, PRETRAIN_STEPS steps at batch 2 (352x704, the exact rule in
    HAHI: B and C at the exact self-attention's 20,570 queries a sample
    and the cross-attention's 61,952, no PE fusion), the ground-mask IoU
    over 4 more batches, then one `tools.train` step of that preset with
    --load-backbone-from: the backbone before the step equals the file,
    every gradient after it is finite, and C ran at the exact rule's query
    counts. Returns the pretraining's JSON line."""
    import contextlib as cl
    import io
    import os.path as osp

    from gedepth_tpu_torch.models import pretrain as tpre
    from gedepth_tpu_torch.tools import pretrain_pe_mask
    from gedepth_tpu_torch.tools import train as train_cli
    import gedepth_tpu_torch.train.loop as loop

    opts = ["--options", f"data.data_root={tree['root']}",
            f"data.train_split={tree['train']}",
            f"data.test_split={tree['test']}", "train.global_batch=2",
            "train.log_interval=1"]
    exact_q = (20570, 61952)
    counters = _kernel_counters()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        made = []
        build = tpre.GroundMaskPretrain.from_config

        def capture(*args, **kwargs):
            made.append(build(*args, **kwargs))
            return made[-1]

        reset_counts(counters)
        out = io.StringIO()
        t0 = time.perf_counter()
        with mock.patch.object(tpre.GroundMaskPretrain, "from_config",
                               capture), cl.redirect_stdout(out):
            pretrain_pe_mask.main([EXACT, "--max-iters", str(PRETRAIN_STEPS),
                                   "--work-dir", osp.join(work, "pre")]
                                  + opts)
        seconds = time.perf_counter() - t0
        line = _json_tail(out.getvalue())
        launches, by_queries = read_counts(counters)
        model = made[0]
        forwards = PRETRAIN_STEPS + 4 * 1     # the IoU: 4 batches
        want_b = {q: forwards for q in exact_q}
        want_c = {q: PRETRAIN_STEPS for q in exact_q}
        # the steps under remat, the IoU's forwards without
        want_a = A_STEP * PRETRAIN_STEPS + A_FORWARD * 4
        if (model.neck.self_attn.sampling, model.neck.multi_att.sampling) \
                != ("bilinear", "bilinear") \
                or by_queries["msda"] != want_b \
                or by_queries["msda_backward"] != want_c \
                or launches["window_attention"] != want_a \
                or launches["pe_fusion"] != 0:
            fail(f"[pretrain] sampling {model.neck.sampling}; launches "
                 f"{launches}, by queries {by_queries}; expected B {want_b}, "
                 f"C {want_c}, {want_a} A, no E")
        if line["n"] != 8 or not 0 <= line["miou"] <= 100:
            fail(f"[pretrain] IoU summary {line}")
        del made, model
        print(f"[pretrain] tools.pretrain_pe_mask {EXACT}, {PRETRAIN_STEPS} "
              f"steps at batch 2, 352x704, exact sampling: {seconds:.1f} s "
              f"with the build; median step {line['step_ms']:.1f} ms (steps "
              f"after the first); ground-mask IoU miou={line['miou']:.3f} "
              f">=60: {line['frac_over_60']:.3f} >=75: "
              f"{line['frac_over_75']:.3f} (n={line['n']}, seeded weights); "
              f"launches {launches}, by queries {by_queries}", flush=True)
        backbone = tpre.load_backbone(line["backbone"])
        seen = {}
        real = loop.make_train_step

        def checked(*args, **kwargs):
            step = real(*args, **kwargs)

            def first(state, batch):
                if not seen:
                    own = tpre.extract_backbone(state.model)
                    seen["keys"] = sorted(own) == sorted(backbone)
                    seen["diff"] = max(float((own[k].cpu() - v).abs().max())
                                       for k, v in backbone.items())
                metrics = step(state, batch)
                seen["bad"] = [n for n, p in state.model.named_parameters()
                               if p.grad is None
                               or not bool(torch.isfinite(p.grad).all())]
                return metrics
            return first

        reset_counts(counters)
        out = io.StringIO()
        with mock.patch.object(loop, "make_train_step", checked), \
                cl.redirect_stdout(out):
            train_cli.main([EXACT, "--max-iters", "1", "--eval-max-images",
                            "1", "--load-backbone-from", line["backbone"],
                            "--work-dir", osp.join(work, "train")] + opts)
        _, by_queries = read_counts(counters)
        trained = _json_tail(out.getvalue())
        if not seen.get("keys") or seen["diff"] != 0.0 or seen["bad"] \
                or "overlaid the backbone" not in out.getvalue() \
                or by_queries["msda_backward"] != {q: 1 for q in exact_q} \
                or not np.isfinite(trained["abs_rel"]):
            fail(f"[pretrain] the overlay step: {seen}, C by queries "
                 f"{by_queries['msda_backward']}, {trained}")
        print(f"[pretrain] tools.train {EXACT} --load-backbone-from "
              f"pe_mask_backbone.npz: the backbone's {len(backbone)} "
              "parameters before the step equal the file (max |diff| 0), "
              "every gradient finite after it, C at the exact rule's "
              f"{by_queries['msda_backward']}; eval abs_rel "
              f"{trained['abs_rel']:.4f}", flush=True)
    return line


# ---- phase 36: the zoo's presets ----

ZOO_PRESETS = ("bts_kitti", "densedepth_kitti", "dpt_kitti", "adabins_nyu",
               BINSFORMER)
# per preset: its tree, the serving frame's size and channels, the decode
# head's module held against the CPU, the train crop
ZOO_SPECS = {
    "bts_kitti": dict(tree="kitti", serve_hw=(352, 1216), channels=5,
                      head="conv_depth", train_hw=(352, 704)),
    "densedepth_kitti": dict(tree="kitti", serve_hw=(352, 1216), channels=5,
                             head="conv_depth", train_hw=(352, 704)),
    # the head's last conv before its ReLU (conv_depth.head)
    "dpt_kitti": dict(tree="kitti", serve_hw=(352, 1216), channels=5,
                      head="conv_depth", train_hw=(352, 704)),
    # AdaBins' depth is a mean of bin centres, never cut by a ReLU; its
    # decoder's last conv is held beside it
    "adabins_nyu": dict(tree="nyu", serve_hw=(480, 640), channels=3,
                        head="decode_final_conv", train_hw=(416, 544)),
    # BinsFormer's depth is a mean of bin centres too; the final decoder
    # layer's normalised queries (through kernels A and B) beside it
    BINSFORMER: dict(tree="nyu", serve_hw=(480, 640), channels=3,
                     head="transformer_decoder.decoder_norm",
                     train_hw=(416, 544)),
}
NYU_TREE_SIZE = (480, 640)


def tb_events(log_dir):
    """{(tag, step): float32 value} of the scalar events in `log_dir`."""
    import glob
    import os.path as osp

    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util

    out = {}
    for path in sorted(glob.glob(osp.join(log_dir, "events.out.*"))):
        for event in EventFileLoader(path).Load():
            for v in event.summary.value:
                out[(v.tag, event.step)] = float(
                    tensor_util.make_ndarray(v.tensor))
    return out


def check_tb(tag, work):
    """The run's `tb/` scalars equal every number of the JSONL's train and
    val records, at their iters, in float32."""
    import os.path as osp

    with open(osp.join(work, "train.log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    want = {(f"{r['mode']}/{k}", r["iter"]): float(np.float32(v))
            for r in records if r["mode"] in ("train", "val")
            for k, v in r.items() if isinstance(v, (int, float))}
    got = tb_events(osp.join(work, "tb"))
    if got != want:
        fail(f"{tag} tb/ events differ from the JSONL: "
             f"{sorted(set(got) ^ set(want))[:6]}")
    print(f"{tag} tb/ holds the JSONL's {len(want)} scalars "
          f"({sorted({t for t, _ in want})[:4]} ...)", flush=True)


def served_with_head_output(handle, rgb, head="conv_depth"):
    """inference_depther(handle, rgb) and, on the CPU, the output of the
    decode head's module `head` (a dotted path: its last conv before its
    ReLU, AdaBins' decoder's last conv, BinsFormer's decoder_norm) in the
    first forward of the flip-TTA pair (at seeded weights the ReLU can zero
    the whole depth, which would hold nothing)."""
    from gedepth_tpu_torch.apis import inference_depther

    seen = []
    module = handle.model.decode_head.get_submodule(head)
    hook = module.register_forward_hook(
        lambda m, i, o: seen.append(o.detach().float().cpu()))
    try:
        depth = inference_depther(handle, rgb)
    finally:
        hook.remove()
    return depth, seen[0]


def zoo_serving(preset, requests, counters):
    """`init_depther(preset)` on the card: 3 flip-TTA requests, the first
    against the CPU forward of the same seeded weights (the depth, and the
    head's module of ZOO_SPECS). Returns its numbers, and the kernel
    launches of the requests after the first (`read_counts`' form); the
    caller's counts go on over the whole call."""
    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.train.loop import cudnn_autotuner

    tag, spec = f"[zoo {preset}]", ZOO_SPECS[preset]
    h, w = spec["serve_hw"]
    pe = requests[0][1]
    with cudnn_autotuner():
        t0 = time.perf_counter()
        handle = init_depther(preset, device="cuda", pe_raw=pe, seed=SEED)
        first, head_out = served_with_head_output(handle, requests[0][0],
                                                  spec["head"])
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        latencies, depths = [], []
        before = read_counts(counters)
        for rgb, _ in requests:
            t = time.perf_counter()
            depths.append(inference_depther(handle, rgb))
            latencies.append((time.perf_counter() - t) * 1e3)
        counted = counts_since(before, read_counts(counters))
        img = torch.randn((1, h, w, spec["channels"]), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(SEED))
        ch = torch.full((1,), 1.65, device="cuda")
        step_ms = cuda_ms(lambda: handle.eval_step(img, ch), reps=5)
        peak = torch.cuda.max_memory_allocated() / 2**20
    for i, d in enumerate(depths):
        check_depth(f"{tag} request {i}", d, handle.cfg.model, (h, w))
    if not np.array_equal(first, depths[0]):
        fail(f"{tag} the same request twice gave two depths")
    n_params = sum(p.numel() for p in handle.model.parameters())
    del handle
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cpu = init_depther(preset, device="cpu", pe_raw=pe, seed=SEED)
    want, want_head = served_with_head_output(cpu, requests[0][0],
                                              spec["head"])
    cpu_s = time.perf_counter() - t0
    err = np.abs(depths[0] - want)
    compare(f"{tag} depth, card against CPU", torch.from_numpy(depths[0]),
            torch.from_numpy(want), rtol=1e-3, atol=1e-3)
    scale = want_head.abs().max().item()
    compare(f"{tag} decode_head.{spec['head']}, card against CPU "
            f"(max |x| {scale:.3g})", head_out, want_head, rtol=1e-3,
            atol=1e-3 * scale)
    print(f"{tag} {n_params} parameters; first request {first_s:.2f} s "
          f"(init, first calls); request latency ms "
          f"{[round(x, 3) for x in latencies]}; flip-TTA eval step "
          f"{step_ms:.3f} ms (CUDA events, {h}x{w}); peak {peak:.1f} MiB; "
          f"against the CPU ({cpu_s:.1f} s): max abs {err.max():.3e} m, "
          f"mean rel {float(np.mean(err / want)):.3e}", flush=True)
    return {"request_ms": statistics.median(latencies),
            "eval_step_ms": step_ms, "serving_peak_mib": peak,
            "cpu_max_abs_err": float(err.max())}, counted


def zoo_training(preset, tree, tb_ok):
    """`train(preset)` for 3 steps from its tree (KITTI or NYU) into a work
    dir, its tb/ events, then `tools.test` with its best `.npz`."""
    import contextlib as cl
    import dataclasses
    import io
    import os.path as osp

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.train.loop import train

    tag, steps = f"[zoo {preset}]", 3
    cfg = get_config(preset)
    cfg = cfg.replace(data=tree_data(preset, tree), train=dataclasses.replace(
        cfg.train, global_batch=2, log_interval=1))
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        _, history, best = train(cfg, work_dir=work, max_iters=steps,
                                 eval_max_images=EVAL_IMAGES, device="cuda")
        wall = time.perf_counter() - t0
        vals = [r for r in history if r["mode"] == "val"]
        history = [r for r in history if r["mode"] == "train"]
        for r in history:
            if not all(np.isfinite(r[k]) for k in ("loss", "grad_norm")):
                fail(f"{tag} step {r['iter']}: {r}")
            print(f"{tag} iter {r['iter']} loss={r['loss']:.6f} "
                  f"grad_norm={r['grad_norm']:.6f} "
                  f"step_ms={r['time'] * 1e3:.3f} "
                  f"step_peak_mem_mib={r['peak_mem_mib']:.1f}", flush=True)
        check_val(tag, vals, steps, best)
        step_ms = statistics.median(r["time"] for r in history[1:]) * 1e3
        first_s = history[0]["time"] - step_ms / 1e3
        peak = max(r["peak_mem_mib"] for r in history[1:])
        print(f"{tag} train({preset!r}, max_iters={steps}), global batch 2, "
              f"crop {cfg.data.crop_size}, the {cfg.data.dataset} tree: "
              f"{wall:.1f} s with "
              f"init and evaluation; step {step_ms:.3f} ms, peak "
              f"{peak:.1f} MiB; the first step {first_s:.1f} s longer "
              "(cuDNN's heuristic)", flush=True)
        if tb_ok:
            check_tb(tag, work)
        elif osp.exists(osp.join(work, "tb")):
            fail(f"{tag} tb/ written without the tensorboard package")
        out = io.StringIO()
        with cl.redirect_stdout(out):
            test_cli.main([preset, osp.join(work, "best_abs_rel.npz"),
                           "--max-images", "2", "--options",
                           f"data.data_root={tree['root']}",
                           f"data.test_split={tree['test']}"])
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        if line["images"] != 2 or not all(
                np.isfinite(line[k]) for k in ("abs_rel", "rmse", "a1")):
            fail(f"{tag} tools.test on the {cfg.data.dataset} tree: {line}")
        print(f"{tag} tools.test with the run's best_abs_rel.npz: "
              f"{json.dumps(line)}", flush=True)
    return {"loop_step_ms": step_ms, "loop_peak_mib": peak,
            "first_step_extra_s": first_s}


def zoo_step_timing(preset, tag=None, train_hw=None, autotuner=True):
    """The f32 train step at the preset's crop, batch 2, timed as
    `tools.benchmark --train-step` does (the first step apart, with
    cuDNN's search where its autotuner is on, 1 warm-up step, 5 timed by
    CUDA events; the profiler's busy time and the idle share)."""
    from gedepth_tpu_torch.tools.benchmark import run_benchmark

    tag = tag or f"[zoo {preset}]"
    h, w = train_hw or ZOO_SPECS[preset]["train_hw"]
    r = run_benchmark(preset, iters=5, warmup=1, batch=2, height=h,
                      width=w, train_step=True, device="cuda", seed=SEED,
                      autotuner=autotuner)
    print(f"{tag} tools.benchmark --train-step: {json.dumps(r)}",
          flush=True)
    if not r["device_ms_median"] > 0:
        fail(f"{tag} no step time: {r}")
    return {"step_ms": r["device_ms_median"], "step_busy_ms":
            r["device_busy_ms"], "step_idle_share": r["device_idle_share"],
            "train_peak_mib": r["peak_mem_mib"],
            "first_step_ms": r["first_step_ms"]}


def nyu_requests(tree):
    """The NYU tree's test frames, RGB without a plane embedding, as
    (rgb, None) requests."""
    import os.path as osp

    from gedepth_tpu_torch.utils.png import read_rgb

    with open(tree["test"]) as f:
        return [(read_rgb(osp.join(tree["root"], line.split()[0])), None)
                for line in f if line.strip()]


def zoo_chamfer_step(tree):
    """One `adabins_nyu` train step with chamfer_weight 0.1 on a batch of 2
    of the NYU tree at the 416x544 crop: the loss and its terms, finite,
    and the step's peak (the (2, 256, 416·544) distance tensor of the
    chamfer is formed whole)."""
    import dataclasses

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.transforms import build_train_pipeline
    from gedepth_tpu_torch.train.loop import (
        build_train_dataset, cudnn_autotuner, train_step_for)
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state)

    tag = "[zoo adabins_nyu] chamfer"
    cfg = get_config("adabins_nyu")
    cfg = cfg.replace(data=tree_data("adabins_nyu", tree),
                      optim=dataclasses.replace(cfg.optim,
                                                chamfer_weight=0.1))
    model = cfg.model.build(device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(model, cfg.optim, cfg.train.max_iters, SEED)
    step = train_step_for(cfg)
    batch = TrainLoader(build_train_dataset(cfg),
                        build_train_pipeline(cfg.data,
                                             cfg.model.depth_scale),
                        2, seed=SEED).make_batch(0)
    batch = batch_to_device(batch, torch.device("cuda"))
    with cudnn_autotuner():
        step(state, batch)                 # cuDNN's search, then one timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    vals = {k: float(v) for k, v in m.items()}
    if not (all(np.isfinite(v) for v in vals.values())
            and vals["loss_chamfer"] > 0):
        fail(f"{tag}: {vals}")
    print(f"{tag} chamfer_weight=0.1, batch 2 at 416x544: loss="
          f"{vals['loss']:.6f} loss_depth={vals['loss_depth']:.6f} "
          f"loss_chamfer={vals['loss_chamfer']:.6f} "
          f"grad_norm={vals['grad_norm']:.6f}; step {ms:.3f} ms (host "
          f"clock, synchronised), peak {peak:.1f} MiB", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return {"chamfer_step_ms": ms, "chamfer_peak_mib": peak,
            "chamfer_loss": vals["loss_chamfer"]}


def binsformer_steps(tree, requests, counters):
    """`binsformer_nyu` on its own kernels: one f32 train step on a batch
    of 2 of the NYU tree at the 416x544 crop, with scene classes (A 24
    times, B and C 6 each at 4,641 queries: `BINS_PER_STEP`), its loss
    terms and peak memory; the same step again from the same seed (the
    DropPath draws replayed under remat): the loss and the generator's
    state equal to the bit, every gradient within 1e-3 of its norm in L2
    (C sums d_value by atomics); one bf16_compute step (A, B and C in bf16,
    as many times); one bf16 flip-TTA request (A 24 and B 12 in bf16).
    Returns the launches of the f32 step (`read_counts`) and, by kernel,
    the bf16 launches of the step and the request."""
    import dataclasses

    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.transforms import build_train_pipeline
    from gedepth_tpu_torch.train.loop import (
        build_train_dataset, train_step_for)
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state)

    tag = f"[zoo {BINSFORMER}]"
    cfg = get_config(BINSFORMER)
    cfg = cfg.replace(data=tree_data(BINSFORMER, tree))
    batch = TrainLoader(build_train_dataset(cfg),
                        build_train_pipeline(cfg.data,
                                             cfg.model.depth_scale),
                        2, seed=SEED).make_batch(0)
    batch = batch_to_device(batch, torch.device("cuda"))
    if batch["img"].shape != (2, 416, 544, 3) or "scene_class" not in batch:
        fail(f"{tag} train batch {batch['img'].shape} {sorted(batch)}")

    def step(bf16):
        model = cfg.model.build(device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
        state = create_train_state(model, cfg.optim, cfg.train.max_iters,
                                   SEED)
        run = train_step_for(cfg.replace(train=dataclasses.replace(
            cfg.train, bf16_compute=bf16)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        t0 = time.perf_counter()
        m = run(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out = ({k: float(v) for k, v in m.items()},
               {n: p.grad.detach().clone() for n, p in
                model.named_parameters()},
               state.generator.get_state(), read_counts(counters),
               read_dtypes(counters), ms,
               torch.cuda.max_memory_allocated() / 2**20)
        del state, model
        torch.cuda.empty_cache()
        return out

    metrics, grads, gen, counted, _, ms, peak = step(False)
    if not all(np.isfinite(v) for v in metrics.values()) or set(metrics) != {
            "loss", "loss_depth", "loss_ce", "aux_loss_depth_2",
            "aux_loss_depth_5", "grad_norm", "lr"}:
        fail(f"{tag} step metrics {metrics}")
    want_by = {"msda": {BINS_TRAIN_Q: 6}, "msda_backward": {BINS_TRAIN_Q: 6}}
    if counted[0] != BINS_PER_STEP or counted[1] != want_by:
        fail(f"{tag} step launches {counted}; expected {BINS_PER_STEP}, "
             f"{want_by}")
    print(f"{tag} f32 step, batch 2 at 416x544 with scene classes: "
          + " ".join(f"{k}={v:.6f}" for k, v in metrics.items())
          + f"; {ms:.3f} ms (host clock, synchronised, cuDNN's defaults), "
          f"peak {peak:.1f} MiB; launches {counted[0]}, by queries "
          f"{counted[1]}", flush=True)
    again, grads2, gen2, _, _, _, _ = step(False)
    if again["loss"] != metrics["loss"] or not torch.equal(gen, gen2):
        fail(f"{tag} the same step from the same seed: loss "
             f"{metrics['loss']!r} then {again['loss']!r}, generator "
             f"{'equal' if torch.equal(gen, gen2) else 'different'}")
    # phase 8's bound: ||g2 - g|| <= 1e-3 ||g|| + 1e-7 (a gradient that is
    # 0 in exact arithmetic, a LayerNorm bias in front of a conv and a
    # train-mode BatchNorm, holds rounding noise on both runs)
    apart = sorted(((float((grads2[n] - g).norm()), float(g.norm()), n)
                    for n, g in grads.items()),
                   key=lambda e: -e[0] / max(e[1], 1e-30))
    over = [e for e in apart if e[0] > 1e-3 * e[1] + 1e-7]
    if over:
        fail(f"{tag} the same step twice: gradients apart (L2 of the "
             f"difference, L2, name) {over[:4]}")
    print(f"{tag} the same step again from seed {SEED}: loss and the "
          f"DropPath generator's state equal to the bit, gradients within "
          f"1e-3 of their norm + 1e-7 (C sums d_value by atomics); the "
          f"furthest relative (L2 of the difference, L2, name): "
          f"{apart[:3]}", flush=True)
    del grads, grads2
    bf_metrics, _, _, bf_counted, bf_dtypes, bf_ms, bf_peak = step(True)
    bf16_step = {k: v.get("bf16", 0) for k, v in bf_dtypes.items()}
    want = {k: v for k, v in BINS_PER_STEP.items() if k != "pe_fusion"}
    if bf16_step != want or not all(np.isfinite(v)
                                    for v in bf_metrics.values()):
        fail(f"{tag} bf16_compute step: bf16 launches {bf16_step} "
             f"(expected {want}), metrics {bf_metrics}")
    print(f"{tag} bf16_compute step: loss={bf_metrics['loss']:.6f} "
          f"loss_ce={bf_metrics['loss_ce']:.6f}; {bf_ms:.3f} ms, peak "
          f"{bf_peak:.1f} MiB; bf16 launches {bf16_step}", flush=True)

    handle = init_depther(BINSFORMER, device="cuda", seed=SEED, bf16=True)
    inference_depther(handle, requests[0][0])             # warm-up
    reset_counts(counters)
    depth = inference_depther(handle, requests[0][0])
    bf16_request = {k: v.get("bf16", 0)
                    for k, v in read_dtypes(counters).items()}
    check_depth(f"{tag} bf16 request", depth, handle.cfg.model, (480, 640))
    want = {"window_attention": 24, "msda": 12, "msda_backward": 0}
    if bf16_request != want:
        fail(f"{tag} bf16 request: bf16 launches {bf16_request}, expected "
             f"{want}")
    print(f"{tag} bf16 flip-TTA request (whole model cast): bf16 launches "
          f"{bf16_request}", flush=True)
    del handle
    torch.cuda.empty_cache()
    return {"step": counted, "bf16_step": bf16_step,
            "bf16_request": bf16_request,
            "summary": {"f32_step_ms": ms, "f32_step_peak_mib": peak,
                        "bf16_step_ms": bf_ms, "bf16_step_peak_mib": bf_peak,
                        **{k: metrics[k] for k in metrics if k != "lr"}}}


def phase_zoo(trees, requests):
    """Phase 36: `bts_kitti`, `densedepth_kitti` and `dpt_kitti` from the
    KITTI tree and `adabins_nyu` and `binsformer_nyu` from an NYU tree
    served, trained and evaluated; the port's kernel counts stay 0 over
    each preset's run but BinsFormer's, which launches A, B and C exactly
    `BINS_PER_REQUEST` times a request and `BINS_PER_STEP` times a step.
    Returns BinsFormer's launches for its `kernels` rows."""
    import gedepth_tpu_torch.train.loop as train_loop
    from gedepth_tpu_torch.tools.make_tree import make_nyu_tree

    try:
        import tensorboard  # noqa: F401
        tb_ok = True
    except ImportError:
        tb_ok = False
    print(f"[zoo] the tensorboard package imports here: {tb_ok}",
          flush=True)
    nyu_root = tempfile.mkdtemp(dir=trees["work"])
    trees = dict(trees, nyu=dict(make_nyu_tree(nyu_root, NYU_TREE_SIZE,
                                               frames=4, seed=SEED),
                                 root=nyu_root))
    by_tree = {"kitti": requests, "nyu": nyu_requests(trees["nyu"])}
    counters = _kernel_counters()
    summary = {}
    # cuDNN's heuristic in place of its autotuner, in `train()` and in the
    # serving and the timed steps of this phase alone
    with mock.patch.object(train_loop, "cudnn_autotuner",
                           contextlib.nullcontext):
        bins = _zoo_presets(trees, by_tree, counters, tb_ok, summary)
    print(f"[zoo] {json.dumps(summary)}", flush=True)
    return bins


def _zoo_presets(trees, by_tree, counters, tb_ok, summary):
    """Phase 36's presets, one after the other, into `summary`; returns
    BinsFormer's launches."""
    bins = {}
    for preset in ZOO_PRESETS:
        t0 = time.perf_counter()
        tree = trees[ZOO_SPECS[preset]["tree"]]
        reset_counts(counters)
        served, requested = zoo_serving(
            preset, by_tree[ZOO_SPECS[preset]["tree"]], counters)
        summary[preset] = dict(served, **zoo_training(preset, tree, tb_ok),
                               **zoo_step_timing(preset, autotuner=False))
        if preset == "adabins_nyu":
            summary[preset].update(zoo_chamfer_step(tree))
        torch.cuda.empty_cache()
        launches, _ = read_counts(counters)
        n = len(by_tree[ZOO_SPECS[preset]["tree"]])
        if preset == BINSFORMER:
            want = {k: n * v for k, v in BINS_PER_REQUEST.items()}
            want_by = {"msda": {BINS_SERVE_Q: n * 12}, "msda_backward": {}}
            if requested != (want, want_by):
                fail(f"[zoo {preset}] {n} requests launched {requested}; "
                     f"expected {want}, {want_by}")
            if not all(launches[k] for k in ("window_attention", "msda",
                                             "msda_backward")):
                fail(f"[zoo {preset}] its run launched {launches}")
            bins = binsformer_steps(tree, by_tree["nyu"], counters)
            bins["requests"] = requested
            summary[preset].update(bins["summary"])
        elif any(launches.values()) or any(requested[0].values()):
            fail(f"[zoo {preset}] launched the port's kernels: {launches}, "
                 f"{requested[0]}")
        summary[preset]["seconds"] = time.perf_counter() - t0
        print(f"[zoo {preset}] kernel launches: {n} flip-TTA requests "
              f"{requested[0]}, the whole run (serving, training, "
              f"evaluation, tools.test) {launches}; {summary[preset]['seconds']:.1f} s", flush=True)
    return bins


# ---- phase 38: the seg preset (HRNet-W18 + the FCN/OCR cascade) ----

SEG = "ocrnet_hr18_kitti"
SEG_STEPS = 3


def seg_batch(cfg, device):
    """The first batch of 2 that `train()` draws from the preset's tree
    (its loader's seed, the KITTI chain at the 352x704 crop)."""
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.transforms import build_train_pipeline
    from gedepth_tpu_torch.train.loop import build_train_dataset
    from gedepth_tpu_torch.train.steps import batch_to_device

    loader = TrainLoader(build_train_dataset(cfg),
                         build_train_pipeline(cfg.data,
                                              cfg.model.depth_scale),
                         2, seed=cfg.train.seed)
    return batch_to_device(loader.make_batch(0), device)


def seg_step_on(weights, cfg, batch, device, dtype=torch.float32):
    """One `make_seg_train_step` on `device` from `weights`, in `dtype`:
    (metrics, {name: gradient on the CPU})."""
    from gedepth_tpu_torch.train.steps import (
        create_train_state, make_seg_train_step)

    model = cfg.model.build(device=device)
    model.load_state_dict(weights, strict=True)
    model.to(dtype)
    state = create_train_state(model, cfg.optim, 10)
    metrics = make_seg_train_step(cfg.model.depth_scale)(
        state, {k: v.to(device, dtype) if v.is_floating_point()
                else v.to(device) for k, v in batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def seg_against_cpu(tag, state, cfg):
    """The trained weights on the card and on the CPU: one train step on
    the centre 176x352 of the tree's first batch (batch 2; loss rtol 1e-4,
    grad_norm rtol 5e-3, every gradient finite, within 0.1 of the CPU's in
    L2 plus 1e-5 of the largest gradient's norm, and non-zero wherever the
    CPU's norm is above that), and one eval forward of a KB-cropped
    352x1216 test
    frame (both stages' logits rtol 1e-3, atol 1e-3 of their largest
    magnitude), TF32 off. Between the two, the float64 steps of
    `seg_float64_anchor`, whose summary it returns."""
    from gedepth_tpu_torch.data.transforms import build_test_pipeline
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    weights = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    # the centre 176x352 of the batch: a quarter of the CPU's step
    batch = {k: v[:, 88:264, 176:528] if v.dim() >= 3 else v
             for k, v in seg_batch(cfg, "cpu").items()}
    t0 = time.perf_counter()
    card, g_card = seg_step_on(weights, cfg, batch, "cuda")
    cpu, g_cpu = seg_step_on(weights, cfg, batch, "cpu")
    for key in ("loss", "loss_seg0", "loss_seg1"):
        if not math.isclose(card[key], cpu[key], rel_tol=1e-4):
            fail(f"{tag} {key} on the card {card[key]} against the CPU "
                 f"{cpu[key]}")
    # each gradient within 0.1 of the CPU's in L2 plus 1e-5 of the largest
    # gradient's norm: two f32 runs part by up to ~3% on the BatchNorm
    # biases, whose gradients are sums of ~1e4 terms of both signs (a card
    # step with cuDNN off parts from the CPU's as much), and a gradient
    # that is 0 in exact arithmetic holds rounding noise on both sides
    # (the OCR head's key_proj.bias adds q·b to every region's logit,
    # which the softmax over the regions takes out)
    top = max(float(g.norm()) for g in g_cpu.values())
    worst, small = ("", 0.0), []
    for name, want in g_cpu.items():
        got = g_card[name]
        if not torch.isfinite(got).all():
            fail(f"{tag} gradient of {name} not finite on the card")
        err, size = float((got - want).norm()), float(want.norm())
        if err > 0.1 * size + 1e-5 * top:
            fail(f"{tag} gradient of {name}: {err:.3e} from the CPU's "
                 f"(norm {size:.3e}, the largest {top:.3e})")
        if size < 1e-5 * top:
            small.append(name)
            continue
        if not got.abs().max() > 0:
            fail(f"{tag} gradient of {name} is 0 on the card, not on the CPU")
        worst = max(worst, (name, err / size), key=lambda x: x[1])
    total = float(torch.cat([(g_card[n] - g).flatten() for n, g in
                             g_cpu.items()]).norm() / torch.cat(
        [g.flatten() for g in g_cpu.values()]).norm())
    # f32 keeps this norm to ~1e-3 on either side (the stem's weight
    # gradients sum ~1e4 positions of a BatchNorm's centred gradient times
    # a non-negative input), so two f32 runs may part by a few 1e-3
    if not math.isclose(card["grad_norm"], cpu["grad_norm"], rel_tol=5e-3):
        fail(f"{tag} grad_norm on the card {card['grad_norm']} against the "
             f"CPU {cpu['grad_norm']}")
    step_s = time.perf_counter() - t0
    anchored = seg_float64_anchor(tag, weights, cfg, batch, card, g_card,
                                  cpu)
    data = build_eval_dataset(cfg)
    img = torch.from_numpy(np.ascontiguousarray(build_test_pipeline(
        cfg.data)(data[0])["img"], np.float32))[None]
    logits = {}
    for device in ("cuda", "cpu"):
        model = cfg.model.build(device=device)
        model.load_state_dict(weights, strict=True)
        with torch.no_grad():
            logits[device] = [x.cpu() for x in
                              model(img.to(device))["seg_logits"]]
    for i, (got, want) in enumerate(zip(logits["cuda"], logits["cpu"])):
        if got.shape != (1, 352, 1216, 2):
            fail(f"{tag} stage {i} logits of shape {tuple(got.shape)}")
        scale = want.abs().max().item()
        compare(f"{tag} stage {i} logits at 352x1216, card against CPU "
                f"(max |x| {scale:.3g}; argmax differs at "
                f"{(got.argmax(-1) != want.argmax(-1)).float().mean():.2e} "
                "of the pixels)", got, want, rtol=1e-3, atol=1e-3 * scale)
    print(f"{tag} one step from the trained weights, card against CPU: "
          f"loss {card['loss']:.6f} / {cpu['loss']:.6f}, grad_norm "
          f"{card['grad_norm']:.6f} / {cpu['grad_norm']:.6f}, the largest "
          f"gradient distance {worst[1]:.3e} of its norm ({worst[0]}), "
          f"all gradients {total:.3e}, {len(small)} below 1e-5 of the "
          f"largest norm ({small[:5]}); {step_s:.1f} s", flush=True)
    return anchored


# the JAX package's f32 seg step's grad_norm, relative to its float64
# step, at phase 38's starting weights and batch on the CPU
# (tests/seg_f64_distance.py phase38)
SEG_JAX_F32_DISTANCE = 4.65e-4
# a float64 seg step on the card against the CPU's: the step takes its
# losses on f32 casts of the logits (as the JAX step does), so its losses
# and their gradients carry f32 rounding, ~1e-6 relative in grad_norm
SEG_F64_RTOL = 2e-6


def seg_float64_anchor(tag, weights, cfg, batch, card, g_card, cpu):
    """The same step in float64 on the card and on the CPU (losses and
    grad_norm rtol SEG_F64_RTOL); then the card's f32 step against the
    card's float64 one: the grad_norm's relative distance, beside the CPU
    f32 step's and the JAX package's (SEG_JAX_F32_DISTANCE), and the
    tensor whose gradient lies farthest from float64 in L2. Returns the
    summary."""
    t0 = time.perf_counter()
    card64, g_card64 = seg_step_on(weights, cfg, batch, "cuda",
                                   torch.float64)
    cpu64, _ = seg_step_on(weights, cfg, batch, "cpu", torch.float64)
    # the step takes its losses on f32 casts of the logits (as the JAX
    # step does), so a float64 step's losses carry f32 rounding
    for key in ("loss", "loss_seg0", "loss_seg1", "grad_norm"):
        rtol = SEG_F64_RTOL
        if not math.isclose(card64[key], cpu64[key], rel_tol=rtol):
            fail(f"{tag} float64 {key} on the card {card64[key]!r} against "
                 f"the CPU {cpu64[key]!r}")
    ref = card64["grad_norm"]
    # the tensor whose f32 gradient lies farthest from float64, among those
    # above 1e-5 of the largest norm (a gradient that is 0 in exact
    # arithmetic holds rounding noise)
    top = max(float(g.norm()) for g in g_card64.values())
    worst = max(((n, float((g.double() - g_card64[n]).norm()
                           / g_card64[n].norm()))
                 for n, g in g_card.items()
                 if float(g_card64[n].norm()) >= 1e-5 * top),
                key=lambda x: x[1])
    summary = {"grad_norm_f64_card": ref,
               "grad_norm_f64_cpu": cpu64["grad_norm"],
               "f64_card_against_cpu": abs(ref - cpu64["grad_norm"])
               / cpu64["grad_norm"],
               "f32_card_distance": abs(card["grad_norm"] - ref) / ref,
               "f32_cpu_distance": abs(cpu["grad_norm"]
                                       - cpu64["grad_norm"])
               / cpu64["grad_norm"],
               "jax_f32_distance": SEG_JAX_F32_DISTANCE,
               "worst_tensor_f32_card": worst[0],
               "worst_tensor_f32_card_rel_l2": worst[1],
               "seconds": time.perf_counter() - t0}
    print(f"{tag} float64 on the card and the CPU, the f32 steps against "
          f"them: {json.dumps(summary)}", flush=True)
    return summary


def phase_seg(trees):
    """Phase 38: `train(ocrnet_hr18_kitti)` for 3 steps from the KITTI
    tree with evaluation in the loop, the weights against the CPU, the
    train step timed, the evaluator's ms an image; none of the port's
    kernels launched (the seg model reaches none of them)."""
    import dataclasses
    import os.path as osp

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.eval import SegEvaluator
    from gedepth_tpu_torch.train.checkpoint import load_params_only
    from gedepth_tpu_torch.train.loop import (
        build_eval_dataset, cudnn_autotuner, train)

    tag = "[seg]"
    t0 = time.perf_counter()
    counters = _kernel_counters()
    reset_counts(counters)
    cfg = get_config(SEG)
    cfg = cfg.replace(data=tree_data(SEG, trees["kitti"]),
                      train=dataclasses.replace(cfg.train, global_batch=2,
                                                log_interval=1))
    with tempfile.TemporaryDirectory() as work:
        state, history, best = train(cfg, work_dir=work,
                                     max_iters=SEG_STEPS,
                                     eval_max_images=EVAL_IMAGES,
                                     device="cuda")
        train_s = time.perf_counter() - t0
        steps = [r for r in history if r["mode"] == "train"]
        vals = [r for r in history if r["mode"] == "val"]
        for r in steps:
            if not all(np.isfinite(r[k]) for k in ("loss", "loss_seg0",
                                                    "loss_seg1",
                                                    "grad_norm")):
                fail(f"{tag} step {r['iter']}: {r}")
            print(f"{tag} iter {r['iter']} loss={r['loss']:.6f} "
                  f"(seg0 {r['loss_seg0']:.6f}, seg1 {r['loss_seg1']:.6f}) "
                  f"grad_norm={r['grad_norm']:.6f} "
                  f"step_ms={r['time'] * 1e3:.3f} "
                  f"peak_mem_mib={r['peak_mem_mib']:.1f}", flush=True)
        grads = {n: p.grad for n, p in state.model.named_parameters()}
        if any(g is None or not torch.isfinite(g).all()
               for g in grads.values()):
            fail(f"{tag} a gradient of the last step is missing or not "
                 "finite")
        keys = {"miou", "acc", "iou_cls0", "iou_cls1"}
        if (len(vals) != 1 or vals[0]["iter"] != SEG_STEPS
                or vals[0]["images"] != EVAL_IMAGES
                or not keys <= set(vals[0])
                or not all(0 <= vals[0][k] <= 1 for k in keys)):
            fail(f"{tag} val records {vals}")
        npz = osp.join(work, "best_miou.npz")
        if best.get("miou") != vals[0]["miou"] or not osp.exists(npz):
            fail(f"{tag} best {best}, best_miou.npz written: "
                 f"{osp.exists(npz)}")
        back = load_params_only(npz, cfg.model.build(device="cuda"))
        theirs = back.state_dict()
        for k, v in state.model.state_dict().items():
            if not k.endswith("num_batches_tracked") and not torch.equal(
                    theirs[k], v):
                fail(f"{tag} best_miou.npz gives back another {k}")
        print(f"{tag} train({SEG!r}, max_iters={SEG_STEPS}), global batch "
              f"2, crop {cfg.data.crop_size}, the KITTI tree: {train_s:.1f}"
              f" s with init and evaluation; val {json.dumps(vals[0])}; "
              "best_miou.npz read back bit for bit", flush=True)
    t1 = time.perf_counter()
    anchored = seg_against_cpu(tag, state, cfg)
    t2 = time.perf_counter()
    state.model.eval()
    evaluator = SegEvaluator(state.model, build_eval_dataset(cfg), cfg.data)
    with cudnn_autotuner():
        evaluator.run()                 # the search at 352x1216, then timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        agg, _ = evaluator.run()
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t) * 1e3 / evaluator.images
    if set(agg) != keys or any(abs(agg[k] - vals[0][k]) > 1e-3
                               for k in keys):
        fail(f"{tag} SegEvaluator {agg} against the loop's {vals[0]}")
    t3 = time.perf_counter()
    timing = zoo_step_timing(SEG, "[seg]", (352, 704))
    launches, _ = read_counts(counters)
    if any(launches.values()):
        fail(f"{tag} launched the port's kernels: {launches}")
    seconds = time.perf_counter() - t0
    loop_step_ms = statistics.median(r["time"] for r in steps[1:]) * 1e3
    # the loop's first step carries cuDNN's search (and its workspace
    # trials' peak); the benchmark's first step finds its choices cached
    summary = dict(timing, eval_ms_per_image=eval_ms,
                   eval_images=evaluator.images,
                   autotune_s=steps[0]["time"] - loop_step_ms / 1e3,
                   autotune_peak_mib=steps[0]["peak_mem_mib"],
                   loop_step_ms=loop_step_ms,
                   loop_peak_mib=max(r["peak_mem_mib"] for r in steps[1:]),
                   n_params=sum(p.numel()
                                for p in state.model.parameters()),
                   seconds=seconds, seconds_train=t1 - t0,
                   seconds_against_cpu=t2 - t1, seconds_eval=t3 - t2,
                   seconds_timing=seconds - (t3 - t0), float64=anchored)
    print(f"{tag} SegEvaluator {eval_ms:.3f} ms an image (352x1216, host "
          f"clock, {evaluator.images} images); kernel launches over the "
          f"phase {launches}; {seconds:.1f} s", flush=True)
    print(f"{tag} {json.dumps(summary)}", flush=True)


# ---- phase 39: the toolbox's extra datasets and heads ----

EXTRA_PRESET = "depthformer_baseline_kitti"
EXTRA_STEPS = 2
# the datasets' own frame sizes (tools.make_tree's defaults)
EXTRA_SIZES = {"cityscapes": (1024, 2048), "nuscenes": (900, 1600),
               "sunrgbd": (530, 730)}
# depthformer_baseline_kitti's HAHI on the exact rule: the self-attention's
# queries (the four Swin levels) and the cross-attention's (the stem grid)
# a sample at the 352x704 crop and at Cityscapes' 1024x2048 frame
EXTRA_TRAIN_QUERIES = (20570, 61952)
EXTRA_EVAL_QUERIES = (174080, 524288)
# NYU Depth v2's color intrinsics at 480x640 (the ASN head's scale)
NYU_K = ((518.8579, 0.0, 325.5824), (0.0, 519.4696, 253.7362),
         (0.0, 0.0, 1.0))


def jpeg_fixtures(tag):
    """Every committed JPEG fixture through the port's decoder: the pixels'
    SHA-256 against fixtures.json, or the refusal it names; decode ms a
    frame (median of 5) at 900x1600 and 530x730 beside the PNG reader's
    on the same pixels. Returns {name: ms}."""
    import hashlib
    import os.path as osp

    from gedepth_tpu_torch.tools.make_jpeg_fixtures import DEFAULT_DIR
    from gedepth_tpu_torch.utils import jpeg
    from gedepth_tpu_torch.utils.png import encode_png, read_rgb

    t0 = time.perf_counter()
    jpeg.load_library()
    built = time.perf_counter() - t0
    with open(osp.join(DEFAULT_DIR, "fixtures.json")) as f:
        index = json.load(f)
    decoded = refused = 0
    for name, entry in sorted(index.items()):
        path = osp.join(DEFAULT_DIR, name)
        if entry["refused"]:
            try:
                jpeg.decode_jpeg(path)
            except jpeg.JpegRefused as err:
                if err.kind != entry["refused"]:
                    fail(f"{tag} {name} refused as {err.kind!r}, not "
                         f"{entry['refused']!r}")
                refused += 1
                continue
            fail(f"{tag} {name} decoded; the port refuses "
                 f"{entry['refused']} JPEGs")
        px = jpeg.decode_jpeg(path)
        if (list(px.shape) != entry["shape"] or hashlib.sha256(
                px.tobytes()).hexdigest() != entry["sha256"]):
            fail(f"{tag} {name}: the port's pixels are not PIL's "
                 f"({px.shape}, SHA-256 differs)")
        decoded += 1
    times = {}
    for name in ("nuscenes_0.jpg", "sunrgbd_0.jpg"):
        data = open(osp.join(DEFAULT_DIR, name), "rb").read()
        png = encode_png(jpeg.decode_bytes(data))
        h, w = index[name]["shape"][:2]
        times[f"jpeg_decode_ms_{h}x{w}"] = median_ms(
            lambda i: jpeg.decode_bytes(data), 5)
        times[f"read_rgb_jpeg_ms_{h}x{w}"] = median_ms(
            lambda i: read_rgb(data), 5)
        times[f"read_rgb_png_ms_{h}x{w}"] = median_ms(
            lambda i: read_rgb(png), 5)
    print(f"{tag} JPEG fixtures: {decoded} decoded bit for bit to PIL's "
          f"pixels (SHA-256), {refused} refused by kind; decoder built in "
          f"{built:.2f} s; host ms a frame (median of 5): "
          + " ".join(f"{k}={v:.2f}" for k, v in times.items()), flush=True)
    return times


def extra_trees(work, tag):
    """The four trees at the datasets' own sizes by `tools.make_tree`, and
    the host ms a sample (median) of each dataset's read and of the read
    and the whole train chain. Returns ({name: tree}, {name: ms})."""
    import dataclasses
    import os.path as osp

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data import build_train_pipeline
    from gedepth_tpu_torch.tools import make_tree
    from gedepth_tpu_torch.train.loop import build_train_dataset

    trees, host = {}, {}
    t0 = time.perf_counter()
    for name in ("cityscapes", "nuscenes", "sunrgbd", "custom"):
        root = osp.join(work, name)
        size = {"size": EXTRA_SIZES[name]} if name in EXTRA_SIZES else {}
        trees[name] = dict(make_tree.WRITERS[name](root, seed=SEED, **size),
                           root=root)
    made = time.perf_counter() - t0
    base = get_config(EXTRA_PRESET)
    for name in ("cityscapes", "nuscenes", "sunrgbd"):
        cfg = base.replace(data=dataclasses.replace(
            base.data, dataset=name, data_root=trees[name]["root"],
            train_split=trees[name]["train"], test_split=trees[name]["test"],
            crop_size=(352, 704) if name != "sunrgbd" else (416, 544)))
        train = build_train_dataset(cfg)
        chain = build_train_pipeline(cfg.data, cfg.model.depth_scale)
        sample = chain(train[0], np.random.default_rng(0))
        if (sample["img"].shape != (*cfg.data.crop_size, 3)
                or not np.isfinite(sample["depth_gt"]).all()
                or not (sample["depth_gt"] > 0).any()):
            fail(f"{tag} {name} train chain: {sample['img'].shape}")
        host[f"{name}_load"] = median_ms(lambda i: train[i % len(train)], 4)
        host[f"{name}_load_and_chain"] = median_ms(
            lambda i: chain(train[i % len(train)],
                            np.random.default_rng(i)), 4)
    print(f"{tag} Cityscapes {EXTRA_SIZES['cityscapes']}, nuScenes "
          f"{EXTRA_SIZES['nuscenes']} and SUN RGB-D {EXTRA_SIZES['sunrgbd']}"
          f" trees and the custom folder written in {made:.1f} s; host ms "
          "a sample (median): "
          + " ".join(f"{k}={v:.1f}" for k, v in host.items()), flush=True)
    return trees, host


def extra_training(trees, work, tag):
    """`tools.train depthformer_baseline_kitti --max-iters 2
    --eval-max-images 1` on the Cityscapes tree (crop 352x704, batch 2;
    the evaluation at 1024x2048, flip-TTA), in this process so that
    cuDNN's choices of phase 7's shapes serve: A, B and C launched as the
    steps and the evaluation need, the step by CUDA events, the peak.
    Returns the summary."""
    import contextlib as cl
    import io
    import os.path as osp

    from gedepth_tpu_torch.tools import train as train_cli
    from gedepth_tpu_torch.train import loop

    tree = trees["cityscapes"]
    counters = _kernel_counters()
    event_ms = []
    real_step_for = loop.train_step_for

    def timed_step_for(cfg):
        step = real_step_for(cfg)

        def run(state, batch):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = step(state, batch)
            b.record()
            b.synchronize()
            event_ms.append(a.elapsed_time(b))
            return out
        return run

    run_dir = osp.join(work, "run")
    reset_counts(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(loop, "train_step_for", timed_step_for), \
            cl.redirect_stdout(out):
        train_cli.main([EXTRA_PRESET, "--max-iters", str(EXTRA_STEPS),
                        "--eval-max-images", "1", "--work-dir", run_dir,
                        "--options", "data.dataset=cityscapes",
                        f"data.data_root={tree['root']}",
                        f"data.train_split={tree['train']}",
                        f"data.test_split={tree['test']}",
                        "train.global_batch=2", "train.log_interval=1"])
    seconds = time.perf_counter() - t0
    launches, by_queries = read_counts(counters)
    with open(osp.join(run_dir, "train.log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if r["mode"] == "train"]
    vals = [r for r in records if r["mode"] == "val"]
    best = json.loads(out.getvalue().strip().splitlines()[-1])
    if (len(steps) != EXTRA_STEPS or len(vals) != 1 or vals[0]["images"] != 1
            or not all(np.isfinite(r[k]) for r in steps
                       for k in ("loss", "loss_depth", "grad_norm"))
            or not all(np.isfinite(vals[0][k]) for k in ("abs_rel", "rmse"))
            or best["iter"] != EXTRA_STEPS):
        fail(f"{tag} tools.train on Cityscapes: {steps} {vals} {best}")
    # flip-TTA: two forwards of the one evaluated frame
    forwards = 2
    want = {"window_attention": A_STEP * EXTRA_STEPS + A_FORWARD * forwards,
            "msda": 2 * EXTRA_STEPS + 2 * forwards,
            "msda_backward": 2 * EXTRA_STEPS, "pe_fusion": 0}
    want_q = {"msda": {**{q: EXTRA_STEPS for q in EXTRA_TRAIN_QUERIES},
                       **{q: forwards for q in EXTRA_EVAL_QUERIES}},
              "msda_backward": {q: EXTRA_STEPS for q in EXTRA_TRAIN_QUERIES}}
    if launches != want or by_queries != want_q:
        fail(f"{tag} launches {launches} by queries {by_queries}, expected "
             f"{want} and {want_q}")
    summary = {"step_event_ms": event_ms[1:], "first_step_event_ms":
               event_ms[0], "step_peak_mib": steps[-1]["peak_mem_mib"],
               "first_step_peak_mib": steps[0]["peak_mem_mib"],
               "eval_s": vals[0]["time"], "seconds": seconds,
               "launches": launches, "launches_by_queries": by_queries}
    print(f"{tag} tools.train {EXTRA_PRESET} on the Cityscapes tree (crop "
          f"352x704, batch 2, {EXTRA_STEPS} steps, evaluation of one "
          f"1024x2048 frame, flip-TTA): {seconds:.1f} s; losses "
          f"{[round(r['loss'], 6) for r in steps]}; val abs_rel "
          f"{vals[0]['abs_rel']:.4f}; {json.dumps(summary)}", flush=True)
    return summary


def extra_custom(trees, work, tag):
    """`tools.test depthformer_baseline_kitti --format-only` on the custom
    folder, its first two frames (a PNG, a JPEG): one uint16 PNG each at
    the frame's own size."""
    import contextlib as cl
    import io
    import os
    import os.path as osp

    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.utils.png import read_png

    out_dir = osp.join(work, "format")
    t0 = time.perf_counter()
    with cl.redirect_stdout(io.StringIO()):
        test_cli.main([EXTRA_PRESET, "--max-images", "2", "--format-only",
                       "--format-dir", out_dir, "--options",
                       "data.dataset=custom",
                       f"data.data_root={trees['custom']['root']}"])
    seconds = time.perf_counter() - t0
    written = sorted(os.listdir(out_dir))
    shapes = {n: read_png(osp.join(out_dir, n)).shape for n in written}
    if shapes != {"frame_a.png": (375, 1242), "frame_b.png": (530, 730)}:
        fail(f"{tag} tools.test --format-only on the custom folder wrote "
             f"{shapes}")
    print(f"{tag} tools.test --format-only on the custom folder (a PNG, a "
          f"JPEG): {shapes} as uint16 PNGs in {seconds:.1f} s", flush=True)
    return seconds


def _asn_run(head, inputs, loss_fn, device, dtype=torch.float32):
    """One forward and backward of `head` (a copy on `device` in `dtype`,
    train mode): (outputs and losses on the CPU, gradients on the CPU,
    host ms)."""
    import copy

    model = copy.deepcopy(head).to(device, dtype).train()
    args = [([x.to(device, dtype) for x in a] if isinstance(a, list)
             else a.to(device, dtype)) for a in inputs]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, losses = loss_fn(model, *args)
    sum(losses.values()).backward()
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = {k: v.detach().cpu() for k, v in {**out, **losses}.items()}
    return got, {n: p.grad.detach().cpu()
                 for n, p in model.named_parameters()}, ms


# float64 on both sides: the card computes the CPU's function to rounding
ASN_F64_RTOL = 1e-9


def _hold_asn(tag, name, card, cpu, normals, f64=False):
    """The card's forward and backward against the CPU's. f32: outputs and
    losses rtol 1e-4, atol 1e-5 of each map's largest magnitude; each key
    of `normals` to its (inside, 1-pixel border) bounds in absolute
    error, and 1e-5 on average: an adaptive normal is the normalised
    softmax mix of its window's triangle normals, which nearly cancel
    where the depth is rough (as the seeded heads' depth is) and most at
    the border, whose zero-padded taps make near-degenerate triangles (the
    JAX package's oracle test holds 1e-5 inside, 2e-2 at the border); a
    difference normal divides a difference of nearly equal depths by the
    depth; gradients within 5e-3 of the CPU's in L2 plus 1e-6 of the
    largest: the heads' convolutions feed train-mode BatchNorms, whose
    backward sums ~1e4 positions of a centred gradient. f64: everything,
    normals too, within `ASN_F64_RTOL` (atol a tenth of it at the largest
    magnitude), gradients within it plus 1e-12 of the largest. Returns the
    largest
    relative gradient distance."""
    (out_g, grad_g, _), (out_c, grad_c, _) = card, cpu
    rtol = ASN_F64_RTOL if f64 else 1e-4
    kind = "float64" if f64 else "f32"
    for key, want in out_c.items():
        got = out_g[key]
        scale = max(want.abs().max().item(), 1.0)
        if key in normals and not f64:
            inside, border = normals[key]
            err = (got - want).abs()
            err_in = err[:, 1:-1, 1:-1].max().item()
            print(f"  {tag} {name} {key}, card against CPU ({kind}): "
                  f"max_abs_err inside={err_in:.3e} (atol {inside:g}) "
                  f"everywhere={err.max().item():.3e} (atol {border:g}) "
                  f"mean_abs_err={err.mean().item():.3e} (1e-5)", flush=True)
            if not (err_in <= inside and err.max().item() <= border
                    and err.mean().item() <= 1e-5):
                fail(f"{tag} {name} {key} on the card disagrees with the "
                     "CPU's")
        else:
            compare(f"{tag} {name} {key}, card against CPU ({kind})", got,
                    want, rtol=rtol, atol=rtol * 0.1 * scale)
    top = max(g.norm().item() for g in grad_c.values())
    grad_rtol, floor = (ASN_F64_RTOL, 1e-12) if f64 else (5e-3, 1e-6)
    worst = 0.0
    for n, want in grad_c.items():
        err = (grad_g[n] - want).norm().item()
        if not torch.isfinite(grad_g[n]).all() or err > (
                grad_rtol * want.norm().item() + floor * top):
            fail(f"{tag} {name} {kind} gradient of {n}: {err:.3e} from the "
                 f"CPU's (norm {want.norm().item():.3e}, rtol "
                 f"{grad_rtol:g})")
        worst = max(worst, err / max(want.norm().item(), 1e-30))
    print(f"  {tag} {name} gradients, card against CPU ({kind}): largest "
          f"relative L2 distance {worst:.3e} (rtol {grad_rtol:g})",
          flush=True)
    return worst


def extra_asn_heads(tag):
    """ASNDepthHeadV2 at NYU width (features (2, 60, 80, 128), x8 to
    480x640, k = 3, 40 triangle samples, NYU's intrinsics) with
    asn_losses' supervised, smoothness and normal terms, and ASNDepthHead
    on densedepth_kitti's ResNet-50 pyramid of a 352x1216 frame with
    SigLoss: forward and backward on the card beside the CPU from weights
    seeded here, in f32, and in float64 at a cut size (the first sample of
    the V2 batch; the pyramid of a 176x608 frame), which keeps the CPU's
    float64 halves to ~6 s (21 s at the f32 shapes) (`_hold_asn`'s
    tolerances). Returns the summary."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.models.asn import ASNDepthHeadV2, asn_losses
    from gedepth_tpu_torch.models.experiment_heads import ASNDepthHead
    from gedepth_tpu_torch.models.layers import init_weights
    from gedepth_tpu_torch.models.losses import sigloss

    def both(name, model, inputs, inputs64, loss_fn, normals):
        """f32 runs on `inputs` and float64 runs on `inputs64`, on the card
        and the CPU, held pairwise: (runs by (device, dtype), their
        summary)."""
        runs = {(dev, dt): _asn_run(model, x, loss_fn, dev, dt)
                for dt, x in ((torch.float32, inputs),
                              (torch.float64, inputs64))
                for dev in ("cuda", "cpu")}
        worst = {kind: _hold_asn(tag, name, runs["cuda", dt],
                                 runs["cpu", dt], normals,
                                 f64=dt == torch.float64)
                 for kind, dt in (("f32", torch.float32),
                                  ("f64", torch.float64))}
        return runs, {
            "card_ms": runs["cuda", torch.float32][2],
            "cpu_ms": runs["cpu", torch.float32][2],
            "card_ms_f64": runs["cuda", torch.float64][2],
            "cpu_ms_f64": runs["cpu", torch.float64][2],
            "worst_grad_rel": worst["f32"],
            "worst_grad_rel_f64": worst["f64"]}

    g = torch.Generator().manual_seed(SEED)
    summary = {}
    # ASNDepthHeadV2 at NYU width
    v2 = ASNDepthHeadV2(input_features_dim=128)
    init_weights(v2, g)
    feats = torch.randn(2, 60, 80, 128, generator=g)
    K = torch.tensor(NYU_K).expand(2, 3, 3).contiguous()
    gt = torch.rand(2, 480, 640, generator=g) * 9.5 + 0.5
    gt[:, :40] = 0.0                               # rows without depth
    rgb = torch.randn(2, 480, 640, 3, generator=g)
    sn = torch.nn.functional.normalize(torch.randn(2, 480, 640, 3,
                                                   generator=g), dim=-1)

    def v2_loss(model, f, k, d, r, n):
        out = model(f, k)
        return out, asn_losses(out, d, r, n)

    # normals: 1e-3 inside (9e-5 measured), 2e-2 at the border
    inputs = [feats, K, gt, rgb, sn]
    runs, summary["v2"] = both("ASNDepthHeadV2", v2, inputs,
                               [x[:1] for x in inputs], v2_loss,
                               {"normals": (1e-3, 2e-2)})
    out = runs["cuda", torch.float32][0]
    if sorted(out) != ["depth", "disp", "guidance", "normals", "smooth_loss",
                       "supvised_loss", "surface_norm_loss"]:
        fail(f"{tag} ASNDepthHeadV2 gave {sorted(out)}")
    if out["normals"].shape != (2, 480, 640, 3):
        fail(f"{tag} normals {out['normals'].shape}")
    summary["v2"].update(triangles=len(v2.triplets), losses={
        k: out[k].item() for k in ("supvised_loss", "smooth_loss",
                                   "surface_norm_loss")})
    # ASNDepthHead on densedepth_kitti's pyramid at 352x1216
    zoo = get_config("densedepth_kitti").model.build(
        device="cuda", generator=torch.Generator().manual_seed(SEED)).eval()
    img = torch.randn(1, 3, 352, 1216, generator=g)
    with torch.no_grad():
        pyramid, pyramid64 = ([x.permute(0, 2, 3, 1).cpu()
                               for x in zoo.backbone(frame.cuda())]
                              for frame in (img, img[..., :176, :608]))
    del zoo
    widths = tuple(x.shape[-1] for x in pyramid)
    head = ASNDepthHead(widths, focal=721.5, max_depth=80.0)
    init_weights(head, g)
    gt1 = torch.rand(1, *pyramid[0].shape[1:3], generator=g) * 79 + 1

    def head_loss(model, feats, d):
        depth, normals = model(feats)
        return ({"depth": depth, "normals": normals},
                {"sigloss": sigloss(depth[..., 0], d)})

    # difference normals: 1e-2 (3.8e-3 measured)
    runs, summary["head"] = both("ASNDepthHead", head, [pyramid, gt1],
                                 [pyramid64, gt1[:, :88, :304]], head_loss,
                                 {"normals": (1e-2, 1e-2)})
    depth = runs["cuda", torch.float32][0]["depth"]
    if depth.shape != (1, 176, 608, 1):
        fail(f"{tag} ASNDepthHead depth {depth.shape}")
    summary["head"]["pyramid"] = [list(x.shape) for x in pyramid]
    print(f"{tag} ASN heads, card against CPU (forward and backward, f32 "
          "and float64): "
          f"{json.dumps(summary)}", flush=True)
    return summary


def phase_extra(work):
    """Phase 39: the JPEG fixtures through the port's decoder, the four
    extra trees at their datasets' sizes, `depthformer_baseline_kitti`
    trained and evaluated on Cityscapes by `tools.train` (A, B and C
    launched), `tools.test --format-only` on a custom folder, and the ASN
    heads on the card against the CPU."""
    tag = "[extra]"
    t0 = time.perf_counter()
    times = {"jpeg": jpeg_fixtures(tag)}
    t1 = time.perf_counter()
    trees, times["host_ms"] = extra_trees(work, tag)
    t2 = time.perf_counter()
    times["train"] = extra_training(trees, work, tag)
    t3 = time.perf_counter()
    extra_custom(trees, work, tag)
    t4 = time.perf_counter()
    times["asn"] = extra_asn_heads(tag)
    t5 = time.perf_counter()
    times["seconds"] = {"jpeg": t1 - t0, "trees": t2 - t1, "train": t3 - t2,
                        "custom": t4 - t3, "asn": t5 - t4, "all": t5 - t0}
    print(f"{tag} {json.dumps(times)}", flush=True)
    return times["train"]["launches"]


# ---- phases 31-33: serving export, a bf16 export, the serving tools ----

PORT_OPS = ["gedepth_torch::msda", "gedepth_torch::pe_fusion",
            "gedepth_torch::window_attention"]
# per flip-TTA forward pair of the main preset: 24 Swin blocks, the two
# deformable attentions, one fusion, each twice
EXPORT_NODES = {"gedepth_torch::window_attention": 48,
                "gedepth_torch::msda": 4, "gedepth_torch::pe_fusion": 2}
# what must not be loaded in a process that serves an artifact
NO_MODEL_CODE = ("gedepth_tpu_torch.models", "gedepth_tpu_torch.configs",
                 "jax", "gedepth_tpu")


def served_inputs(handle, requests):
    """The requests as the exported program takes them: each RGB with the
    handle's plane embedding through the preset's test pipeline, as
    `inference_depther` forms them, (1, 352, 1216, 5) f32."""
    from gedepth_tpu_torch.geometry.plane import clip_pe_for_input

    pe = handle.pe_raw
    pe_in = clip_pe_for_input(pe, handle.cfg.model.depth_scale)
    out = []
    for rgb, _ in requests:
        img = np.concatenate([rgb.astype(np.float32), pe_in[..., None],
                              pe[..., None]], axis=-1)
        img = handle.pipeline({"img": img, "cam_height": np.float32(
            handle.cfg.model.default_cam_height)})["img"]
        out.append(np.ascontiguousarray(img[None], np.float32))
    return out


def check_program(exported, meta, tag):
    """The port's ops in an exported main-preset program: the op names, as
    many nodes as the eager step's launches, and kernel A's k and v handed
    over as views of the packed qkv (selects, no copies)."""
    from gedepth_tpu_torch.apis.export import program_ops

    names = [(n, n.target.name()) for n in exported.graph.nodes
             if hasattr(n.target, "name")]
    counts = {op: sum(name == op for _, name in names) for op in PORT_OPS}
    if meta["ops"] != program_ops(exported) or meta["ops"] != PORT_OPS \
            or counts != EXPORT_NODES:
        fail(f"{tag} the program's ops {meta['ops']} {counts}, want "
             f"{EXPORT_NODES}")
    kv = {a.target.name() for n, name in names
          if name == "gedepth_torch::window_attention" for a in n.args[1:3]}
    if kv != {"aten::select.int"}:
        fail(f"{tag} kernel A's k and v come from {kv}, not views")
    return counts


def serve_exported_worker(art, work):
    """`chip_smoke.py --serve-exported ART WORK`, phase 31's fresh process:
    load the artifact with `load_exported` (torch and the port's ops only),
    serve WORK/request_*.npy, write WORK/depth_*.npy and print one JSON
    line: the load seconds, the host ms of each request, the kernels'
    launches over the requests and the modules of the port, JAX or the JAX
    package this process loaded."""
    import glob
    import os.path as osp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    from gedepth_tpu_torch.apis.export import load_exported
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    served = load_exported(art)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    counters = {"window_attention": wa.window_attention,
                "msda": msda_ops.msda, "pe_fusion": pe_ops.pe_fusion}
    for c in counters.values():
        c.launches = 0
    host_ms = []
    for i, path in enumerate(sorted(glob.glob(osp.join(work,
                                                       "request_*.npy")))):
        img = np.load(path)
        torch.cuda.synchronize()
        t = time.perf_counter()
        depth = served.predict(img)
        host_ms.append((time.perf_counter() - t) * 1e3)
        np.save(osp.join(work, f"depth_{i}.npy"), depth)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gedepth_tpu",
                                           "gedepth_tpu_torch"))
    print(json.dumps({"load_s": load_s, "host_ms": host_ms,
                      "launches": {k: c.launches
                                   for k, c in counters.items()},
                      "modules": loaded}), flush=True)
    return 0


def _event_and_host_ms(fn, n):
    """Median CUDA-event ms and median synchronised host ms of n calls."""
    dev, host = [], []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(host)


def phase_export(handle, requests, work):
    """Phase 31: the main preset exported at full width (352x1216, batch 1,
    flip-TTA, f32) by `apis.export.export_depther`, saved, and loaded in a
    fresh process that imports no model or config code
    (`--serve-exported`): its depth of each request bit-equal to the eager
    `inference_depther` of the same weights, and kernels A, B and E
    launched inside the loaded program (48, 4 and 2 a request). Then the
    program, as exported here, timed against the eager eval step in turns.
    Returns the launches counted in the fresh process."""
    import os
    import os.path as osp

    from gedepth_tpu_torch.apis import inference_depther
    from gedepth_tpu_torch.apis.export import export_depther, save_exported

    art = osp.join(work, "art")
    t0 = time.perf_counter()
    exported, weights, meta = export_depther(PRESET, device="cuda")
    export_s = time.perf_counter() - t0
    counts = check_program(exported, meta, "[export]")
    t0 = time.perf_counter()
    save_exported(art, exported, weights, meta)
    save_s = time.perf_counter() - t0
    size = {f: os.path.getsize(osp.join(art, f)) for f in os.listdir(art)}
    print(f"[export] export_depther({PRESET!r}): {export_s:.1f} s (the "
          f"trace {meta['export_seconds']:.1f} s), save {save_s:.1f} s, "
          f"bytes {size}; ops {counts}; kernel A's k and v are views of "
          "the packed qkv", flush=True)
    inputs = served_inputs(handle, requests)
    want = [inference_depther(handle, rgb) for rgb, _ in requests]
    for i, img in enumerate(inputs):
        np.save(osp.join(work, f"request_{i}.npy"), img)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, osp.abspath(__file__), "--serve-exported", art,
         work], capture_output=True, text=True, timeout=600)
    worker_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"[export] the serving process exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    line = _json_tail(proc.stdout)
    banned = [m for m in line["modules"]
              if any(m == b or m.startswith(b + ".") for b in NO_MODEL_CODE)]
    if banned:
        fail(f"[export] the serving process loaded {banned}")
    n = len(requests)
    if line["launches"] != {"window_attention": 24 * 2 * n, "msda": 4 * n,
                            "pe_fusion": 2 * n}:
        fail(f"[export] launches inside the loaded program: "
             f"{line['launches']}")
    worst = 0.0
    for i, w in enumerate(want):
        got = np.load(osp.join(work, f"depth_{i}.npy"))
        if got.shape != (1, 352, 1216):
            fail(f"[export] request {i}: depth shape {got.shape}")
        worst = max(worst, float(np.abs(got[0] - w).max()))
        if not np.array_equal(got[0], w):
            fail(f"[export] request {i}: the loaded program's depth is not "
                 f"the eager one's (max |diff| {worst})")
    print(f"[export] fresh process ({worker_s:.1f} s): load_exported "
          f"{line['load_s']:.1f} s, request host ms "
          f"{[round(x, 1) for x in line['host_ms']]}, launches "
          f"{line['launches']} over {n} requests; depth bit-equal to the "
          f"eager inference_depther for all {n} (max |diff| {worst}); "
          f"modules of the port it loaded: {len(line['modules'])}, none of "
          f"{NO_MODEL_CODE}", flush=True)

    # the program as exported (the one the fresh process loaded from
    # model.pt2) against the eager step, in this process
    x = torch.from_numpy(inputs[0]).cuda()
    cam = torch.full((1,), handle.cfg.model.default_cam_height,
                     device="cuda")
    program = functools.partial(exported.module(), weights, x, cam)
    eager = functools.partial(handle.eval_step, x, cam)
    times = {"exported": [], "eager": []}
    with torch.inference_mode():
        for name in ("eager", "exported", "exported", "eager"):
            times[name].append(_event_and_host_ms(
                program if name == "exported" else eager, EXPORT_REPS))
    record = {"export_s": export_s, "trace_s": meta["export_seconds"],
              "save_s": save_s, "bytes": sum(size.values()),
              "load_s_fresh": line["load_s"]}
    for name, runs in times.items():
        record[f"{name}_event_ms"] = [round(d, 3) for d, _ in runs]
        record[f"{name}_host_ms"] = [round(h, 3) for _, h in runs]
    print(f"[export] flip-TTA request, {EXPORT_REPS} calls a turn (median "
          f"ms; eager, exported, exported, eager): {json.dumps(record)}",
          flush=True)
    del exported, weights, program
    torch.cuda.empty_cache()
    return line["launches"]


EXPORT_REPS = 5


def phase_export_bf16(requests):
    """Phase 32: the main preset exported as a whole-model bf16 eval step
    (`bf16=True`) and run as exported (phase 31 saved and loaded the f32
    program): one request bit-equal to the eager bf16 step, and the bf16
    instances of A and B (and E, f32, the wrapper lifting) launched inside
    the program."""
    from gedepth_tpu_torch.apis import init_depther
    from gedepth_tpu_torch.apis.export import export_depther
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    exported, weights, meta = export_depther(PRESET, bf16=True,
                                             device="cuda")
    export_s = time.perf_counter() - t0
    check_program(exported, meta, "[export bf16]")
    handle = init_depther(PRESET, device="cuda", bf16=True, seed=SEED,
                          pe_raw=requests[0][1])
    x = torch.from_numpy(served_inputs(handle, requests[:1])[0]).cuda()
    cam = torch.full((1,), handle.cfg.model.default_cam_height,
                     device="cuda")
    counters = {"window_attention": wa.window_attention,
                "msda": msda_ops.msda, "pe_fusion": pe_ops.pe_fusion}
    reset_counts(counters)
    with torch.inference_mode():
        got = exported.module()(weights, x, cam)
    torch.cuda.synchronize()
    launches, _ = read_counts(counters)
    dtypes = read_dtypes(counters)
    want = handle.eval_step(x, cam)
    if launches != {"window_attention": 48, "msda": 4, "pe_fusion": 2} or \
            dtypes["window_attention"] != {"bf16": 48} or \
            dtypes["msda"] != {"bf16": 4}:
        fail(f"[export bf16] launches {launches}, instances {dtypes}")
    if got.dtype != torch.float32 or not torch.equal(got, want):
        fail(f"[export bf16] depth differs from the eager bf16 step: max "
             f"|diff| {(got - want).abs().max().item()}")
    size = sum(t.numel() * t.element_size() for t in weights.values())
    print(f"[export bf16] export_depther({PRESET!r}, bf16=True): "
          f"{export_s:.1f} s, weights {size} bytes; one request bit-equal "
          f"to the eager bf16 step; launches {launches}, instances "
          f"{dtypes}", flush=True)
    del exported, weights, handle
    torch.cuda.empty_cache()


def phase_serving_tools(tree, npz):
    """Phase 33: `tools.inference` (two frames of the KITTI tree's first
    date with its plane embedding, --npy) and `tools.test --show-dir
    --format-only` (the tree's 2 test frames) with the weights of `npz`:
    each colour PNG equals `colorize_depth` of its depth, each 16-bit PNG
    the prediction x 256 clipped and truncated, every depth finite and in
    range."""
    import contextlib as cl
    import glob
    import io
    import os
    import os.path as osp

    from gedepth_tpu_torch.tools import inference as inference_cli
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.utils.color_depth import colorize_depth
    from gedepth_tpu_torch.utils.png import read_png

    date = sorted(os.listdir(osp.join(tree["root"], "input")))[0]
    frames = sorted(glob.glob(osp.join(tree["root"], "input", date, "*",
                                       "image_02", "data", "*.png")))[:2]
    pe = osp.join(tree["root"], "input", date, "pe", "pe_165.npy")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with cl.redirect_stdout(io.StringIO()):
            inference_cli.main([PRESET, npz, *frames, "--pe", pe,
                                "--out-dir", out, "--npy"])
        inference_s = time.perf_counter() - t0
        for frame in frames:
            stem = osp.join(out, osp.splitext(osp.basename(frame))[0])
            depth = np.load(stem + "_depth.npy")
            if depth.shape != (352, 1216) or not np.isfinite(depth).all() \
                    or depth.min() < 1e-3 - 1e-6 or depth.max() > 80 + 1e-4:
                fail(f"[serving tools] tools.inference {frame}: depth "
                     f"{depth.shape} {depth.min()}..{depth.max()}")
            if not np.array_equal(read_png(stem + "_depth.png"),
                                  colorize_depth(depth)):
                fail(f"[serving tools] {stem}_depth.png is not the depth's "
                     "colour render")
        preds = {}
        real_write = test_cli.write_outputs

        def recording(args, cfg, dataset, index, pred):
            preds[test_cli.output_stem(dataset, index)] = pred
            real_write(args, cfg, dataset, index, pred)

        show, fmt = osp.join(out, "show"), osp.join(out, "fmt")
        t0 = time.perf_counter()
        with mock.patch.object(test_cli, "write_outputs", recording), \
                cl.redirect_stdout(io.StringIO()):
            test_cli.main([PRESET, npz, "--show-dir", show, "--format-only",
                           "--format-dir", fmt, "--options",
                           f"data.data_root={tree['root']}",
                           f"data.test_split={tree['test']}"])
        test_s = time.perf_counter() - t0
        if len(preds) != 2 or sorted(os.listdir(fmt)) != sorted(
                f"{s}.png" for s in preds):
            fail(f"[serving tools] tools.test --format-only wrote "
                 f"{os.listdir(fmt)} for {sorted(preds)}")
        for stem, pred in preds.items():
            out16 = read_png(osp.join(fmt, stem + ".png"))
            if not np.array_equal(out16, np.clip(pred * 256.0, 0, 65535)
                                  .astype(np.uint16)):
                fail(f"[serving tools] {stem}.png is not pred x 256")
            if not np.array_equal(read_png(osp.join(show,
                                                    stem + "_depth.png")),
                                  colorize_depth(pred)):
                fail(f"[serving tools] {stem}_depth.png is not the "
                     "prediction's colour render")
    print(f"[serving tools] tools.inference {len(frames)} frames with --pe "
          f"--npy: {inference_s:.1f} s; tools.test --show-dir --format-only "
          f"on the KITTI tree's {len(preds)} test frames: {test_s:.1f} s; "
          "every PNG read back equal to its depth", flush=True)


RUN_TAG = "CHIP_SMOKE_RUN"  # in the environment of each process a run starts


def own_processes():
    """(pid, command line) of every live process but this one whose
    environment holds this run's RUN_TAG: each process the run started,
    also one that left its process tree (torchrun's workers run in a
    session of their own, a loader worker is the forkserver's child)."""
    import os

    tag = f"{RUN_TAG}={os.environ[RUN_TAG]}".encode()
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                if tag not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:         # gone meanwhile, or not ours to read
            continue
        found.append((int(entry), cmd.strip()))
    return found


def stop_processes(grace=10.0):
    """Stop every process this run started that still runs: first the
    loader's forkserver and resource tracker (`stop_worker_server`), then
    whatever else `own_processes` finds, by SIGTERM and after `grace`
    seconds SIGKILL; reaps this process's children. Returns what ran
    before any was stopped."""
    import os
    import signal

    running = own_processes()
    with contextlib.suppress(ImportError):      # run alone, without the repo
        from gedepth_tpu_torch.data.loader import stop_worker_server
        stop_worker_server()
    deadline = time.perf_counter() + grace
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid, _ in own_processes():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        while own_processes() and time.perf_counter() < deadline:
            time.sleep(0.1)
        deadline = time.perf_counter() + grace
    while True:                                 # reap the children
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                break
        except ChildProcessError:
            break
    return running


def main():
    import os

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank-step"]:
        return rank_step_worker(sys.argv[2])
    if sys.argv[1:2] == ["--serve-exported"]:
        return serve_exported_worker(*sys.argv[2:4])
    os.environ[RUN_TAG] = f"{os.getpid()}-{time.time_ns()}"
    try:
        with contextlib.ExitStack() as stack:
            return run(stack)
    finally:
        running = stop_processes()
        if running:
            print(f"chip_smoke: stopped the processes still running: "
                  f"{running}", file=sys.stderr)


def run(stack):
    started = last = time.perf_counter()
    laps = []

    def lap(name):
        # host-clock seconds of the phases since the last lap
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[time] {name}: {now - last:.1f} s ({now - started:.1f} s "
              "since the start)", flush=True)
        laps.append((now - last, name))
        last = now

    smi = phase_device()
    built = phase_build()
    trees = phase_trees(stack.enter_context(tempfile.TemporaryDirectory()),
                        before_timing=built)
    lap("device, the build beside the KITTI and DDAD trees (phases 1, 2, "
        "23)")
    # every kernel against its plain version first, while the process is
    # young: `torch.profiler` loses device activities later on
    results = phase_kernels()
    results["msda_backward"] = phase_kernel_c()
    lap("kernels f32 (phases 3, 6)")
    bf16_results = phase_kernels_bf16()
    lap("kernels bf16 (phase 13)")
    rule_results = phase_rule_kernels()
    lap("sampling rules (phase 9)")
    ddad_results = phase_kernels_ddad()
    lap("kernels at DDAD shapes (phase 24)")
    bins_results = phase_kernels_binsformer()
    lap("kernels at BinsFormer's shapes (phase 37)")
    handle, requests, serving_launches = phase_main_path()
    phase_whole_forward(handle, requests)
    lap("serving, whole forward (phases 4, 5)")
    with tempfile.TemporaryDirectory() as work:
        export_launches = phase_export(handle, requests, work)
        del handle
        torch.cuda.empty_cache()
        lap("serving export, a fresh serving process (phase 31)")
    phase_export_bf16(requests)
    lap("bf16 serving export (phase 32)")
    launches, _, _, f32_peak, kitti_step_ms = phase_train(
        tree_data(PRESET, trees["kitti"]))
    phase_tools_test(trees["kitti"])
    phase_whole_step()
    lap("train and evaluation from the KITTI tree, whole step (phases 7, "
        "8)")
    phase_remat(trees["kitti"])
    lap("remat on and off, the preset's global batch (phase 34)")
    # weights in and out, while cuDNN's choices for the train crop are warm
    with tempfile.TemporaryDirectory() as work:
        best_npz, best_weights = phase_checkpoints(work)
        lap("checkpointed training, restore, resume (phase 20)")
        parity_npz = phase_weights_in(work, best_npz, best_weights, requests)
        del best_weights
        lap("weights in: .npz and reference .pth (phase 21)")
        phase_serving_tools(trees["kitti"], best_npz)
        lap("tools.inference, tools.test --show-dir --format-only (phase "
            "33)")
        phase_compat_check(parity_npz)
        lap("compat_check (phase 22)")
        phase_dress_rehearsal(work)
        lap("official Swin-L-384 file to the protocol step (phase 35)")
    ddad_serving = phase_ddad_serving(trees["ddad"])
    ddad_launches, ddad_by_queries, _, ddad_peak, ddad_step_ms = phase_train(
        tree_data(DDAD, trees["ddad"]), preset=DDAD, steps=5,
        tag="[train ddad]", queries=(DDAD_SELF, DDAD_CROSS),
        eval_forwards=EVAL_IMAGES, eval_queries=(DDAD_SELF, DDAD_CROSS))
    host = trees["host_ms"]
    for name, step_ms in (("kitti", kitti_step_ms), ("ddad", ddad_step_ms)):
        need = 2 * host[f"{name}_load_and_chain"]
        print(f"[loader] {name}: one loader thread would prepare a batch "
              f"of 2 in ~{need:.0f} ms against a {step_ms:.0f} ms step: "
              + ("it would bound training" if need > step_ms else
                 "the step bounds training")
              + " (the presets load with 4 workers; phase 27 times them)",
              flush=True)
    lap("DDAD serving, training and evaluation from the tree (phases 25, "
        "26)")
    phase_loader_workers(trees, {"kitti": kitti_step_ms, "ddad": ddad_step_ms})
    lap("loader workers (phase 27)")
    exact, preset_launches = phase_presets(requests)
    _, exact_train, _, _, _ = phase_train(
        synthetic_data(), preset=EXACT, steps=3, tag="[train exact]",
        queries=(20570, 61952),
        nonzero=("neck.reference_points.weight",
                 "neck.multi_att.sampling_offsets.weight",
                 "neck.self_attn.sampling_offsets.weight"))
    phase_evaluator(exact.model)
    lap("presets, exact train, evaluation (phases 10-12)")
    # bf16: the parity preset, the other scopes, accuracy on seeded weights,
    # bf16 evaluation, bf16-compute training, f32 beside bf16 in one process
    parity_a = phase_parity(requests)
    b_bf16 = phase_scopes(requests)
    whole, counted = phase_accuracy(exact, requests)
    b_bf16.update(counted)
    del exact
    phase_eval_bf16(whole)
    lap("parity, scopes, accuracy, bf16 evaluation (phases 14-17)")
    del whole
    torch.cuda.empty_cache()
    _, bf16_by_queries, bf16_dtypes, bf16_peak, _ = phase_train(
        synthetic_data(), steps=3, tag="[train bf16]", bf16=True,
        nonzero=TRAIN_GRADS + ("neck.multi_att.sampling_offsets.weight",
                               "neck.multi_att.attention_weights.weight"))
    print(f"[train bf16] peak device memory of a step {bf16_peak:.1f} MiB "
          f"with bf16_compute against {f32_peak:.1f} MiB in f32 (phase 7)",
          flush=True)
    lap("bf16 training (phase 18)")
    phase_benchmark()
    lap("f32 beside bf16 (phase 19)")
    phase_two_ranks(trees["kitti"])
    lap("two ranks on one card (phase 28)")
    phase_nccl_world_one(trees["kitti"])
    lap("torchrun, NCCL, a world of one (phase 29)")
    phase_pretrain(trees["kitti"])
    lap("stage-1 pretraining and the backbone overlay (phase 30)")
    bins_counted = phase_zoo(trees, requests)
    lap("the zoo's bts_kitti, densedepth_kitti, dpt_kitti, adabins_nyu and "
        "binsformer_nyu (phase 36)")
    phase_seg(trees)
    lap("the seg preset ocrnet_hr18_kitti: training, evaluation (phase 38)")
    with tempfile.TemporaryDirectory() as work:
        extra_launches = phase_extra(work)
    lap("the extra datasets, JPEG, the ASN heads (phase 39)")

    sources = {
        "window_attention": ("gedepth_tpu_torch/csrc/window_attention.cu",
                             "gedepth_tpu/ops/pallas/window_attn.py:49"),
        "msda": ("gedepth_tpu_torch/csrc/msda.cu",
                 "gedepth_tpu/ops/pallas/msda_windowed.py:112"),
        "msda_backward": ("gedepth_tpu_torch/csrc/msda_bwd.cu",
                          "gedepth_tpu/ops/pallas/msda_windowed.py:898"),
        "pe_fusion": ("gedepth_tpu_torch/csrc/pe_fusion.cu",
                      "gedepth_tpu/ops/pallas/pe_fusion.py:57"),
    }
    # the bf16 instances: A and C are sources of their own; B is msda.cu
    # compiled for __nv_bfloat16 (unit msda_bf16.cu)
    sources["window_attention_bf16"] = (
        "gedepth_tpu_torch/csrc/window_attention_bf16.cu",
        sources["window_attention"][1])
    sources["msda_bf16"] = sources["msda"]
    sources["msda_backward_bf16"] = (
        "gedepth_tpu_torch/csrc/msda_bwd_bf16.cu",
        sources["msda_backward"][1])
    # the planning kernel of B's and C's unhinted launches has no TPU
    # counterpart: the TPU kernels it plans for
    sources["msda_plan"] = (
        "gedepth_tpu_torch/csrc/msda_plan.cu",
        "none (plans the tiles of msda_windowed.py:112 and :898 from the "
        "positions)")

    def row(name, kernel, t, n_train, n_serving):
        source, replaces = sources[kernel]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_train or n_serving,
                "launches_train": n_train, "launches_serving": n_serving,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "event_ms": t["event_ms"],
                "device_ms": t["device_ms"],
                "plain_device_ms": t["plain_device_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    kernels = [row(name, name, results[name], launches[name],
                   serving_launches.get(name, 0))
               for name in ("window_attention", "msda", "msda_backward",
                            "pe_fusion")]
    for k in kernels:           # inside the loaded program of phase 31
        k["launches_exported"] = export_launches.get(k["name"], 0)
        k["launches_cityscapes"] = extra_launches.get(k["name"], 0)
    # the shapes of the exact and compat presets: the launches that their
    # paths made at this shape's query count
    for name, t in rule_results.items():
        kernel, rule, shape = name.split()
        train_shape = shape.startswith("train")
        if rule == "compat" and train_shape:
            continue            # the compat preset is served, not trained
        counted = exact_train if train_shape else preset_launches[
            EXACT if rule == "exact" else COMPAT]
        n = counted[kernel].get(t["queries"], 0)
        r = row(f"{kernel}[{rule} {shape}]", kernel, t,
                n if train_shape else 0, 0 if train_shape else n)
        if "unplanned" in t["extra_ms"]:
            # the same launch over the unplanned rows
            r["unplanned_device_ms"], r["unplanned_event_ms"] = t[
                "extra_ms"]["unplanned"]
        kernels.append(r)
    # the bf16 instances, held against float64 (`max_abs_err` is that
    # error), each with its f32 instance's time at the same shape; launches
    # from the bf16 paths: A from the parity preset's requests and the
    # bf16-compute steps, B from the scope forwards and the accuracy
    # forwards, C from the bf16-compute steps
    for name, t in bf16_results.items():
        kernel = t["kernel"]
        rule, shape = name[name.index("[") + 1:-1].split()[-2:]
        train_shape = shape.startswith("train")
        if kernel == "window_attention_bf16":
            n = (bf16_dtypes["window_attention"]["bf16"] if train_shape
                 else parity_a)
        elif kernel == "msda_bf16":
            n = b_bf16.get((rule, t["queries"]), 0)
        else:
            # the bf16-compute steps of phase 18 train the windowed preset
            n = (bf16_by_queries["msda_backward"].get(t["queries"], 0)
                 if rule == "windowed" else 0)
        if n == 0:
            print(f"[kernels bf16] {name}: checked above; no bf16 path of "
                  "this run launches it, so it gets no row")
            continue
        r = row(name, kernel, t, n if train_shape else 0,
                0 if train_shape else n)
        r["against"] = "float64"
        r["f32_device_ms"], r["f32_event_ms"] = t["extra_ms"]["f32"]
        kernels.append(r)
    kernels += ddad_rows(row, ddad_results, ddad_serving, ddad_launches,
                         ddad_by_queries)
    kernels += binsformer_rows(row, bins_results, bins_counted)
    print(f"[train ddad] peak device memory of a batch-2 step {ddad_peak:.1f}"
          f" MiB at 384x640 against {f32_peak:.1f} MiB at 352x704 (phase 7)",
          flush=True)
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"kernel row {k['name']} was launched on no main path")
    costliest = "; ".join(f"{name} {sec:.1f} s"
                          for sec, name in sorted(laps, reverse=True)[:5])
    print(f"[time] total {time.perf_counter() - started:.1f} s; the five "
          f"costliest laps: {costliest}", flush=True)
    print("[processes] started by this run and still running, now stopped: "
          f"{stop_processes() or 'none'}", flush=True)
    print(f"[power] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        if PYCACHE:
            shutil.rmtree(PYCACHE, ignore_errors=True)
    sys.exit(code)
