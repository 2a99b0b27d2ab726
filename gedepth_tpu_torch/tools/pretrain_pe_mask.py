"""Stage-1 ground-mask pretraining CLI of the port (the counterpart of
tools/pretrain_pe_mask.py).

    python -m gedepth_tpu_torch.tools.pretrain_pe_mask <preset>
        [--max-iters N] [--work-dir DIR] [--device cuda]
        [--options key=value ...]

Trains `models.pretrain.GroundMaskPretrain` (the preset's Swin-L and HAHI
widths, HAHI sampling with the exact rule) in one process on the preset's
train split at its global batch: the labels are "the raw prior within 3% of
the lidar depth", the loss the class-weighted cross entropy (0.2 for
not-ground, 1.0 for ground), the optimizer the preset's AdamW recipe. It
logs to <work-dir>/train.log.jsonl (default
<cfg.work_dir>/<preset>_pe_mask_pretrain), ends with the ground-mask IoU of
4 more train batches against "the prior within 5% of the lidar depth"
(mean IoU and the >= 60 and >= 75 shares) and writes the backbone's
parameters to <work-dir>/pe_mask_backbone.npz in the JAX key layout; give
that file to `tools.train --load-backbone-from`. The last line is one JSON
object: the IoU summary, the median step time in ms (steps after the first;
on a CUDA device synchronised) and the file written. f32 runs without
TF32.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import statistics
import time

IOU_BATCHES = 4


def main(argv=None):
    from gedepth_tpu_torch.configs import (
        apply_options, get_config, list_configs)
    from gedepth_tpu_torch.utils.env import disable_tf32

    parser = argparse.ArgumentParser(
        description="Stage-1 ground-mask pretraining (PyTorch)")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from gedepth_tpu_torch.data.loader import TrainLoader, stop_worker_server
    from gedepth_tpu_torch.data.transforms import build_train_pipeline
    from gedepth_tpu_torch.eval.mask_iou import (
        MaskIoUAccumulator, pe_ground_truth_mask)
    from gedepth_tpu_torch.models.pretrain import (
        GroundMaskPretrain, mask_labels, save_backbone, weighted_ce_ignore)
    from gedepth_tpu_torch.train.loop import (
        build_train_dataset, cudnn_autotuner)
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state)

    disable_tf32()
    cfg = apply_options(get_config(args.config), args.options)
    work_dir = args.work_dir or osp.join(cfg.work_dir,
                                         cfg.name + "_pe_mask_pretrain")
    os.makedirs(work_dir, exist_ok=True)
    max_iters = args.max_iters or cfg.train.max_iters
    seed = cfg.train.seed
    device = torch.device(args.device)
    cuda = device.type == "cuda"

    loader = TrainLoader(build_train_dataset(cfg),
                         build_train_pipeline(cfg.data, cfg.model.depth_scale),
                         cfg.train.global_batch, seed=seed,
                         num_workers=cfg.train.num_workers,
                         sampling=cfg.train.sampling, pin_memory=cuda)

    def step(batch):
        model.train()
        model.set_generator(state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(batch["img"])
        loss = weighted_ce_ignore(logits.float(),
                                  mask_labels(batch["img"], batch["depth_gt"]))
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    times = []
    with contextlib.ExitStack() as stack:
        stack.callback(stop_worker_server)      # after the loader closes
        # the loader's workers start while the model is built
        batches = stack.enter_context(contextlib.closing(iter(loader)))
        model = GroundMaskPretrain.from_config(
            cfg.model, device=device,
            generator=torch.Generator().manual_seed(seed))
        state = create_train_state(model, cfg.optim, max_iters,
                                   seed=seed + 1)
        stack.enter_context(cudnn_autotuner())
        log = stack.enter_context(
            open(osp.join(work_dir, "train.log.jsonl"), "a"))
        for it in range(max_iters):
            batch = batch_to_device(next(batches), device)
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            loss = float(step(batch))
            times.append(time.perf_counter() - t0)
            if (it + 1) % cfg.train.log_interval == 0 or it + 1 == max_iters:
                log.write(json.dumps({"iter": it + 1, "mask_ce": loss,
                                      "time": times[-1], "mode": "train"})
                          + "\n")
                log.flush()
                print(f"iter {it + 1}/{max_iters} mask_ce={loss:.4f}",
                      flush=True)

        # the reference's mask-PE evaluation: per-image IoU against the
        # prior within 5% of the lidar depth, on the next train batches
        model.eval()
        acc = MaskIoUAccumulator()
        with torch.inference_mode():
            for _ in range(IOU_BATCHES):
                b = next(batches)
                img = np.asarray(b["img"])
                pred = model(torch.from_numpy(img).to(device)).argmax(-1)
                pred = pred.cpu().numpy()
                gt = np.asarray(b["depth_gt"])
                for i in range(pred.shape[0]):
                    acc.add(pred[i] == 1,
                            pe_ground_truth_mask(img[i, ..., 4], gt[i]))
        summary = acc.summary()
        log.write(json.dumps({"mode": "val", **summary}) + "\n")
    print(f"ground-mask IoU: miou={summary['miou']:.2f} "
          f">=60: {summary['frac_over_60']:.2f} "
          f">=75: {summary['frac_over_75']:.2f} (n={summary['n']})",
          flush=True)
    out = osp.join(work_dir, "pe_mask_backbone.npz")
    save_backbone(out, model)
    print(f"saved the backbone to {out}", flush=True)
    step_ms = statistics.median(times[1:] or times) * 1e3
    print(json.dumps(dict(summary, step_ms=step_ms, iters=max_iters,
                          backbone=out)))


if __name__ == "__main__":
    main()
