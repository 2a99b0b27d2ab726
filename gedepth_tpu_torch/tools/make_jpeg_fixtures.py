"""Write the JPEG fixtures of `gedepth_tpu_torch/testdata/jpeg/` with PIL.

    python -m gedepth_tpu_torch.tools.make_jpeg_fixtures [OUT_DIR]

Each fixture is a seeded synthetic frame (a lit street or room: sky or
wall and ground gradients, blocks, mild sensor noise) encoded by PIL's
libjpeg at the quality, chroma sampling and options its entry in FIXTURES
names. `fixtures.json` beside them holds, per file, the SHA-256 of PIL's
decoded pixels (`np.asarray(Image.open(f).convert("RGB"))`, C order), their
shape, and for a file the port's decoder does not read, the kind it
refuses. `tools.make_tree` copies the dataset frames into the SUN RGB-D,
nuScenes and custom trees, so that those trees are written where PIL is
missing; the tests and `chip_smoke.py` hold the port's decoder to the
hashes. PIL is imported here only.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import os.path as osp

import numpy as np

DEFAULT_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "testdata", "jpeg")
# name -> (height, width, PIL save options, mode, the port's refusal)
FIXTURES = {
    "nuscenes_0.jpg": (900, 1600, dict(quality=85, subsampling=2), "RGB",
                       None),
    "nuscenes_1.jpg": (900, 1600, dict(quality=85, subsampling=2), "RGB",
                       None),
    "sunrgbd_0.jpg": (530, 730, dict(quality=90, subsampling=2), "RGB",
                      None),
    "sunrgbd_1.jpg": (530, 730, dict(quality=90, subsampling=2), "RGB",
                      None),
    "nuscenes_small_0.jpg": (45, 80, dict(quality=75, subsampling=2),
                             "RGB", None),
    "nuscenes_small_1.jpg": (45, 80, dict(quality=75, subsampling=2),
                             "RGB", None),
    "sunrgbd_small_0.jpg": (53, 73, dict(quality=90, subsampling=2), "RGB",
                            None),
    "sunrgbd_small_1.jpg": (53, 73, dict(quality=90, subsampling=2), "RGB",
                            None),
    "q95_444.jpg": (61, 83, dict(quality=95, subsampling=0), "RGB", None),
    "q50_422.jpg": (61, 83, dict(quality=50, subsampling=1), "RGB", None),
    "q75_420_optimized_restart.jpg": (
        61, 83, dict(quality=75, subsampling=2, optimize=True,
                     restart_marker_blocks=5), "RGB", None),
    "gray_q75.jpg": (61, 83, dict(quality=75), "L", None),
    "progressive.jpg": (61, 83, dict(quality=75, progressive=True), "RGB",
                        "progressive"),
    "cmyk.jpg": (61, 83, dict(quality=75), "CMYK", "CMYK"),
}


def synthetic_frame(h, w, seed):
    """(h, w, 3) uint8: a horizon with sky (or wall) above and ground
    below, a few blocks, a vignette and noise of 2 levels."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    horizon = rng.uniform(0.35, 0.55)
    sky = np.stack([150 + 60 * y + 0 * x, 180 + 40 * y + 0 * x,
                    230 - 20 * y + 0 * x], -1)
    ground = np.stack([90 + 50 * y + 10 * x, 85 + 45 * y + 0 * x,
                       80 + 40 * y - 10 * x], -1)
    img = np.where((y > horizon)[..., None], ground, sky)
    for _ in range(6):
        bh, bw = int(rng.integers(h // 10, h // 3)), int(rng.integers(
            w // 12, w // 4))
        y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
        shade = rng.uniform(30, 220, 3)
        img[y0:y0 + bh, x0:x0 + bw] = shade * (0.8 + 0.2 * np.linspace(
            0, 1, bw))[None, :, None]
    img *= (1.0 - 0.25 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))[..., None]
    img += rng.normal(0.0, 2.0, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def pixel_sha256(path):
    from PIL import Image

    with Image.open(path) as im:
        px = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    return hashlib.sha256(px.tobytes()).hexdigest(), list(px.shape)


def write_fixtures(out_dir=DEFAULT_DIR):
    """Write every fixture and `fixtures.json` into out_dir; returns the
    JSON's entries."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    index = {}
    for seed, (name, (h, w, options, mode, refused)) in enumerate(
            FIXTURES.items()):
        rgb = synthetic_frame(h, w, seed)
        im = Image.fromarray(rgb)
        if mode == "L":
            im = im.convert("L")
        elif mode == "CMYK":
            im = im.convert("CMYK")
        buf = io.BytesIO()
        im.save(buf, "JPEG", **options)
        path = osp.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        sha, shape = pixel_sha256(path)
        index[name] = {"sha256": sha, "shape": shape,
                       "bytes": len(buf.getvalue()), "refused": refused}
    with open(osp.join(out_dir, "fixtures.json"), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
        f.write("\n")
    return index


def main(argv=None):
    parser = argparse.ArgumentParser(description="Write the JPEG fixtures")
    parser.add_argument("out_dir", nargs="?", default=DEFAULT_DIR)
    args = parser.parse_args(argv)
    index = write_fixtures(args.out_dir)
    total = sum(e["bytes"] for e in index.values())
    print(f"wrote {len(index)} fixtures, {total} bytes, to {args.out_dir}")


if __name__ == "__main__":
    main()
