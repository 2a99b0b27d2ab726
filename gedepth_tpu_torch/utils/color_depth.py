"""Depth colorization without matplotlib (the port of
`gedepth_tpu.utils.color_depth`, which renders with matplotlib's `magma_r`).

`colorize_depth` normalises the depth to [0, 1] over (vmin, vmax) and looks
it up in matplotlib's 256-entry `magma_r` table by matplotlib's rule: index
floor(x·256), 1.0 taken as the last entry, NaN (a constant map, or NaN
depth) black; the colour is the table's float times 255, truncated to
uint8. `MAGMA_R` holds those truncated entries, written out from matplotlib
3.10's table, so the result equals the JAX package's byte for byte.
"""
from __future__ import annotations

import numpy as np

# matplotlib's magma_r: (lut[:256, :3] * 255).astype(uint8), RGB hex
MAGMA_R = np.frombuffer(bytes.fromhex(
    "fbfcbffbfabdfbf9bbfbf7b9fcf5b7fcf3b5fcf1b3fcf0b1"
    "fceeb0fcecaefceaacfce8aafce6a8fce5a6fce3a5fde1a3"
    "fddfa1fddd9ffddc9dfdda9cfdd89afdd698fdd497fdd295"
    "fdd193fdcf92fdcd90fecb8efec98dfec78bfec689fec488"
    "fec286fec085febe83febc82febb80feb97ffeb77dfeb57c"
    "feb37bfeb179feaf78feae76feac75feaa74fea873fea671"
    "fda470fda26ffda16efd9f6cfd9d6bfd9b6afd9969fd9768"
    "fd9567fc9366fc9265fc9064fc8e63fc8c63fb8a62fb8861"
    "fb8660fb8460fa825ffa805efa7f5ef97d5df97b5df9795c"
    "f8775cf8755cf7735cf7715bf6705bf66e5bf56c5bf56a5b"
    "f4685bf3675bf3655cf2635cf1615cf0605def5e5dee5d5d"
    "ee5b5eed595fec585feb5660ea5560e85461e75262e65162"
    "e55063e44e64e24d65e14c66e04b66de4a67dd4968dc4869"
    "da4769d9466ad7456bd6446cd4436dd3426dd1426ed0416f"
    "ce4070cd3f70cb3e71ca3e72c83d72c63c73c53c74c33b74"
    "c23a75c03a75be3976bd3977bb3877b93778b83778b63679"
    "b53679b3357ab1357ab0347bae347bac337bab337ca9327c"
    "a7317da6317da4307da3307ea12f7e9f2f7e9e2e7e9c2e7f"
    "9a2d7f992d7f972c7f952c80942b80922b80912a808f2a80"
    "8d29808c29808a2881892881872781852681842681822581"
    "8125817f24817e24817c23817a2281792281772181762181"
    "742081731f81711f816f1e816e1e816c1d806b1c80691c80"
    "681b80661a80651a8063197f61187f60187f5e177f5d177e"
    "5b167e5a157e58157e57147d55137d53137c52127c50127b"
    "4f117b4d117a4b10794a1079481078470f77450f76430f75"
    "420f74400f733e0f723c0f713b0f6f390f6e370f6c350f6a"
    "3410683210673010652f10622d10602b115e2a115c281159"
    "26115725115523115222115020114d1f114b1e10491c1046"
    "1b10441a1041180f3f170f3c160e3a150e38140d35120d33"
    "110c31100c2f0f0b2c0e0a2a0d0a280c09260b08240a0722"
    "09071f08061d07051b060519050417040415040313030311"
    "02020f02020d01010b010109010007000006000004000003"
), np.uint8).reshape(256, 3)


def colorize_depth(depth: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 `magma_r` render, near depth bright.
    The normalisation is the JAX package's, in its dtypes: a map whose range
    is under 1e-10 normalises to NaN where the float32 sum vmin + 1e-10
    rounds to vmin, and renders black."""
    d = np.asarray(depth, dtype=np.float32)
    vmin = np.nanmin(d) if vmin is None else vmin
    vmax = np.nanmax(d) if vmax is None else vmax
    if vmax - vmin < 1e-10:
        vmax = vmin + 1e-10
    x = np.clip((d - vmin) / (vmax - vmin), 0, 1)
    # matplotlib's lookup of a float in [0, 1] (`Colormap.__call__`)
    x = x * len(MAGMA_R)
    x[x == len(MAGMA_R)] = len(MAGMA_R) - 1
    bad = np.isnan(x)
    with np.errstate(invalid="ignore"):
        index = x.astype(int)
    out = MAGMA_R[np.where(bad, 0, index)]
    out[bad] = 0
    return out
