"""Painted H&E-like tissue: the benchmark's inputs, made from a seed.

A frozen copy of `synth_nuclei_image` from the repository root's bench.py
(dark-purple disks of radius 5-10 on a light, noisy background), changed
in three ways: each nucleus has a type whose colour it takes, so that a
typed model has something to learn; a nucleus is painted only where it
takes the label (image and labels agree where disks overlap); and nuclei
can be kept inside a tissue mask, for pseudo-slides.
"""

from __future__ import annotations

import numpy as np

# mean RGB of a nucleus of type 1, 2, ...: purple shades a typed model
# can tell apart through the per-nucleus noise (sd 10)
TYPE_COLOURS = np.array([[120, 70, 150], [70, 35, 110], [165, 95, 180],
                         [105, 60, 95], [140, 110, 200]], np.float32)
_YY, _XX = np.mgrid[-12:13, -12:13]


def background(h: int, w: int, rng: np.random.Generator,
               device=None) -> np.ndarray:
    """Light stroma: 225 + N(0, 4) per channel, uint8. With a torch
    `device` the noise is drawn there by a generator seeded from `rng`
    (a slide's 300 MB of noise in a moment on a card)."""
    if device is not None:
        import torch

        g = torch.Generator(device=device).manual_seed(
            int(rng.integers(1 << 62)))
        img = torch.randn((h, w, 3), generator=g, device=device)
        return img.mul_(4.0).add_(225.0).clamp_(0, 255).to(
            torch.uint8).cpu().numpy()
    img = rng.standard_normal((h, w, 3), dtype=np.float32)
    img *= 4.0
    img += 225.0
    return np.clip(img, 0, 255, out=img).astype(np.uint8)


def paint_nuclei(img: np.ndarray, centres: np.ndarray, rng, nr_types=None,
                 inst: np.ndarray | None = None,
                 types: np.ndarray | None = None):
    """Paint one disk of radius 5-10 at each (y, x) of `centres` (at least
    12 px from the border) onto `img` in place; with `inst` (int32, zero)
    label them 1, 2, ... in order, an earlier nucleus keeping the pixels
    it has. Types are drawn in 1..nr_types-1 (1 when untyped); `types`,
    when given, receives each label's type at its index."""
    n_types = max((nr_types or 2) - 1, 1)
    for k, (cy, cx) in enumerate(centres, 1):
        r = int(rng.integers(5, 11))
        t = int(rng.integers(1, n_types + 1))
        col = TYPE_COLOURS[t - 1] + rng.normal(0, 10, 3)
        m = (_YY ** 2 + _XX ** 2) <= r * r
        win = np.s_[cy - 12:cy + 13, cx - 12:cx + 13]
        if inst is not None:
            sub = inst[win]
            m = m & (sub == 0)
            sub[m] = k
        img[win][m] = np.clip(col, 0, 255).astype(np.uint8)
        if types is not None:
            types[k] = t
    return img


def paint_tile(h: int, w: int, n_nuclei: int, seed: int, nr_types=None,
               with_labels: bool = False, device=None):
    """One tile: (image uint8 [h, w, 3], and with labels the instance map
    int32 and the type map int32)."""
    rng = np.random.default_rng(seed)
    img = background(h, w, rng, device)
    centres = np.stack([rng.integers(14, h - 14, n_nuclei),
                        rng.integers(14, w - 14, n_nuclei)], axis=1)
    if not with_labels:
        return paint_nuclei(img, centres, rng, nr_types)
    inst = np.zeros((h, w), np.int32)
    types = np.zeros(n_nuclei + 1, np.int32)
    paint_nuclei(img, centres, rng, nr_types, inst, types)
    return img, inst, types[inst]


def tissue_mask(shape, fraction: float, rng, scale: int = 16) -> np.ndarray:
    """A uint8 {0, 1} mask at 1/`scale` of `shape`: a smoothed random
    field cut at the quantile that leaves `fraction` of it tissue."""
    import cv2

    mh, mw = -(-shape[0] // scale), -(-shape[1] // scale)
    field = rng.standard_normal((mh, mw)).astype(np.float32)
    field = cv2.GaussianBlur(field, (0, 0), sigmaX=mh / 12)
    return (field > np.quantile(field, 1.0 - fraction)).astype(np.uint8)


def paint_slide(h: int, w: int, per_mpx: float, fraction: float, seed: int,
                nr_types=None, scale: int = 16, device=None):
    """A pseudo-slide: (image uint8 [h, w, 3], tissue mask at 1/`scale`,
    nuclei painted). Nuclei fall in the mask's tissue at `per_mpx` a
    million tissue pixels."""
    rng = np.random.default_rng(seed)
    mask = tissue_mask((h, w), fraction, rng, scale)
    img = background(h, w, rng, device)
    n = int(round(per_mpx * mask.sum() * scale * scale / 1e6))
    ys = rng.integers(14, h - 14, 4 * n)
    xs = rng.integers(14, w - 14, 4 * n)
    inside = mask[ys // scale, xs // scale] > 0
    centres = np.stack([ys[inside], xs[inside]], axis=1)[:n]
    paint_nuclei(img, centres, rng, nr_types)
    return img, mask
