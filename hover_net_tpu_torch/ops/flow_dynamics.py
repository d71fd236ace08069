"""Cellpose's flow dynamics on the device: a [dY, dX, cellprob] map ->
an instance label map, as `cellpose/dynamics.py::compute_masks` computes
it at its defaults, in torch ops (no hand-written kernel).

Written from Cellpose 4 (github.com/MouseLand/cellpose: dynamics.py
`compute_masks`, `follow_flows`, `steps_interp`, `get_masks_torch`,
`remove_bad_flow_masks`, `masks_to_flows_gpu`, `_extend_centers_gpu`,
`get_centers`; metrics.py `flow_error`; utils.py
`fill_holes_and_remove_small_masks`), with every threshold as published:

1. `follow`: the pixels with cellprob > 0 follow dP / 5 (dP masked to
   those pixels) for 200 Euler steps, each a bilinear `grid_sample` of the
   flow at the point (coordinates normalised by the image's size less one,
   `align_corners=False`, as Cellpose writes it), clamped to the image;
   all points at once, with no host read inside the steps;
2. `get_masks`: the end points, shifted by a pad of 20, histogrammed; the
   seeds are the 5x5 max-pool maxima holding more than 10 points, sorted
   by their count; each seed's 11x11 box of the histogram is gathered at
   once (no loop over seeds) and its mask grown 5 times by a 3x3 max-pool
   where the count is above 2; where boxes overlap the seed of the larger
   count wins (Cellpose writes the seeds' masks in that order); every
   pixel takes the label at its end point; masks over 0.4 of the image
   are dropped and the rest renumbered;
3. `remove_bad_flow_masks`: each mask's own flows (`masks_to_flows`: heat
   diffusion in float64 from the mask pixel nearest its mean, 2 x the
   largest bbox extent iterations, the normalised gradient) against the
   net's dP / 5; a mask whose mean squared error, summed over the two
   components, exceeds 0.4 is dropped;
4. `fill_holes_and_remove_small`: masks under 15 pixels are dropped, and
   background holes enclosed by one mask are given to it (4-connected,
   as `fill_voids.fill` on each mask's box); then the labels are
   renumbered 1..n.

One departure: Cellpose fills each mask's voids whatever they hold, so a
mask lying wholly inside another's hole is overwritten by it; here only
background voids are filled. Ties among the seeds' counts are ordered by
a stable sort (Cellpose's `argsort` leaves them to the backend).

`compute_masks` returns the labels and the counts `n_seeds`,
`n_dropped_flow_error` and `n_dropped_small`, each a device tensor; the
host reads it needs (the numbers of points and seeds, the diffusion's
iterations) fall between the stages, never inside the 200 steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .post_proc_device import connected_components

NITER = 200
CELLPROB_THRESHOLD = 0.0
FLOW_THRESHOLD = 0.4
MIN_SIZE = 15
MAX_SIZE_FRACTION = 0.4
RPAD = 20
FLOW_SCALE = 5.0  # the net predicts 5x the masks' flows
# the counts `compute_masks` returns, in the order the tile pipeline packs
# them
COUNTERS = ("n_seeds", "n_dropped_flow_error", "n_dropped_small")


def follow(flows: torch.Tensor, niter: int = NITER):
    """[3, H, W] float32 (dY, dX, cellprob) -> (end points [2, n] int32
    (y, x), the followed pixels (ys, xs) int64): Cellpose's
    `follow_flows` / `steps_interp` on the pixels above the cellprob
    threshold."""
    dp, cellprob = flows[:2].float(), flows[2].float()
    fg = cellprob > CELLPROB_THRESHOLD
    ys, xs = torch.nonzero(fg, as_tuple=True)
    dp = dp * fg / FLOW_SCALE
    h, w = dp.shape[1:]
    # (x, y) order of grid_sample; Cellpose normalises by the size less one
    shape = (float(w - 1), float(h - 1))
    im = torch.stack([dp[1] * (2.0 / shape[0]),
                      dp[0] * (2.0 / shape[1])])[None]
    pt = torch.stack([xs.float() / shape[0], ys.float() / shape[1]],
                     dim=-1)[None, None]
    pt = pt * 2 - 1
    for _ in range(niter if len(ys) else 0):
        d = F.grid_sample(im, pt, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # [1, 2, 1, n]
        pt = torch.clamp(pt + d[0, :, 0].t()[None, None], -1.0, 1.0)
    pt = (pt + 1) * 0.5
    p = torch.stack([pt[0, 0, :, 1] * shape[1], pt[0, 0, :, 0] * shape[0]])
    return p.int(), (ys, xs)


def _max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max over [N, H, W] float, stride 1, the window cut at the
    border (Cellpose's `max_pool_nd`)."""
    return F.max_pool2d(x[:, None], k, stride=1, padding=k // 2)[:, 0]


def _renumber(labels: torch.Tensor, n: int) -> torch.Tensor:
    """Labels in 0..n -> 1..m in ascending order, 0 kept."""
    seen = torch.zeros(n + 1, dtype=torch.int32, device=labels.device)
    seen.index_fill_(0, labels.reshape(-1).long(), 1)
    seen[0] = 0
    rank = torch.cumsum(seen, 0, dtype=torch.int32)
    return rank[labels.long()]


def get_masks(p: torch.Tensor, inds, shape0: Tuple[int, int]):
    """(labels [H, W] int32 renumbered 1..m, seeds [S, 2] of the padded
    histogram in ascending count order): Cellpose's `get_masks_torch`."""
    h0, w0 = shape0
    dev = p.device
    labels = torch.zeros(shape0, dtype=torch.int32, device=dev)
    if p.shape[1] == 0:
        return labels, torch.zeros((0, 2), dtype=torch.long, device=dev)
    pt = p.long() + RPAD
    pt = pt.clamp(min=0)
    pt[0] = pt[0].clamp(max=h0 + RPAD - 1)
    pt[1] = pt[1].clamp(max=w0 + RPAD - 1)
    shape = (h0 + 2 * RPAD, w0 + 2 * RPAD)
    hist = torch.zeros(shape, dtype=torch.float32, device=dev)
    hist.index_put_((pt[0], pt[1]), torch.ones_like(pt[0],
                                                    dtype=torch.float32),
                    accumulate=True)
    hmax = _max_pool(hist[None], 5)[0]
    seeds = torch.nonzero((hist >= hmax) & (hist > 10))
    if seeds.shape[0] == 0:
        return labels, seeds
    seeds = seeds[torch.argsort(hist[seeds[:, 0], seeds[:, 1]],
                                stable=True)]
    n = seeds.shape[0]
    off = torch.arange(-5, 6, device=dev)
    by = (seeds[:, 0, None] + off)[:, :, None].expand(n, 11, 11)
    bx = (seeds[:, 1, None] + off)[:, None, :].expand(n, 11, 11)
    h_slc = hist[by, bx]
    grow = torch.zeros((n, 11, 11), dtype=torch.float32, device=dev)
    grow[:, 5, 5] = 1
    for _ in range(5):
        grow = _max_pool(grow, 3) * (h_slc > 2)
    # the later (larger) seed wins where masks overlap
    rank = torch.arange(1, n + 1, dtype=torch.int32,
                        device=dev)[:, None, None].expand(n, 11, 11)
    m1 = torch.zeros(shape[0] * shape[1], dtype=torch.int32, device=dev)
    on = grow > 0
    m1.scatter_reduce_(0, (by[on] * shape[1] + bx[on]), rank[on], "amax")
    labels[inds] = m1[pt[0] * shape[1] + pt[1]]
    counts = torch.bincount(labels.reshape(-1), minlength=n + 1)
    big = counts > h0 * w0 * MAX_SIZE_FRACTION
    big[0] = False
    labels = torch.where(big[labels.long()], 0, labels)
    return _renumber(labels, n), seeds


def _bbox(lab: torch.Tensor, ys, xs, n: int):
    """Per-label (ymin, ymax + 1, xmin, xmax + 1) of the pixels (ys, xs)
    labelled `lab` in 1..n (`find_objects`' slices)."""
    dev = lab.device
    big = torch.iinfo(torch.int64).max
    out = []
    for v, red, init in ((ys, "amin", big), (ys, "amax", -1),
                         (xs, "amin", big), (xs, "amax", -1)):
        t = torch.full((n + 1,), init, dtype=torch.int64, device=dev)
        out.append(t.scatter_reduce_(0, lab, v, red, include_self=True))
    y0, y1, x0, x1 = out
    return y0, y1 + 1, x0, x1 + 1


def _mask_flows(masks: torch.Tensor, n: int):
    """(ys, xs, labels, flows [2, N] float64) of the N mask pixels of labels
    1..n: Cellpose's `masks_to_flows_gpu`, its centres as `get_centers`
    takes them (the pixel nearest each mask's mean, the first in raster
    order on a tie) and its diffusion as `_extend_centers_gpu` runs it,
    the same float64 arithmetic in fewer launches: the heat table is flat
    with one cell always zero, which a pixel's non-neighbours read (as
    Cellpose's `isneighbor` product zeroes them), and one scratch cell,
    where the absent labels' sources land."""
    dev = masks.device
    mp = F.pad(masks.long(), (1, 1, 1, 1))
    wp = mp.shape[1]
    y, x = torch.nonzero(mp, as_tuple=True)
    lab = mp[y, x]
    y0, y1, x0, x1 = _bbox(lab, y - 1, x - 1, n)
    # centres: yi, xi relative to the box, as get_centers computes them
    yi = (y - 1 - y0[lab]).double()
    xi = (x - 1 - x0[lab]).double()
    cnt = torch.bincount(lab, minlength=n + 1).double()
    ymed = torch.zeros(n + 1, dtype=torch.float64,
                       device=dev).index_add_(0, lab, yi) / cnt
    xmed = torch.zeros(n + 1, dtype=torch.float64,
                       device=dev).index_add_(0, lab, xi) / cnt
    d = (xi - xmed[lab]) ** 2 + (yi - ymed[lab]) ** 2
    dmin = torch.full((n + 1,), float("inf"), dtype=torch.float64,
                      device=dev).scatter_reduce_(0, lab, d, "amin")
    idx = torch.arange(y.numel(), device=dev)
    first = torch.full((n + 1,), y.numel(), dtype=torch.long,
                       device=dev).scatter_reduce_(
        0, lab, torch.where(d == dmin[lab], idx, y.numel()), "amin")
    present = cnt > 0  # labels up to n may be absent
    present[0] = False
    lin = y * wp + x
    zero, scratch = mp.numel(), mp.numel() + 1
    meds = torch.where(present, lin[first.clamp(max=y.numel() - 1)],
                       scratch)
    ext = torch.where(present, (y1 - y0) + (x1 - x0) + 2, 0)
    n_iter = 2 * int(ext.max())
    yxi = ((0, -1, 1, 0, 0, -1, -1, 1, 1), (0, 0, 0, -1, 1, -1, 1, -1, 1))
    off = (torch.tensor(yxi[0], device=dev) * wp
           + torch.tensor(yxi[1], device=dev))[:, None]
    nb = lin[None] + off  # [9, N]
    isneighbor = mp.reshape(-1)[nb] == lab[None]
    src = torch.where(isneighbor, nb, zero)
    ones = torch.ones(n + 1, dtype=torch.float64, device=dev)
    t = torch.zeros(mp.numel() + 2, dtype=torch.float64, device=dev)
    for _ in range(n_iter):
        t.index_add_(0, meds, ones)
        t[lin] = t[src].mean(dim=0)
    g = t[nb[[2, 1, 4, 3]]]
    mu = torch.stack([g[0] - g[1], g[2] - g[3]])
    mu = mu / (1e-60 + torch.sqrt((mu ** 2).sum(dim=0)))
    return y - 1, x - 1, lab, mu


def masks_to_flows(masks: torch.Tensor, n: int) -> torch.Tensor:
    """[2, H, W] float64 (dy, dx) flows of labels 1..n (`_mask_flows`),
    zero off the masks."""
    mu0 = torch.zeros((2,) + tuple(masks.shape), dtype=torch.float64,
                      device=masks.device)
    if n:
        ys, xs, _, mu = _mask_flows(masks, n)
        mu0[:, ys, xs] = mu
    return mu0


def remove_bad_flow_masks(masks: torch.Tensor, flows: torch.Tensor,
                          n: int):
    """(masks with every mask of flow error above 0.4 zeroed, the number
    dropped): Cellpose's `remove_bad_flow_masks` over `flow_error`, the
    mean over each mask of (its flows - dP / 5)^2 summed over dY and
    dX."""
    if n == 0:
        return masks, torch.zeros((), dtype=torch.int64,
                                  device=masks.device)
    ys, xs, lab, mu = _mask_flows(masks, n)
    cnt = torch.bincount(lab, minlength=n + 1).double()
    err = torch.zeros(n + 1, dtype=torch.float64, device=masks.device)
    for i in range(2):
        sq = (mu[i] - (flows[i, ys, xs].float() / FLOW_SCALE).double()) ** 2
        err = err + torch.zeros_like(err).index_add_(0, lab, sq) \
            / cnt.clamp(min=1)
    bad = err > FLOW_THRESHOLD
    bad[0] = False
    return torch.where(bad[masks.long()], 0, masks), bad.sum()


def fill_holes_and_remove_small(masks: torch.Tensor, n: int,
                                min_size: int = MIN_SIZE):
    """(labels renumbered 1..m, the number of masks under `min_size`
    dropped): the masks under `min_size` pixels zeroed, then every
    background region 4-connected to no image border and bordered by one
    mask alone given to that mask."""
    dev = masks.device
    counts = torch.bincount(masks.reshape(-1).long(), minlength=n + 1)
    small = (counts < min_size) & (counts > 0)
    small[0] = False
    masks = torch.where(small[masks.long()], 0, masks)
    h, w = masks.shape
    bg = connected_components((masks == 0)[None])[0].long()
    border = torch.cat([bg[0], bg[-1], bg[:, 0], bg[:, -1]])
    outside = torch.zeros(h * w + 1, dtype=torch.bool, device=dev)
    outside[border] = True
    outside[0] = True
    hole = ~outside[bg]
    lo = torch.full((h * w + 1,), n + 1, dtype=torch.int32, device=dev)
    hi = torch.zeros(h * w + 1, dtype=torch.int32, device=dev)
    padded = F.pad(masks, (1, 1, 1, 1))
    for sy, sx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        nb = padded[sy:sy + h, sx:sx + w]
        at = hole & (nb > 0)
        lo.scatter_reduce_(0, bg[at], nb[at], "amin")
        hi.scatter_reduce_(0, bg[at], nb[at], "amax")
    single = (lo == hi) & (hi > 0)
    masks = torch.where(hole & single[bg], hi[bg], masks)
    return _renumber(masks, n), small.sum()


def compute_masks(flows: torch.Tensor,
                  mark: Optional[Callable[[str], None]] = None):
    """[3, H, W] (dY, dX, cellprob) -> (labels [H, W] int32 1..m,
    {"n_seeds", "n_dropped_flow_error", "n_dropped_small"} as device
    tensors). `mark(stage)` is called at the ends of `flow_follow`,
    `flow_masks` and `flow_error` (the tile pipeline's `StageEvents`)."""
    mark = mark or (lambda name: None)
    flows = flows.float()
    p, inds = follow(flows)
    mark("flow_follow")
    labels, seeds = get_masks(p, inds, tuple(flows.shape[1:]))
    n = seeds.shape[0]
    mark("flow_masks")
    labels, n_bad = remove_bad_flow_masks(labels, flows, n)
    mark("flow_error")
    labels, n_small = fill_holes_and_remove_small(labels, n)
    counts = (torch.tensor(n, device=labels.device), n_bad, n_small)
    counters: Dict[str, torch.Tensor] = dict(zip(COUNTERS, counts))
    return labels, counters
