"""Batched post-processing on tensors: HV maps -> instance label maps.

Counterpart of hover_net_tpu/ops/post_proc_device.py, in plain PyTorch.
It is the CPU path of the port and the plain version that the CUDA tail
kernel (ops/post_proc_cuda.py, csrc/post_proc_tail.cu) is held against:
for the same input both give the same int32 labels, and those are the
labels of the JAX package's exact path, `proc_np_hv_batch(exact=True)`.

Semantics kept from the JAX package:

- component labels are 1 + the linear index (within one map) of the
  component's first pixel in raster order;
- small-object removal is exact (per-component pixel counts);
- the watershed cost word is `(level << 15) | hops`: the minimax energy
  level along the path, and the hops since its last strict ascent,
  saturating at 32767; INT_MAX (unreached) passes through a crossing;
- phase 2 of the watershed breaks exact cost ties by (total hops from
  the marker, marker label), the unique fixpoint of a relaxation along
  the cost-attaining edges;
- the energy is quantised over the fixed range [-1, 0] to 65536 levels,
  rounding half to even.

The CCL runs segmented min-scans along rows and columns to a fixpoint
(as the JAX scan path does; `torch.cummin` over a (segment, value) key
replaces `associative_scan`). The watershed relaxes 4-neighbour sweeps
to each phase's fixpoint (as the TPU kernel does); both fixpoints are
unique, so the sweep scheme does not change the labels. There are no
halo windows and no seams: every map is solved whole.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import filters

INT_MAX = 2**31 - 1
HOP_BITS = 15
HOP_MASK = (1 << HOP_BITS) - 1
NUM_LEVELS = 1 << 16


# ------------------------------------------------------- segmented scans

def _seg_min_scan(vals: torch.Tensor, mask: torch.Tensor, dim: int,
                  reverse: bool = False) -> torch.Tensor:
    """Min over the contiguous run of `mask` ending at each position
    (in scan direction) of non-negative int32 `vals`."""
    if reverse:
        return _seg_min_scan(vals.flip(dim), mask.flip(dim), dim).flip(dim)
    prev = torch.cat([torch.zeros_like(mask.narrow(dim, 0, 1)),
                      mask.narrow(dim, 0, mask.shape[dim] - 1)], dim)
    seg = torch.cumsum((mask & ~prev).to(torch.int64), dim)
    # segment ids grow along the scan, so a key that puts the NEGATED id
    # in the high word makes cummin restart at every new segment
    key = ((seg.amax() + 1 - seg) << 32) | vals.to(torch.int64)
    out = (torch.cummin(key, dim).values & 0xFFFFFFFF).to(torch.int32)
    return torch.where(mask, out, vals)


def _linear_index(shape, device) -> torch.Tensor:
    n, h, w = shape
    idx = torch.arange(1, h * w + 1, dtype=torch.int32, device=device)
    return idx.reshape(1, h, w).expand(n, h, w)


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """4-connected components of bool [N, H, W]. Returns int32 labels:
    0 = background, else 1 + the component's minimum linear index."""
    lab = torch.where(mask, _linear_index(mask.shape, mask.device),
                      torch.full_like(mask, INT_MAX, dtype=torch.int32))
    while True:
        new = _seg_min_scan(lab, mask, 2)
        new = _seg_min_scan(new, mask, 2, reverse=True)
        new = _seg_min_scan(new, mask, 1)
        new = _seg_min_scan(new, mask, 1, reverse=True)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(mask, lab, torch.zeros_like(lab))


def remove_small(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Zero every component of int32 [N, H, W] `labels` (values in
    [0, H*W]) with fewer than `min_size` pixels."""
    n, h, w = labels.shape
    bins = h * w + 1
    offs = (torch.arange(n, device=labels.device) * bins).reshape(n, 1, 1)
    sizes = torch.bincount((labels + offs).flatten(), minlength=n * bins)
    keep = (sizes >= min_size).reshape(n, bins)
    keep[:, 0] = False
    kept = torch.gather(keep, 1, labels.flatten(1).long()).reshape(n, h, w)
    return torch.where(kept, labels, torch.zeros_like(labels))


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill background regions not 4-connected to the map border
    (scipy.ndimage.binary_fill_holes)."""
    n, h, w = mask.shape
    bg = connected_components(~mask)
    border = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    flat = bg.flatten(1).long()
    touch = torch.zeros((n, h * w + 1), dtype=torch.bool, device=mask.device)
    touch.scatter_(1, torch.where(border.flatten()[None], flat,
                                  torch.zeros_like(flat)), True)
    outside = torch.gather(touch, 1, flat).reshape(n, h, w)
    return mask | (bg > 0) & ~outside


# ------------------------------------------------------------- watershed

def cross_cost(q_c: torch.Tensor, energy_sh: torch.Tensor) -> torch.Tensor:
    """Packed cost after crossing a pixel of shifted energy `energy_sh`
    from a neighbour of packed cost `q_c`: a strict ascent resets the
    hops, otherwise hops + 1 (saturating; INT_MAX passes through)."""
    lev = q_c & ~HOP_MASK
    bump = ((q_c & HOP_MASK) != HOP_MASK).to(torch.int32)
    return torch.where(energy_sh > lev, energy_sh, q_c + bump)


def _shift(x: torch.Tensor, dim: int, amt: int, fill) -> torch.Tensor:
    """out[i] = x[i - amt] along `dim` (amt = +-1); vacated cells =
    fill."""
    n = x.shape[dim]
    edge = torch.full_like(x.narrow(dim, 0, 1), fill)
    if amt > 0:
        return torch.cat([edge, x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), edge], dim)


_NEIGHBOURS = ((1, 1), (1, -1), (2, 1), (2, -1))


def watershed_cost(energy_q: torch.Tensor, markers: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Phase 1 of the marker watershed: the packed minimax cost
    `(level << 15) | hops` of every pixel of `mask`, relaxed to its
    fixpoint with synchronous 4-neighbour sweeps (INT_MAX where no
    marker reaches). Arguments as for `watershed_flood`."""
    seeded = (markers > 0) & mask
    energy_sh = energy_q << HOP_BITS
    cost = torch.where(seeded, energy_sh, torch.full_like(energy_sh, INT_MAX))
    while True:
        best = cost
        for dim, amt in _NEIGHBOURS:
            best = torch.minimum(
                best, cross_cost(_shift(cost, dim, amt, INT_MAX), energy_sh))
        new = torch.where(mask, best, cost)
        if torch.equal(new, cost):
            return cost
        cost = new


def watershed_flood(energy_q: torch.Tensor, markers: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Marker watershed by minimax path cost, in two phases.

    energy_q: int32 [N, H, W] levels in [0, 65535]; markers: int32 labels
    (0 = none); mask: bool flood region. Returns int32 labels (0 outside
    the mask or where no marker reaches).

    Phase 1 (`watershed_cost`) relaxes the packed cost to its fixpoint.
    Phase 2 relaxes (total hops, label) along the edges that attain the
    fixed costs."""
    cost = watershed_cost(energy_q, markers, mask)
    seeded = (markers > 0) & mask
    energy_sh = energy_q << HOP_BITS
    imax = torch.full_like(energy_sh, INT_MAX)
    sec = torch.where(seeded, torch.zeros_like(imax), imax)
    lab = torch.where(seeded, markers, torch.zeros_like(markers))
    while True:
        new_s, new_l = sec, lab
        for dim, amt in _NEIGHBOURS:
            q_c = _shift(cost, dim, amt, INT_MAX)
            q_s = _shift(new_s, dim, amt, INT_MAX)
            q_l = _shift(new_l, dim, amt, 0)
            offer = ((q_l > 0) & (q_c != INT_MAX) & (q_s != INT_MAX) & mask
                     & (cross_cost(q_c, energy_sh) == cost))
            s_c = torch.where(offer, q_s + 1, imax)
            take = offer & ((s_c < new_s) | ((s_c == new_s) & (q_l < new_l)))
            new_s = torch.where(take, s_c, new_s)
            new_l = torch.where(take, q_l, new_l)
        if torch.equal(new_l, lab) and torch.equal(new_s, sec):
            break
        sec, lab = new_s, new_l
    return torch.where(mask, lab, torch.zeros_like(lab))


# ---------------------------------------------------------- full solve

def energy_inputs(pred: torch.Tensor, valid_mask: Optional[torch.Tensor]
                  = None):
    """[N, H, W, 3] (np prob, hv x, hv y) -> (blb bool, sob float32)
    [N, H, W]: the thresholded nuclei mask (confined to `valid_mask`)
    and max(1 - norm(Sobel_x(h)), 1 - norm(Sobel_y(v))), with every
    min-max taken over the valid region only."""
    pred = pred.float()
    blb = pred[..., 0] >= 0.5
    if valid_mask is not None:
        blb = blb & valid_mask
    h_dir = filters.minmax_norm(pred[..., 1], where=valid_mask)
    v_dir = filters.minmax_norm(pred[..., 2], where=valid_mask)
    sobelh = 1.0 - filters.minmax_norm(filters.sobel_h(h_dir, 21),
                                       where=valid_mask)
    sobelv = 1.0 - filters.minmax_norm(filters.sobel_v(v_dir, 21),
                                       where=valid_mask)
    return blb, torch.maximum(sobelh, sobelv)


def proc_np_hv_batch(pred: torch.Tensor,
                     valid_mask: Optional[torch.Tensor] = None,
                     marker_min_size: int = 10, blob_min_size: int = 10
                     ) -> torch.Tensor:
    """[N, H, W, 3] -> [N, H, W] int32 seed-index instance labels.

    Channels: 0 nuclei prob, 1 horizontal, 2 vertical. valid_mask ([N, H,
    W] bool) confines instances to the source region of a mirrored
    canvas. The Sobel energy is plain PyTorch; the tail after it is
    `post_proc_cuda.proc_tail`: the CUDA kernel for CUDA tensors, its
    plain version for CPU tensors."""
    from .post_proc_cuda import proc_tail

    blb, sob = energy_inputs(pred, valid_mask)
    return proc_tail(blb, sob, marker_min_size=marker_min_size,
                     blob_min_size=blob_min_size)


# ------------------------------------------------------- host handoff

def compact_labels_u16(inst: torch.Tensor):
    """Seed-index labels [B, H, W] int32 -> (dense ids [B, H, W] uint16,
    0 stays background; [B] int32 distinct-label counts). The rank of
    label L is the number of seed pixels (lab[i] == i + 1) up to L - 1."""
    b, h, w = inst.shape
    flat = inst.reshape(b, h * w)
    iota1 = torch.arange(1, h * w + 1, dtype=torch.int32,
                         device=inst.device)
    ranks = torch.cumsum((flat == iota1).to(torch.int32), 1,
                         dtype=torch.int32)
    idx = (flat - 1).clamp_min(0).long()
    out = torch.where(flat > 0, torch.gather(ranks, 1, idx),
                      torch.zeros_like(flat))
    return (out.clamp(0, 65535).to(torch.uint16).reshape(b, h, w),
            ranks[:, -1].contiguous())


def remap_labels_u16(lab: torch.Tensor) -> torch.Tensor:
    """Labels [H, W] of ids below 65536 (a crop of `compact_labels_u16`'s,
    in any integer dtype) -> int32 ids renumbered 1..n in ascending order,
    0 kept: `metrics.stats.remap_label` on the device, from a presence
    table and its running count, with no sort and no host read."""
    flat = lab.reshape(-1).long()
    seen = torch.zeros(1 << 16, dtype=torch.int32, device=lab.device)
    seen.index_fill_(0, flat, 1)
    seen[0] = 0
    rank = torch.cumsum(seen, 0, dtype=torch.int32)
    return rank.index_select(0, flat).view(lab.shape)


# 8-neighbour directions (E, NE, N, NW, W, SW, S, SE): the bit order of
# the native COO contour tracer (csrc/instance_table.cpp)
_DIRS8 = ((0, 1), (-1, 1), (-1, 0), (-1, -1),
          (0, -1), (1, -1), (1, 0), (1, 1))


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """y[..., r, c] = x[..., r + dy, c + dx], 0 outside."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        x[..., max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def _neighbour_mask(lab: torch.Tensor):
    """int32 labels [..., H, W] -> (same, boundary): the 8-neighbour
    bitmask of same-label neighbours (bit k = `_DIRS8[k]`; outside the
    map counts as another label) and the labelled pixels whose mask is
    not full."""
    same = torch.zeros(lab.shape, dtype=torch.int32, device=lab.device)
    for k, (dy, dx) in enumerate(_DIRS8):
        nb = _shift2d(lab, dy, dx)
        same |= ((nb == lab) & (lab > 0)).to(torch.int32) << k
    return same, (lab > 0) & (same != 0xFF)


def instance_tables(lab: torch.Tensor, tp_map: Optional[torch.Tensor] = None,
                    coo_cap: int = 1 << 17, stat_cap: int = 4096,
                    nr_types: Optional[int] = None, with_sums: bool = True):
    """Fixed-capacity per-instance tables of a compacted [H, W] label
    map (ids 0..n): what the host pulls instead of the map. Same
    contract as the JAX function:

      coo    [coo_cap, 2] int32 ((y << 16) | x, (label << 8) | mask8) of
             the boundary pixels in raster order; slack rows (INT_MAX, 0)
      coo_n  [] int32 boundary-pixel count
      bbox   [stat_cap + 1, 4] int32 (rmin, rmax_excl, cmin, cmax_excl)
      sum_yx [stat_cap + 1, 2], size [stat_cap + 1]    (with_sums)
      type_hist [stat_cap + 1, nr_types]               (typed)

    Row index = label; labels above stat_cap land in row stat_cap."""
    if nr_types:
        with_sums = True
    lab = lab.to(torch.int32)
    h, w = lab.shape
    dev = lab.device
    same, boundary = _neighbour_mask(lab)

    pos = torch.nonzero(boundary.flatten()).flatten()  # raster order
    coo_n = pos.numel()
    pos = pos[:coo_cap]
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    pyx = ((yy << 16) | xx).flatten()
    plm = ((lab << 8) | same).flatten()
    coo = torch.zeros((coo_cap, 2), dtype=torch.int32, device=dev)
    coo[:, 0] = INT_MAX
    coo[:pos.numel(), 0] = pyx[pos]
    coo[:pos.numel(), 1] = plm[pos]

    out = {"coo": coo,
           "coo_n": torch.tensor(coo_n, dtype=torch.int32, device=dev)}
    if with_sums:
        flat = lab.flatten().clamp_max(stat_cap).long()
        cols = [torch.ones_like(pyx), yy.flatten(), xx.flatten()]
        if nr_types:
            t = tp_map.to(torch.int32).flatten().clamp(0, nr_types - 1)
            cols += [(t == k).to(torch.int32) for k in range(nr_types)]
        payload = torch.stack(cols, dim=-1)
        sums = torch.zeros((stat_cap + 1, payload.shape[1]),
                           dtype=torch.int32, device=dev)
        sums.index_add_(0, flat, payload)
        present = sums[:, 0] > 0

    # an instance's row/col extremes lie on its boundary, so min/max over
    # the COO give the bbox; slack rows go to the dustbin row stat_cap
    # as (0, 0), as in the JAX function
    hit = torch.arange(coo_cap, device=dev) < pos.numel()
    bl = torch.where(hit, coo[:, 1] >> 8, stat_cap).clamp_max(stat_cap).long()
    by = torch.where(hit, coo[:, 0] >> 16, 0)
    bx = torch.where(hit, coo[:, 0] & 0xFFFF, 0)
    mins = torch.full((stat_cap + 1, 2), INT_MAX, dtype=torch.int32,
                      device=dev)
    maxs = torch.zeros((stat_cap + 1, 2), dtype=torch.int32, device=dev)
    mins.scatter_reduce_(0, bl[:, None].expand(-1, 2),
                         torch.stack([by, bx], -1), "amin")
    maxs.scatter_reduce_(0, bl[:, None].expand(-1, 2),
                         torch.stack([by + 1, bx + 1], -1), "amax")
    if not with_sums:
        present = mins[:, 0] != INT_MAX
    rmin = torch.where(present, mins[:, 0], h)
    cmin = torch.where(present, mins[:, 1], w)
    out["bbox"] = torch.stack([rmin, maxs[:, 0], cmin, maxs[:, 1]], -1)
    if with_sums:
        out["sum_yx"] = sums[:, 1:3]
        out["size"] = sums[:, 0]
    if nr_types:
        out["type_hist"] = sums[:, 3:]
    return out


# the background pixels of a window and the unused slots of its COO add
# into this many dustbin rows past the label rows, spread by position, so
# that no single row takes the atomic adds of most of a window
_DUST_ROWS = 1024


def window_caps(area: int):
    """(stat_cap, coo_cap) of the tables of a post-processing window of
    `area` pixels. At PanNuke's 385 nuclei a tissue Mpx a 2048^2 window
    of full tissue holds ~1,600 nuclei and ~10^5 boundary pixels; the caps
    allow 5x both (8192 rows, 2^19 COO slots there)."""
    return max(256, area >> 9), max(4096, area >> 3)


def window_tables(lab: torch.Tensor, tp_map: Optional[torch.Tensor],
                  nr_types: Optional[int], stat_cap: int, coo_cap: int):
    """`instance_tables` of a batch of windows, with no host read: what the
    WSI manager pulls in place of a window batch's label and type maps.

    lab: [B, H, W] compacted labels (ids 0..n of each window; a window
    smaller than H x W sits at the top left with 0 around it, which reads
    as the window's own border); tp_map: [B, H, W] types (with nr_types);
    the caps as `window_caps` gives them.
    Returns a dict of [B, ...] int32 tensors: `coo`, `coo_n`, `bbox`,
    `sum_yx`, `size` and `type_hist` (typed) as `instance_tables` gives
    them for each window's labels (rows 1..stat_cap; row 0 and the bbox of
    an absent id hold nothing), and `n`, each window's largest id.

    Where `instance_tables` compacts the boundary with `torch.nonzero`
    (a host read), each COO slot j here finds the (j + 1)-th boundary
    pixel in the running count of boundary flags by a binary search, so
    `coo_n` stays on the device. Background pixels and unused slots add
    into `_DUST_ROWS` rows past the label rows, dropped at the end."""
    b, h, w = lab.shape
    dev = lab.device
    lab = lab.to(torch.int32)
    hw = h * w
    rows = stat_cap + 1 + _DUST_ROWS
    same, boundary = _neighbour_mask(lab)
    flat = lab.reshape(b, hw)

    # raster-order COO of the boundary pixels
    cum = torch.cumsum(boundary.reshape(b, hw), 1, dtype=torch.int32)
    coo_n = cum[:, -1]
    slot = torch.arange(1, coo_cap + 1, dtype=torch.int32, device=dev)
    pos = torch.searchsorted(cum, slot.expand(b, coo_cap).contiguous())
    hit = slot[None] <= coo_n[:, None]
    pos = pos.clamp_max(hw - 1)
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    pyx = ((yy << 16) | xx).reshape(hw)
    plm = torch.gather(((lab << 8) | same).reshape(b, hw), 1, pos)
    coo = torch.stack([torch.where(hit, pyx[pos], INT_MAX),
                       torch.where(hit, plm, 0)], -1)

    # per-id sums: one atomic add a pixel into each of the type histogram
    # (whose row sums are the sizes), the y sums and the x sums
    base = (torch.arange(b, device=dev) * rows)[:, None]
    dust = stat_cap + 1 + (torch.arange(hw, device=dev) & (_DUST_ROWS - 1))
    row = (torch.where(flat > 0, flat.clamp_max(stat_cap).long(), dust)
           + base).reshape(-1)
    n_t = nr_types or 1
    key = row * n_t
    if nr_types:
        key = key + tp_map.to(torch.int64).reshape(-1).clamp(0, n_t - 1)
    hist = torch.zeros(b * rows * n_t, dtype=torch.int32, device=dev)
    hist.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    hist = hist.view(b, rows, n_t)[:, :stat_cap + 1]
    sums = []
    for coord in (yy, xx):
        s = torch.zeros(b * rows, dtype=torch.int32, device=dev)
        s.index_add_(0, row, coord.reshape(1, hw).expand(b, hw).reshape(-1))
        sums.append(s.view(b, rows)[:, :stat_cap + 1])
    size = hist.sum(-1, dtype=torch.int32)

    # an instance's row/col extremes lie on its boundary: min/max over the
    # COO give the bbox
    bl = torch.where(hit, (coo[..., 1] >> 8).clamp_max(stat_cap).long(),
                     stat_cap + 1 + ((slot.long() - 1) & (_DUST_ROWS - 1)))
    bl = (bl + base).reshape(-1, 1).expand(-1, 2)
    yx = torch.stack([coo[..., 0] >> 16, coo[..., 0] & 0xFFFF], -1)
    mins = torch.full((b * rows, 2), INT_MAX, dtype=torch.int32, device=dev)
    maxs = torch.zeros((b * rows, 2), dtype=torch.int32, device=dev)
    mins.scatter_reduce_(0, bl, yx.reshape(-1, 2), "amin")
    maxs.scatter_reduce_(0, bl, yx.reshape(-1, 2) + 1, "amax")
    mins = mins.view(b, rows, 2)[:, :stat_cap + 1]
    maxs = maxs.view(b, rows, 2)[:, :stat_cap + 1]
    present = size > 0
    out = {"coo": coo, "coo_n": coo_n,
           "bbox": torch.stack([torch.where(present, mins[..., 0], h),
                                maxs[..., 0],
                                torch.where(present, mins[..., 1], w),
                                maxs[..., 1]], -1),
           "sum_yx": torch.stack(sums, -1), "size": size,
           "n": flat.amax(1)}
    if nr_types:
        out["type_hist"] = hist
    return out
