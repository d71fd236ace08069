"""Grid geometry of tile and slide inference, and the benchmark's counts.

`prepare_tile_patching`, `bucket_grid_dim`, `patch_top_left_grid`,
`wsi_tile_grids`, `wsi_chunk_patch_grids` and `select_patches_in_chunk`
are frozen copies of hover_net_tpu_torch/data/tiling.py (the reference's
infer/tile.py:46-94 and infer/wsi.py:64-221). The functions after them
derive, from those grids and the slide's tissue mask, the work a slide
needs: the patches the forward must run and the post-processing windows,
as HoVer-Net's WSI inference selects them (patches and boxes whose box,
scaled to the mask, touches tissue; windows rounded up to 256-pixel shape
classes). The reference and the roofline counts use them.
"""

from __future__ import annotations

import math

import numpy as np


def prepare_tile_patching(img_hw, window: int, step: int):
    """Compute reflect padding + patch grid so output windows tile the
    image exactly (infer/tile.py:46-94 semantics).

    Returns (pads (t, b, l, r), coords [K,2] top-left in padded image,
    grid (nr_rows, nr_cols)).
    """
    im_h, im_w = img_hw

    def last_steps(length):
        nr_step = math.ceil((length - step) / step)
        return int((nr_step + 1) * step), int(nr_step + 1)

    last_h, nr_rows = last_steps(im_h)
    last_w, nr_cols = last_steps(im_w)

    diff = window - step
    padt = padl = diff // 2
    padb = last_h + window - im_h
    padr = last_w + window - im_w

    ys = np.arange(0, last_h, step, dtype=np.int32)
    xs = np.arange(0, last_w, step, dtype=np.int32)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([yy.ravel(), xx.ravel()], axis=-1)
    return (padt, padb, padl, padr), coords, (nr_rows, nr_cols)


def bucket_grid_dim(n: int) -> int:
    """Round a patch-grid dimension up to a canonical class: exact up to
    8, then geometric ~12.5% steps (next multiple of 2^(log2(n)-2)).
    Bounds the number of canvas shapes for a directory of heterogeneous
    image sizes to O(log^2) classes at <= ~14% padded compute per dim."""
    n = int(n)
    if n <= 8:
        return max(n, 1)
    q = 1 << (n.bit_length() - 3)
    return -(-n // q) * q


def patch_top_left_grid(img_shape, input_size, output_size):
    """Top-left coords of (input, output) windows covering img_shape
    (infer/wsi.py:64-88). All args are (y, x) int arrays."""
    img_shape = np.asarray(img_shape)
    input_size = np.asarray(input_size)
    output_size = np.asarray(output_size)
    diff = input_size - output_size
    nr_step = np.floor((img_shape - diff) / output_size) + 1
    last = (diff // 2) + nr_step * output_size
    ys = np.arange(diff[0] // 2, last[0], output_size[0], dtype=np.int32)
    xs = np.arange(diff[1] // 2, last[1], output_size[1], dtype=np.int32)
    # x-major ordering (matches the reference's meshgrid flatten)
    yy, xx = np.meshgrid(ys, xs, indexing="xy")
    out_tl = np.stack([yy.ravel(), xx.ravel()], axis=-1)
    in_tl = out_tl - diff // 2
    return in_tl, out_tl


def wsi_tile_grids(img_shape, tile_shape, ambiguous_size: int = 128):
    """3-phase post-processing grids: full tiles, boundary strips,
    4-corner crosses (infer/wsi.py:92-151).

    Returns three [K, 2, 2] arrays of (top-left, bottom-right) boxes.
    """
    img_shape = np.asarray(img_shape, np.int64)
    tile_shape = np.asarray(tile_shape, np.int64)

    tl, _ = patch_top_left_grid(img_shape, tile_shape, tile_shape)
    br = np.minimum(tl + tile_shape, img_shape)
    tile_grid = np.stack([tl, br], axis=1)

    ys = np.unique(tl[:, 0])
    xs = np.unique(tl[:, 1])

    def stack_boxes(tls, brs):
        return np.stack([tls, brs], axis=1)

    def mesh(a, b):
        aa, bb = np.meshgrid(a, b)
        return np.stack([aa.ravel(), bb.ravel()], axis=-1)

    # vertical strips around internal x boundaries, then horizontal
    bound_v = stack_boxes(
        mesh(ys, xs[1:] - ambiguous_size),
        mesh(ys + tile_shape[0], xs[1:] + ambiguous_size),
    )
    bound_h = stack_boxes(
        mesh(ys[1:] - ambiguous_size, xs),
        mesh(ys[1:] + ambiguous_size, xs + tile_shape[1]),
    )
    tile_boundary = np.concatenate([bound_v, bound_h], axis=0)

    cross = stack_boxes(
        mesh(ys[1:] - 2 * ambiguous_size, xs[1:] - 2 * ambiguous_size),
        mesh(ys[1:] + 2 * ambiguous_size, xs[1:] + 2 * ambiguous_size),
    )
    return tile_grid, tile_boundary, cross


def wsi_chunk_patch_grids(img_shape, chunk_input_shape, patch_input_shape,
                          patch_output_shape):
    """Chunk grid aligned so chunk outputs are exact multiples of patch
    outputs, plus the full patch grid (infer/wsi.py:155-221).

    Returns (chunk_info [C,2,2,2], patch_info [P,2,2,2]) where the axes
    are [idx, (input|output), (tl|br), (y|x)].
    """
    img_shape = np.asarray(img_shape, np.int64)
    chunk_input_shape = np.asarray(chunk_input_shape, np.int64)
    patch_input_shape = np.asarray(patch_input_shape, np.int64)
    patch_output_shape = np.asarray(patch_output_shape, np.int64)

    def round_down(x, mult):
        return (np.floor(x / mult) * mult).astype(np.int64)

    diff = patch_input_shape - patch_output_shape
    chunk_output_shape = round_down(chunk_input_shape - diff, patch_output_shape)
    chunk_input_shape = chunk_output_shape + diff

    p_in_tl, _ = patch_top_left_grid(img_shape, patch_input_shape, patch_output_shape)
    p_in_br = p_in_tl + patch_input_shape
    # true receptive centers (the reference stores input_tl + diff here,
    # infer/wsi.py:180 — a quirk only used for mask-overlap tests)
    p_out_tl = p_in_tl + diff // 2
    p_out_br = p_out_tl + patch_output_shape
    patch_info = np.stack(
        [np.stack([p_in_tl, p_in_br], axis=1), np.stack([p_out_tl, p_out_br], axis=1)],
        axis=1,
    )

    c_in_tl, _ = patch_top_left_grid(img_shape, chunk_input_shape, chunk_output_shape)
    c_in_br = c_in_tl + chunk_input_shape
    # clamp chunks that overrun the slide so their output stays a
    # multiple of the patch output (infer/wsi.py:194-210)
    for axis in range(2):
        sel = c_in_br[:, axis] > img_shape[axis]
        extent = (img_shape[axis] - diff[axis]) - c_in_tl[sel, axis]
        extent = round_down(extent, patch_output_shape[axis])
        c_in_br[sel, axis] = c_in_tl[sel, axis] + extent + diff[axis]
    c_out_tl = c_in_tl + diff // 2
    c_out_br = c_in_br - diff // 2
    chunk_info = np.stack(
        [np.stack([c_in_tl, c_in_br], axis=1), np.stack([c_out_tl, c_out_br], axis=1)],
        axis=1,
    )
    return chunk_info, patch_info


def select_patches_in_chunk(patch_info, chunk_info, patch_input_shape):
    """Patches whose input top-left lies within the chunk's feedable
    region (infer/wsi.py:341-349)."""
    start = chunk_info[0, 0]
    end = chunk_info[0, 1] - np.asarray(patch_input_shape)
    tl = patch_info[:, 0, 0]
    sel = (
        (tl[:, 0] >= start[0]) & (tl[:, 0] <= end[0])
        & (tl[:, 1] >= start[1]) & (tl[:, 1] <= end[1])
    )
    return patch_info[sel]


def touches_tissue(mask: np.ndarray, boxes: np.ndarray, proc_h: int):
    """[K] bool: each (tl, br) box of `boxes` [K, 2, 2] (slide pixels),
    scaled to `mask` and rounded, covers a tissue pixel."""
    if boxes.shape[0] == 0:
        return np.zeros(0, bool)
    ratio = mask.shape[0] / proc_h
    b = np.rint(boxes * ratio).astype(np.int64)
    mh, mw = mask.shape
    ii = np.zeros((mh + 1, mw + 1), np.int64)
    np.cumsum((mask > 0).cumsum(axis=0), axis=1, out=ii[1:, 1:])
    r0, r1 = np.clip(b[:, 0, 0], 0, mh), np.clip(b[:, 1, 0], 0, mh)
    c0, c1 = np.clip(b[:, 0, 1], 0, mw), np.clip(b[:, 1, 1], 0, mw)
    return (ii[r1, c1] - ii[r0, c1] - ii[r1, c0] + ii[r0, c0]) > 0


def slide_patches(shape, mask, chunk: int, win: int, step: int):
    """[K, 2, 2, 2] patch boxes (input | output, tl | br, y | x) the
    forward runs over a slide of `shape` (y, x): those fed by some chunk
    whose output box touches tissue, chunk by chunk."""
    shape = np.asarray(shape, np.int64)
    chunks, patches = wsi_chunk_patch_grids(
        shape, np.array([chunk] * 2), np.array([win] * 2),
        np.array([step] * 2))
    out = []
    for c in chunks:
        sub = select_patches_in_chunk(patches, c, (win, win))
        out.append(sub[touches_tissue(mask, sub[:, 1], int(shape[0]))])
    return np.concatenate(out) if out else np.zeros((0, 2, 2, 2), np.int64)


def canonical_window(shape, tl, br):
    """The post-processing window of box (tl, br): (anchor (y, x), shape
    (hc, wc)), rounded up to multiples of 256 and kept inside the slide."""
    img_h, img_w = int(shape[0]), int(shape[1])
    h, w = int(br[0] - tl[0]), int(br[1] - tl[1])
    hc = min(-(-h // 256) * 256, -(-img_h // 256) * 256)
    wc = min(-(-w // 256) * 256, -(-img_w // 256) * 256)
    return ((max(min(int(tl[0]), img_h - hc), 0),
             max(min(int(tl[1]), img_w - wc), 0)), (hc, wc))


def slide_windows(shape, mask, tile: int, ambiguous: int):
    """[(hc, wc)] of every post-processing window of the three phases
    (full tiles, boundary strips, corner crosses) that touches tissue and
    holds slide pixels."""
    shape = np.asarray(shape, np.int64)
    out = []
    for grid in wsi_tile_grids(shape, np.array([tile] * 2), ambiguous):
        grid = grid[touches_tissue(mask, grid, int(shape[0]))]
        for tl, br in grid:
            if (np.minimum(br, shape) - np.maximum(tl, 0)).min() <= 0:
                continue
            out.append(canonical_window(shape, tl, br)[1])
    return out


def tile_canvas(hw, win: int, step: int):
    """(exact grid (rows, cols), canonical canvas (h, w)) of a tile of
    size `hw`: the post-processing map covers the canonical grid."""
    _, _, grid = prepare_tile_patching(hw, win, step)
    rows, cols = bucket_grid_dim(grid[0]), bucket_grid_dim(grid[1])
    return grid, (rows * step, cols * step)
