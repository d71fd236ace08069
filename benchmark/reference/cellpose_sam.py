"""Plain float32 Cellpose-SAM and Cellpose's mask dynamics: the benchmark's
reference of the `cellpose_sam_he` configuration.

Written from Pachitariu, Rariden & Stringer, "Cellpose-SAM: superhuman
generalization for cellular segmentation" (bioRxiv, 2025) and Cellpose 4
(github.com/MouseLand/cellpose: cellpose/vit_sam.py::Transformer with
backbone "vit_l", ps 8, nout 3, bsize 256; dynamics.py; metrics.py
`flow_error`; utils.py `fill_holes_and_remove_small_masks`;
transforms.py `normalize99`), on the Segment Anything image encoder
(segment_anything/modeling/image_encoder.py, build_sam_vit_l). It imports
nothing of the measured package and no JAX. Its module tree, and so its
`state_dict()` keys, are Cellpose's (`encoder.*`, `out.*`, `W2`,
`diam_labels`, `diam_mean`).

The forward (`CellposeRef`, TF32 off unless `strict` is False): the
patch embedding 8x8 at stride 8, 3 -> 1024, plus `pos_embed` [1, 32, 32,
1024]; 24 SAM blocks (`reference/cellvit.py`'s `Block` and `Attention`:
LayerNorm eps 1e-6, qkv with bias, S = (q d^-1/2) k^T + R_h + R_w written
out as SAM writes it, softmax, times v, proj; MLP 4096 with exact GELU),
each global over the 32^2 tokens (Cellpose sets `window_size` 0), its
tables of 27 or 127 rows resized linearly to 63; the neck (1x1 conv,
LayerNorm2d, 3x3 conv, LayerNorm2d); `out`, 1x1 conv 256 -> 192; then
`conv_transpose2d(., W2, stride=8)` with the fixed identity `W2`.

The dynamics (`compute_masks`) are Cellpose's code as published, loops
over masks and seeds included: `follow_flows` / `steps_interp`
(`grid_sample`), `get_masks_torch`, `remove_bad_flow_masks` with
`masks_to_flows_gpu` (torch diffusion from `get_centers`' centres) and
`flow_error` (scipy.ndimage.mean), `fill_holes_and_remove_small_masks`.

Departures from the published code, each small:
- `fastremap` and `fill_voids` are not installed: `np.unique`,
  `np.isin` and a renumbering in ascending order stand in for
  `fastremap.unique`, `.mask` and `.renumber` (which renumbers in order
  of appearance: the masks are the same up to their ids), and
  `scipy.ndimage.binary_fill_holes` (4-connected background, as
  `fill_voids.fill` in 2-D) for `fill_voids.fill`;
- the masks under `min_size` are found by their own pixel counts;
- the seeds are sorted by a stable sort (Cellpose's `argsort` leaves ties
  to the backend);
- the tile is run as the program runs it (HoVer-Net's stitching: 256^2
  blocks at stride 224, reflect padding, each block's centre 224^2
  kept), where Cellpose's `run_net` blends blocks at `tile_overlap` 0.1
  with a taper mask.

Every convolution, linear layer and attention matmul applies the module's
`quant` when one is set (`cellvit.set_quant`): the fp8 control.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import binary_fill_holes, find_objects
from scipy.ndimage import mean as nd_mean
from torch import nn

from .cellvit import Block, Conv, LayerNorm2d, PatchEmbed
from .model import strict_fp32

# the architecture keys a configuration file gives, with Cellpose-SAM's
# published values (vit_sam.Transformer("vit_l", ps=8, nout=3, bsize=256)
# on build_sam_vit_l)
SAM_L = {"sam_img_size": 1024, "sam_patch_size": 16, "patch_size": 8,
         "embed_dim": 1024, "depth": 24, "num_heads": 16, "mlp_ratio": 4.0,
         "window_size": 14, "global_attn_indexes": [5, 11, 17, 23],
         "out_chans": 256, "nout": 3, "bsize": 256}
HEADS = ("out",)


class Encoder(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        dim = a["embed_dim"]
        sam_grid = a["sam_img_size"] // a["sam_patch_size"]
        grid = a["bsize"] // a["patch_size"]
        self.patch_embed = PatchEmbed(a["patch_size"], dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        glob = set(a["global_attn_indexes"])
        self.blocks = nn.ModuleList(
            Block(dim, a["num_heads"], a["mlp_ratio"],
                  0 if i in glob else a["window_size"], sam_grid)
            for i in range(a["depth"]))
        for blk in self.blocks:  # Cellpose: blk.window_size = 0
            blk.window = 0
        out = a["out_chans"]
        self.neck = nn.Sequential(Conv(dim, out, 1, bias=False),
                                  LayerNorm2d(out),
                                  Conv(out, out, 3, padding=1, bias=False),
                                  LayerNorm2d(out))


class CellposeRef(nn.Module):
    """NCHW float32 normalised images -> [B, 3, H, W] float32 [dY, dX,
    cellprob] (Cellpose's `Transformer.forward` at inference)."""

    strict = True

    def __init__(self, arch: dict):
        super().__init__()
        a = {**SAM_L, **{k: arch[k] for k in SAM_L if k in arch}}
        self.arch = a
        ps, nout = a["patch_size"], a["nout"]
        self.encoder = Encoder(a)
        self.out = Conv(a["out_chans"], nout * ps ** 2, kernel_size=1)
        self.W2 = nn.Parameter(torch.eye(nout * ps ** 2).reshape(
            nout * ps ** 2, nout, ps, ps), requires_grad=False)
        self.diam_labels = nn.Parameter(torch.tensor([30.0]),
                                        requires_grad=False)
        self.diam_mean = nn.Parameter(torch.tensor([30.0]),
                                      requires_grad=False)

    def forward(self, x):
        with strict_fp32() if self.strict else contextlib.nullcontext():
            x = self.encoder.patch_embed(x.float())
            x = x + self.encoder.pos_embed
            for blk in self.encoder.blocks:
                x = blk(x)
            x = self.encoder.neck(x.permute(0, 3, 1, 2))
            x1 = self.out(x)
            return F.conv_transpose2d(x1, self.W2.to(x1.dtype),
                                      stride=self.arch["patch_size"],
                                      padding=0)


def normalize99(img: np.ndarray) -> np.ndarray:
    """Cellpose's `normalize_img` at its defaults on an [H, W, C] image:
    each channel with a range `normalize99`'d by its 1st and 99th
    percentiles, float32."""
    x = img.astype(np.float32)
    for c in range(x.shape[-1]):
        if np.ptp(x[..., c]) > 0.0:
            x01 = np.percentile(x[..., c], 1.0)
            x99 = np.percentile(x[..., c], 99.0)
            if x99 - x01 > 1e-3:
                x[..., c] = (x[..., c] - x01) / (x99 - x01)
            else:
                x[..., c] = 0
    return x


class CellposeReference:
    """The reference's map of a tile: `normalize99`, reflect padding, the
    256^2 blocks at stride 224 (the program's grid), each block's centre
    224^2, stitched; [H, W, 3] float32 [dY, dX, cellprob]. `rounding`
    (`lowp.ROUNDINGS`) puts the control's rounding on every convolution,
    linear layer and attention matmul but the 1x1 readout."""

    def __init__(self, cfg: dict, weights: str, device: str,
                 rounding=None, batch: int = 8):
        from .cellvit import set_quant
        from .lowp import ROUNDINGS

        self.cfg, self.device, self.batch = cfg, device, batch
        self.model = CellposeRef(cfg)
        state = torch.load(weights, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["desc"])
        self.model.to(device).eval()
        if rounding is not None:
            set_quant(self.model, ROUNDINGS[rounding], HEADS)
        self.win, self.step = cfg["patch_input"], cfg["patch_output"]

    @torch.no_grad()
    def patches(self, patches: np.ndarray) -> np.ndarray:
        m = (self.win - self.step) // 2
        out = []
        for i in range(0, len(patches), self.batch):
            x = torch.from_numpy(np.ascontiguousarray(
                patches[i:i + self.batch])).to(self.device)
            y = self.model(x.permute(0, 3, 1, 2))
            out.append(y[:, :, m:m + self.step, m:m + self.step]
                       .permute(0, 2, 3, 1).float().cpu().numpy())
        return np.concatenate(out)

    def tile(self, img: np.ndarray) -> np.ndarray:
        from .geometry import prepare_tile_patching

        h, w = img.shape[:2]
        x = normalize99(img)
        pads, coords, grid = prepare_tile_patching((h, w), self.win,
                                                   self.step)
        padded = np.pad(x, ((pads[0], pads[1]), (pads[2], pads[3]), (0, 0)),
                        mode="reflect")
        maps = self.patches(np.stack([padded[y:y + self.win, x0:x0 + self.win]
                                      for y, x0 in coords]))
        c = maps.shape[-1]
        full = maps.reshape(grid[0], grid[1], self.step, self.step, c)
        full = full.transpose(0, 2, 1, 3, 4).reshape(
            grid[0] * self.step, grid[1] * self.step, c)
        return full[:h, :w]


# --------------------------------------------------------- the dynamics
# (Cellpose 4's code, at compute_masks' defaults)

def steps_interp(dP, inds, niter, device=torch.device("cpu")):
    shape = dP.shape[1:]
    ndim = len(shape)
    pt = torch.zeros((*[1] * ndim, len(inds[0]), ndim), dtype=torch.float32,
                     device=device)
    im = torch.zeros((1, ndim, *shape), dtype=torch.float32, device=device)
    for n in range(ndim):
        pt[0, 0, :, ndim - n - 1] = torch.from_numpy(inds[n]).to(
            device, dtype=torch.float32)
        im[0, ndim - n - 1] = torch.from_numpy(dP[n]).to(
            device, dtype=torch.float32)
    shape = np.array(shape)[::-1].astype("float") - 1
    for k in range(ndim):
        im[:, k] *= 2. / shape[k]
        pt[..., k] /= shape[k]
    pt *= 2
    pt -= 1
    for t in range(niter):
        dPt = torch.nn.functional.grid_sample(im, pt, align_corners=False)
        for k in range(ndim):
            pt[..., k] = torch.clamp(pt[..., k] + dPt[:, k], -1., 1.)
    pt += 1
    pt *= 0.5
    for k in range(ndim):
        pt[..., k] *= shape[k]
    pt = pt[..., [1, 0]].squeeze()
    pt = pt.unsqueeze(0) if pt.ndim == 1 else pt
    return pt.T


def follow_flows(dP, inds, niter=200, device=torch.device("cpu")):
    return steps_interp(dP, inds, niter, device=device)


def max_pool1d(h, kernel_size=5, axis=1, out=None):
    if out is None:
        out = h.clone()
    else:
        out.copy_(h)
    nd = h.shape[axis]
    k0 = kernel_size // 2
    for d in range(-k0, k0 + 1):
        if axis == 1:
            mv = out[:, max(-d, 0):min(nd - d, nd)]
            hv = h[:, max(d, 0):min(nd + d, nd)]
        else:
            mv = out[:, :, max(-d, 0):min(nd - d, nd)]
            hv = h[:, :, max(d, 0):min(nd + d, nd)]
        torch.maximum(mv, hv, out=mv)
    return out


def max_pool_nd(h, kernel_size=5):
    hmax = max_pool1d(h, kernel_size=kernel_size, axis=1)
    return max_pool1d(hmax, kernel_size=kernel_size, axis=2)


def _renumber(m: np.ndarray) -> np.ndarray:
    u, inv = np.unique(m, return_inverse=True)
    if u[0] != 0:
        return (inv + 1).reshape(m.shape).astype(m.dtype)
    return inv.reshape(m.shape).astype(m.dtype)


def get_masks_torch(pt, inds, shape0, rpad=20, max_size_fraction=0.4):
    ndim = len(shape0)
    pt += rpad
    pt = torch.clamp(pt, min=0)
    for i in range(pt.shape[0]):
        pt[i] = torch.clamp(pt[i], max=shape0[i] + rpad - 1)
    shape = tuple(np.array(shape0) + 2 * rpad)
    coo = torch.sparse_coo_tensor(pt, torch.ones(pt.shape[1],
                                                 device=pt.device,
                                                 dtype=torch.int), shape,
                                  check_invariants=False)
    h1 = coo.to_dense()
    del coo
    hmax1 = max_pool_nd(h1.unsqueeze(0), kernel_size=5)
    hmax1 = hmax1.squeeze()
    seeds1 = torch.nonzero((h1 - hmax1 > -1e-6) * (h1 > 10))
    del hmax1
    if len(seeds1) == 0:
        return np.zeros(shape0, dtype="uint16"), 0
    npts = h1[tuple(seeds1.T)]
    isort1 = npts.argsort(stable=True)
    seeds1 = seeds1[isort1]
    n_seeds = len(seeds1)
    h_slc = torch.zeros((n_seeds, *[11] * ndim), device=seeds1.device)
    for k in range(n_seeds):
        slc = tuple([slice(seeds1[k][j] - 5, seeds1[k][j] + 6)
                     for j in range(ndim)])
        h_slc[k] = h1[slc]
    del h1
    seed_masks = torch.zeros((n_seeds, *[11] * ndim), device=seeds1.device)
    seed_masks[:, 5, 5] = 1
    for iter in range(5):
        seed_masks = max_pool_nd(seed_masks, kernel_size=3)
        seed_masks *= h_slc > 2
    del h_slc
    seeds_new = [tuple((torch.nonzero(seed_masks[k]) + seeds1[k] - 5).T)
                 for k in range(n_seeds)]
    del seed_masks
    dtype = torch.int32 if n_seeds < 2**16 else torch.int64
    M1 = torch.zeros(shape, dtype=dtype, device=pt.device)
    for k in range(n_seeds):
        M1[seeds_new[k]] = 1 + k
    M1 = M1[tuple(pt)]
    M1 = M1.cpu().numpy()
    dtype = "uint16" if n_seeds < 2**16 else "uint32"
    M0 = np.zeros(shape0, dtype=dtype)
    M0[inds] = M1
    uniq, counts = np.unique(M0, return_counts=True)
    big = np.prod(shape0) * max_size_fraction
    bigc = uniq[counts > big]
    if len(bigc) > 0 and (len(bigc) > 1 or bigc[0] != 0):
        M0[np.isin(M0, bigc)] = 0
    M0 = _renumber(M0)
    return M0.reshape(tuple(shape0)), n_seeds


def get_centers(masks, slices):
    centers = np.zeros((len(slices), 2), "int32")
    exts = np.zeros((len(slices),), "int32")
    for p in range(len(slices)):
        si = slices[p]
        i = si[0]
        sr, sc = si[1:3], si[3:5]
        yi, xi = np.nonzero(masks[sr[0]:sr[-1], sc[0]:sc[-1]] == (i + 1))
        ymed = yi.mean()
        xmed = xi.mean()
        imin = ((xi - xmed)**2 + (yi - ymed)**2).argmin()
        ymed = yi[imin] + sr[0]
        xmed = xi[imin] + sc[0]
        centers[p] = np.array([ymed, xmed])
        exts[p] = (sr[1] - sr[0]) + (sc[1] - sc[0]) + 2
    return centers, exts


def _extend_centers_gpu(neighbors, meds, isneighbor, shape, n_iter=200,
                        device=torch.device("cpu")):
    T = torch.zeros(shape, dtype=torch.double, device=device)
    for i in range(n_iter):
        T[tuple(meds.T)] += 1
        Tneigh = T[tuple(neighbors)]
        Tneigh *= isneighbor
        T[tuple(neighbors[:, 0])] = Tneigh.mean(axis=0)
    del meds, isneighbor, Tneigh
    grads = T[neighbors[0, [2, 1, 4, 3]], neighbors[1, [2, 1, 4, 3]]]
    del neighbors
    dy = grads[0] - grads[1]
    dx = grads[2] - grads[3]
    del grads
    mu_torch = np.stack((dy.cpu().squeeze(0), dx.cpu().squeeze(0)), axis=-2)
    return mu_torch


def masks_to_flows_gpu(masks, device=torch.device("cpu"), niter=None):
    if masks.max() > 0:
        Ly0, Lx0 = masks.shape
        masks_padded = torch.from_numpy(masks.astype("int64")).to(device)
        masks_padded = F.pad(masks_padded, (1, 1, 1, 1))
        shape = masks_padded.shape
        y, x = torch.nonzero(masks_padded, as_tuple=True)
        y = y.int()
        x = x.int()
        neighbors = torch.zeros((2, 9, y.shape[0]), dtype=torch.int,
                                device=device)
        yxi = [[0, -1, 1, 0, 0, -1, -1, 1, 1], [0, 0, 0, -1, 1, -1, 1, -1, 1]]
        for i in range(9):
            neighbors[0, i] = y + yxi[0][i]
            neighbors[1, i] = x + yxi[1][i]
        isneighbor = torch.ones((9, y.shape[0]), dtype=torch.bool,
                                device=device)
        m0 = masks_padded[neighbors[0, 0], neighbors[1, 0]]
        for i in range(1, 9):
            isneighbor[i] = masks_padded[neighbors[0, i], neighbors[1, i]] \
                == m0
        del m0, masks_padded
        slices = find_objects(masks)
        slices = np.array([
            np.array([i, si[0].start, si[0].stop, si[1].start, si[1].stop])
            for i, si in enumerate(slices) if si is not None])
        centers, ext = get_centers(masks, slices)
        meds_p = torch.from_numpy(centers).to(device).long()
        meds_p += 1
        n_iter = 2 * ext.max() if niter is None else niter
        mu = _extend_centers_gpu(neighbors.long(), meds_p, isneighbor, shape,
                                 n_iter=n_iter, device=device)
        mu = mu.astype("float64")
        mu /= (1e-60 + (mu**2).sum(axis=0)**0.5)
        mu0 = np.zeros((2, Ly0, Lx0))
        mu0[:, y.cpu().numpy() - 1, x.cpu().numpy() - 1] = mu
    else:
        mu0 = np.zeros((2, masks.shape[0], masks.shape[1]))
    return mu0


def flow_error(maski, dP_net, device=None):
    dP_masks = masks_to_flows_gpu(maski, device=device)
    flow_errors = np.zeros(maski.max())
    for i in range(dP_masks.shape[0]):
        flow_errors += nd_mean((dP_masks[i] - dP_net[i] / 5.)**2, maski,
                               index=np.arange(1, maski.max() + 1))
    return flow_errors, dP_masks


def remove_bad_flow_masks(masks, flows, threshold=0.4,
                          device=torch.device("cpu")):
    merrors, _ = flow_error(masks, flows, device)
    badi = 1 + (merrors > threshold).nonzero()[0]
    masks[np.isin(masks, badi)] = 0
    return masks, len(badi)


def fill_holes_and_remove_small_masks(masks, min_size=15):
    n_small = 0
    if min_size > 0:
        ids, counts = np.unique(masks, return_counts=True)
        small = ids[(counts < min_size) & (ids > 0)]
        n_small = len(small)
        masks[np.isin(masks, small)] = 0
        masks = _renumber(masks)
    slices = find_objects(masks)
    j = 0
    for i, slc in enumerate(slices):
        if slc is not None:
            msk = masks[slc] == (i + 1)
            msk = binary_fill_holes(msk)
            masks[slc][msk] = (j + 1)
            j += 1
    return masks, n_small


def compute_masks(dP, cellprob, niter=200, cellprob_threshold=0.0,
                  flow_threshold=0.4, min_size=15, max_size_fraction=0.4,
                  device=torch.device("cpu")) -> Tuple[np.ndarray, dict]:
    """(masks, {"n_seeds", "n_dropped_flow_error", "n_dropped_small"}) of
    the net's dP [2, H, W] and cellprob [H, W] (numpy float32)."""
    counts = {"n_seeds": 0, "n_dropped_flow_error": 0, "n_dropped_small": 0}
    if (cellprob > cellprob_threshold).sum():
        inds = np.nonzero(cellprob > cellprob_threshold)
        p_final = follow_flows(dP * (cellprob > cellprob_threshold) / 5.,
                               inds=inds, niter=niter, device=device)
        p_final = p_final.int()
        mask, counts["n_seeds"] = get_masks_torch(
            p_final, inds, dP.shape[1:], max_size_fraction=max_size_fraction)
        del p_final
        if mask.max() > 0 and flow_threshold is not None \
                and flow_threshold > 0:
            mask, counts["n_dropped_flow_error"] = remove_bad_flow_masks(
                mask, dP, threshold=flow_threshold, device=device)
        if mask.max() < 2**16 and mask.dtype != "uint16":
            mask = mask.astype("uint16")
    else:
        mask = np.zeros(dP.shape[1:], "uint16")
    if min_size > 0:
        mask, counts["n_dropped_small"] = \
            fill_holes_and_remove_small_masks(mask, min_size=min_size)
    return mask, counts


def masks_of_map(flow_map: np.ndarray, device="cpu"):
    """`compute_masks` of an [H, W, 3] [dY, dX, cellprob] map."""
    dP = np.ascontiguousarray(flow_map[..., :2].transpose(2, 0, 1),
                              dtype=np.float32)
    cellprob = np.ascontiguousarray(flow_map[..., 2], dtype=np.float32)
    return compute_masks(dP, cellprob, device=torch.device(device))
