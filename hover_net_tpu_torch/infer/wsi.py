"""WSI inference on one or several CUDA devices: a slide -> per-nucleus json.

Counterpart of hover_net_tpu/infer/wsi.py, with its structure:

- chunked inference: a prefetch thread reads chunk k+2 of the slide and
  pushes it to the device while the main thread gathers and forwards the
  masked patches of chunk k in batches (`_run_chunk`); outputs are cast
  to the pred map's dtype (float16 by default) on the device;
- the stitched prediction map stays on the device when it fits
  `hbm_pred_budget` (`_alloc_pred_dev`, `scatter_patches`); otherwise a
  writer thread pulls the outputs into an `.npy` mmap;
- tissue selection by a summed-area table of the mask;
- the 3-phase boundary-consistent post-processing (full tiles, boundary
  strips, 4-corner crosses) over canonical windows, batched on the
  device: out-of-slide zeroing, the valid mask from the boxes, the Sobel
  energy, the post-processing tail (kernel K1 on a GPU) and uint16 label
  compaction; a staging thread reads mmap windows ahead, `inflight`
  batches stay queued, a pool extracts instances, and the callbacks that
  renumber and stitch run in order. Where the pred map is resident on one
  device, the slide's instance map lives beside it and the callbacks'
  whole-window passes run there on the tail's labels; each window's
  instance tables are built there too, and the host pulls them in place
  of the labels and keeps the per-nucleus dict;
- resume: a slide whose json exists is skipped.

Several devices (`n_devices` > 1, or an explicit `devices` list of more
than one slot, which may repeat a device) build a mesh
(parallel/mesh.py), and the JAX manager's mesh branches run in one
process:

- each forward batch is `batch_size` times the slots, split into
  consecutive `batch_size` shards, so that every shard is a batch the
  single-device path runs; each runs on its slot's device with that
  device's model replica, and the chunk image is pushed once to each
  distinct device;
- the device pred buffer is row-striped (`_alloc_pred_dev`): each slot
  owns `s_rows` core rows plus `_stripe_halo(patch_output)` landing
  rows on either side, and the budget is `hbm_pred_budget` a slot; the
  batch's outputs are gathered to every slot, which writes the patches
  that touch its core rows (`_scatter`);
- a window batch is `batch` windows a slot: each slot cuts every
  window's overlap with its core rows, a `psum_scatter` hands slot d its
  shard fully assembled, and the post-processing tail (K1 on a GPU) runs
  on slot d's device (`_pp_windows`); on the mmap path each window batch
  is split over the slots the same way. Core rows are disjoint, so the
  sum adds exact zeros and the instance map is the single-device path's,
  bit for bit;
- each shard's forward runs whole on one device, so `_use_fused_enc`
  decides there as on one device: where it allows K3 (a bf16 fast model
  on a card) the encoder is kernel K3 on every slot. The JAX manager
  keeps the standard encoder under a mesh, where GSPMD cannot partition
  the Pallas call; one process that runs each shard on its own device
  has no such limit.

Differences from the JAX manager, all of them deliberate:

- K1 solves every window whole, so there is no seam guard;
- no post-proc prewarm: PyTorch compiles no programs ahead;
- eager PyTorch has no compiled batch shape to keep, so the last forward
  batch of a chunk and the last window batch of a shape class run at
  their own size instead of being padded (under a mesh the last shards
  are short or empty, and an empty shard launches nothing).
  `scatter_patches` keeps the clamp of `lax.dynamic_update_slice` all
  the same; the striped scatter writes a patch only into the stripes
  whose core rows it touches, where the JAX scatter parks the others in
  the dead top halo;
- no `force_mesh`: a `devices` list that repeats one device builds the
  mesh on one card, which is what the JAX flag was for.
"""

from __future__ import annotations

import glob
import logging
import os
import pathlib
import queue
import shutil
import threading
import time
from collections import deque
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import cv2
import numpy as np
import torch

from ..data.tiling import (
    select_patches_in_chunk,
    wsi_chunk_patch_grids,
    wsi_tile_grids,
)
from ..metrics.stats import remap_label
from ..ops import cc_np
from ..ops.post_proc_device import (
    compact_labels_u16,
    proc_np_hv_batch,
    remap_labels_u16,
    window_caps,
    window_tables,
)
from ..ops.post_proc_host import (
    extract_instance_info,
    instance_info_from_tables,
    instance_info_lut,
)
from ..parallel.mesh import (
    Mesh,
    all_gather,
    make_mesh,
    psum_scatter,
    replicate,
    shard_batch,
    shard_bounds,
)
from ..runtime import forward_events, span
from . import base
from .steps import StageEvents, extract_patches, flow_outputs, infer_output
from .wsi_handler import get_file_handler

logger = logging.getLogger("hover_net_tpu_torch")

# landing rows above and below each slot's core stripe of the striped
# device pred buffer: at least one patch output, so that a patch that
# straddles a stripe border lands whole in both neighbours' stripes
_STRIPE_HALO = 256


def _stripe_halo(out_sz: int) -> int:
    """The landing rows for patch outputs of `out_sz`: `_STRIPE_HALO`, or
    `out_sz` rounded up to 256 where that is more (CellViT's 960)."""
    return max(_STRIPE_HALO, -(-out_sz // 256) * 256)


def _warn_u16_overflow(n_labels):
    """Loud signal if the uint16 window compaction clipped: every instance
    ranked >= 65535 was aliased into one label. `n_labels`: the label
    counts of each shard of a window batch."""
    n = max(int(t.max()) for t in n_labels)
    if n > 65535:
        logger.warning(
            "uint16 window compaction overflow: %d instances in one "
            "post-proc window (> 65535) — ids were aliased; rerun with a "
            "smaller tile_shape or inspect the prediction", n)


def _simple_tissue_mask(handler):
    """Otsu at 1.25x + morphology, as the JAX manager builds it."""
    thumb = handler.get_full_img(read_mag=1.25)
    gray = cv2.cvtColor(thumb, cv2.COLOR_RGB2GRAY)
    _, mask = cv2.threshold(gray, 0, 255, cv2.THRESH_OTSU)
    mask = cc_np.remove_small_objects(mask == 0, min_size=16 * 16,
                                      connectivity=2)
    mask = cc_np.remove_small_holes(mask, area_threshold=128 * 128)
    return cc_np.binary_dilation_disk(mask, 16)


def _clamp_starts(coords: np.ndarray, dims, size) -> np.ndarray:
    """Start indices clamped into [0, dim - size] per axis, as
    `lax.dynamic_slice` / `dynamic_update_slice` clamp them."""
    hi = np.asarray(dims, np.int64) - np.asarray(size, np.int64)
    return np.clip(np.asarray(coords, np.int64), 0, np.maximum(hi, 0))


def scatter_patches(buf: torch.Tensor, outs: torch.Tensor,
                    coords: np.ndarray) -> None:
    """Write patch outputs [K, h, w, C] into the pred buffer [H, W, C] at
    top-lefts `coords` [K, 2], in order and in place. Starts clamp as in
    the JAX scatter (`dynamic_update_slice`): a coordinate past the
    buffer (the JAX "dustbin") lands in its bottom-right slack, which no
    window of the slide reads."""
    h, w = outs.shape[1], outs.shape[2]
    starts = _clamp_starts(coords, buf.shape[:2], (h, w))
    outs = outs.to(buf.dtype)
    for k, (y, x) in enumerate(starts):
        buf[y:y + h, x:x + w] = outs[k]


def _to_host_async(t: torch.Tensor):
    """Start the device->host copy of `t`: (host tensor, event to wait on
    before reading it, or None on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _timing_event(device: torch.device):
    """A timing CUDA event recorded now on `device`'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _host(pulled) -> np.ndarray:
    host, ev = pulled
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _host_cat(pulls) -> np.ndarray:
    """The pulls of a batch's shards, in order, as one array."""
    return np.concatenate([_host(p) for p in pulls], axis=0)


def _unpack_tables(row: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """One window's row of a pulled batch of tables -> {name: array}, by
    the `(name, shape)` layout they were packed in."""
    out, lo = {}, 0
    for name, shape in layout:
        size = int(np.prod(shape, dtype=np.int64))
        out[name] = row[lo:lo + size].reshape(shape)
        lo += size
    return out


def _id_table(ids: torch.Tensor, n: int, drop_min: bool = False):
    """[n] bool: which of the ids 0..n-1 occur in `ids` (int64, each
    below n); with `drop_min` the smallest that occurs left out, as
    `np.unique(ids)[1:]` leaves it out. The callbacks' stand-in for
    `np.unique`, `np.isin` and `np.setdiff1d`: fixed-size, no sort and no
    host read."""
    table = torch.zeros(n, dtype=torch.bool, device=ids.device)
    table.index_fill_(0, ids, True)
    if drop_min:
        table.index_fill_(0, ids.min().reshape(1), False)
    return table


def _ids_to_host(*tables):
    """`np.flatnonzero` of each bool table, through one copy to the
    host."""
    flat = _host(_to_host_async(torch.cat(tables)))
    out, lo = [], 0
    for t in tables:
        out.append(np.flatnonzero(flat[lo:lo + len(t)]))
        lo += len(t)
    return out


class WSIInferManager(base.InferManagerBase):
    # class-level defaults, so that instances built with __new__ (the
    # tests drive single methods) run on the CPU with the mmap pred map
    device = torch.device("cpu")
    mesh = None
    _stripe = None
    _mask_integral = None
    _slide_times = None
    _pred_dev_mode = False
    _pred_dev = None
    _part_events = None
    _cb_stream = None
    n_forward_batches = 0
    n_window_batches = 0
    n_window_shards = 0

    def __init__(self, *args, chunk_shape=10000, tile_shape=2048,
                 ambiguous_size=128, proc_mag=40, cache_path="cache",
                 pred_map_dtype="float16", hbm_pred_budget: int = 4 << 30,
                 **kwargs):
        """`n_devices`, `devices` and `device` pick the devices
        (`base.InferManagerBase`); more than one slot builds the mesh
        (`devices=["cuda:0"] * 2` prices the striped path against the
        single-device one on one card)."""
        super().__init__(*args, **kwargs)
        if flow_outputs(self.model):
            raise ValueError(f"{self.cfg.mode} runs through the tile "
                             f"manager only: Cellpose normalises each "
                             f"image by its own percentiles")
        self.chunk_shape = int(chunk_shape)
        self.tile_shape = int(tile_shape)
        self.ambiguous_size = int(ambiguous_size)
        self.proc_mag = proc_mag
        self.cache_path = cache_path
        # float16 (default) halves the pred map, its pulls and its disk
        # traffic; "float32" is the reference's dtype
        self.pred_map_dtype = np.dtype(pred_map_dtype)
        # the stitched prediction map stays on the device when it fits
        # this budget: no device->host pull of the outputs, no host->
        # device push of the post-proc windows
        self.hbm_pred_budget = int(hbm_pred_budget)
        self._pred_dev = None
        self._pred_dev_mode = False
        self._mask_integral = None
        # per slide (`process_single_file`): host seconds of `prepare`,
        # `inference` (of it `chunk_wait`), each `post_proc_phase{k}`
        # (of them `pp_extract` and `pp_callback`), `post_proc`, `save`,
        # and on the manager's first slide `model_build`; the device ms of
        # the chunk loop's forward batches (`forward_ms`, CUDA only), and
        # for a model that times parts of its forward (`forward_parts`:
        # CellViT's `vit_encoder`, `global_attn`, `window_attn`,
        # `vit_decoder`) their device ms, summed over the forward batches;
        # the phase callbacks run on the device's instance map
        # (`pp_callback_windows_dev`) or on a host map
        # (`pp_callback_windows_host`); the extraction's windows made
        # their dicts from the device's tables (`pp_extract_windows_tables`)
        # or from a dense map (`pp_extract_windows_dense`). And the forward
        # and window batches of the last slide
        self.mesh = (make_mesh(devices=self.devices)
                     if len(self.devices) > 1 else None)
        self.timings: Dict[str, Dict[str, float]] = {}
        self.n_forward_batches = 0
        self.n_window_batches = 0
        self.n_window_shards = 0

    # ------------------------------------------------------- device fns

    def _forward_batch(self, chunk_img: torch.Tensor, coords: torch.Tensor,
                       device: torch.device) -> torch.Tensor:
        """Gather + forward one batch of patches of a chunk (pushed to
        `device`) with `device`'s model; the outputs are cast to the pred
        map's dtype there."""
        out_dtype = (torch.float16 if self.pred_map_dtype == np.float16
                     else torch.float32)
        patches = extract_patches(chunk_img, coords,
                                  self.cfg.patch_input_shape)
        parts = None
        if self._part_events is not None and device.type == "cuda":
            parts = self._part_events.setdefault(device, StageEvents(device))
        token = forward_events.set(parts)
        try:
            with torch.no_grad():
                return infer_output(self.model_on(device),
                                    patches).to(out_dtype)
        finally:
            forward_events.reset(token)

    def _run_chunk(self, chunk_img, patch_coords: np.ndarray,
                   out_coords: np.ndarray | None = None, events=None):
        """Forward all selected patches of one chunk in batches.

        patch_coords: [K, 2] input top-lefts relative to the chunk. Under
        a mesh a batch is `batch_size` patches a slot, in consecutive
        shards (an empty shard runs nothing). Default: returns a list of
        (host tensor, event) pulls started here, one a shard in order,
        which the writer thread completes. Device-resident mode
        (out_coords given): the outputs scatter into the device pred
        buffer instead, and nothing crosses to the host. `events`, a
        list, receives a (start, end) pair of CUDA events around each
        forward shard on a CUDA device."""
        bs = self.batch_size
        slots = self._slots()
        imgs = self._push_chunk(chunk_img)
        if self.mesh is None:
            imgs = {self.device: imgs}
        coords = torch.from_numpy(patch_coords.astype(np.int64))
        coords = {dev: coords.to(dev) for dev in imgs}
        outs = []
        for i in range(0, len(patch_coords), bs * len(slots)):
            shards = []
            for dev, (lo, hi) in zip(slots, shard_bounds(
                    min(len(patch_coords) - i, bs * len(slots)), slots, bs)):
                if lo == hi:
                    break
                timed = events is not None and dev.type == "cuda"
                if timed:
                    start = _timing_event(dev)
                shards.append(self._forward_batch(
                    imgs[dev], coords[dev][i + lo:i + hi], dev))
                if timed:
                    events.append((start, _timing_event(dev)))
                self.n_forward_batches += 1
            if out_coords is None:
                outs += [_to_host_async(o) for o in shards]
            else:
                self._scatter(shards, out_coords[i:i + bs * len(slots)])
        return outs

    def _slots(self) -> Mesh:
        """The mesh, or one slot on the manager's device."""
        return self.mesh if self.mesh is not None else Mesh((self.device,))

    def _push_chunk(self, chunk_img):
        """Host->device push of one chunk image: a tensor, or under a mesh
        {device: tensor}, pushed once to each distinct device. No-op on
        what a push returned: the prefetch thread pushes ahead of the
        dispatch loop."""
        if isinstance(chunk_img, (torch.Tensor, dict)):
            return chunk_img
        img = torch.from_numpy(np.ascontiguousarray(chunk_img))
        if self.mesh is None:
            return img.to(self.device)
        return dict(zip(self.mesh, replicate(img, self.mesh)))

    def _scatter(self, shards, coords: np.ndarray) -> None:
        """Write a batch's output shards (one a slot, in slot order; the
        last slots' may be missing) at their top-lefts `coords` into the
        device pred buffer. Under a mesh the shards are gathered to every
        slot, and each slot writes the patches that touch its core rows
        at row `oy - row0 + halo` of its stripe (a straddling patch lands
        whole in both neighbours; halo copies are never read)."""
        if self.mesh is None:
            scatter_patches(self._pred_dev, shards[0], coords)
            return
        s_rows, halo = self._stripe
        coords = np.asarray(coords, np.int64)
        ph = shards[0].shape[1]
        gathered = all_gather(
            shards + [shards[0][:0]] * (len(self.mesh) - len(shards)),
            self.mesh)
        for d, (buf, outs) in enumerate(zip(self._pred_dev, gathered)):
            row0 = d * s_rows
            hit = np.flatnonzero((coords[:, 0] < row0 + s_rows)
                                 & (coords[:, 0] + ph > row0))
            if len(hit):
                scatter_patches(
                    buf, outs[torch.from_numpy(hit).to(outs.device)],
                    coords[hit] - (row0 - halo, 0))

    def _post_proc(self, seg: torch.Tensor, valid: torch.Tensor):
        """[B, H, W, 3] windows + [B, H, W] valid masks -> (uint16
        labels, [B] label counts): Sobel energy, the post-processing tail
        (K1 on a GPU), label compaction."""
        return compact_labels_u16(proc_np_hv_batch(seg, valid))

    def _pp_windows(self, shape, starts, boxes, batch: int):
        """Post-proc of a batch of canonical windows read from the device
        pred buffer. starts [B, 2] window anchors, boxes [B, 4] (y0, y1,
        x0, x1) valid boxes in window coordinates. Returns a list with
        one (inst uint16, n_labels, tp uint8 or None) for each shard.

        One device: one shard, the windows sliced from the buffer. Under a
        mesh, `batch` windows a slot: every slot cuts each window's
        overlap with its core rows (`_stripe_windows`), `psum_scatter`
        hands slot d its consecutive shard fully assembled, and slot d
        runs the tail on its own device; an empty shard runs nothing.
        The slots' tails are dispatched one after another from this
        thread. K1 reads a host flag every few watershed sweeps, so on
        distinct GPUs slot d + 1's tail starts only when slot d's K1
        returns: the slots' post-processing does not overlap yet."""
        if self.mesh is None:
            hc, wc = shape
            buf = self._pred_dev
            starts = _clamp_starts(starts, buf.shape[:2], shape)
            wins = torch.stack([buf[y:y + hc, x:x + wc] for y, x in starts])
            return [self._pp_tail(wins, starts, boxes)]
        parts = [self._stripe_windows(d, shape, starts)
                 for d in range(len(self.mesh))]
        out = []
        for wins, (lo, hi) in zip(
                psum_scatter(parts, self.mesh, batch),
                shard_bounds(len(starts), self.mesh, batch)):
            if lo < hi:
                out.append(self._pp_tail(wins, starts[lo:hi],
                                         boxes[lo:hi]))
        return out

    def _stripe_windows(self, d: int, shape, starts) -> torch.Tensor:
        """Slot d's part of a window batch: each window's rows inside the
        slot's core rows [row0, row0 + s_rows) copied from its stripe,
        zeros elsewhere (the JAX manager's clamped and masked gather);
        the window's column start clamps as `lax.dynamic_slice` clamps
        it."""
        hc, wc = shape
        buf = self._pred_dev[d]
        s_rows, halo = self._stripe
        row0 = d * s_rows
        part = torch.zeros((len(starts), hc, wc, buf.shape[-1]),
                           dtype=buf.dtype, device=buf.device)
        for k, (wy, wx) in enumerate(starts):
            wy, wx = int(wy), min(max(int(wx), 0), buf.shape[1] - wc)
            lo, hi = max(wy, row0), min(wy + hc, row0 + s_rows)
            if lo < hi:
                part[k, lo - wy:hi - wy] = buf[lo - row0 + halo:
                                               hi - row0 + halo, wx:wx + wc]
        return part

    def _pp_tail(self, wins: torch.Tensor, starts, boxes):
        """The post-processing tail of [B, hc, wc, C] windows on their
        device: the outside-slide part zeroed, the valid mask from the
        boxes, `_post_proc` (K1 on a GPU). Returns (inst uint16,
        n_labels, tp uint8 or None)."""
        hc, wc = wins.shape[1], wins.shape[2]
        dev = wins.device
        wins = wins.float()
        self.n_window_shards += 1
        ri = torch.arange(hc, device=dev)[None, :, None]
        ci = torch.arange(wc, device=dev)[None, None, :]
        s = torch.as_tensor(np.asarray(starts), device=dev)[:, :, None, None]
        img_h, img_w = (int(v) for v in self.wsi_proc_shape)
        # zero the outside-slide part of each window (the buffer's slack
        # may hold anything), as the mmap staging zero-fills it
        inimg = (ri + s[:, 0] < img_h) & (ci + s[:, 1] < img_w)
        wins = torch.where(inimg[..., None], wins, torch.zeros((), device=dev))
        typed = self.nr_types is not None
        seg = wins[..., 1:4] if typed else wins[..., 0:3]
        b = torch.as_tensor(np.asarray(boxes), device=dev)[:, :, None, None]
        valid = ((ri >= b[:, 0]) & (ri < b[:, 1])
                 & (ci >= b[:, 2]) & (ci < b[:, 3]))
        inst, nlab = self._post_proc(seg, valid)
        tp = wins[..., 0].to(torch.uint8) if typed else None
        return inst, nlab, tp

    def _alloc_pred_dev(self, out_ch: int):
        """The device-resident pred buffer; sets `_pred_dev` and
        `_stripe`.

        One device: one zeroed (Bh, Bw, C) block, 256-aligned with one
        patch output of slack per axis (covers every canonical window
        class and edge patch overruns). Mesh: row-striped, a list of one
        (s_rows + 2 * halo, Bw, C) block a slot on the slot's device,
        s_rows = Bh / slots rounded up to 256; slot d's core rows
        [d * s_rows, (d + 1) * s_rows) sit at [halo, halo + s_rows)."""
        proc_shape = tuple(int(v) for v in self.wsi_proc_shape)
        out_sz = self.cfg.patch_output_shape
        bh = -(-(proc_shape[0] + out_sz) // 256) * 256
        bw = -(-(proc_shape[1] + out_sz) // 256) * 256
        dt = (torch.float16 if self.pred_map_dtype == np.float16
              else torch.float32)
        if self.mesh is None:
            self._stripe = None
            self._pred_dev = torch.zeros((bh, bw, out_ch), dtype=dt,
                                         device=self.device)
        else:
            halo = _stripe_halo(out_sz)
            s_rows = -(-(-(-bh // len(self.mesh))) // 256) * 256
            self._stripe = (s_rows, halo)
            self._pred_dev = [torch.zeros((s_rows + 2 * halo, bw, out_ch),
                                          dtype=dt, device=dev)
                              for dev in self.mesh]
        self._pred_dev_mode = True

    def _get_raw_prediction(self, chunk_info, patch_info):
        """Chunk loop: read region -> device forward -> the writer thread
        assembles the pred map mmap; in device-resident mode the outputs
        scatter into the device buffer instead. Into the slide's timings:
        the main thread's wait for the prefetch thread's chunks
        (`chunk_wait`, span `hnt.wsi.chunk_wait`) and the forward
        batches' device ms (`forward_ms`, read once the loop has
        synchronised) and, for a model with `forward_parts`, the device
        ms of each part its forward batches time."""
        times = self._slide_times
        fwd_events = []
        self._part_events = ({} if hasattr(self.model, "forward_parts")
                             else None)
        write_q: "queue.Queue" = queue.Queue(maxsize=4)

        def writer():
            if self._pred_dev_mode:
                return
            pred_map = np.load(self._pred_map_path, mmap_mode="r+")
            while True:
                item = write_q.get()
                if item is None:
                    break
                _, pulls, coords = item
                outputs = np.concatenate([_host(p) for p in pulls], axis=0)
                ph, pw = outputs.shape[1:3]
                for k, (y, x) in enumerate(coords):
                    pred_map[y:y + ph, x:x + pw] = outputs[k]
                del outputs
            pred_map.flush()

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

        def read_chunk(idx):
            """Host side of one chunk on the prefetch thread: mask-select
            the patches, read the region, push it to the device."""
            cinfo = chunk_info[idx]
            sub = select_patches_in_chunk(
                patch_info, cinfo, (self.cfg.patch_input_shape,) * 2)
            sub = self._select_masked_patches(sub)
            if sub.shape[0] == 0:
                return None
            tl = cinfo[0, 0]
            read_size = (cinfo[0, 1] - cinfo[0, 0])[::-1]  # (w, h)
            chunk_img = self.wsi_handler.read_region(tl[::-1], read_size)
            rel_in_tl = (sub[:, 0, 0] - tl).astype(np.int32)
            return tl, self._push_chunk(chunk_img), rel_in_tl, sub[:, 1, 0]

        n_chunks = chunk_info.shape[0]
        try:
            with ThreadPoolExecutor(max_workers=1) as ex:
                futs = deque(ex.submit(read_chunk, i)
                             for i in range(min(2, n_chunks)))
                for idx in range(n_chunks):
                    with span("hnt.wsi.chunk_wait", times, "chunk_wait"):
                        item = futs.popleft().result()
                    if idx + 2 < n_chunks:
                        futs.append(ex.submit(read_chunk, idx + 2))
                    if item is None:
                        continue
                    tl, chunk_img, rel_in_tl, out_coords = item
                    if self._pred_dev_mode:
                        self._run_chunk(chunk_img, rel_in_tl, out_coords,
                                        events=fwd_events)
                    else:
                        write_q.put((tl, self._run_chunk(
                            chunk_img, rel_in_tl, events=fwd_events),
                            out_coords))
                    logger.info("chunk %d/%d: %d patches", idx + 1,
                                n_chunks, rel_in_tl.shape[0])
        finally:
            write_q.put(None)
            wt.join()
        if self._pred_dev_mode:
            for dev in (self.mesh.devices if self.mesh is not None
                        else (self.device,)):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        if fwd_events and times is not None:
            # done: synchronised above, or pulled by the writer thread
            times["forward_ms"] = sum(start.elapsed_time(end)
                                      for start, end in fwd_events)
        if times is not None:
            for parts in (self._part_events or {}).values():
                for name, ms in parts.ms().items():
                    times[name] = times.get(name, 0.0) + ms
        self._part_events = None

    def _boxes_touch_tissue(self, scaled_boxes):
        """Tissue-overlap test of many boxes through a summed-area table
        of the mask (one cumsum per mask, four lookups per box). The
        table is kept for the mask object it was built from: a new slide's
        mask builds its own, whatever its shape."""
        mh, mw = self.wsi_mask.shape[:2]
        if self._mask_integral is None or \
                self._mask_integral[0] is not self.wsi_mask:
            ii = np.zeros((mh + 1, mw + 1), np.int64)
            np.cumsum((self.wsi_mask > 0).cumsum(axis=0), axis=1,
                      out=ii[1:, 1:])
            self._mask_integral = (self.wsi_mask, ii)
        ii = self._mask_integral[1]
        r0 = np.clip(scaled_boxes[:, 0, 0], 0, mh)
        r1 = np.clip(scaled_boxes[:, 1, 0], 0, mh)
        c0 = np.clip(scaled_boxes[:, 0, 1], 0, mw)
        c1 = np.clip(scaled_boxes[:, 1, 1], 0, mw)
        area = ii[r1, c1] - ii[r0, c1] - ii[r1, c0] + ii[r0, c0]
        return area > 0

    def _select_masked_patches(self, patch_info, box_level: int = 1):
        """Keep patches whose output box overlaps tissue."""
        if patch_info.shape[0] == 0:
            return patch_info
        ratio = self.wsi_mask.shape[0] / self.wsi_proc_shape[0]
        boxes = np.rint(patch_info[:, box_level] * ratio).astype(np.int64)
        return patch_info[self._boxes_touch_tissue(boxes)]

    def _select_masked_boxes(self, boxes):
        if boxes.shape[0] == 0:
            return boxes
        ratio = self.wsi_mask.shape[0] / self.wsi_proc_shape[0]
        scaled = np.rint(boxes * ratio).astype(np.int64)
        return boxes[self._boxes_touch_tissue(scaled)]

    # ------------------------------------------------ tile post-process

    def _canonical_window(self, tl, br):
        """Round the read window up to a shape class and anchor it inside
        the slide: ((wy, wx), (Hc, Wc))."""
        h, w = int(br[0] - tl[0]), int(br[1] - tl[1])
        img_h, img_w = (int(v) for v in self.wsi_proc_shape)
        hc = min(-(-h // 256) * 256, -(-img_h // 256) * 256)
        wc = min(-(-w // 256) * 256, -(-img_w // 256) * 256)
        wy = max(min(int(tl[0]), img_h - hc), 0)
        wx = max(min(int(tl[1]), img_w - wc), 0)
        return (wy, wx), (hc, wc)

    def _window_geom(self, tl, br):
        """Canonical window anchor and shape, its in-slide read size, and
        the requested box clipped to the in-slide part of the window."""
        (wy, wx), (hc, wc) = self._canonical_window(tl, br)
        img_h, img_w = (int(v) for v in self.wsi_proc_shape)
        read_h, read_w = min(hc, img_h - wy), min(wc, img_w - wx)
        y0 = min(max(int(tl[0]) - wy, 0), read_h)
        y1 = min(max(int(br[0]) - wy, 0), read_h)
        x0 = min(max(int(tl[1]) - wx, 0), read_w)
        x1 = min(max(int(br[1]) - wx, 0), read_w)
        return (wy, wx), (hc, wc), (read_h, read_w), (y0, y1, x0, x1)

    def _read_window(self, pred_map, tl, br):
        """One canonical window of the mmap (zero outside the slide) and
        its valid mask."""
        (wy, wx), (hc, wc), (read_h, read_w), geom = self._window_geom(tl, br)
        window = np.zeros((hc, wc, pred_map.shape[-1]), pred_map.dtype)
        window[:read_h, :read_w] = pred_map[wy:wy + read_h, wx:wx + read_w]
        valid = np.zeros((hc, wc), bool)
        y0, y1, x0, x1 = geom
        valid[y0:y1, x0:x1] = True
        return window, valid, geom

    def _dispatch_post_processing(self, boxes, callback, desc,
                                  batch: int = 4, inflight: int = 2):
        """Batched, pipelined device post-processing of `boxes`.

        Boxes are grouped by canonical window shape and sent to the device
        `batch` windows at a time (under a mesh `batch` a slot, each slot
        post-processing its consecutive shard), with `inflight` batches
        queued ahead of the host. The extraction of instances runs on a
        pool; the callbacks run in order, one batch at a time. Where the
        labels stay on the device (`dev_labels`) the host pulls each
        window's instance tables, built there, and makes the dict from
        them; elsewhere it pulls the labels and extracts from the dense
        map. Returns the number of window batches and the seconds taken.
        The main thread's seconds in the extraction (with the pulls
        before it; span `hnt.wsi.pp.extract`) and in the callbacks (span
        `hnt.wsi.pp.callback`) are added into the slide's `pp_extract`
        and `pp_callback`, and its windows into `pp_extract_windows_tables`
        (the dict from the tables) or `pp_extract_windows_dense` (from a
        dense map: the host path, or a window whose tables overflow);
        each batch's dispatch is span `hnt.wsi.pp.dispatch`."""
        start = time.perf_counter()
        times = self._slide_times
        per_slot = batch
        if self.mesh is not None:
            batch *= len(self.mesh)
        pred_map = (None if self._pred_dev_mode
                    else np.load(self._pred_map_path, mmap_mode="r"))
        groups: Dict[tuple, list] = {}
        for idx in range(boxes.shape[0]):
            tl, br = boxes[idx]
            in_tl = np.maximum(tl, 0)
            in_br = np.minimum(br, np.asarray(self.wsi_proc_shape))
            if (in_br - in_tl).min() <= 0:
                # no in-slide pixels: the grid's floor+1 step count emits a
                # zero-area trailing row/column on exact tile multiples
                continue
            _, shape = self._canonical_window(tl, br)
            groups.setdefault(shape, []).append(idx)
        typed = self.nr_types is not None
        batches = [(shape, idxs[i:i + batch])
                   for shape, idxs in groups.items()
                   for i in range(0, len(idxs), batch)]
        # the callbacks take the windows' labels where the tail left them
        # when the instance map lives on that device; the host then pulls
        # each window's instance tables in place of its labels
        dev_labels = (self._pred_dev_mode and self.mesh is None
                      and isinstance(self.wsi_inst_map, torch.Tensor))

        def pool_map(fn, n):
            if ext_pool is not None and n > 1:
                return list(ext_pool.map(fn, range(n)))
            return [fn(k) for k in range(n)]

        def extract_dense(item):
            """[(map, dict)] of a batch from its label (and type) pulls:
            each window renumbered and extracted on the host."""
            idxs, _, inst_pulls, nlabs, geoms, tps, tp_pulls = item
            _warn_u16_overflow(nlabs)
            inst_host = _host_cat(inst_pulls)
            if tp_pulls is not None:
                tp_host = _host_cat(tp_pulls)
                tps = [tp_host[k, g[0]:g[1], g[2]:g[3]].astype(np.int32)
                       for k, g in enumerate(geoms)]

            def extract_one(k):
                y0, y1, x0, x1 = geoms[k]
                return extract_instance_info(remap_label(
                    inst_host[k, y0:y1, x0:x1].astype(np.int32)), tps[k])

            return pool_map(extract_one, len(idxs))

        def extract_tables(item):
            """[(dict, lut)] of a batch from its pulled window tables, and
            how many windows they served; a window whose tables overflow
            (a capacity, or an instance past the int32 sums' bound) pulls
            its crop and takes the dense extraction."""
            idxs, crops, pull, layout, geoms, tp = item
            tables = [_unpack_tables(row, layout) for row in _host(pull)]
            _warn_u16_overflow([np.array([t["nlab"] for t in tables])])

            def extract_one(k):
                got = instance_info_from_tables(tables[k], int(tables[k]["n"]),
                                                typed)
                if got[0] is not None:
                    return got, True
                y0, y1, x0, x1 = geoms[k]
                tp_k = (tp[k, y0:y1, x0:x1].to(torch.int32).cpu().numpy()
                        if typed else None)
                return instance_info_lut(crops[k].cpu().numpy(), tp_k), False

            out = pool_map(extract_one, len(idxs))
            return [o for o, _ in out], sum(on for _, on in out)

        def finalize(item):
            idxs, crops = item[0], item[1]
            with span("hnt.wsi.pp.extract", times, "pp_extract"):
                if crops is None:
                    extracted, n_tables = extract_dense(item), 0
                else:
                    extracted, n_tables = extract_tables(item)
            if times is not None:
                for key, n in (("pp_extract_windows_tables", n_tables),
                               ("pp_extract_windows_dense",
                                len(idxs) - n_tables)):
                    times[key] = times.get(key, 0) + n
            with span("hnt.wsi.pp.callback", times, "pp_callback"), \
                    self._callback_stream(crops, item[2]):
                for k, idx in enumerate(idxs):
                    if crops is None:
                        inst, inst_info = extracted[k]
                    else:
                        # the dict's ids: the renumbered crop, less the
                        # instances the extraction dropped
                        inst_info, lut = extracted[k]
                        inst = crops[k]
                        if lut is not None:
                            inst = torch.as_tensor(
                                lut, device=inst.device).index_select(
                                    0, inst.reshape(-1)).view(inst.shape)
                    tl, br = boxes[idx]
                    callback(inst, inst_info, tl, br)

        def stage_mmap(sub):
            """Host side of one mmap batch on the staging thread: window
            reads, valid masks and the push to the device."""
            wins, valids, geoms, tps = [], [], [], []
            for idx in sub:
                tl, br = boxes[idx]
                window, valid, geom = self._read_window(pred_map, tl, br)
                wins.append(window[..., 1:4] if typed else window[..., 0:3])
                valids.append(valid)
                geoms.append(geom)
                y0, y1, x0, x1 = geom
                tps.append(window[..., 0].astype(np.int32)[y0:y1, x0:x1]
                           if typed else None)
            wins = torch.from_numpy(np.stack(wins))
            valids = torch.from_numpy(np.stack(valids))
            if self.mesh is None:
                return [(wins.to(self.device), valids.to(self.device))], \
                    geoms, tps
            shards = [(w, v) for w, v in zip(
                shard_batch(self.mesh, wins, per_slot),
                shard_batch(self.mesh, valids, per_slot)) if len(w)]
            return shards, geoms, tps

        def dispatch(shape, sub, staged):
            if self._pred_dev_mode:
                starts, geoms = [], []
                for idx in sub:
                    tl, br = boxes[idx]
                    (wy, wx), _, _, geom = self._window_geom(tl, br)
                    starts.append((wy, wx))
                    geoms.append(geom)
                outs = self._pp_windows(shape, starts, geoms, per_slot)
                if dev_labels:
                    return (sub,) + self._window_tables_async(outs[0], geoms)
                tps, tp_pulls = [None] * len(sub), None
                if typed:
                    tp_pulls = [_to_host_async(tp) for _, _, tp in outs]
            else:
                (shards, geoms, tps), tp_pulls = staged, None
                outs = []
                for wins, valids in shards:
                    self.n_window_shards += 1
                    outs.append(self._post_proc(wins, valids))
            # start the label pulls now; the host reads them `inflight`
            # batches later
            return (sub, None,
                    [_to_host_async(o[0].to(torch.int32)) for o in outs],
                    [o[1] for o in outs], geoms, tps, tp_pulls)

        n_fin = getattr(self, "finalize_workers", 0) or min(
            8, os.cpu_count() or 1)
        ext_pool = (ThreadPoolExecutor(max_workers=n_fin)
                    if n_fin > 1 else None)
        pending = []
        try:
            with ThreadPoolExecutor(max_workers=1) as ex:
                futs = deque()
                if not self._pred_dev_mode:
                    for _, sub in batches[:2]:
                        futs.append(ex.submit(stage_mmap, sub))
                for i, (shape, sub) in enumerate(batches):
                    staged = None
                    if not self._pred_dev_mode:
                        staged = futs.popleft().result()
                        if i + 2 < len(batches):
                            futs.append(
                                ex.submit(stage_mmap, batches[i + 2][1]))
                    with span("hnt.wsi.pp.dispatch"):
                        pending.append(dispatch(shape, sub, staged))
                    while len(pending) > inflight:
                        finalize(pending.pop(0))
            while pending:
                finalize(pending.pop(0))
            if self._cb_stream is not None:
                # later work on the current stream (the next phase's map
                # reads, a pull of the map) follows the callbacks' stores
                torch.cuda.current_stream(self._cb_stream.device).wait_stream(
                    self._cb_stream)
        finally:
            if ext_pool is not None:
                ext_pool.shutdown(wait=True)
        secs = time.perf_counter() - start
        logger.info("%s: %d boxes in %.2fs", desc, boxes.shape[0], secs)
        return len(batches), secs

    def _window_tables_async(self, out, geoms):
        """The device side of a window batch's extraction where its labels
        stay on the card: each window's valid box renumbered
        (`remap_labels_u16`, the callbacks' labels), its instance tables
        (`window_tables`, sized by the window's area) and one pull of them
        with the tail's label counts, started now. No host read. Returns
        (crops, pull, layout, geoms, the type maps)."""
        inst, nlab, tp = out
        lab = inst.to(torch.int32)
        crops = [remap_labels_u16(lab[k, y0:y1, x0:x1])
                 for k, (y0, y1, x0, x1) in enumerate(geoms)]
        canvas = torch.zeros_like(lab)
        tp_canvas = None if tp is None else torch.zeros_like(tp)
        for k, (y0, y1, x0, x1) in enumerate(geoms):
            canvas[k, :y1 - y0, :x1 - x0] = crops[k]
            if tp is not None:
                tp_canvas[k, :y1 - y0, :x1 - x0] = tp[k, y0:y1, x0:x1]
        tables = window_tables(canvas, tp_canvas, self.nr_types,
                               *window_caps(lab.shape[1] * lab.shape[2]))
        tables["nlab"] = nlab
        layout = [(name, tuple(t.shape[1:])) for name, t in tables.items()]
        flat = torch.cat([t.reshape(len(geoms), -1).to(torch.int32)
                          for t in tables.values()], 1)
        return crops, _to_host_async(flat), layout, geoms, tp

    def _callback_stream(self, crops, pull):
        """Where a window batch's callbacks run: for labels on a card, on a
        stream of the manager's own that waits for this batch's tables'
        pull (`pull`, recorded behind its tail and tables), so that a
        callback's read of ids waits for the callbacks' work alone and not
        for the window batches queued behind this one; elsewhere in
        place."""
        if crops is None or not crops[0].is_cuda:
            return nullcontext()
        dev = crops[0].device
        if self._cb_stream is None or self._cb_stream.device != dev:
            self._cb_stream = torch.cuda.Stream(dev)
        self._cb_stream.wait_event(pull[1])
        for crop in crops:
            crop.record_stream(self._cb_stream)
        return torch.cuda.stream(self._cb_stream)

    def post_process_phases(self):
        """The 3 phases over the slide's stitched prediction: full tiles,
        then boundary strips, then 4-corner crosses, each box kept when
        it touches tissue. Sets `n_window_batches` and `n_window_shards`
        (the tail's calls: one a batch on one device, one a non-empty
        slot shard under a mesh); returns the seconds of each phase."""
        grids = wsi_tile_grids(self.wsi_proc_shape,
                               np.array([self.tile_shape] * 2),
                               self.ambiguous_size)
        callbacks = (self._cb_normal_tile, self._cb_fixing_tile,
                     self._cb_fixing_tile)
        self.n_window_batches = self.n_window_shards = 0
        secs = []
        for k, (grid, cb) in enumerate(zip(grids, callbacks), 1):
            n, sec = self._dispatch_post_processing(
                self._select_masked_boxes(grid), cb, f"post-proc phase {k}")
            self.n_window_batches += n
            secs.append(sec)
        return secs

    # -------------------------------------------------------- full run

    def process_single_file(self, wsi_path, msk_path, output_dir):
        wsi_name = pathlib.Path(wsi_path).stem
        ext = pathlib.Path(wsi_path).suffix
        os.makedirs(self.cache_path, exist_ok=True)
        times: Dict[str, float] = {}
        if self._build_s is not None:  # the manager's first slide
            times["model_build"] = self._build_s
            self._build_s = None
        self.timings[wsi_name] = times
        self._slide_times = times

        start = time.perf_counter()
        self.wsi_handler = get_file_handler(wsi_path, backend=ext)
        self.wsi_proc_shape = self.wsi_handler.get_dimensions(self.proc_mag)
        self.wsi_handler.prepare_reading(
            read_mag=self.proc_mag,
            cache_path=f"{self.cache_path}/src_wsi.npy")
        self.wsi_proc_shape = np.array(self.wsi_proc_shape[::-1])  # (y, x)

        if msk_path is not None and os.path.isfile(msk_path):
            mask = cv2.cvtColor(cv2.imread(msk_path), cv2.COLOR_BGR2GRAY)
            self.wsi_mask = (mask > 0).astype(np.uint8)
        else:
            logger.warning("no mask found, generating via Otsu at 1.25x")
            self.wsi_mask = _simple_tissue_mask(
                self.wsi_handler).astype(np.uint8)
        if self.wsi_mask.sum() == 0:
            logger.info("skip due to empty mask")
            return
        if getattr(self, "save_mask", False):
            cv2.imwrite(f"{output_dir}/mask/{wsi_name}.png",
                        self.wsi_mask * 255)
        if getattr(self, "save_thumb", False):
            thumb = self.wsi_handler.get_full_img(read_mag=1.25)
            cv2.imwrite(f"{output_dir}/thumb/{wsi_name}.png",
                        cv2.cvtColor(thumb, cv2.COLOR_RGB2BGR))

        out_ch = 4 if self.nr_types is not None else 3
        proc_shape = tuple(int(v) for v in self.wsi_proc_shape)
        pred_bytes = (proc_shape[0] * proc_shape[1] * out_ch
                      * self.pred_map_dtype.itemsize)
        # the budget is a slot's: a mesh holds the buffer row-striped
        slots = len(self.mesh) if self.mesh is not None else 1
        self._pred_dev_mode = pred_bytes <= self.hbm_pred_budget * slots
        if self._pred_dev_mode:
            self._alloc_pred_dev(out_ch)
            self._pred_map_path = None
            logger.info("pred map resident on %s (%.2f GB%s)", self.device,
                        pred_bytes / 2**30,
                        f", striped over {slots} slots" if slots > 1 else "")
        else:
            self._pred_dev = None
            self._pred_map_path = f"{self.cache_path}/pred_map.npy"
            pred_map = np.lib.format.open_memmap(
                self._pred_map_path, mode="w+",
                shape=proc_shape + (out_ch,), dtype=self.pred_map_dtype)
            del pred_map
        self.wsi_inst_map = None  # the last slide's, freed first
        if self._pred_dev_mode and self.mesh is None:
            # beside the pred map: the callbacks stitch it on the device
            self.wsi_inst_map = torch.zeros(proc_shape, dtype=torch.int32,
                                            device=self.device)
        else:
            self.wsi_inst_map = np.lib.format.open_memmap(
                f"{self.cache_path}/pred_inst.npy", mode="w+",
                shape=proc_shape, dtype=np.int32)
        self.wsi_inst_info: Dict[int, dict] = {}
        times["prepare"] = time.perf_counter() - start

        # ---- raw prediction over chunks
        start = time.perf_counter()
        chunk_info, patch_info = wsi_chunk_patch_grids(
            self.wsi_proc_shape, np.array([self.chunk_shape] * 2),
            np.array([self.cfg.patch_input_shape] * 2),
            np.array([self.cfg.patch_output_shape] * 2))
        self.n_forward_batches = 0
        self._get_raw_prediction(chunk_info, patch_info)
        times["inference"] = time.perf_counter() - start
        logger.info("inference: %.2fs (%d forward batches)",
                    times["inference"], self.n_forward_batches)

        # ---- 3-phase post-processing
        start = time.perf_counter()
        for k, secs in enumerate(self.post_process_phases(), 1):
            times[f"post_proc_phase{k}"] = secs
        times["post_proc"] = time.perf_counter() - start
        logger.info("post-proc: %.2fs", times["post_proc"])

        start = time.perf_counter()
        if getattr(self, "save_mask", False) or \
                getattr(self, "save_thumb", False):
            json_path = f"{output_dir}/json/{wsi_name}.json"
        else:
            json_path = f"{output_dir}/{wsi_name}.json"
        base.save_json(json_path, self.wsi_inst_info, mag=self.proc_mag)
        times["save"] = time.perf_counter() - start
        logger.info("save: %.2fs", times["save"])
        self._pred_dev = None  # free device memory before the next slide

    # ---- phase callbacks (the reference's boundary bookkeeping)
    #
    # One implementation in torch ops over the instance map wherever it
    # lives: a torch.int32 tensor on the device beside a resident pred map
    # (`process_single_file`), else a numpy array or memmap on the host,
    # seen through a zero-copy tensor. Every id of the map is a key of
    # `wsi_inst_info` and every id of a window's labels a key of its
    # `inst_info`, so tables over 0..max key stand for np.unique, np.isin
    # and np.setdiff1d. The host keeps the dict: the ids, the offsets of
    # bbox, contour and centroid, the installs and the pops.

    def _callback_map(self) -> torch.Tensor:
        """The instance map as a tensor; counts the callback into the
        slide's `pp_callback_windows_dev` or `pp_callback_windows_host`."""
        inst_map = self.wsi_inst_map
        on_dev = isinstance(inst_map, torch.Tensor)
        times = self._slide_times
        if times is not None:
            key = f"pp_callback_windows_{'dev' if on_dev else 'host'}"
            times[key] = times.get(key, 0) + 1
        return inst_map if on_dev else torch.from_numpy(inst_map)

    def _cb_normal_tile(self, pred_inst, inst_info, tl, br):
        inst_map = self._callback_map()
        if len(inst_info) == 0:
            return
        top_left = np.array([tl[1], tl[0]])  # (x, y)
        wsi_max_id = max(self.wsi_inst_info.keys(), default=0)
        for inst_id, info in inst_info.items():
            info["bbox"] += np.asarray(tl)  # bbox rows are (y, x)
            info["contour"] += top_left
            info["centroid"] += top_left
            self.wsi_inst_info[inst_id + wsi_max_id] = info
        pred = torch.as_tensor(pred_inst, device=inst_map.device)
        inst_map[tl[0]:br[0], tl[1]:br[1]] = torch.where(
            pred > 0, pred + int(wsi_max_id), 0)

    def _cb_fixing_tile(self, pred_inst, inst_info, tl, br):
        inst_map = self._callback_map()
        if len(inst_info) == 0:
            return
        top_left = np.array([tl[1], tl[0]])
        wsi_max_id = max(self.wsi_inst_info.keys(), default=0)
        n_old, n_new = int(wsi_max_id) + 1, int(max(inst_info)) + 1
        win = inst_map[tl[0]:br[0], tl[1]:br[1]]
        roi = win.reshape(-1).long()
        pred = torch.as_tensor(pred_inst, device=win.device).reshape(-1).long()

        # keep old nuclei that straddle this window's boundary; drop the
        # interior ones (the re-prediction replaces them). 0 is never
        # inner: it is the smallest id wherever it occurs
        edge = _id_table(torch.cat([win[[0, -1], :].reshape(-1),
                                    win[:, [0, -1]].reshape(-1)]).long(),
                         n_old)
        inner = _id_table(roi, n_old, drop_min=True) & ~edge
        roi = torch.where(inner[roi], 0, roi)

        # from the new prediction, drop nuclei overlapping the kept old
        # boundary-straddlers; install the rest (an overlap table that
        # holds 0 drops and installs nothing more)
        overlap = _id_table(torch.where(roi > 0, pred, 0), n_new)
        new_inner = _id_table(pred, n_new, drop_min=True) & ~overlap
        pred = torch.where(overlap[pred], 0, pred)
        pred = torch.where(pred > 0, pred + int(wsi_max_id), 0)
        win.copy_((roi + pred).view(win.shape))

        inner_ids, new_inner = _ids_to_host(inner, new_inner)
        for inst_id in inner_ids:
            self.wsi_inst_info.pop(int(inst_id), None)
        for inst_id in new_inner:
            if inst_id not in inst_info:
                logger.info("nucleus id=%d missing from info dict", inst_id)
                continue
            info = inst_info[inst_id]
            info["bbox"] += np.asarray(tl)
            info["contour"] += top_left
            info["centroid"] += top_left
            self.wsi_inst_info[int(inst_id) + wsi_max_id] = info

    # -------------------------------------------------------------- run

    def process_wsi_list(self, input_dir, output_dir, input_mask_dir=None,
                         save_thumb=False, save_mask=False):
        """Every slide of `input_dir` -> `<name>.json` (under json/ when
        thumbnails or masks are saved too). A slide whose json exists is
        skipped (resume); a slide that fails is logged and the next one
        runs. Returns the number of slides written."""
        self.save_thumb = save_thumb
        self.save_mask = save_mask
        os.makedirs(self.cache_path, exist_ok=True)
        os.makedirs(f"{output_dir}/json", exist_ok=True)
        if save_thumb:
            os.makedirs(f"{output_dir}/thumb", exist_ok=True)
        if save_mask:
            os.makedirs(f"{output_dir}/mask", exist_ok=True)

        written = 0
        for wsi_path in sorted(glob.glob(f"{input_dir}/*")):
            if os.path.isdir(wsi_path):
                continue
            name = pathlib.Path(wsi_path).stem
            msk_path = (f"{input_mask_dir}/{name}.png"
                        if input_mask_dir else None)
            out_file = (f"{output_dir}/json/{name}.json"
                        if (save_thumb or save_mask)
                        else f"{output_dir}/{name}.json")
            if os.path.exists(out_file):
                logger.info("skip (resume): %s", name)
                continue
            try:
                logger.info("process: %s", name)
                self.process_single_file(wsi_path, msk_path, output_dir)
                written += os.path.exists(out_file)
                logger.info("finish %s", name)
            except Exception:
                logger.exception("crash on %s", name)
            finally:
                self._pred_dev = None  # free device memory even on failure
        shutil.rmtree(self.cache_path, ignore_errors=True)
        return written


def fill_pred_dev(mgr: WSIInferManager, outs: torch.Tensor,
                  coords: np.ndarray, per_slot: int) -> None:
    """Scatter patch outputs [K, h, w, C] at top-lefts `coords` into
    `mgr`'s device pred buffer as the chunk loop does, without a forward:
    batches of `per_slot` outputs a slot, sharded over the mesh when
    there is one."""
    slots = mgr._slots()
    bs = per_slot * len(slots)
    for i in range(0, len(coords), bs):
        shards = [t for t in shard_batch(slots, outs[i:i + bs], per_slot)
                  if len(t)]
        mgr._scatter(shards, coords[i:i + bs])


def _dryrun_striped_once(n_devices: int, pred: np.ndarray, shape,
                         devices=None):
    """Scatter a pre-built float16 (np, hv_x, hv_y) prediction map into
    the striped (n_devices > 1) or single-device pred buffer, in forward
    batches of 8 patch outputs a slot, and run all 3 post-proc phases
    with 128^2 tiles. `devices` (default: the CUDA devices) lists the
    devices of the slots and may repeat one. Returns (inst_map, the set
    of instance ids)."""
    from ..models.hovernet import HoVerNetConfig

    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=8)
    out_sz = cfg.patch_output_shape
    ys = list(range(0, shape[0], out_sz))
    xs = list(range(0, shape[1], out_sz))
    padded = np.zeros((ys[-1] + out_sz, xs[-1] + out_sz, 3), np.float16)
    padded[:shape[0], :shape[1]] = pred
    coords = np.array([(y, x) for y in ys for x in xs], np.int32)
    patches = torch.from_numpy(np.stack(
        [padded[y:y + out_sz, x:x + out_sz] for y, x in coords]))

    mesh = make_mesh(n_devices, devices)
    mgr = WSIInferManager.__new__(WSIInferManager)
    mgr.cfg = cfg
    mgr.nr_types = None
    mgr.tile_shape = 128
    mgr.ambiguous_size = 32
    mgr.pred_map_dtype = np.dtype("float16")
    mgr.mesh = mesh if n_devices > 1 else None
    mgr.device = mesh[0]
    mgr.wsi_proc_shape = np.array(shape)
    mgr.wsi_mask = np.ones((30, 26), np.uint8)
    mgr.wsi_inst_info = {}
    mgr.wsi_inst_map = np.zeros(shape, np.int32)
    mgr._alloc_pred_dev(3)
    fill_pred_dev(mgr, patches, coords, 8)
    mgr.post_process_phases()
    return mgr.wsi_inst_map.copy(), set(mgr.wsi_inst_info.keys())


def dryrun_striped_infer(n_devices: int, devices=None) -> dict:
    """One striped scatter and window-gather round over an n-slot mesh on
    a 300x260 map of 40 discs: the striped path runs (all_gather scatter,
    psum_scatter window reads, the tail on each slot's device) and gives
    the single-device resident path's instance map bit for bit and the
    same instance ids. `devices` as in `_dryrun_striped_once`; the
    single-device run takes the first. Returns {"n_instances": int}."""
    from ..ops.targets import gen_instance_hv_map

    rng = np.random.default_rng(3)
    shape = (300, 260)
    inst_gt = np.zeros(shape, np.int32)
    k = 1
    for _ in range(40):
        cy = int(rng.integers(10, shape[0] - 10))
        cx = int(rng.integers(10, shape[1] - 10))
        r = int(rng.integers(4, 8))
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        m = (yy ** 2 + xx ** 2) <= r * r
        sub = inst_gt[cy - r:cy + r + 1, cx - r:cx + r + 1]
        sub[m & (sub == 0)] = k
        k += 1
    hv = gen_instance_hv_map(inst_gt, shape)
    pred = np.dstack([(inst_gt > 0).astype(np.float32),
                      hv[..., 0], hv[..., 1]]).astype(np.float16)

    inst_n, keys_n = _dryrun_striped_once(n_devices, pred, shape, devices)
    inst_1, keys_1 = _dryrun_striped_once(
        1, pred, shape, None if devices is None else devices[:1])
    if not np.array_equal(inst_n, inst_1) or keys_n != keys_1:
        raise AssertionError(
            f"striped ({n_devices} slots) and single-device instance maps "
            f"differ: {len(keys_n)} vs {len(keys_1)} instances")
    n = len(keys_n)
    if n <= 10:
        raise AssertionError(f"striped dryrun found only {n} instances")
    logger.info("dryrun_striped_infer: striped == single-device (bit-exact "
                "instance map, %d instances)", n)
    return {"n_instances": n}
