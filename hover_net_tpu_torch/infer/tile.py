"""Tile inference: a directory of images -> json / mat / overlay / qupath.

HoVer-Net, CellViT and Cellpose-SAM run through it; what the model
outputs picks the post-processing (infer/steps.make_tile_pipeline):
HoVer-Net's maps go through the energy and K1, Cellpose's flows through
its dynamics (ops/flow_dynamics.py), and both through the same tables,
finalize and json.

Counterpart of hover_net_tpu/infer/tile.py. Each image is reflect-padded
and zero-extended to its canonical patch grid exactly as the JAX package
does (prepare_tile_patching, bucket_grid_dim), so the canvas matches it
pixel for pixel (cut to the canonical canvas where the reflect padding
reaches past it, a case in which the JAX manager raises); the device
pipeline (infer/steps.make_tile_pipeline)
returns the per-instance tables, and the host builds the json from them
with the native contour tracer. Every map is post-processed whole, so
the JAX package's seam guard has no counterpart here.

Several devices (`n_devices`, or an explicit `devices` list of slots
that may repeat a device) take successive images in turn, as the JAX
manager's round-robin does: each image's whole pipeline (forward,
energy, K1, tables) runs on its slot's device with that device's model
replica, up to 3 images a slot wait for their finalize, and the
finalizes stay in input order. Each slot has its own dispatch thread:
K1 reads host flags every few watershed sweeps and the tables size
their boundary list on the host (`torch.nonzero`), so a dispatch
returns only once the image's forward, K1 and most of its tables have
run on the device, and one dispatching thread would run the images of
distinct GPUs one after another; with a thread a slot they overlap, and slots that share a
device interleave their work on its stream. With one slot the main
thread dispatches. The stage timings do not hold the dispatch: each
call's CUDA events travel with its outputs (`steps.StageEvents`) and
the finalize worker reads them once it has pulled the tables.
torch.profiler records the CPU ops of the thread that starts it, so a
`--profile_dir` trace of several slots lacks the dispatch threads' CPU
ops and their `hnt.tile.dispatch` spans (the kernels are in it).

`device_post_proc=False` (the CLI's `--host_post_proc`) selects the host
branch: the forward runs on the manager's first device, the stitched
prediction map is pulled, and the host oracle
(ops/post_proc_host.process) post-processes it. The branch runs only
when the caller asks for it; it is never a fallback for the device path.
"""

from __future__ import annotations

import glob
import logging
import os
import pathlib
import re
import shutil
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import ExitStack

import cv2
import numpy as np
import scipy.io as sio
import torch

from ..data.tiling import bucket_grid_dim, prepare_tile_patching
from ..metrics.stats import remap_label
from ..ops.flow_dynamics import COUNTERS
from ..ops.instance_table import apply_lut
from ..ops.post_proc_host import (
    extract_instance_info,
    instance_info_from_tables,
    process as host_process,
)
from ..runtime import span
from ..utils.qupath import to_qupath
from ..utils.viz import overlay_instances
from . import base
from .steps import (
    StageEvents,
    assemble_grid,
    extract_patches,
    flow_outputs,
    make_tile_pipeline,
)

logger = logging.getLogger("hover_net_tpu_torch")


def _rm_n_mkdir(path):
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)


class TileInferManager(base.InferManagerBase):
    """Tile-mode inference (patches 270/80 original, 256/164 fast).

    `timings` collects one dict per image written: on the device branch
    the device ms of each pipeline stage (`steps.STAGES`) and of the
    forward's `encoder` and `decoders` (CUDA only), the host ms of the
    image's read (`read_ms`, span `hnt.tile.read`), of its dispatch
    (`dispatch_ms`, span `hnt.tile.dispatch`: pad, push, launches and
    the waits for the device of K1 and the tables) and of its finalize
    (`finalize_ms`), and
    `from_tables`, whether the json came from the device tables through
    the native contour tracer (False: the dense-map fallback ran); on
    the host branch (`device_post_proc=False`) the host post-processing
    ms. A model with Cellpose's outputs (`steps.flow_outputs`) runs the
    stages `steps.FLOW_STAGES`, its forward's parts `vit_encoder` and
    `readout` and the attention's `global_attn`, and adds its counters
    `n_seeds`, `n_dropped_flow_error` and `n_dropped_small`; its json is
    untyped, and the host branch refuses it (the oracle post-processes
    HoVer-Net's maps)."""

    # the counters of the last image finalized (a flow model's)
    last_counters: dict = {}

    def __init__(self, *args, device_post_proc: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if not device_post_proc and flow_outputs(self.model):
            raise ValueError(f"--host_post_proc post-processes HoVer-Net's "
                             f"maps; {self.cfg.mode} runs Cellpose's flow "
                             f"dynamics on the device")
        self.patch_input_shape = self.cfg.patch_input_shape
        self.patch_output_shape = self.cfg.patch_output_shape
        self.device_post_proc = device_post_proc
        self._pipelines = {}
        self._rr = 0  # images dispatched: the next one's slot
        self.timings = []

    def _pipeline_for(self, grid, slot: int):
        """One pipeline per canonical grid class and slot."""
        if (grid, slot) not in self._pipelines:
            self._pipelines[grid, slot] = make_tile_pipeline(
                self.model_on(self.devices[slot]), grid,
                batch=self.batch_size)
        return self._pipelines[grid, slot]

    def _reflect_padded(self, img: np.ndarray):
        """(reflect-padded image, patch top-left coords, grid) of the exact
        patch grid over `img`."""
        pads, coords, grid = prepare_tile_patching(
            img.shape[:2], self.patch_input_shape, self.patch_output_shape)
        padded = np.pad(img, ((pads[0], pads[1]), (pads[2], pads[3]), (0, 0)),
                        mode="reflect")
        return padded, coords, grid

    def next_slot(self) -> int:
        """The slot of the next image, in turn."""
        slot = self._rr % len(self.devices)
        self._rr += 1
        return slot

    def predict_image_async(self, img: np.ndarray, slot=None,
                            times=None):
        """Run one RGB uint8 image through the device pipeline of `slot`
        (default: the next slot in turn). Returns (full, inst, n_labels,
        tp, tables) tensors at canonical size and the call's
        `steps.StageEvents` (`.ms()`: the device ms of each stage, read
        once the tables are on the host). The host seconds of the call
        are added into `times["dispatch"]` when `times` is given."""
        with span("hnt.tile.dispatch", times, "dispatch"):
            return self._dispatch(img, slot)

    def _dispatch(self, img: np.ndarray, slot):
        src_h, src_w = img.shape[:2]
        win, step = self.patch_input_shape, self.patch_output_shape
        padded, coords, grid = self._reflect_padded(img)
        rows, cols = bucket_grid_dim(grid[0]), bucket_grid_dim(grid[1])
        if (rows, cols) != grid:
            # zero-extend the canvas to the canonical grid; the pipeline
            # mirrors the source over it before post-processing. The
            # reflect padding may already reach past the canonical canvas
            # (a 1000^2 tile in original mode pads to 1405^2 for a 1310^2
            # canvas): the patches never read past it, so cut it there
            # (np.pad refuses the negative extension the JAX manager asks
            # for in that case)
            can_h = rows * step + (win - step)
            can_w = cols * step + (win - step)
            padded = np.pad(padded[:can_h, :can_w], (
                (0, max(can_h - padded.shape[0], 0)),
                (0, max(can_w - padded.shape[1], 0)), (0, 0)))
            ys = np.arange(0, rows * step, step, dtype=np.int32)
            xs = np.arange(0, cols * step, step, dtype=np.int32)
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            coords = np.stack([yy.ravel(), xx.ravel()], axis=-1)
        if slot is None:
            slot = self.next_slot()
        device = self.devices[slot]
        run = self._pipeline_for((rows, cols), slot)
        events = StageEvents(device)
        out = run(torch.from_numpy(np.ascontiguousarray(padded)).to(device),
                  torch.from_numpy(coords.astype(np.int64)).to(device),
                  (src_h, src_w), events)
        return out, events

    def finalize_prediction(self, img, dev_out, pull_pred_map: bool = True,
                            pull_inst_map: bool = True):
        """Per-nucleus info from the device tables; optionally pull the
        label and prediction maps (cropped to the source). Sets
        `self.last_from_tables` (see `timings`)."""
        src_h, src_w = img.shape[:2]
        full, inst_dev, n_labels, tp_dev, tables = dev_out
        n = int(n_labels.max())
        if n > 65535:
            logger.warning("uint16 label compaction overflow: %d instances "
                           "in one tile (> 65535), ids were aliased", n)

        inst_info = lut = None
        if n <= 65535:
            stats = tables["stats"].cpu().numpy()
            host_tables = {"coo_n": tables["coo_n"].cpu().numpy(),
                           "coo": tables["coo"].cpu().numpy(),
                           "bbox": stats[:, 0:4]}
            if stats.shape[1] > 4:  # typed: sums + type histogram
                host_tables["sum_yx"] = stats[:, 4:6]
                host_tables["size"] = stats[:, 6]
            if stats.shape[1] > 7:
                host_tables["type_hist"] = stats[:, 7:]
            inst_info, lut = instance_info_from_tables(
                host_tables, n, typed=self.nr_types is not None)

        self.last_from_tables = inst_info is not None
        self.last_counters = ({} if "counters" not in tables else dict(zip(
            COUNTERS, tables["counters"].cpu().tolist())))
        if inst_info is None:
            # a table capacity was exceeded: dense-map path
            inst_map = remap_label(_to_numpy(inst_dev)[:src_h, :src_w]
                                   .astype(np.int32))
            pred_type = (tp_dev.cpu().numpy()[:src_h, :src_w].astype(np.int32)
                         if self.nr_types else None)
            inst_map, inst_info = extract_instance_info(inst_map, pred_type)
            inst_map = inst_map.astype(np.int32)
        elif pull_inst_map:
            inst_map = _to_numpy(inst_dev)[:src_h, :src_w].astype(np.int32)
            if lut is not None:  # erase artifact ids (keeps map == dict)
                inst_map = apply_lut(inst_map, lut)
        else:
            inst_map = inst_dev

        pred_map = full[:src_h, :src_w]
        if pull_pred_map:
            pred_map = pred_map.cpu().numpy().astype(np.float32)
        return pred_map, inst_map, inst_info

    def predict_image(self, img: np.ndarray):
        """RGB uint8 image -> (pred_map [H, W, C], inst_map int32,
        inst_info dict). On the host branch sets `self.last_post_proc_ms`,
        the host post-processing time."""
        if self.device_post_proc:
            out, _ = self.predict_image_async(img)
            return self.finalize_prediction(img, out)
        src_h, src_w = img.shape[:2]
        padded, coords, grid = self._reflect_padded(img)
        patches = extract_patches(
            torch.from_numpy(np.ascontiguousarray(padded)).to(self.device),
            torch.from_numpy(coords.astype(np.int64)).to(self.device),
            self.patch_input_shape)
        full = assemble_grid(self.run_batches(patches), grid)
        pred_map = full[:src_h, :src_w].cpu().numpy().astype(np.float32)
        t0 = time.perf_counter()
        inst_map, inst_info = host_process(
            pred_map, nr_types=self.nr_types, return_centroids=True)
        self.last_post_proc_ms = (time.perf_counter() - t0) * 1e3
        return pred_map, inst_map.astype(np.int32), inst_info

    def _save_outputs(self, name, img, pred_map, inst_map, inst_info,
                      output_dir, draw_dot=False, save_qupath=False,
                      save_raw_map=False, save_format="all"):
        nuc_vals = list(inst_info.values())
        if save_format == "all":
            mat = {
                "inst_map": inst_map,
                "inst_uid": np.array(list(inst_info.keys()))[:, None],
                "inst_centroid": np.array([v["centroid"] for v in nuc_vals])
                if nuc_vals else np.zeros((0, 2)),
            }
            if self.nr_types is not None:
                mat["inst_type"] = (
                    np.array([v["type"] for v in nuc_vals])[:, None]
                    if nuc_vals else np.zeros((0, 1), np.int32))
            if save_raw_map:
                mat["raw_map"] = pred_map
            sio.savemat(f"{output_dir}/mat/{name}.mat", mat)
            overlaid = overlay_instances(
                img, inst_info, draw_dot=draw_dot,
                type_colour=self.type_info, line_thickness=2)
            cv2.imwrite(f"{output_dir}/overlay/{name}.png",
                        cv2.cvtColor(overlaid, cv2.COLOR_RGB2BGR))
        if save_qupath:
            to_qupath(
                f"{output_dir}/qupath/{name}.tsv",
                np.array([v["centroid"] for v in nuc_vals]).reshape(-1, 2),
                np.array([v["type"] for v in nuc_vals], dtype=np.int64),
                self.type_info)
        base.save_json(f"{output_dir}/json/{name}.json", inst_info, None)

    def process_file_list(self, input_dir, output_dir, draw_dot=False,
                          save_qupath=False, save_raw_map=False,
                          save_format="all"):
        """save_format "all" writes mat/overlay/json[/qupath]; "json"
        writes json[/qupath] from the device tables alone. The main
        thread reads the images and dispatches each (to its slot's
        thread when there are several slots); the host finalize and save
        run on one worker thread, in input order (up to 3 images a slot
        wait for it). On the host
        branch each image is predicted, post-processed and saved in turn
        on the main thread. Returns the number of images written."""
        pattern = re.sub(r"([\[\]])", "[\\1]", f"{input_dir}/*")
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no input files found in {input_dir}")
        if save_format == "json" and save_raw_map:
            logger.warning("--save_raw_map is a mat-file field; ignored "
                           "with --save_format json")
            save_raw_map = False
        subs = ("json", "mat", "overlay") if save_format == "all" \
            else ("json",)
        for sub in subs + (("qupath",) if save_qupath else ()):
            _rm_n_mkdir(f"{output_dir}/{sub}")

        n_failed = 0  # touched by the main thread and the one worker

        def finalize_one(name, img, dispatched, t0, times):
            nonlocal n_failed
            try:
                dev_out, events = dispatched.result()
                t1 = time.perf_counter()
                pred_map, inst_map, inst_info = self.finalize_prediction(
                    img, dev_out, pull_pred_map=save_raw_map,
                    pull_inst_map=(save_format == "all"))
                self._save_outputs(name, img, pred_map, inst_map, inst_info,
                                   output_dir, draw_dot, save_qupath,
                                   save_raw_map, save_format)
                t2 = time.perf_counter()
                self.timings.append(dict(
                    events.ms(), name=name, n_nuclei=len(inst_info),
                    read_ms=times["read"] * 1e3,
                    dispatch_ms=times["dispatch"] * 1e3,
                    finalize_ms=(t2 - t1) * 1e3,
                    from_tables=self.last_from_tables,
                    **self.last_counters))
                logger.info("done %s (%d nuclei, %.2fs)", name,
                            len(inst_info), t2 - t0)
            except Exception:
                n_failed += 1
                logger.exception("crash on %s", name)

        with ExitStack() as stack:
            fin = stack.enter_context(ThreadPoolExecutor(max_workers=1))
            dispatch = []  # the slots' dispatch threads
            if len(self.devices) > 1 and self.device_post_proc:
                for slot, device in enumerate(self.devices):
                    self.model_on(device)  # the replicas are made here
                    dispatch.append(stack.enter_context(ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix=f"slot{slot}")))
            futs = deque()  # one worker: finalizes stay in order
            for path in files + [None]:
                if path is not None:
                    name = pathlib.Path(path).stem
                    t0 = time.perf_counter()
                    times = {}  # host seconds: read, dispatch
                    try:
                        with span("hnt.tile.read", times, "read"):
                            img = cv2.cvtColor(cv2.imread(path),
                                               cv2.COLOR_BGR2RGB)
                        if not self.device_post_proc:
                            pred_map, inst_map, inst_info = \
                                self.predict_image(img)
                            self._save_outputs(name, img, pred_map, inst_map,
                                               inst_info, output_dir,
                                               draw_dot, save_qupath,
                                               save_raw_map, save_format)
                            self.timings.append(dict(
                                name=name, n_nuclei=len(inst_info),
                                post_proc_ms=self.last_post_proc_ms))
                            logger.info("done %s (%d nuclei, %.2fs)", name,
                                        len(inst_info),
                                        time.perf_counter() - t0)
                            continue
                        slot = self.next_slot()
                        if dispatch:
                            dispatched = dispatch[slot].submit(
                                self.predict_image_async, img, slot, times)
                        else:
                            dispatched = Future()
                            dispatched.set_result(
                                self.predict_image_async(img, slot, times))
                        futs.append(fin.submit(finalize_one, name, img,
                                               dispatched, t0, times))
                    except Exception:
                        n_failed += 1
                        logger.exception("crash on %s", name)
                        continue
                while futs and (path is None
                                or len(futs) >= 3 * len(self.devices)):
                    futs.popleft().result()
        if n_failed:
            logger.error("%d/%d images failed", n_failed, len(files))
            if n_failed == len(files):
                raise RuntimeError(f"all {len(files)} images failed; see "
                                   "the tracebacks above")
        return len(files) - n_failed


def _to_numpy(inst: torch.Tensor) -> np.ndarray:
    """uint16 label map on any device -> numpy."""
    return inst.to(torch.int32).cpu().numpy()
