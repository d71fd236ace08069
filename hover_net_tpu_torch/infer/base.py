"""Shared inference manager: devices, model and checkpoint, type info, json.

Counterpart of hover_net_tpu/infer/base.py. The manager builds the model
of its `mode` (models/zoo.py): HoVer-Net in `fast` or `original` mode, or
CellViT-SAM-H in `cellvit_sam_h` (the port's own; the JAX package has
none). A HoVer-Net checkpoint is a reference PyTorch `.tar` ({'desc':
state_dict}) or the port trainer's `.tar`, or a `.msgpack` of the JAX
package (its trainer's `net_epoch=N.msgpack`), read without flax and
checked against the model as the JAX managers check it
(models/checkpoints.load_model_state); a CellViT checkpoint is its
`.pth` ({'model_state_dict': ...}) or a `.tar`. Each loads into the
port's module tree with strict=True.

A manager runs on an ordered list of devices (`devices`): the first
holds the loaded model, and `model_on(device)` gives a replica on any
other, made once per device (the counterpart of the JAX managers'
`_variables_on` / `_mesh_variables`).
"""

from __future__ import annotations

import copy
import json
import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.checkpoints import load_model_state
from ..models.zoo import build_model, model_config
from ..ops.instance_table import emit_nuc_json
from ..parallel.mesh import canonical_device, resolve_device
from ..runtime import span
from .steps import forward_batches

logger = logging.getLogger("hover_net_tpu_torch")


def resolve_devices(n_devices: int, device) -> Tuple[torch.device, ...]:
    """The devices of an `n_devices` run on `device`'s type: for CUDA,
    `device` (cuda:0 by default) and the next ones, clamped to the cards
    there are, as the JAX managers clamp to `len(jax.devices())`; the CPU
    is one device. A clamp logs a warning; a CUDA request without a GPU
    raises (`resolve_device`), it never moves to the CPU."""
    dev = canonical_device(resolve_device(device))
    n = max(1, int(n_devices))
    if dev.type == "cuda":
        avail = torch.cuda.device_count() - dev.index
        if avail < 1:
            raise RuntimeError(f"device {device!r} requested but there are "
                               f"{torch.cuda.device_count()} CUDA devices")
    else:
        avail = 1
    if n > avail:
        logger.warning("n_devices=%d: only %d %s device(s) from %s; running "
                       "on %d", n, avail, dev.type, dev, avail)
        n = avail
    if dev.type == "cuda":
        return tuple(torch.device("cuda", dev.index + i) for i in range(n))
    return (dev,)


def load_type_info(path: Optional[str], nr_types: Optional[int]):
    """{type_id: (name, (r, g, b))} from type_info.json, with the JAX
    package's availability check and fallback palette."""
    if nr_types is None:
        return {None: ("no label", (0, 0, 0))}
    if path is not None:
        with open(path) as f:
            raw = json.load(f)
        info = {int(k): (v[0], tuple(v[1])) for k, v in raw.items()}
        missing = [k for k in range(nr_types) if k not in info]
        if missing:
            raise ValueError(f"type_id={missing[0]} missing from {path}")
        return info
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("hot")
    colours = (cmap(np.arange(nr_types))[:, :3] * 255).astype(np.uint8)
    return {k: (str(k), tuple(int(c) for c in colours[k]))
            for k in range(nr_types)}


class InferManagerBase:
    # host seconds of the model's construction, checkpoint load and push
    # (span `hnt.model.build`); the WSI manager reports it with its first
    # slide and then sets it to None
    _build_s = None

    def __init__(self, model_path: str, mode: str = "fast",
                 nr_types: Optional[int] = None,
                 type_info_path: Optional[str] = None, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, batch_size: int = 32,
                 device="cuda", n_devices: int = 1,
                 devices: Optional[Sequence] = None):
        """`devices`, when given, lists the devices to run on and may
        repeat one; otherwise `resolve_devices(n_devices, device)` picks
        them."""
        if devices is not None:
            self.devices = tuple(canonical_device(resolve_device(d))
                                 for d in devices)
            if not self.devices:
                raise ValueError("devices is empty")
        else:
            self.devices = resolve_devices(n_devices, device)
        self.device = self.devices[0]
        self.cfg = model_config(mode, nr_types, width, dtype)
        build: Dict[str, float] = {}
        with span("hnt.model.build", build, "model_build"):
            self.model = build_model(self.cfg,
                                     load_model_state(model_path, self.cfg))
            self.model.to(self.device).eval()
        self._build_s = build["model_build"]
        self._replicas: Dict[torch.device, torch.nn.Module] = {}
        self.nr_types = nr_types
        self.batch_size = batch_size
        self.type_info = load_type_info(type_info_path, nr_types)

    def model_on(self, device: torch.device) -> torch.nn.Module:
        """The model on `device`: the loaded one on the first device, else
        a copy made at the first call for that device and kept."""
        if device == self.device:
            return self.model
        if device not in self._replicas:
            self._replicas[device] = copy.deepcopy(self.model).to(device)
        return self._replicas[device]

    @torch.no_grad()
    def run_batches(self, patches: torch.Tensor) -> torch.Tensor:
        """The forward over [K, H, W, 3] patches on the manager's device:
        [K, h, w, C] head activations (steps.infer_output), in balanced
        batches of at most `batch_size` (steps.forward_batches, the
        batching of the tile pipeline, so both tile branches run the same
        batches)."""
        return forward_batches(self.model, patches.to(self.device),
                               self.batch_size)


def save_json(path, inst_info, mag=None):
    """{mag, nuc: {id: {...}}} with ndarray -> list conversion. Entries of
    the standard 5-field schema go through the native emitter
    (ops/instance_table.emit_nuc_json)."""
    payload = _save_json_native(path, inst_info, mag)
    if payload is not None:
        return payload
    nuc = {}
    for inst_id, info in inst_info.items():
        nuc[int(inst_id)] = {k: v.tolist() if isinstance(v, np.ndarray)
                             else v for k, v in info.items()}
    with open(path, "w") as f:
        json.dump({"mag": mag, "nuc": nuc}, f)
    return nuc


_SCHEMA_KEYS = ("bbox", "centroid", "contour", "type_prob", "type")


def _save_json_native(path, inst_info, mag):
    """Pack inst_info into flat tables and emit natively. Returns
    inst_info, or None when the schema does not match or there is no
    native library (the caller then uses json.dump)."""
    n = len(inst_info)
    ids = np.empty(n, np.int64)
    bbox = np.empty((n, 4), np.int64)
    centroid = np.empty((n, 2), np.float64)
    lens = np.zeros(n + 1, np.int64)
    contours = []
    type_ids = np.empty(n, np.int32)
    type_probs = np.empty(n, np.float64)
    typed = None
    for info in inst_info.values():
        if tuple(info.keys()) != _SCHEMA_KEYS:
            return None
        b, c, ct = info["bbox"], info["centroid"], info["contour"]
        if not (isinstance(b, np.ndarray) and b.shape == (2, 2)
                and isinstance(c, np.ndarray) and c.shape == (2,)
                and isinstance(ct, np.ndarray) and ct.ndim == 2
                and ct.shape[1] == 2 and ct.dtype.kind in "iu"):
            return None
        typed = info["type"] is not None
        break
    try:
        for i, (inst_id, info) in enumerate(inst_info.items()):
            if (info["type"] is not None) != typed:
                return None
            ids[i] = inst_id
            bbox[i] = info["bbox"].ravel()
            centroid[i] = info["centroid"]
            lens[i + 1] = len(info["contour"])
            contours.append(info["contour"])
            if typed:
                type_ids[i] = info["type"]
                type_probs[i] = info["type_prob"]
    except (KeyError, TypeError, ValueError):
        return None
    pts = (np.concatenate(contours, axis=0) if contours
           else np.zeros((0, 2), np.int32))
    payload = emit_nuc_json(
        ids, bbox, centroid, np.cumsum(lens), pts,
        type_ids if typed else None, type_probs if typed else None, mag)
    if payload is None:
        return None
    with open(path, "wb") as f:
        f.write(payload)
    return inst_info
