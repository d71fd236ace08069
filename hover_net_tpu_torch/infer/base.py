"""Shared inference manager: device, model and checkpoint, type info, json.

Counterpart of hover_net_tpu/infer/base.py. Checkpoints are reference
PyTorch `.tar` files ({'desc': state_dict}), which load into the port's
module tree with strict=True; a JAX `.msgpack` checkpoint is converted
once with hover_net_tpu.models.checkpoints.save_torch_tar.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..models.checkpoints import load_torch_tar
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..ops.instance_table import emit_nuc_json
from .steps import forward_batches


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a GPU raises
    (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available (pass --device cpu to run on the CPU)")
    return dev


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
    def __init__(self, model_path: str, mode: str = "fast",
                 nr_types: Optional[int] = None,
                 type_info_path: Optional[str] = None, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, batch_size: int = 32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = HoVerNetConfig(mode=mode, nr_types=nr_types, width=width,
                                  dtype=dtype)
        self.model = HoVerNet(self.cfg)
        self.model.load_state_dict(load_torch_tar(model_path), strict=True)
        self.model.to(self.device).eval()
        self.nr_types = nr_types
        self.batch_size = batch_size
        self.type_info = load_type_info(type_info_path, nr_types)

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
