"""Checkpoint loading for the port.

Counterpart of the parts of hover_net_tpu/models/checkpoints.py that the
tile path needs. The port's module tree uses the reference PyTorch state
dict names, so a reference `.tar` ({'desc': state_dict}) loads with
strict=True. The JAX package's `.msgpack` format needs flax: convert such
a checkpoint once with hover_net_tpu.models.checkpoints.save_torch_tar.

`state_dict_from_jax` carries a JAX {params, batch_stats} tree (nested
numpy dicts) into the port's state dict. Its name map restates the JAX
package's `torch_name_map`, which cannot be imported here because that
module imports flax.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .hovernet import HoVerNetConfig

RES_COUNTS = {"d0": 3, "d1": 4, "d2": 6, "d3": 3}
DENSE_COUNTS = {"u3": 8, "u2": 4}

# (torch key, JAX path, transform); transform "OIHW" marks conv kernels
Row = Tuple[str, Tuple[str, ...], Optional[str]]


def _bn(key: str, path: Tuple[str, ...]) -> List[Row]:
    return [(key + ".weight", ("params",) + path + ("scale",), None),
            (key + ".bias", ("params",) + path + ("bias",), None),
            (key + ".running_mean", ("batch_stats",) + path + ("mean",), None),
            (key + ".running_var", ("batch_stats",) + path + ("var",), None)]


def _conv(key: str, path: Tuple[str, ...], bias: bool = False) -> List[Row]:
    rows = [(key + ".weight", ("params",) + path + ("kernel",), "OIHW")]
    if bias:
        rows.append((key + ".bias", ("params",) + path + ("bias",), None))
    return rows


def name_map(cfg: HoVerNetConfig) -> List[Row]:
    """Every model variable: reference torch key <-> JAX variable path."""
    rows = _conv("conv0./", ("conv0", "conv")) + _bn("conv0.bn",
                                                     ("conv0", "bn"))
    for d, count in RES_COUNTS.items():
        for k in range(count):
            u, fu = f"{d}.units.{k}", (d, f"unit{k}")
            if k:
                rows += _bn(f"{u}.preact/bn", fu + ("preact_bn",))
            rows += _conv(f"{u}.conv1", fu + ("conv1",))
            rows += _bn(f"{u}.conv1/bn", fu + ("conv1_bn",))
            rows += _conv(f"{u}.conv2", fu + ("conv2",))
            rows += _bn(f"{u}.conv2/bn", fu + ("conv2_bn",))
            rows += _conv(f"{u}.conv3", fu + ("conv3",))
        rows += _conv(f"{d}.shortcut", (d, "shortcut"))
        rows += _bn(f"{d}.blk_bna.bn", (d, "bn"))
    rows += _conv("conv_bot", ("conv_bot",))
    for branch in cfg.branches:
        b, fb = f"decoder.{branch}", f"decoder_{branch}"
        for lvl, count in DENSE_COUNTS.items():
            rows += _conv(f"{b}.{lvl}.conva", (fb, f"{lvl}_conva"))
            for k in range(count):
                du, fdu = f"{b}.{lvl}.dense.units.{k}", (fb, f"{lvl}_dense",
                                                         f"unit{k}")
                rows += _bn(f"{du}.preact_bna/bn", fdu + ("preact_bn",))
                rows += _conv(f"{du}.conv1", fdu + ("conv1",))
                rows += _bn(f"{du}.conv1/bn", fdu + ("conv1_bn",))
                rows += _conv(f"{du}.conv2", fdu + ("conv2",))
            rows += _bn(f"{b}.{lvl}.dense.blk_bna.bn",
                        (fb, f"{lvl}_dense", "bn"))
            rows += _conv(f"{b}.{lvl}.convf", (fb, f"{lvl}_convf"))
        rows += _conv(f"{b}.u1.conva", (fb, "u1_conva"))
        rows += _bn(f"{b}.u0.bn", (fb, "u0_bn"))
        rows += _conv(f"{b}.u0.conv", (fb, "u0_conv"), bias=True)
    return rows


def state_dict_from_jax(variables, cfg: HoVerNetConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX {params, batch_stats} (nested dicts of numpy arrays) -> the
    port's state dict: HWIO kernels -> OIHW, scale -> weight, mean ->
    running_mean, var -> running_var."""
    out = {}
    for key, path, transform in name_map(cfg):
        node = variables
        for part in path:
            if part not in node:
                raise KeyError(f"JAX variables miss {'/'.join(path)} "
                               f"(-> {key})")
            node = node[part]
        v = np.asarray(node, np.float32)
        if transform == "OIHW":
            v = v.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(v)
    out["upsample2x.unpool_mat"] = torch.ones(2, 2)
    return out


def load_torch_tar(path: str) -> Dict[str, torch.Tensor]:
    """State dict of a reference '.tar' ({'desc': state_dict}), with the
    DataParallel 'module.' prefix stripped."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload["desc"] if isinstance(payload, dict) and "desc" in \
        payload else payload
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}
