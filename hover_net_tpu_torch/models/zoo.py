"""The model of an inference `--model_mode`, built once by the managers
(infer/base.py): HoVer-Net in `fast` (256 -> 164) or `original`
(270 -> 80) mode (models/hovernet.py), CellViT-SAM-H in `cellvit_sam_h`
(1024 -> 960, models/cellvit.py), Cellpose-SAM in `cellpose_sam`
(256 -> 224, models/cellpose_sam.py). Below the managers nothing branches
on the architecture: the patch shapes are the configuration's, the
forward is `infer/steps.infer_output`'s `decode(encode(...))`, and what
the model outputs (HoVer-Net's maps or Cellpose's flows) picks the tile
pipeline's post-processing (`infer/steps.make_tile_pipeline`)."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from .cellpose_sam import CELLPOSE_MODES, CellposeSAM, CellposeSAMConfig
from .cellvit import CELLVIT_MODES, CellViT, CellViTConfig
from .hovernet import MODE_SHAPES, HoVerNet, HoVerNetConfig

MODES = (*MODE_SHAPES, *CELLVIT_MODES, *CELLPOSE_MODES)
# run_infer's batch when none is given: HoVer-Net's 32, CellViT's 8 (its
# `cell_detection` default), Cellpose's 8 (its `batch_size` default)
DEFAULT_BATCH = {**{m: 32 for m in MODE_SHAPES},
                 **{m: 8 for m in CELLVIT_MODES},
                 **{m: 8 for m in CELLPOSE_MODES}}

ModelConfig = Union[HoVerNetConfig, CellViTConfig, CellposeSAMConfig]


def model_config(mode: str, nr_types: Optional[int] = None, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    """The configuration of `mode`; `width` is HoVer-Net's (CellViT's and
    Cellpose-SAM's widths are the published ones)."""
    if mode in CELLPOSE_MODES:
        return CellposeSAMConfig.for_mode(mode, nr_types=nr_types,
                                          dtype=dtype)
    if mode in CELLVIT_MODES:
        return CellViTConfig.for_mode(mode, nr_types=nr_types, dtype=dtype)
    return HoVerNetConfig(mode=mode, nr_types=nr_types, width=width,
                          dtype=dtype)


def build_model(cfg: ModelConfig, state: Dict[str, torch.Tensor]):
    """The model of `cfg` holding `state` (strict=True), on the host."""
    if isinstance(cfg, CellViTConfig):
        return CellViT.from_state_dict(cfg, state)
    if isinstance(cfg, CellposeSAMConfig):
        return CellposeSAM.from_state_dict(cfg, state)
    model = HoVerNet(cfg)
    model.load_state_dict(state, strict=True)
    return model
