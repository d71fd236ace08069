"""Experiment configuration (config.py + models/hovernet/opt.py parity).

The port's copy of hover_net_tpu/config.py (same names, same behaviour);
checkpoint paths name the port's `.tar` files instead of `.msgpack`.

One dataclass tree instead of the reference's Config class + dynamic
module import: shapes/mode invariants are enforced here
(config.py:40-45), and the default two-phase plan reproduces
opt.py:23-142 — phase 0 frozen encoder from ImageNet-pretrained
weights, bs 16, 50 epochs; phase 1 full finetune chained from phase 0,
bs 4, 50 epochs; Adam 1e-4 with StepLR(25); loss weights
np{bce,dice}/hv{mse,msge}/tp{bce,dice} all 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

MODE_SHAPES = {
    "original": {"aug": (540, 540), "act": (270, 270), "out": (80, 80)},
    "fast": {"aug": (540, 540), "act": (256, 256), "out": (164, 164)},
}


@dataclasses.dataclass
class PhaseConfig:
    freeze_encoder: bool = False
    # None = scratch; path = checkpoint (.tar) or .npz weights;
    # -1 = chain from previous phase's last epoch (opt.py:89)
    pretrained: Optional[object] = None
    batch_size: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"train": 16, "valid": 16}
    )
    nr_epochs: int = 50
    lr: float = 1.0e-4
    lr_step_epochs: int = 25
    lr_gamma: float = 0.1
    loss_weights: Optional[dict] = None  # None -> DEFAULT_LOSS_WEIGHTS


@dataclasses.dataclass
class TrainConfig:
    seed: int = 10
    logging: bool = True
    debug: bool = False

    model_mode: str = "original"
    nr_types: Optional[int] = 5
    type_classification: bool = True
    width: int = 64

    dataset_name: str = "consep"
    log_dir: str = "logs/"
    train_dir_list: Sequence[str] = ("train_patches_path",)
    valid_dir_list: Sequence[str] = ("valid_patches_path",)

    nr_procs_train: int = 8
    nr_procs_valid: int = 4

    # phase-0 ImageNet preact-ResNet50 weights (.npz TF- or torch-keyed,
    # or .tar); feeds default_phases (reference opt.py:55)
    pretrained: Optional[str] = None

    phases: Optional[List[PhaseConfig]] = None
    # test/debug hook: override {"aug","act","out"} shapes (any input
    # size satisfying the decoder divisibility constraints compiles —
    # see models/hovernet.py dynamic crops)
    shape_override: Optional[Dict[str, Tuple[int, int]]] = None

    def __post_init__(self):
        if self.model_mode not in MODE_SHAPES:
            raise ValueError(
                f"model_mode {self.model_mode!r}: run_train trains HoVer-Net "
                f"in {sorted(MODE_SHAPES)} mode only (CellViT runs through "
                f"run_infer, from a trained checkpoint)")
        if self.phases is None:
            self.phases = default_phases(self.model_mode, self.pretrained)
        if not self.type_classification:
            self.nr_types = None

    @property
    def shapes(self):
        if self.shape_override is not None:
            return self.shape_override
        return MODE_SHAPES[self.model_mode]

    @property
    def act_shape(self) -> Tuple[int, int]:
        return self.shapes["act"]

    @property
    def out_shape(self) -> Tuple[int, int]:
        return self.shapes["out"]


def default_phases(mode: str, pretrained: Optional[str] = None):
    """The reference's two-phase plan (opt.py:28-95)."""
    return [
        PhaseConfig(
            freeze_encoder=True, pretrained=pretrained,
            batch_size={"train": 16, "valid": 16}, nr_epochs=50,
        ),
        PhaseConfig(
            freeze_encoder=False, pretrained=-1,
            batch_size={"train": 4, "valid": 8}, nr_epochs=50,
        ),
    ]
