"""Small utility functions (misc/utils.py parity: normalize,
colour deconvolution, dir helpers, seeding).

The port's copy of hover_net_tpu/utils/misc.py (same names, same
behaviour)."""

from __future__ import annotations

import os
import random
import shutil

import numpy as np


def normalize_to_uint8(mask, dtype=np.uint8):
    """Scale a map to 0..255 (misc/utils.py:13-14)."""
    return (255 * mask / np.amax(mask)).astype(dtype)


def color_deconvolution(rgb, stain_mat):
    """Optical-density colour deconvolution (misc/utils.py:111-119)."""
    log255 = np.log(255)
    rgb_float = rgb.astype(np.float64)
    log_rgb = -((255.0 * np.log((rgb_float + 1) / 255.0)) / log255)
    output = np.exp(-(log_rgb @ stain_mat - 255.0) * log255 / 255.0)
    output[output > 255] = 255
    return np.floor(output + 0.5).astype("uint8")


def rm_n_mkdir(dir_path):
    if os.path.isdir(dir_path):
        shutil.rmtree(dir_path)
    os.makedirs(dir_path)


def mkdir(dir_path):
    os.makedirs(dir_path, exist_ok=True)


def check_manual_seed(seed: int):
    """Seed host RNGs (run_utils/utils.py:33-49); torch randomness is
    handled by explicit torch.Generators seeded from the same seed."""
    random.seed(seed)
    np.random.seed(seed)
    return seed
