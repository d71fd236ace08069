"""Dataset registry: Kumar / CPM17 / CoNSeP parsers (dataset.py parity).

The port's copy of hover_net_tpu/data/datasets.py (same names, same
behaviour).

Each parser returns images as RGB uint8 and annotations as HxWx1 (inst)
or HxWx2 (inst, type) int32 stacks. CoNSeP merges types {3,4}->3 and
{5,6,7}->4 exactly like the paper setup (dataset.py:86-87).
"""

from __future__ import annotations

import cv2
import numpy as np
import scipy.io as sio


class _Base:
    def load_img(self, path):
        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)

    def load_ann(self, path, with_type=False):
        raise NotImplementedError


class Kumar(_Base):
    def load_ann(self, path, with_type=False):
        assert not with_type, "Kumar has no type annotations"
        inst = sio.loadmat(path)["inst_map"].astype("int32")
        return inst[..., None]


class CPM17(_Base):
    def load_ann(self, path, with_type=False):
        assert not with_type, "CPM17 has no type annotations"
        inst = sio.loadmat(path)["inst_map"].astype("int32")
        return inst[..., None]


class CoNSeP(_Base):
    def load_ann(self, path, with_type=False):
        mat = sio.loadmat(path)
        inst = mat["inst_map"]
        if with_type:
            tp = mat["type_map"]
            tp[(tp == 3) | (tp == 4)] = 3
            tp[(tp == 5) | (tp == 6) | (tp == 7)] = 4
            return np.dstack([inst, tp]).astype("int32")
        return inst.astype("int32")[..., None]


_REGISTRY = {"kumar": Kumar, "cpm17": CPM17, "consep": CoNSeP}


def get_dataset(name: str):
    try:
        return _REGISTRY[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown dataset '{name}'; have {sorted(_REGISTRY)}")
