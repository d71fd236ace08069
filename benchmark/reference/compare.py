"""What decides `correct`: the program's maps and instances against the
reference's.

- `map_err`: the relative L2 distance of the np probability and hv maps,
  ||P - R|| / ||R|| over the compared pixels.
- `type_err`: the share of the reference's nucleus pixels (np >= 0.5)
  whose type differs.
- `pp_miss`: the post-processing and finalize by themselves: the oracle
  run on the program's own head map, against the program's json nuclei.
  `match` counts a nucleus missed where the other side's nucleus that
  overlaps it most has an IoU under 0.5.
- readings, printed and not compared: the program's json nuclei against
  the oracle's nuclei on the reference map (`inst_miss`), and among the
  matched the share typed otherwise.
"""

from __future__ import annotations

import json

import cv2
import numpy as np

from .postproc import instance_types, proc_np_hv

IOU = 0.5


def map_err_parts(port: np.ndarray, ref: np.ndarray, typed: bool):
    """(squared error, squared norm) of the np + hv channels."""
    c = 1 if typed else 0
    p, r = port[..., c:c + 3].astype(np.float64), ref[..., c:c + 3].astype(
        np.float64)
    return float(((p - r) ** 2).sum()), float((r ** 2).sum())


def type_err_parts(port: np.ndarray, ref: np.ndarray):
    """(pixels typed otherwise, nucleus pixels) over the reference's
    nucleus pixels."""
    fg = ref[..., 1] >= 0.5
    return int((np.rint(port[..., 0])[fg] != ref[..., 0][fg]).sum()), \
        int(fg.sum())


def raster(nuc: dict, origin, shape) -> tuple:
    """The program's json nuclei whose bbox meets the box at `origin`
    (y, x) of `shape`, filled from their contours into a label map of
    that box: (labels int32, [n + 1] types)."""
    oy, ox = origin
    h, w = shape
    lab = np.zeros((h, w), np.int32)
    types = [0]
    for info in nuc.values():
        (r0, c0), (r1, c1) = info["bbox"]
        if r1 <= oy or r0 >= oy + h or c1 <= ox or c0 >= ox + w:
            continue
        pts = np.asarray(info["contour"], np.int32) - np.array([ox, oy])
        types.append(int(info["type"]) if info.get("type") is not None
                     else 0)
        cv2.fillPoly(lab, [pts.reshape(-1, 1, 2)], len(types) - 1)
    return lab, np.asarray(types)


def match(ref_inst: np.ndarray, ref_types, port_lab: np.ndarray,
          port_types, interior: np.ndarray):
    """(reference nuclei counted, missed, matched typed otherwise) over
    the reference nuclei whose pixels all lie in `interior` (a bool mask:
    nuclei cut by the compared box are left out)."""
    n = int(ref_inst.max())
    if n == 0:
        return 0, 0, 0
    fg = ref_inst > 0
    outside = np.bincount(ref_inst[fg & ~interior], minlength=n + 1)
    area = np.bincount(ref_inst[fg], minlength=n + 1)
    keep = (area > 0) & (outside == 0)
    keep[0] = False
    m = int(port_lab.max()) + 1
    pair = np.bincount(ref_inst[fg].astype(np.int64) * m + port_lab[fg],
                       minlength=(n + 1) * m).reshape(n + 1, m)
    pair[:, 0] = 0
    best = pair.argmax(axis=1)
    inter = pair[np.arange(n + 1), best]
    port_area = np.bincount(port_lab.ravel(), minlength=m)
    iou = inter / np.maximum(area + port_area[best] - inter, 1)
    hit = keep & (iou >= IOU)
    typed_otherwise = 0
    if ref_types is not None:
        typed_otherwise = int((hit & (np.asarray(port_types)[best]
                                      != ref_types)).sum())
    return int(keep.sum()), int((keep & ~hit).sum()), typed_otherwise


def reference_instances(ref_map: np.ndarray, typed: bool):
    """(instance labels, [n + 1] types or None) of a reference map."""
    c = 1 if typed else 0
    inst = proc_np_hv(ref_map[..., c:c + 3])
    types = instance_types(inst, ref_map[..., 0].astype(np.int64)) \
        if typed else None
    return inst, types


def load_nuclei(path: str) -> dict:
    with open(path) as f:
        return json.load(f)["nuc"]


class Tally:
    """Sums of the compared quantities over every sampled tile or region;
    `numbers()` gives the ratios."""

    def __init__(self, typed: bool):
        self.typed = typed
        self.sq_err = self.sq_ref = 0.0
        self.type_px = self.fg_px = 0
        self.nuclei = self.missed = self.typed_otherwise = 0
        self.pp_nuclei = self.pp_missed = 0
        self.has_stage = False

    def add_maps(self, port, ref):
        e, r = map_err_parts(port, ref, self.typed)
        self.sq_err += e
        self.sq_ref += r
        if self.typed:
            a, b = type_err_parts(port, ref)
            self.type_px += a
            self.fg_px += b

    def add_match(self, counted, missed, typed_otherwise):
        self.nuclei += counted
        self.missed += missed
        self.typed_otherwise += typed_otherwise

    def add_stage(self, counted, missed):
        self.has_stage = True
        self.pp_nuclei += counted
        self.pp_missed += missed

    def numbers(self) -> dict:
        """{name: value} of the compared numbers: map_err, type_err (typed)
        and pp_miss (where the stage was added)."""
        out = {"map_err": (self.sq_err / max(self.sq_ref, 1e-30)) ** 0.5}
        if self.typed:
            out["type_err"] = self.type_px / max(self.fg_px, 1)
        if self.has_stage:
            out["pp_miss"] = self.pp_missed / max(self.pp_nuclei, 1)
        return out

    def readings(self) -> dict:
        """Numbers printed but not compared: the program's nuclei against
        the reference's. The post-processing is robust to the forward's
        precision, so these do not separate a bf16 forward from an fp8
        one (PERF.md)."""
        out = {"inst_miss": self.missed / max(self.nuclei, 1),
               "ref_nuclei": self.nuclei, "pp_nuclei": self.pp_nuclei}
        if self.typed:
            out["inst_type_miss"] = self.typed_otherwise / max(
                self.nuclei - self.missed, 1)
        return out
