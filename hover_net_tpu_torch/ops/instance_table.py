"""Native (C++) per-instance statistics, contours, json and targets.

The port's copy of the functions it uses from
hover_net_tpu/ops/instance_table.py (same names, same behaviour), bound
to the port's own copy of the C++ source, csrc/instance_table.cpp. The
library is compiled with g++ at first use into build/hover_net_tpu_torch/
at the repository root (beside the CUDA kernels), under a name keyed by
a hash of the source and of the host CPU's feature flags (it is built
with -march=native, and a checkout may be copied to another host),
behind a lock: two threads racing the first build would corrupt the
`.so`. As in the JAX module, every function returns
None (or takes its NumPy path) when there is no compiler or the build
fails, and its callers take their Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

from .nvcc_build import BUILD_DIR, CSRC

_SRC = os.path.join(CSRC, "instance_table.cpp")
_lock = threading.Lock()
_state = {"lib": None, "failed": False}


def _build_lib() -> Optional[ctypes.CDLL]:
    lib = _state["lib"]
    if lib is not None:
        return lib
    with _lock:
        if _state["lib"] is None and not _state["failed"]:
            try:
                _state["lib"] = _load(_compile())
            except (OSError, subprocess.CalledProcessError):
                _state["failed"] = True
        return _state["lib"]


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), else its architecture."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")),
                        b"") or platform.machine().encode()
    except OSError:
        return platform.machine().encode()


def _compile() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + _cpu_flags()).hexdigest()[:12]
    so_path = os.path.join(BUILD_DIR, f"instance_table_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        _SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def _load(so_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so_path)
    lib.instance_table.restype = None
    lib.apply_lut.restype = None
    lib.trace_contours.restype = ctypes.c_int64
    lib.trace_contours_coo.restype = ctypes.c_int64
    lib.fragment_labels.restype = ctypes.c_int32
    lib.hv_targets.restype = ctypes.c_int32
    lib.emit_nuc_json.restype = ctypes.c_int64
    return lib


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def instance_table(labels: np.ndarray, type_map: Optional[np.ndarray] = None,
                   n_types: int = 0):
    """labels: [H, W] int32 contiguous 1..N. Returns
    (bbox [N,4] (rmin,rmax,cmin,cmax), centroid [N,2] (x,y),
    size [N], type_hist [N,n_types] | None)."""
    labels = np.ascontiguousarray(labels, np.int32)
    n = int(labels.max())
    h, w = labels.shape
    if n == 0:
        empty_hist = np.zeros((0, n_types), np.int64) if type_map is not None else None
        return (np.zeros((0, 4), np.int64), np.zeros((0, 2), np.float64),
                np.zeros((0,), np.int64), empty_hist)

    lib = _build_lib()
    if lib is not None:
        bbox = np.empty((n, 4), np.int64)
        sum_yx = np.empty((n, 2), np.int64)
        size = np.empty((n,), np.int64)
        if type_map is not None:
            tmap = np.ascontiguousarray(type_map, np.int32)
            hist = np.zeros((n, max(n_types, 1)), np.int64)
            tptr, hptr = _i32p(tmap), _i64p(hist)
        else:
            hist, tptr, hptr = None, None, None
        lib.instance_table(
            _i32p(labels), tptr, ctypes.c_int64(h), ctypes.c_int64(w),
            ctypes.c_int32(n), ctypes.c_int32(max(n_types, 1)),
            _i64p(bbox), _i64p(sum_yx), _i64p(size), hptr,
        )
    else:  # NumPy fallback (vectorised bincounts)
        flat = labels.ravel()
        size = np.bincount(flat, minlength=n + 1)[1:].astype(np.int64)
        ys, xs = np.nonzero(labels)
        lab = labels[ys, xs]
        order = np.argsort(lab, kind="stable")
        lab_s, ys_s, xs_s = lab[order], ys[order], xs[order]
        starts = np.searchsorted(lab_s, np.arange(1, n + 1))
        ends = np.searchsorted(lab_s, np.arange(1, n + 1), side="right")
        bbox = np.zeros((n, 4), np.int64)
        sum_yx = np.zeros((n, 2), np.int64)
        for i in range(n):
            sl = slice(starts[i], ends[i])
            if starts[i] == ends[i]:
                continue
            bbox[i] = (ys_s[sl].min(), ys_s[sl].max() + 1,
                       xs_s[sl].min(), xs_s[sl].max() + 1)
            sum_yx[i] = (ys_s[sl].sum(), xs_s[sl].sum())
        hist = None
        if type_map is not None:
            hist = np.zeros((n, max(n_types, 1)), np.int64)
            t = type_map[ys, xs]
            np.add.at(hist, (lab - 1, np.clip(t, 0, max(n_types, 1) - 1)), 1)

    with np.errstate(invalid="ignore"):
        centroid = np.stack(
            [sum_yx[:, 1] / np.maximum(size, 1), sum_yx[:, 0] / np.maximum(size, 1)],
            axis=1,
        )  # (x, y)
    return bbox, centroid, size, hist


def trace_contours(labels: np.ndarray, bbox: np.ndarray):
    """Outer contour of every instance in ONE native pass (Moore border
    following with CHAIN_APPROX_SIMPLE compression, bit-identical to
    cv2.findContours output on connected instances).

    labels: [H, W] int32 contiguous 1..N; bbox from instance_table.
    Returns list of [K_i, 2] int32 (x, y) arrays, index i = label i+1,
    or None when the native library is unavailable (callers fall back
    to per-instance cv2).
    """
    lib = _build_lib()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, np.int32)
    n = int(bbox.shape[0])
    if n == 0:
        return []
    h, w = labels.shape
    bbox = np.ascontiguousarray(bbox, np.int64)
    cap = max(1024, int((bbox[:, 1] - bbox[:, 0]).sum()
                        + (bbox[:, 3] - bbox[:, 2]).sum()) * 4)
    offs = np.empty((n + 1,), np.int64)
    while True:
        pts = np.empty((cap, 2), np.int32)
        r = lib.trace_contours(
            _i32p(labels), ctypes.c_int64(h), ctypes.c_int64(w),
            ctypes.c_int32(n), _i64p(bbox), _i32p(pts),
            ctypes.c_int64(cap), _i64p(offs),
        )
        if r >= 0:
            break
        cap *= 4
    return [pts[offs[i]:offs[i + 1]].copy() for i in range(n)]


def trace_contours_coo(yx: np.ndarray, lm: np.ndarray, n_labels: int):
    """Contours from a device-computed boundary-pixel table (the full
    label map never crosses to the host).

    yx: [n] int32 packed (y << 16) | x, lm: [n] int32 packed
    (label << 8) | neighbour-bitmask, in raster (y, x) order.
    Returns list of [K_i, 2] int32 (x, y) arrays (index i = label i+1;
    same chains as trace_contours / cv2 CHAIN_APPROX_SIMPLE), or None
    when the native library is unavailable.
    """
    lib = _build_lib()
    if lib is None:
        return None
    n = int(yx.shape[0])
    if n_labels == 0:
        return []
    yx = np.ascontiguousarray(yx, np.int32)
    lm = np.ascontiguousarray(lm, np.int32)
    offs = np.empty((n_labels + 1,), np.int64)
    cap = max(1024, 2 * n)
    while True:
        pts = np.empty((cap, 2), np.int32)
        r = lib.trace_contours_coo(
            _i32p(yx), _i32p(lm), ctypes.c_int64(n), ctypes.c_int32(n_labels),
            _i32p(pts), ctypes.c_int64(cap), _i64p(offs),
        )
        if r == -2:
            raise RuntimeError(
                "trace_contours_coo: walk left the boundary table "
                "(inconsistent COO input)"
            )
        if r >= 0:
            break
        cap *= 4
    return [pts[offs[i]:offs[i + 1]].copy() for i in range(n_labels)]


def fragment_labels(ann: np.ndarray):
    """4-connected same-value fragment labelling of an int32 map.

    Returns ([H, W] int32 fragment map numbered 1..F in first-raster-
    pixel order, F), or None when the native library is unavailable
    (callers fall back to scipy.sparse.csgraph)."""
    lib = _build_lib()
    if lib is None:
        return None
    ann = np.ascontiguousarray(ann, np.int32)
    out = np.empty(ann.shape, np.int32)
    n = lib.fragment_labels(
        _i32p(ann), ctypes.c_int64(ann.shape[0]), ctypes.c_int64(ann.shape[1]),
        _i32p(out),
    )
    return out, int(n)


def hv_targets_native(ann: np.ndarray, crop_shape, min_size: int = 30):
    """Fused native gen_instance_hv_map (ops/targets.py semantics,
    bit-exact vs the NumPy path by construction).

    Returns the FULL-SIZE [H, W, 2] float32 (x, y) map (caller crops),
    or None when the native library is unavailable.
    """
    lib = _build_lib()
    if lib is None:
        return None
    ann = np.ascontiguousarray(ann, np.int32)
    h, w = ann.shape
    ch, cw = crop_shape
    cy0 = int((h - ch) * 0.5)
    cx0 = int((w - cw) * 0.5)
    out = np.empty((h, w, 2), np.float32)
    out_x = np.empty((h, w), np.float32)
    out_y = np.empty((h, w), np.float32)
    frag = np.empty((h, w), np.int32)
    lib.hv_targets(
        _i32p(ann), ctypes.c_int64(h), ctypes.c_int64(w),
        ctypes.c_int64(cy0), ctypes.c_int64(cy0 + ch),
        ctypes.c_int64(cx0), ctypes.c_int64(cx0 + cw),
        ctypes.c_int64(min_size),
        out_x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _i32p(frag),
    )
    out[..., 0] = out_x
    out[..., 1] = out_y
    return out


def emit_nuc_json(ids, bbox, centroid, contour_offs, contour_pts,
                  type_ids, type_probs, mag) -> Optional[bytes]:
    """Serialize the {"mag", "nuc"} instance payload from flat tables in
    one native pass. Returns the utf-8 payload, or None when the native
    library is unavailable. Arrays must follow the emit_nuc_json C
    contract."""
    lib = _build_lib()
    if lib is None:
        return None
    n = int(ids.shape[0])
    ids = np.ascontiguousarray(ids, np.int64)
    bbox = np.ascontiguousarray(bbox, np.int64)
    centroid = np.ascontiguousarray(centroid, np.float64)
    contour_offs = np.ascontiguousarray(contour_offs, np.int64)
    contour_pts = np.ascontiguousarray(contour_pts, np.int32)
    if type_ids is not None:
        type_ids = np.ascontiguousarray(type_ids, np.int32)
        type_probs = np.ascontiguousarray(type_probs, np.float64)
        tptr = _i32p(type_ids)
        pptr = type_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    else:
        tptr = pptr = None
    mag_json = json.dumps(mag).encode()
    cap = 256 * max(n, 1) + 16 * int(contour_pts.shape[0]) * 2 + 1024
    while True:
        buf = ctypes.create_string_buffer(cap)
        r = lib.emit_nuc_json(
            _i64p(ids), ctypes.c_int64(n), _i64p(bbox),
            centroid.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _i64p(contour_offs), _i32p(contour_pts),
            tptr, pptr, mag_json, buf, ctypes.c_int64(cap),
        )
        if r >= 0:
            return buf.raw[:r]
        cap *= 4


def apply_lut(labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """labels = lut[labels], in place when native lib available."""
    lib = _build_lib()
    labels = np.ascontiguousarray(labels, np.int32)
    lut = np.ascontiguousarray(lut, np.int32)
    if lib is not None:
        lib.apply_lut(_i32p(labels), ctypes.c_int64(labels.size),
                      _i32p(lut), ctypes.c_int32(lut.size))
        return labels
    return lut[labels]
