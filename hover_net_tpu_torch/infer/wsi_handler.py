"""WSI file handlers (misc/wsi_handler.py parity).

The port's copy of hover_net_tpu/infer/wsi_handler.py (same names, same
behaviour). `OpenSlideHandler` wraps openslide, imported only when a
slide format needs it; `ArrayHandler` serves .npy / plain-image
pseudo-slides so the entire WSI pipeline runs (and is tested) without
OpenSlide. Both expose the same magnification logic: `get_dimensions`,
`prepare_reading` (caching a rescaled copy when the requested mag isn't
native), `read_region` in (x, y) coords at the prepared mag,
`get_full_img` at any mag.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

import cv2
import numpy as np


class FileHandler:
    def __init__(self):
        self.metadata = {}
        self.image_ptr = None
        self.read_lv = None

    # -- mag bookkeeping (misc/wsi_handler.py:50-99 semantics)

    def get_dimensions(self, read_mag=None, read_mpp=None):
        """(x, y) dimensions at the requested magnification."""
        if read_mpp is not None:
            read_mag = (self.metadata["base_mpp"] / read_mpp)[0] * self.metadata["base_mag"]
        scale = read_mag / self.metadata["base_mag"]
        return (self.metadata["base_shape"] * scale).astype(np.int64)

    def _get_read_info(self, read_mag=None, read_mpp=None):
        if read_mpp is not None:
            assert read_mpp[0] == read_mpp[1], "uneven read_mpp unsupported"
            read_mag = (self.metadata["base_mpp"] / read_mpp)[0] * self.metadata["base_mag"]
        available = self.metadata["available_mag"]
        hires_mag = read_mag
        scale_factor = None
        if read_mag not in available:
            if read_mag > self.metadata["base_mag"]:
                scale_factor = read_mag / self.metadata["base_mag"]
                hires_mag = self.metadata["base_mag"]
            else:
                mags = np.sort(np.array(available))[::-1]
                higher = mags[(mags - read_mag) > 0]
                hires_mag = higher[np.argmin(higher - read_mag)]
                scale_factor = read_mag / hires_mag
        return available.index(hires_mag), scale_factor

    def prepare_reading(self, read_mag=None, read_mpp=None, cache_path=None):
        """Cache a rescaled full image (mmap) when the requested mag is
        not native; otherwise read directly at the native level."""
        read_lv, scale_factor = self._get_read_info(read_mag, read_mpp)
        if scale_factor is None:
            self.image_ptr = None
            self.read_lv = read_lv
        else:
            np.save(cache_path, self.get_full_img(read_mag=read_mag))
            self.image_ptr = np.load(cache_path, mmap_mode="r")

    def read_region(self, coords, size):
        """(x, y) top-left + (w, h) size at the prepared magnification."""
        if self.image_ptr is not None:
            region = self.image_ptr[
                coords[1] : coords[1] + size[1], coords[0] : coords[0] + size[0]
            ]
            return np.array(region)[..., :3]
        return self._read_native(coords, size)

    def _read_native(self, coords, size):
        raise NotImplementedError

    def get_full_img(self, read_mag=None, read_mpp=None):
        raise NotImplementedError


class OpenSlideHandler(FileHandler):
    def __init__(self, file_path):
        super().__init__()
        import openslide  # imported only for the slide formats that need it

        self._openslide = openslide
        self.file_ptr = openslide.OpenSlide(file_path)
        props = self.file_ptr.properties
        base_mag = float(props[openslide.PROPERTY_NAME_OBJECTIVE_POWER])
        mags = [base_mag / d for d in self.file_ptr.level_downsamples]
        mpp = np.array([
            float(props[openslide.PROPERTY_NAME_MPP_X]),
            float(props[openslide.PROPERTY_NAME_MPP_Y]),
        ])
        self.metadata = OrderedDict([
            ("available_mag", mags),
            ("base_mag", base_mag),
            ("base_mpp", mpp),
            ("vendor", props.get(openslide.PROPERTY_NAME_VENDOR)),
            ("base_shape", np.array(self.file_ptr.dimensions)),
        ])

    def _read_native(self, coords, size):
        lv0 = np.array(self.file_ptr.level_dimensions[0])
        lvr = np.array(self.file_ptr.level_dimensions[self.read_lv])
        up = (lv0 / lvr)[0]
        new_coord = (int(coords[0] * up), int(coords[1] * up))
        region = self.file_ptr.read_region(new_coord, self.read_lv, tuple(size))
        return np.array(region)[..., :3]

    def get_full_img(self, read_mag=None, read_mpp=None):
        read_lv, scale_factor = self._get_read_info(read_mag, read_mpp)
        size = self.file_ptr.level_dimensions[read_lv]
        img = np.array(self.file_ptr.read_region((0, 0), read_lv, size))[..., :3]
        if scale_factor is not None:
            interp = cv2.INTER_CUBIC if scale_factor > 1 else cv2.INTER_LINEAR
            img = cv2.resize(img, (0, 0), fx=scale_factor, fy=scale_factor,
                             interpolation=interp)
        return img


class ArrayHandler(FileHandler):
    """Pseudo-slide from a .npy array or a plain image file.

    The declared `base_mag` (default 40) stands in for objective power;
    useful for tests and for pipelines fed by pre-exported regions.
    """

    def __init__(self, file_path, base_mag: float = 40.0):
        super().__init__()
        if file_path.endswith(".npy"):
            self.array = np.load(file_path, mmap_mode="r")
        else:
            img = cv2.imread(file_path)
            assert img is not None, f"cannot read {file_path}"
            self.array = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        h, w = self.array.shape[:2]
        self.metadata = OrderedDict([
            ("available_mag", [base_mag]),
            ("base_mag", base_mag),
            ("base_mpp", np.array([0.25, 0.25]) * 40.0 / base_mag),
            ("vendor", "array"),
            ("base_shape", np.array([w, h])),
        ])

    def _read_native(self, coords, size):
        region = self.array[
            coords[1] : coords[1] + size[1], coords[0] : coords[0] + size[0]
        ]
        return np.array(region)[..., :3]

    def get_full_img(self, read_mag=None, read_mpp=None):
        _, scale_factor = self._get_read_info(read_mag, read_mpp)
        img = np.array(self.array)[..., :3]
        if scale_factor is not None:
            interp = cv2.INTER_CUBIC if scale_factor > 1 else cv2.INTER_LINEAR
            img = cv2.resize(img, (0, 0), fx=scale_factor, fy=scale_factor,
                             interpolation=interp)
        return img


OPENSLIDE_EXTS = (".svs", ".tif", ".vms", ".vmu", ".ndpi", ".scn", ".mrxs",
                  ".tiff", ".svslide", ".bif")


def get_file_handler(path: str, backend: Optional[str] = None, base_mag: float = 40.0):
    ext = backend or os.path.splitext(path)[1]
    ext = ext.lower()
    if ext in OPENSLIDE_EXTS:
        try:
            return OpenSlideHandler(path)
        except ImportError:
            raise RuntimeError(
                f"openslide not installed but required for {ext} files"
            )
    if ext in (".npy", ".png", ".jpg", ".jpeg", ".bmp"):
        return ArrayHandler(path, base_mag=base_mag)
    raise ValueError(f"unknown WSI format `{ext}`")
