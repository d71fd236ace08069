"""Training augmentations (host-side NumPy/cv2, per dataloader worker).

The port's copy of hover_net_tpu/data/augs.py (same names, same
behaviour).

Semantics track the reference pipeline (dataloader/train_loader.py:
113-183 + dataloader/augs.py):

shape: affine (scale 0.8-1.2 per axis, translate +-1%, shear +-5deg,
rotate +-179deg, nearest-neighbour, cv2 backend) -> center crop ->
flips. photometric: OneOf{gaussian blur, median blur, additive gaussian
noise} then hue/saturation/brightness/contrast in random order.

Deliberate fix (documented deviation): the reference's contrast aug
returns the clipped *original* image (augs.py:97 clips `img` not `ret`),
making it a no-op. We implement the obviously-intended behaviour.
"""

from __future__ import annotations

import math

import cv2
import numpy as np

from ..utils.crops import cropping_center


class AffineAug:
    """imgaug.Affine-equivalent: one sampled matrix applied to image and
    annotation with nearest-neighbour interpolation."""

    def __init__(self, scale=(0.8, 1.2), translate_pct=(-0.01, 0.01),
                 shear_deg=(-5, 5), rotate_deg=(-179, 179)):
        self.scale = scale
        self.translate_pct = translate_pct
        self.shear_deg = shear_deg
        self.rotate_deg = rotate_deg

    def sample_matrix(self, rng, shape):
        h, w = shape[:2]
        sx = rng.uniform(*self.scale)
        sy = rng.uniform(*self.scale)
        tx = rng.uniform(*self.translate_pct) * w
        ty = rng.uniform(*self.translate_pct) * h
        rot = math.radians(rng.uniform(*self.rotate_deg))
        shear = math.radians(rng.uniform(*self.shear_deg))
        # center -> scale/rotate/shear -> translate -> back (imgaug order)
        cx, cy = w / 2 - 0.5, h / 2 - 0.5
        c1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
        s = np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1]])
        r = np.array([[math.cos(rot), -math.sin(rot), 0],
                      [math.sin(rot), math.cos(rot), 0], [0, 0, 1]])
        sh = np.array([[1, -math.sin(shear), 0], [0, math.cos(shear), 0],
                       [0, 0, 1]])
        t = np.array([[1, 0, tx + cx], [0, 1, ty + cy], [0, 0, 1]])
        return (t @ sh @ r @ s @ c1)[:2]

    def apply(self, m, arr):
        h, w = arr.shape[:2]
        return cv2.warpAffine(
            arr, m, (w, h), flags=cv2.INTER_NEAREST,
            borderMode=cv2.BORDER_REFLECT_101,
        )

    def apply_cropped(self, m, arr, out_shape):
        """Warp + center-crop fused: compose the crop offset into the
        matrix and render ONLY the out_shape window (~4.4x less warp
        work for 540^2 -> 256^2 than warping the full source and
        cropping). Equivalent to cropping_center(apply(m, arr)) up to
        float tie-breaking of nearest-neighbour sample coordinates
        (img and ann share one matrix, so they stay aligned)."""
        h, w = arr.shape[:2]
        oh, ow = out_shape
        y0, x0 = (h - oh) // 2, (w - ow) // 2
        m2 = m.copy()
        m2[0, 2] -= x0
        m2[1, 2] -= y0
        return cv2.warpAffine(
            arr, m2, (ow, oh), flags=cv2.INTER_NEAREST,
            borderMode=cv2.BORDER_REFLECT_101,
        )


def gaussian_blur(rng, img, max_ksize=3):
    k = rng.integers(0, max_ksize, 2) * 2 + 1
    out = cv2.GaussianBlur(img, tuple(int(v) for v in k), sigmaX=0, sigmaY=0,
                           borderType=cv2.BORDER_REPLICATE)
    return out.reshape(img.shape).astype(np.uint8)


def median_blur(rng, img, max_ksize=3):
    k = int(rng.integers(0, max_ksize)) * 2 + 1
    return cv2.medianBlur(img, k).astype(np.uint8)


def additive_gaussian_noise(rng, img, scale=0.05 * 255, per_channel_p=0.5):
    # cv2's MWC gaussian fill is ~3x numpy's ziggurat on one core;
    # its stream is reseeded from `rng` per call so the chain stays
    # deterministic per worker (sample values were never imgaug-stream
    # reproducible anyway — see PARITY.md on augmentation RNG)
    sigma = float(rng.uniform(0, scale))
    cv2.setRNGSeed(int(rng.integers(0, 2**31 - 1)))
    if rng.uniform() < per_channel_p:
        noise = np.empty(img.shape, np.float32)
        cv2.randn(noise, (0.0,) * img.shape[-1], (sigma,) * img.shape[-1])
    else:
        noise = np.empty(img.shape[:2], np.float32)
        cv2.randn(noise, 0.0, sigma)
        noise = noise[..., None]
    return np.clip(img + noise, 0, 255).astype(np.uint8)


_IDENT_LUT = np.arange(256, dtype=np.float32)


def add_to_hue(rng, img, rng_range=(-8, 8)):
    """Shift the HSV hue channel. The +hue (mod 180) is applied through
    a 3-channel LUT (identity on S/V) — one vectorized pass instead of
    a fancy-indexed read-modify-write of the hue plane."""
    hue = rng.uniform(*rng_range)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    lut = np.stack(
        [(_IDENT_LUT + hue) % 180, _IDENT_LUT, _IDENT_LUT], -1
    ).astype(np.uint8).reshape(256, 1, 3)
    cv2.LUT(hsv, lut, dst=hsv)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def add_to_saturation(rng, img, rng_range=(-0.2, 0.2)):
    """img*v + gray*(1-v) as ONE per-pixel 3x3 matrix pass
    (cv2.transform, saturating to uint8): the grayscale mix is linear
    in RGB, so the whole op folds into v*I + (1-v)*ones@w_gray."""
    value = np.float32(1 + rng.uniform(*rng_range))
    w = np.array([0.299, 0.587, 0.114], np.float32)  # RGB2GRAY weights
    m = np.eye(3, dtype=np.float32) * value + (1 - value) * np.tile(w, (3, 1))
    return cv2.transform(img, m)


def add_to_brightness(rng, img, rng_range=(-26, 26)):
    value = rng.uniform(*rng_range)
    return cv2.add(img, (value, value, value, 0))  # saturating uint8 add


def add_to_contrast(rng, img, rng_range=(0.75, 1.25)):
    """(img - mean)*v + mean as one saturating 3x4 affine pass;
    cv2.mean is ~50x numpy's pairwise uint8->f32 reduction here."""
    value = np.float32(rng.uniform(*rng_range))
    mean = np.asarray(cv2.mean(img)[: img.shape[-1]], np.float32)
    m = np.hstack([np.eye(3, dtype=np.float32) * value,
                   (mean * (1 - value))[:, None]])
    return cv2.transform(img, m)


class TrainAugmentor:
    """Full train-mode augmentation chain; `valid` mode = center crop only."""

    def __init__(self, input_shape, mode: str = "train", seed: int = 0):
        self.input_shape = tuple(input_shape)
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.affine = AffineAug()

    def reseed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray, ann: np.ndarray):
        """img uint8 HWC, ann int32 HW[,C]; returns the augmented pair,
        BOTH center-cropped to input_shape.

        The crop sits right after the affine — exactly the reference's
        shape_augs chain (Affine -> CropToFixedSize(center) -> Fliplr ->
        Flipud, train_loader.py:113-138, applied to img AND ann) — so
        flips, photometric augs and downstream HV-target generation all
        run at input_shape (256^2 fast), not the 540^2 source patch:
        ~4.4x less photometric/target host work per sample, and
        boundary instances normalise their HV extents over the SAME
        clipped view the reference sees."""
        rng = self.rng
        if self.mode == "train":
            m = self.affine.sample_matrix(rng, img.shape)
            img = self.affine.apply_cropped(m, img, self.input_shape)
            # cv2 warps <=4 interleaved channels in one call (ann is
            # inst[, type]); reshape restores a singleton channel dim
            # that cv2 squeezes
            ann = self.affine.apply_cropped(m, ann, self.input_shape)\
                .reshape(*self.input_shape, *ann.shape[2:])
            if rng.uniform() < 0.5:
                img, ann = img[:, ::-1].copy(), ann[:, ::-1].copy()
            if rng.uniform() < 0.5:
                img, ann = img[::-1].copy(), ann[::-1].copy()

            choice = rng.integers(0, 3)
            if choice == 0:
                img = gaussian_blur(rng, img)
            elif choice == 1:
                img = median_blur(rng, img)
            else:
                img = additive_gaussian_noise(rng, img)

            photometric = [add_to_hue, add_to_saturation,
                           add_to_brightness, add_to_contrast]
            for i in rng.permutation(4):
                img = photometric[i](rng, img)
            return img, ann

        img = cropping_center(img, self.input_shape)
        ann = cropping_center(ann, self.input_shape)
        return img, ann
