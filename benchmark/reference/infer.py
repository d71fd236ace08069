"""The reference's inference: the plain model over a tile's or a slide
region's patches, in float32 with TF32 off, stitched as HoVer-Net
stitches them. `rounding` names one of
`lowp.ROUNDINGS` to put on every convolution: `fp8`, the control; `bf16`,
the witness."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .geometry import prepare_tile_patching
from .lowp import ROUNDINGS
from .model import HoVerNetRef, head_maps, set_quant, strict_fp32


class Reference:
    def __init__(self, cfg: dict, weights: str, device: str,
                 rounding: Optional[str] = None, batch: int = 16):
        self.cfg, self.device, self.batch = cfg, device, batch
        self.model = HoVerNetRef(cfg["mode"], cfg["nr_types"], cfg["width"])
        state = torch.load(weights, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["desc"])
        self.model.to(device).eval()
        if rounding is not None:
            set_quant(self.model, ROUNDINGS[rounding])
        self.win, self.step = cfg["patch_input"], cfg["patch_output"]

    @torch.no_grad()
    def patches(self, patches: np.ndarray) -> np.ndarray:
        """[K, win, win, 3] uint8 -> [K, step, step, C] float32 maps."""
        out = []
        with strict_fp32():
            for i in range(0, len(patches), self.batch):
                x = torch.from_numpy(np.ascontiguousarray(
                    patches[i:i + self.batch])).to(self.device)
                out.append(head_maps(self.model(x.permute(0, 3, 1, 2)))
                           .cpu().numpy())
        return np.concatenate(out)

    def tile(self, img: np.ndarray) -> np.ndarray:
        """A tile's map [H, W, C] over the exact patch grid of the tile
        path: reflect padding, patches at stride `step`, stitched."""
        h, w = img.shape[:2]
        pads, coords, grid = prepare_tile_patching((h, w), self.win, self.step)
        padded = np.pad(img, ((pads[0], pads[1]), (pads[2], pads[3]), (0, 0)),
                        mode="reflect")
        maps = self.patches(np.stack([padded[y:y + self.win, x:x + self.win]
                                      for y, x in coords]))
        c = maps.shape[-1]
        full = maps.reshape(grid[0], grid[1], self.step, self.step, c)
        full = full.transpose(0, 2, 1, 3, 4).reshape(
            grid[0] * self.step, grid[1] * self.step, c)
        return full[:h, :w]

    def region(self, slide: np.ndarray, patch_boxes: np.ndarray, origin,
               size: int) -> np.ndarray:
        """The slide map over the box at `origin` (y, x) of `size`: each
        patch of `patch_boxes` ([K, 2, 2, 2]: input | output, tl | br)
        whose output meets the box is run from the slide and pasted; the
        rest is zero, as in a slide's map where no patch ran."""
        oy, ox = origin
        out_tl = patch_boxes[:, 1, 0]
        hit = ((out_tl[:, 0] < oy + size) & (out_tl[:, 0] + self.step > oy)
               & (out_tl[:, 1] < ox + size) & (out_tl[:, 1] + self.step > ox))
        boxes = patch_boxes[hit]
        c = 4 if self.cfg["nr_types"] else 3
        region = np.zeros((size, size, c), np.float32)
        if not len(boxes):
            return region
        maps = self.patches(np.stack([
            slide[y:y + self.win, x:x + self.win] for y, x in boxes[:, 0, 0]]))
        for (py, px), m in zip(boxes[:, 1, 0], maps):
            y0, x0 = max(py, oy), max(px, ox)
            y1 = min(py + self.step, oy + size)
            x1 = min(px + self.step, ox + size)
            region[y0 - oy:y1 - oy, x0 - ox:x1 - ox] = \
                m[y0 - py:y1 - py, x0 - px:x1 - px]
        return region
