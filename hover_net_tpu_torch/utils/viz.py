"""Contour overlays of the tile manager (host, cv2).

The port's copy of `overlay_instances` and its helper from
hover_net_tpu/utils/viz.py (same names, same behaviour); parity with
misc/viz_utils.py:28-125 of the reference.
"""

from __future__ import annotations

import colorsys
import random

import cv2
import numpy as np


def random_colors(n, bright=True, shuffle=True):
    brightness = 1.0 if bright else 0.7
    hsv = [(i / max(n, 1), 1, brightness) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    if shuffle:
        random.shuffle(colors)
    return colors


def overlay_instances(image, inst_info, draw_dot=False, type_colour=None,
                      line_thickness=2):
    """Draw instance contours (from an inst_info dict) on an RGB image.

    type_colour: {type_id: (name, (r, g, b))} like type_info.json.
    """
    overlay = np.copy(image)
    rng_colors = (np.array(random_colors(len(inst_info))) * 255).astype(np.uint8)
    for idx, (inst_id, info) in enumerate(inst_info.items()):
        contour = np.asarray(info["contour"], np.int32)
        if info.get("type") is not None and type_colour is not None:
            colour = tuple(int(c) for c in type_colour[info["type"]][1])
        else:
            colour = tuple(int(c) for c in rng_colors[idx])
        cv2.drawContours(overlay, [contour], -1, colour, line_thickness)
        if draw_dot:
            cx, cy = (int(v) for v in info["centroid"])
            overlay = cv2.circle(overlay, (cx, cy), 3, (255, 0, 0), -1)
    return overlay
