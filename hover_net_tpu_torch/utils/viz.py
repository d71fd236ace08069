"""Contour overlays of the tile manager and the training panels (host).

The port's copy of `overlay_instances`, `overlay_instances_map`,
`gen_figure`, `colorize`, `viz_train_panel` and their helper from
hover_net_tpu/utils/viz.py (same names, same behaviour); parity with
misc/viz_utils.py:28-173 and the jet-colormap panels of
run_desc.py:201-256 of the reference.

`colorize` takes matplotlib's 256-entry jet table from `JET_LUT`, built
here from matplotlib's own segment data by its interpolation rule, so
that the training panels need no matplotlib (the card's machine has
none). Only `gen_figure` imports matplotlib, when it is called.
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


def overlay_instances_map(image, inst_map, type_map=None, type_colour=None,
                          line_thickness=2):
    """Draw instance contours directly from a labelled instance map
    (no info dict needed) — `visualize_instances_map` parity
    (misc/viz_utils.py:42-90): per-instance bbox crop with a 2-px
    margin, cv2 contour extraction, colour by the type map's dominant
    non-zero id (type_colour: {type_id: (r, g, b)}) or a random palette.
    """
    overlay = np.copy(np.asarray(image).astype(np.uint8))
    inst_map = np.asarray(inst_map)
    inst_ids = [int(v) for v in np.unique(inst_map) if v != 0]
    rng_colors = (np.array(random_colors(len(inst_ids))) * 255).astype(np.uint8)

    for idx, inst_id in enumerate(inst_ids):
        mask = (inst_map == inst_id).astype(np.uint8)
        ys, xs = np.nonzero(mask)
        y1, y2 = ys.min(), ys.max()
        x1, x2 = xs.min(), xs.max()
        y1 = max(y1 - 2, 0)
        x1 = max(x1 - 2, 0)
        y2 = min(y2 + 2, inst_map.shape[0] - 1)
        x2 = min(x2 + 2, inst_map.shape[1] - 1)
        crop = mask[y1:y2, x1:x2]
        contours = cv2.findContours(
            crop, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE
        )[0]
        if not contours:
            continue
        contour = np.squeeze(contours[0].astype(np.int32)).reshape(-1, 2)
        contour = contour + np.asarray([[x1, y1]])
        if type_map is not None and type_colour is not None:
            type_id = int(np.max(type_map[y1:y2, x1:x2]))
            colour = tuple(int(c) for c in type_colour[type_id])
        else:
            colour = tuple(int(c) for c in rng_colors[idx])
        cv2.drawContours(overlay, [contour], -1, colour, line_thickness)
    return overlay


# matplotlib's jet segment data (x, y0, y1) per channel (_cm._jet_data)
_JET_SEGMENTS = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
     (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)


def _lookup_table(n, data):
    """matplotlib.colors._create_lookup_table for gamma 1, in float64."""
    adata = np.array(data, float)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


# [256, 3] RGB in [0, 1]: the table of matplotlib's "jet" colormap
JET_LUT = np.stack([_lookup_table(256, seg) for seg in _JET_SEGMENTS], -1)


def gen_figure(imgs_list, titles, fig_inch=None, shape=None,
               share_ax="all", show=False, colormap="jet"):
    """Matplotlib grid of images with titles (viz_utils.py:129-173):
    near-square layout unless `shape`=(rows, cols) is given; ticks
    hidden; returns the figure."""
    import math

    import matplotlib.pyplot as plt

    num_img = len(imgs_list)
    if shape is None:
        ncols = math.ceil(math.sqrt(num_img))
        nrows = math.ceil(num_img / ncols)
    else:
        nrows, ncols = shape

    fig, axes = plt.subplots(nrows=nrows, ncols=ncols, sharex=share_ax,
                             sharey=share_ax, squeeze=False)
    if fig_inch is not None:
        fig.set_size_inches(fig_inch)
    idx = 0
    for row in axes:
        for cell in row:
            if idx < num_img:
                cell.set_title(titles[idx])
                cell.imshow(imgs_list[idx], cmap=colormap)
            cell.tick_params(axis="both", which="both", bottom=False,
                             top=False, labelbottom=False, right=False,
                             left=False, labelleft=False)
            idx += 1
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def colorize(ch, vmin, vmax):
    """Jet colormap of a scalar map, clamped to [vmin, vmax]; a NaN is
    black, as matplotlib's 'bad' colour."""
    n = len(JET_LUT)
    ch = np.squeeze(ch.astype("float32")).copy()
    ch = np.clip(ch, vmin, vmax)
    ch = (ch - vmin) / (vmax - vmin + 1.0e-16)
    # Colormap.__call__: scale by N in the input's dtype, N -> N - 1,
    # truncate to the table index
    xa = ch * n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(xa.astype(int), 0, n - 1)
    rgb = (JET_LUT[idx] * 255).astype("uint8")
    rgb[bad] = 0
    return rgb


def viz_train_panel(imgs, true_np, pred_np, true_hv, pred_hv,
                    true_tp=None, pred_tp=None, nr_types=None):
    """True-vs-pred comparison panel per sample (run_desc.py:201-256)."""
    rows = []
    for i in range(imgs.shape[0]):
        h, w = true_np[i].shape[:2]
        img = imgs[i]
        y0 = (img.shape[0] - h) // 2
        x0 = (img.shape[1] - w) // 2
        img = img[y0 : y0 + h, x0 : x0 + w].astype(np.uint8)
        true_row = [img, colorize(true_np[i], 0, 1),
                    colorize(true_hv[i][..., 0], -1, 1),
                    colorize(true_hv[i][..., 1], -1, 1)]
        pred_row = [img, colorize(pred_np[i], 0, 1),
                    colorize(pred_hv[i][..., 0], -1, 1),
                    colorize(pred_hv[i][..., 1], -1, 1)]
        if nr_types is not None and true_tp is not None:
            true_row.append(colorize(true_tp[i], 0, nr_types))
            pred_row.append(colorize(pred_tp[i], 0, nr_types))
        rows.append(np.concatenate(
            [np.concatenate(true_row, axis=1), np.concatenate(pred_row, axis=1)],
            axis=0,
        ))
    return np.concatenate(rows, axis=0)
