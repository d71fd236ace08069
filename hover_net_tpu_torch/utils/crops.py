"""Center-crop primitives of the model code.

The port's copy of the functions it uses from hover_net_tpu/utils/crops.py
(same names, same behaviour). Pure slicing, so they work on numpy arrays
and torch tensors alike.

Behavioural reference: misc/utils.py:32-52 and
models/hovernet/utils.py:11-50 in the upstream repo.
"""

from __future__ import annotations


def crop_op(x, cropping, layout: str = "NHWC"):
    """Center crop by a fixed *amount* (`cropping` = total pixels removed).

    Top/left get ``amount // 2``; bottom/right get the remainder — the same
    asymmetric split as the reference (models/hovernet/utils.py:20-27).
    """
    ct = cropping[0] // 2
    cb = cropping[0] - ct
    cl = cropping[1] // 2
    cr = cropping[1] - cl
    if layout == "NHWC":
        return x[:, ct : x.shape[1] - cb, cl : x.shape[2] - cr, :]
    if layout == "NCHW":
        return x[:, :, ct : x.shape[2] - cb, cl : x.shape[3] - cr]
    raise ValueError(f"unknown layout {layout}")


def crop_to_shape(x, target_hw, layout: str = "NHWC"):
    """Center crop ``x`` so its spatial dims equal ``target_hw`` (h, w)."""
    if layout == "NHWC":
        dh, dw = x.shape[1] - target_hw[0], x.shape[2] - target_hw[1]
    else:
        dh, dw = x.shape[2] - target_hw[0], x.shape[3] - target_hw[1]
    assert dh >= 0 and dw >= 0, "target must be smaller than source"
    return crop_op(x, (dh, dw), layout)


def cropping_center(x, crop_shape, batch: bool = False):
    """Center crop of a (H, W, ...) array (or (N, H, W, ...) when batch).

    Matches misc/utils.py:32-52: offsets use ``int((size - crop) * 0.5)``.
    """
    if not batch:
        h0 = int((x.shape[0] - crop_shape[0]) * 0.5)
        w0 = int((x.shape[1] - crop_shape[1]) * 0.5)
        return x[h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1]]
    h0 = int((x.shape[1] - crop_shape[0]) * 0.5)
    w0 = int((x.shape[2] - crop_shape[1]) * 0.5)
    return x[:, h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1]]
