from .crops import (  # noqa: F401
    crop_op,
    crop_to_shape,
    cropping_center,
    center_pad_to_shape,
    get_bounding_box,
)
