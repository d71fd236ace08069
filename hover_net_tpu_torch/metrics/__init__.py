from .stats import (  # noqa: F401
    get_dice_1,
    get_dice_2,
    get_fast_aji,
    get_fast_aji_plus,
    get_fast_dice_2,
    get_fast_pq,
    pair_coordinates,
    remap_label,
)
