"""The whole tile step's share of the card's bf16 peak, %: the reference
model's FLOPs for a tile's exact patch grid, times the tiles of the traced
stretch, over its wall seconds, over 989 TFLOP/s."""

from benchmark.roofline import BF16_PEAK_FLOPS


def read(facts):
    w = facts["trace"]["window_s"]
    if not facts["tiles"] or w <= 0:
        return None
    return 100.0 * facts["flops_per_tile"] * facts["tiles"] / w / BF16_PEAK_FLOPS
