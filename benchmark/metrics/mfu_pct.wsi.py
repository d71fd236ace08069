"""The whole slide's share of the card's bf16 peak, %: the reference
model's FLOPs per patch times the patches the traced slide needs (those
over tissue), over the traced stretch's wall seconds, over 989 TFLOP/s."""

from benchmark.roofline import BF16_PEAK_FLOPS


def read(facts):
    w = facts["trace"]["window_s"]
    if not facts["patches"] or w <= 0:
        return None
    return 100.0 * facts["flops_per_patch"] * facts["patches"] / w / BF16_PEAK_FLOPS
