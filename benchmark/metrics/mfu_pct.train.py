"""The whole training step's share of the card's TF32 peak, %: three times
the reference model's forward FLOPs of a patch (forward and backward), times
the patches of the traced steps, over the traced stretch's wall seconds,
over 495 TFLOP/s (TF32, the precision of run_train's convolutions)."""

from benchmark.roofline import TF32_PEAK_FLOPS


def read(facts):
    w = facts["trace"]["window_s"]
    if not facts["steps"] or w <= 0:
        return None
    return 100.0 * facts["flops_per_step"] * facts["steps"] / w / TF32_PEAK_FLOPS
