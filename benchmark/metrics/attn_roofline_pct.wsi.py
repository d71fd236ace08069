"""The ViT attention's share of its roofline on the WSI path, %: the
reference's FLOPs of the attention modules of one patch (qkv, the scores
q k^T, the decomposed relative-position products, the weighted sum and
proj: the work inside the parts the program times), times the patches of
the traced slide, over the device seconds of the traced slide's
`global_attn` and `window_attn` parts, over 989 TFLOP/s (bf16)."""

from benchmark.roofline import BF16_PEAK_FLOPS


def read(facts):
    t = facts["timings"].get(facts.get("traced_slide"), {})
    s = (t.get("global_attn", 0.0) + t.get("window_attn", 0.0)) / 1e3
    if s <= 0 or not facts.get("attn_flops_per_patch") or \
            not facts["patches"]:
        return None
    return (100.0 * facts["attn_flops_per_patch"] * facts["patches"] / s
            / BF16_PEAK_FLOPS)
