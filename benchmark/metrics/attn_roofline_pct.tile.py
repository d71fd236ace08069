"""The ViT attention's share of its roofline on the tile path, %: the
reference's FLOPs of the attention modules of a tile's blocks (qkv, the
scores q k^T, the decomposed relative-position products, the weighted sum
and proj: the work inside the part the program times), over the mean
device seconds of a tile's `global_attn` part, over 989 TFLOP/s (bf16),
as `attn_roofline_pct.wsi` counts them."""

from benchmark.roofline import BF16_PEAK_FLOPS


def read(facts):
    v = [t["global_attn"] for t in facts["timings"] if "global_attn" in t]
    flops = facts.get("attn_flops_per_tile")
    if not v or not flops or sum(v) <= 0:
        return None
    s = sum(v) / len(v) / 1e3
    return 100.0 * flops / s / BF16_PEAK_FLOPS
