"""K1's share of its roofline on the WSI path, %: the least time its bytes
need (9 B a pixel of every post-processing window of the traced slide at
3.35 TB/s) over the device time of K1's kernels in the traced stretch."""

from benchmark.roofline import k1_floor_s, k1_seconds


def read(facts):
    k1_s = k1_seconds(facts["trace"]["device_by_name"])
    if k1_s <= 0 or not facts["k1_pixels"]:
        return None
    return 100.0 * k1_floor_s(facts["k1_pixels"]) / k1_s
