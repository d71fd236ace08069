"""Device ms of the attention of CellViT's 28 windowed blocks (qkv through
proj, with the pad, the window partition and the merge), per Mpx of
slide: the sum over the window's slides of
`WSIInferManager.timings[s]["window_attn"]` (CUDA events around each
windowed block's attention, summed over the forward batches) over their
area."""

KEY = "window_attn"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return sum(v) / facts["mpx"] if v and facts["mpx"] else None
