"""Device ms of the attention of CellViT's 4 global blocks (qkv through
proj), per Mpx of slide: the sum over the window's slides of
`WSIInferManager.timings[s]["global_attn"]` (CUDA events around each
global block's attention, summed over the forward batches) over their
area."""

KEY = "global_attn"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return sum(v) / facts["mpx"] if v and facts["mpx"] else None
