"""Device ms of CellViT's encoder (input normalisation, patch embedding,
the 32 blocks, the neck and the tissue head), per Mpx of slide: the sum
over the window's slides of `WSIInferManager.timings[s]["vit_encoder"]`
(CUDA events around `CellViT.encode` in `infer_output`, summed over the
forward batches) over their area."""

KEY = "vit_encoder"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return sum(v) / facts["mpx"] if v and facts["mpx"] else None
