"""Device ms of CellViT's decoders and heads (the skip decoders, the three
upsampling branches, the centre cut), per Mpx of slide: the sum over the
window's slides of `WSIInferManager.timings[s]["vit_decoder"]` (CUDA
events around `CellViT.decode` in `infer_output`, summed over the
forward batches) over their area."""

KEY = "vit_decoder"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return sum(v) / facts["mpx"] if v and facts["mpx"] else None
