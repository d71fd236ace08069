"""Device ms of the chunk loop's forward batches (patch gather, the
model, the cast), per Mpx of slide: the sum of
`WSIInferManager.timings[s]["forward_ms"]` (CUDA events around each
forward batch) over the window's slides over their area."""

KEY = "forward_ms"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return sum(v) / facts["mpx"] if v and facts["mpx"] else None
