"""The chunk loop's wait for the prefetch thread (mask selection,
`read_region` and the push of the next chunk), ms per Mpx of slide: the
sum of `WSIInferManager.timings[s]["chunk_wait"]` (span
`hnt.wsi.chunk_wait`) over the window's slides over their area."""

KEY = "chunk_wait"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return 1e3 * sum(v) / facts["mpx"] if v and facts["mpx"] else None
