"""The post-processing phases' host extraction of instances (the label
pulls, then the pool's `extract_instance_info`), main-thread ms per Mpx
of slide: the sum of `WSIInferManager.timings[s]["pp_extract"]` (span
`hnt.wsi.pp.extract`) over the window's slides over their area."""

KEY = "pp_extract"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return 1e3 * sum(v) / facts["mpx"] if v and facts["mpx"] else None
