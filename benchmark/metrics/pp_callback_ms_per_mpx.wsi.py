"""The post-processing phases' in-order callbacks (renumbering and
stitching the instances into the slide's map and json), ms per Mpx of
slide: the sum of `WSIInferManager.timings[s]["pp_callback"]` (span
`hnt.wsi.pp.callback`) over the window's slides over their area."""

KEY = "pp_callback"


def read(facts):
    v = [t[KEY] for t in facts["timings"].values() if KEY in t]
    return 1e3 * sum(v) / facts["mpx"] if v and facts["mpx"] else None
