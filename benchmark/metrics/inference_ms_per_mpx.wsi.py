"""WSI chunk loop (read, push, patch forward, scatter into the pred map),
ms per Mpx of slide: the sum of `WSIInferManager.timings[s]["inference"]`
over the window's slides over their area."""


def read(facts):
    v = [t["inference"] for t in facts["timings"].values() if "inference" in t]
    return 1e3 * sum(v) / facts["mpx"] if v and facts["mpx"] else None
