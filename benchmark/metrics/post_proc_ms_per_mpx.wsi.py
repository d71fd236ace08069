"""WSI 3-phase post-processing, ms per Mpx of slide: the sum of
`timings[s]["post_proc_phase1..3"]` over the window's slides over their
area."""


def read(facts):
    v = [sum(t[f"post_proc_phase{k}"] for k in (1, 2, 3))
         for t in facts["timings"].values() if "post_proc_phase3" in t]
    return 1e3 * sum(v) / facts["mpx"] if v and facts["mpx"] else None
