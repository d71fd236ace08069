"""Device ms of a tile's post-processing: the CUDA-event stages `energy`,
`post_proc_tail` (K1) and `tables`, mean over the window's tiles."""

STAGES = ("energy", "post_proc_tail", "tables")


def read(facts):
    v = [sum(t[s] for s in STAGES) for t in facts["timings"]
         if all(s in t for s in STAGES)]
    return sum(v) / len(v) if v else None
