"""Device ms of a tile's masks from the followed points (the seeds and
their grown boxes, the labels, the big-mask cut: stage `flow_masks`) and
of the flow-error check (each mask's own flows by heat diffusion against
the net's: stage `flow_error`), mean over the window's tiles."""

STAGES = ("flow_masks", "flow_error")


def read(facts):
    v = [sum(t[s] for s in STAGES) for t in facts["timings"]
         if all(s in t for s in STAGES)]
    return sum(v) / len(v) if v else None
