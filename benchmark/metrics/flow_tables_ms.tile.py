"""Device ms of a Cellpose-SAM tile's masks after the flow-error check:
the masks under `min_size` dropped, the holes filled (a connected-component
pass over the whole background) and the instance tables built (stage
`tables` of the flow pipeline), mean over the window's tiles."""

FLOW = "flow_error"  # a stage of the flow pipeline alone


def read(facts):
    v = [t["tables"] for t in facts["timings"] if FLOW in t and "tables" in t]
    return sum(v) / len(v) if v else None
