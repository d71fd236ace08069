"""Device ms of a tile's flow following (Cellpose's 200 Euler steps of the
foreground pixels through the stitched flows), mean over the window's
tiles: the tile pipeline's CUDA-event stage `flow_follow`."""

KEY = "flow_follow"


def read(facts):
    v = [t[KEY] for t in facts["timings"] if KEY in t]
    return sum(v) / len(v) if v else None
