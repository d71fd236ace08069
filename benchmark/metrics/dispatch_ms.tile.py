"""Host ms of a tile's dispatch (pad, push, the pipeline's launches, and
the waits for the device of K1's flag reads and the tables' boundary
count), mean over the window's tiles: span
`hnt.tile.dispatch`, `TileInferManager.timings[i]["dispatch_ms"]`."""

KEY = "dispatch_ms"


def read(facts):
    v = [t[KEY] for t in facts["timings"] if KEY in t]
    return sum(v) / len(v) if v else None
