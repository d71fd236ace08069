"""Host ms of a tile's image read on the main thread (`cv2.imread` and the
colour conversion), mean over the window's tiles: span `hnt.tile.read`,
`TileInferManager.timings[i]["read_ms"]`."""

KEY = "read_ms"


def read(facts):
    v = [t[KEY] for t in facts["timings"] if KEY in t]
    return sum(v) / len(v) if v else None
