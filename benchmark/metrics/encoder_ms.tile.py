"""Device ms of a tile's encoder (stem, d0..d3, `conv_bot`), summed over
its forward sub-batches, mean over the window's tiles: the tile
pipeline's CUDA-event part `encoder` (`TileInferManager.timings`)."""

KEY = "encoder"


def read(facts):
    v = [t[KEY] for t in facts["timings"] if KEY in t]
    return sum(v) / len(v) if v else None
