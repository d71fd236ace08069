"""Device ms of a tile's three decoders and their heads, summed over its
forward sub-batches, mean over the window's tiles: the tile pipeline's
CUDA-event part `decoders` (`TileInferManager.timings`)."""

KEY = "decoders"


def read(facts):
    v = [t[KEY] for t in facts["timings"] if KEY in t]
    return sum(v) / len(v) if v else None
