"""Device ms of a tile's forward (patch gather, the model, the stitch),
mean over the window's tiles: the tile pipeline's CUDA-event stage
`forward` (`run.stage_ms()`, in `TileInferManager.timings`)."""


def read(facts):
    v = [t["forward"] for t in facts["timings"] if "forward" in t]
    return sum(v) / len(v) if v else None
