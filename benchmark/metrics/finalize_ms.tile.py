"""Host finalize of a tile (tables -> nuclei -> json written), mean ms over
the window's tiles: `TileInferManager.timings[i]["finalize_ms"]`."""


def read(facts):
    v = [t["finalize_ms"] for t in facts["timings"] if "finalize_ms" in t]
    return sum(v) / len(v) if v else None
