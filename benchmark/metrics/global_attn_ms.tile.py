"""Device ms of a tile's attention (qkv through proj of every ViT block,
CellViT's `Block.attend` under Cellpose-SAM's 24 global blocks), mean over
the window's tiles: the CUDA-event part `global_attn` of the tile
pipeline's forward, summed over its sub-batches, in
`TileInferManager.timings[i]`."""

KEY = "global_attn"


def read(facts):
    v = [t[KEY] for t in facts["timings"] if KEY in t]
    return sum(v) / len(v) if v else None
