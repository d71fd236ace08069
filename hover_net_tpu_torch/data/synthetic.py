"""bench.py's synthetic nuclei tile, and the batch stream of the recipe
checkpoint that cli/recipe.py trains (`recipe_batches`).

A module without torch, so that the worker processes of
`pooled_recipe_batches` start in a moment: they draw the recipe's tiles
in parallel, while the training step runs, and the stream they give is
`recipe_batches`' array for array.
"""

from __future__ import annotations

import collections
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from ..ops.targets import gen_targets
from ..utils.crops import cropping_center

# the recipe's tiles: 256^2 synthetic H&E of 70 nuclei, targets at 164^2
RECIPE_SIZE, RECIPE_OUT, RECIPE_NUCLEI = 256, 164, 70


def synth_nuclei_image(h, w, seed=1, n_nuclei=1200):
    """H&E-ish synthetic tile: dark-purple disks on a light background."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 225, np.float32)
    img += rng.normal(0, 4, img.shape)
    inst = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[-12:13, -12:13]
    k = 1
    for _ in range(n_nuclei):
        cy, cx = int(rng.integers(14, h - 14)), int(rng.integers(14, w - 14))
        r = int(rng.integers(5, 11))
        m = (yy**2 + xx**2) <= r * r
        sub = inst[cy - 12: cy + 13, cx - 12: cx + 13]
        sub[m & (sub == 0)] = k
        k += 1
        col = np.array([120, 70, 150]) + rng.normal(0, 10, 3)
        img[cy - 12: cy + 13, cx - 12: cx + 13][m] = col
    return np.clip(img, 0, 255).astype(np.uint8), inst


def recipe_tile(seed: int):
    """One tile of the recipe from its seed: (image uint8, np_map,
    hv_map, instance map)."""
    img, inst = synth_nuclei_image(RECIPE_SIZE, RECIPE_SIZE, seed=seed,
                                   n_nuclei=RECIPE_NUCLEI)
    t = gen_targets(inst, (RECIPE_OUT, RECIPE_OUT))
    return (img, t["np_map"].astype(np.int32), t["hv_map"].astype(np.float32),
            inst)


def _type_map(inst, types) -> np.ndarray:
    return cropping_center(np.where(inst > 0, types[inst], 0),
                           (RECIPE_OUT, RECIPE_OUT)).astype(np.int32)


def _stack(tiles, nr_types) -> Dict[str, np.ndarray]:
    """tiles: [(img, np_map, hv_map, tp_map or None)] -> a batch."""
    out = {"img": np.stack([t[0].astype(np.float32) for t in tiles]),
           "np_map": np.stack([t[1] for t in tiles]),
           "hv_map": np.stack([t[2] for t in tiles])}
    if nr_types is not None:
        out["tp_map"] = np.stack([t[3] for t in tiles])
    return out


def recipe_batches(rng, batch: int, nr_types: Optional[int] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless training batches of the checkpoint recipe, drawn from `rng`
    as bench.py:86-101 draws them: `batch` synthetic 256^2 tiles of 70
    nuclei, each seeded from `rng`, with their np and hv targets at 164^2.
    With `nr_types`, each instance's type is drawn from `rng` in
    1..nr_types-1 after its tile, and `tp_map` is added."""
    while True:
        tiles = []
        for _ in range(batch):
            img, np_map, hv_map, inst = recipe_tile(
                int(rng.integers(1 << 30)))
            tp = None
            if nr_types is not None:
                tp = _type_map(inst, rng.integers(1, nr_types,
                                                  int(inst.max()) + 1))
            tiles.append((img, np_map, hv_map, tp))
        yield _stack(tiles, nr_types)


def _rng_at(state: dict):
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng


def recipe_batch(seeds, types, nr_types):
    """A worker's batch of the recipe: the tiles of `seeds`, with types
    each tile's drawn types (drawn on a guess of how many the tile
    draws: its largest label + 1). Returns (the batch, or None where a
    tile's largest label proves its guess wrong; the host seconds)."""
    t0 = time.perf_counter()
    tiles = []
    for i, tile_seed in enumerate(seeds):
        img, np_map, hv_map, inst = recipe_tile(tile_seed)
        tp = None
        if nr_types is not None:
            if int(inst.max()) + 1 != len(types[i]):
                return None, time.perf_counter() - t0
            tp = _type_map(inst, types[i])
        tiles.append((img, np_map, hv_map, tp))
    return _stack(tiles, nr_types), time.perf_counter() - t0


def pooled_recipe_batches(seed: int, batch: int, n_batches: int,
                          nr_types: Optional[int] = None, workers: int = 4,
                          ahead: int = 8, guess: int = RECIPE_NUCLEI + 1,
                          host_s: Optional[list] = None
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """The first `n_batches` of `recipe_batches(np.random.default_rng(
    seed), batch, nr_types)`, array for array, each batch drawn by one of
    `workers` processes (`recipe_batch`), up to `ahead` batches in
    flight.

    The seeds come from one rng, in order. With types, that rng draws
    each tile's types right after its seed, as many as the tile's largest
    label + 1: RECIPE_NUCLEI + 1 unless the last nucleus lies wholly
    under earlier ones. The draws ahead take `guess` types a tile; a
    batch whose worker finds a guess wrong is drawn again here, as
    `recipe_batches` draws it, from the rng's state at its start, the
    batches in flight after it are dropped, and the draws go on from the
    rng's true state. `host_s`, a list, receives each worker batch's
    seconds."""
    rng = np.random.default_rng(seed)
    ctx = multiprocessing.get_context("forkserver")
    # read when the server starts, once per process
    ctx.set_forkserver_preload([__name__])
    inflight = collections.deque()  # (rng state at the batch, future)
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        def submit():
            start = rng.bit_generator.state
            seeds, types = [], []
            for _ in range(batch):
                seeds.append(int(rng.integers(1 << 30)))
                if nr_types is not None:
                    types.append(rng.integers(1, nr_types, guess))
            inflight.append((start, pool.submit(recipe_batch, seeds, types,
                                                nr_types)))

        for i in range(n_batches):
            while len(inflight) < min(ahead, n_batches - i):
                submit()
            start, fut = inflight.popleft()
            out, secs = fut.result()
            if host_s is not None:
                host_s.append(secs)
            if out is None:
                for _, f in inflight:
                    f.cancel()
                inflight.clear()
                rng = _rng_at(start)
                out = next(recipe_batches(rng, batch, nr_types))
            yield out
