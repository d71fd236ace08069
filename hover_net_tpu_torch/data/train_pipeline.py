"""Host training-data pipeline: .npy patches -> augmented device batches.

Counterpart of hover_net_tpu/data/train_pipeline.py. `PatchDataset` and
`TrainLoader` are its copies (same names, same behaviour, same seeding:
`base_seed + pid * 7919` in each worker, the plain seed with
`num_workers=0`, so that at `num_workers=0` the batches equal the JAX
loader's bit for bit), except that the worker pool is started with the
`forkserver` method: the trainer forks it after CUDA and OpenCV have
started threads, which `fork` does not survive safely. The server is a
fresh interpreter that imports this module once; each pool's workers are
forks of it, so the second and later pools (validation, the next phase)
do not pay the interpreter's start and those imports again.
`PrefetchLoader` replaces
the JAX package's `jax.device_put` double buffer with pinned host
batches copied `non_blocking` on a side CUDA stream, the compute stream
waiting on an event per batch.

In data-parallel training each rank has a `TrainLoader(rank=r,
world_size=W)`: every rank walks the same seeded order in global batches
of `batch_size` and loads only its consecutive shard of each (the shard
that the JAX package's `shard_batch` gives device r), and its
`PrefetchLoader` puts the shard on the rank's device.

Patch files are [H, W, 3+1(+1)] stacks: RGB, instance map(, type map) —
the format produced by cli/extract_patches.py (same as the reference's
extract_patches.py output).
"""

from __future__ import annotations

import collections
import glob
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..ops.targets import gen_targets
from ..utils.crops import cropping_center
from .augs import TrainAugmentor

_WORKER_STATE: dict = {}


def _worker_init(input_shape, mask_shape, mode, with_type, base_seed):
    pid_seed = (base_seed + os.getpid() * 7919) % (2**31)
    _WORKER_STATE["aug"] = TrainAugmentor(input_shape, mode=mode, seed=pid_seed)
    _WORKER_STATE["mask_shape"] = tuple(mask_shape)
    _WORKER_STATE["with_type"] = with_type


def _load_one(path: str) -> Dict[str, np.ndarray]:
    aug: TrainAugmentor = _WORKER_STATE["aug"]
    mask_shape = _WORKER_STATE["mask_shape"]
    with_type = _WORKER_STATE["with_type"]

    data = np.load(path)
    img = data[..., :3].astype(np.uint8)
    ann = data[..., 3:].astype(np.int32)

    img, ann = aug(img, ann)
    inst_map = ann[..., 0]
    # compact dtypes through worker IPC and host->device: uint8 img /
    # binary np_map are 4x smaller than float32/int32; the train step
    # casts on the device
    sample = {"img": img}
    if with_type:
        sample["tp_map"] = cropping_center(
            ann[..., 1].copy(), mask_shape
        ).astype(np.int32)
    target = gen_targets(inst_map, mask_shape)
    sample["np_map"] = target["np_map"].astype(np.uint8)
    sample["hv_map"] = target["hv_map"].astype(np.float32)
    return sample


class PatchDataset:
    """Lists .npy patches from one or more directories (sorted order,
    like run_train.py:102-114)."""

    def __init__(self, dir_list: Sequence[str]):
        files: List[str] = []
        for d in dir_list:
            files.extend(glob.glob(f"{d}/*.npy"))
        files.sort()
        assert files, f"no .npy patches under {list(dir_list)}"
        self.files = files

    def __len__(self):
        return len(self.files)


class TrainLoader:
    """Epoch iterator yielding stacked host batches: the global batches of
    `batch_size`, or with `world_size` > 1 rank `rank`'s consecutive
    shard of each."""

    def __init__(self, dataset: PatchDataset, batch_size: int,
                 input_shape, mask_shape, mode: str = "train",
                 with_type: bool = False, num_workers: int = 8,
                 seed: int = 10, drop_last: Optional[bool] = None,
                 rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.mode = mode
        self.with_type = with_type
        self.num_workers = 0 if num_workers is None else num_workers
        self.seed = seed
        self.epoch = 0
        self.drop_last = (mode == "train") if drop_last is None else drop_last
        self._init_args = (tuple(input_shape), tuple(mask_shape), mode,
                           with_type)
        self._pool = None
        if self.num_workers > 0:
            ctx = multiprocessing.get_context("forkserver")
            # read when the server starts, once per process
            ctx.set_forkserver_preload([__name__])
            self._pool = ProcessPoolExecutor(
                self.num_workers, initializer=_worker_init,
                initargs=self._init_args + (seed,), mp_context=ctx,
            )
        else:
            _worker_init(*self._init_args, seed)

    def steps_per_epoch(self) -> int:
        """Global batches per epoch (each rank takes a step on each)."""
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        order = np.arange(len(self.dataset))
        if self.mode == "train":
            rng.shuffle(order)
        files = [self.dataset.files[i] for i in order]
        self.epoch += 1

        # this rank's files of each global batch, and whether that batch
        # is full; one rank takes every file
        mine: List[str] = []
        shards = []
        for start in range(0, len(files), self.batch_size):
            chunk = files[start:start + self.batch_size]
            per = -(-len(chunk) // self.world_size)
            part = chunk[self.rank * per:(self.rank + 1) * per]
            mine += part
            shards.append((len(part), len(chunk) == self.batch_size))

        if self._pool is not None:
            sample_iter = self._pool.map(_load_one, mine, chunksize=4)
        else:
            sample_iter = map(_load_one, mine)

        for size, full in shards:
            batch = [next(sample_iter) for _ in range(size)]
            if batch and (full or not self.drop_last):
                yield self._stack(batch)

    @staticmethod
    def _stack(batch):
        return {k: np.stack([s[k] for s in batch]) for k in batch[0]}

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()


class PrefetchLoader:
    """Iterable wrapper: batches come out as tensors on `device`, with
    `buffer` batches in flight, so that the host work and the host->device
    copy of batch k+1 overlap the device compute of batch k.

    `wait_s` holds, per batch handed out (all epochs), the seconds the
    consumer waited for it (the host loader's share of a train step)."""

    def __init__(self, loader: TrainLoader, device="cuda", buffer: int = 2):
        self.loader = loader
        self.device = device
        self.buffer = buffer
        self.wait_s: List[float] = []

    def __iter__(self):
        return device_prefetch(iter(self.loader), self.device, self.buffer,
                               self.wait_s)

    def __len__(self):
        return self.loader.steps_per_epoch()

    def steps_per_epoch(self):
        return self.loader.steps_per_epoch()

    def close(self):
        self.loader.close()


def device_prefetch(host_iter, device="cuda", buffer: int = 2,
                    wait_s: Optional[list] = None):
    """Double-buffered host->device pipeline. On a CUDA device each batch
    is pinned, copied `non_blocking` on a side stream, and the compute
    stream waits on the copy's event before the batch is handed out; on
    the CPU the batch is wrapped as tensors. Appends each hand-out's
    wait (seconds) to `wait_s`."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def put(b):
        host = {k: torch.from_numpy(v) for k, v in b.items()}
        if not cuda:
            return host, None
        host = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    queue = collections.deque()
    it = iter(host_iter)
    t0 = time.perf_counter()
    try:
        for _ in range(buffer):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out, done = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        if cuda:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            # the batch was allocated on the copy stream: keep its memory
            # from reuse until the compute stream is done with it
            for v in out.values():
                v.record_stream(compute)
        if wait_s is not None:
            wait_s.append(time.perf_counter() - t0)
        yield out
        t0 = time.perf_counter()
