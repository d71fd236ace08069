"""One process per device, and the collectives of data-parallel training.

Counterpart of the collective part of hover_net_tpu/parallel/mesh.py.
The JAX package trains across devices from one controller: XLA runs the
whole step over the global batch, averages the gradients and takes
BatchNorm's moments over the global batch. A BatchNorm with global
moments needs every replica's partial sums in the middle of each forward
and backward, so here each device gets a process of its own
(`run_ranks`), and the step calls the collectives below at those points.

The backend follows from the device list (`backend_for`): NCCL when every
rank has a CUDA device of its own; gloo on the CPU, and when a CUDA device
repeats, since NCCL refuses two ranks on one GPU. Only `all_reduce`,
`broadcast` and `barrier` are used, the collectives gloo offers on CUDA
tensors, so one code runs on NCCL, on gloo with CUDA tensors and on gloo
with CPU tensors. There is no fallback from one backend to the other.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import canonical_device

logger = logging.getLogger("hover_net_tpu_torch")

# seconds a collective may wait for the other ranks (rank 0's validation
# epoch runs while the others wait at a barrier)
COLLECTIVE_TIMEOUT_S = 3600.0
# seconds a rank may take to exit once it has sent its result
EXIT_GRACE_S = 60.0


@dataclasses.dataclass
class Rank:
    """What a rank's function knows of its run: its index, the number of
    ranks, its device and the process group; `marks` is the rank's
    timeline, which `run_ranks` logs (`mark`)."""

    rank: int
    world_size: int
    device: torch.device
    group: Any
    marks: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        """Note the wall-clock time of `what` on the rank's timeline
        (the first mark of a name counts)."""
        if all(name != what for name, _ in self.marks):
            self.marks.append((what, time.time()))


def backend_for(devices: Sequence) -> str:
    """'nccl' when every device is a distinct CUDA device, else 'gloo'
    (the CPU, or a CUDA device that serves several ranks)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient is summed over the ranks too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: every rank's
    gradient of the result reaches every rank's `x`."""
    return _AllReduceSum.apply(x, group)


def _flat_buckets(tensors: Sequence[torch.Tensor]):
    """[(flat tensor, members)] with one flat copy per dtype, in first-seen
    order."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [(torch.cat([t.reshape(-1) for t in ts]), ts)
            for ts in by_dtype.values()]


def _unflatten(flat: torch.Tensor, members: Sequence[torch.Tensor]):
    offset = 0
    for t in members:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its sum over the ranks, in one all_reduce
    per dtype."""
    for flat, members in _flat_buckets(tensors):
        dist.all_reduce(flat, group=group)
        _unflatten(flat, members)


def average_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the ranks."""
    sum_(tensors, group)
    world = dist.get_world_size(group)
    for t in tensors:
        t.div_(world)


def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Give every rank rank `src`'s values of `tensors`, in place."""
    with torch.no_grad():
        for flat, members in _flat_buckets(tensors):
            dist.broadcast(flat, src=src, group=group)
            _unflatten(flat, members)


def replicas_equal(tensors: Sequence[torch.Tensor], group) -> bool:
    """True on every rank when every rank's `tensors` equal rank 0's bit
    for bit, else False on every rank."""
    with torch.no_grad():
        off = 0.0
        for flat, _ in _flat_buckets(tensors):
            ref = flat.clone()
            dist.broadcast(ref, src=0, group=group)
            off += float(not torch.equal(
                ref.view(torch.uint8), flat.view(torch.uint8)))
        flag = torch.tensor([off], dtype=torch.float64,
                            device=tensors[0].device)
        dist.all_reduce(flag, group=group)
    return float(flag) == 0.0


def barrier(group) -> None:
    dist.barrier(group=group)


def module_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    """Every parameter and buffer of `module` (the state a replica holds)."""
    return [t.data for t in module.parameters()] + list(module.buffers())


# ------------------------------------------------------------ processes

def _result_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"result_{rank}.pt")


def _rank_main(fn, rank, devices, backend, init_method, tmp, results):
    """A rank's process: bind the device, join the group, run `fn` on the
    arguments saved in `tmp`, save its result there with torch.save and
    send back ("ok", its timeline), or send ("error", the traceback)."""
    marks = [("up", time.time())]
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        torch.set_num_threads(1)
        device = devices[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.init()
        marks.append(("device bound", time.time()))
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=len(devices),
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw)
        ctx = Rank(rank, len(devices), device, dist.group.WORLD, marks)
        ctx.mark("group joined")
        torch.save(fn(ctx, *args), _result_path(tmp, rank))
        ctx.mark("returned")
        results.put((rank, "ok", marks))
    except BaseException:
        # the parent reads this, kills every rank and raises
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        # a training loader's pool started multiprocessing's forkserver in
        # this rank: end it and wait for it, so that no helper outlives
        # the rank
        from multiprocessing import forkserver

        forkserver._forkserver._stop()


def _next_message(results, procs, done, deadline):
    """The next (rank, status, payload) from the ranks, or a string that
    says why none will come: a rank ended without sending its result, or
    the deadline passed."""
    while True:
        try:
            return results.get(timeout=0.2)
        except queue.Empty:
            pass
        dead = [r for r, p in enumerate(procs)
                if r not in done and p.exitcode is not None]
        if dead:
            try:  # a rank that exited has flushed its message, if any
                return results.get(timeout=2.0)
            except queue.Empty:
                return (f"rank {dead[0]} ended with exit code "
                        f"{procs[dead[0]].exitcode} and no result")
        if time.monotonic() > deadline:
            return (f"timed out ({len(done)} of {len(procs)} ranks "
                    "done)")


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def run_ranks(fn: Callable, devices: Sequence, args=(),
              timeout_s: Optional[float] = None) -> List[Any]:
    """Run `fn(Rank, *args)` in one process per entry of `devices`
    (started with `spawn`; a device may repeat) and return each rank's
    result, in rank order.

    `fn` must be a module-level function of this package (a rank imports
    the module that defines it). `args` reach the ranks in a file written
    with torch.save (in a process's start arguments they would hold each
    start until the rank before had imported `fn`'s module), and each
    result comes back the same way (through the queue, a result of a few
    hundred MB, such as a trainer's RunInfo with its model and optimizer,
    took 10-18 s to pass on an H100 host: PERF.md §6). Each rank's
    timeline is
    logged, in seconds from the start: its process up (the interpreter,
    torch and `fn`'s module imported), its device bound, the group joined,
    what `fn` marked (`Rank.mark`, e.g. its first step) and `fn` returned;
    then the ranks' exit.
    When a rank raises or ends without a result, or `timeout_s` (None: no
    limit) passes, or a rank has not exited `EXIT_GRACE_S` after every
    result came, every rank is killed and a RuntimeError names the first
    failed rank with its traceback: no rank is left waiting in a
    collective."""
    devices = [canonical_device(d) for d in devices]
    backend = backend_for(devices)
    logger.info("run_ranks: %d ranks on %s, backend %s", len(devices),
                [str(d) for d in devices], backend)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="hnt_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                             args=(fn, r, devices, backend, init_method,
                                   tmp, results))
                 for r in range(len(devices))]
        t_start = time.time()
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        marks: Dict[int, List[Tuple[str, float]]] = {}
        failure = None
        deadline = (math.inf if timeout_s is None
                    else time.monotonic() + timeout_s)
        try:
            while len(out) < len(procs) and failure is None:
                msg = _next_message(results, procs, out, deadline)
                if isinstance(msg, str):
                    failure = msg
                elif msg[1] == "ok":
                    out[msg[0]] = torch.load(_result_path(tmp, msg[0]),
                                             weights_only=False)
                    marks[msg[0]] = msg[2]
                else:
                    failure = (f"rank {msg[0]} ({devices[msg[0]]}) "
                               f"failed:\n{msg[2]}")
            for p in procs if failure is None else ():
                p.join(max(1.0, min(EXIT_GRACE_S,
                                    deadline - time.monotonic())))
                if p.exitcode is None:
                    failure = f"{p.name} did not exit after its result"
            t_exit = time.time()
            for r in sorted(marks):
                logger.info("run_ranks: rank %d (%s), s from the start: %s; "
                            "all exited %.1f", r, devices[r], ", ".join(
                                f"{what} {t - t_start:.1f}"
                                for what, t in marks[r]), t_exit - t_start)
        finally:
            _stop(procs)
            results.close()
    if failure is not None:
        raise RuntimeError(f"run_ranks ({len(devices)} ranks, {backend}): "
                           f"{failure}")
    return [out[r] for r in range(len(procs))]
