"""Device mesh and its collectives for inference, in one process.

Counterpart of hover_net_tpu/parallel/mesh.py. The JAX package drives
every chip from one controller: a 1-D 'data' mesh over a list of
devices, batches sharded on their leading axis, and the two collectives
of the striped WSI path (`all_gather` and `psum_scatter`, tiled) inside
`shard_map`. The port keeps that shape: a `Mesh` is an ordered tuple of
stripe slots, each bound to a `torch.device`, and the collectives are
plain functions over one tensor per slot, made of explicit copies and
adds. There is no `torch.distributed` here.

A device may fill several slots (`make_mesh(devices=["cpu"] * 4)`), as
XLA's virtual host devices let the JAX tests run an 8-device mesh on one
CPU: slots index stripes, stripe offsets and batch shards, devices index
model replicas and pushed copies. Shards and results of slots that share
a device are separate tensors, but a copy to a device is made once per
device where the data is the same for every slot (`replicate`,
`all_gather`).

Copies between two CUDA devices go through PyTorch's device-to-device
copy, which orders the copy after the work queued on both devices'
current streams and makes the destination's stream wait for it; every
kernel of the port runs on its device's current stream, so no further
event is needed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


class Mesh(tuple):
    """An ordered tuple of `torch.device` stripe slots."""

    @property
    def devices(self) -> List[torch.device]:
        """The distinct devices of the slots, in slot order."""
        return list(dict.fromkeys(self))


def canonical_device(device) -> torch.device:
    """`torch.device` for `device`, a bare "cuda" pinned to the current
    CUDA device (so that equal devices compare and hash equal)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a GPU raises
    (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available (pass --device cpu to run on the CPU)")
    return dev


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first `n_devices` slots of `devices` (all of them when
    `n_devices` is None); by default the CUDA devices cuda:0..n-1. Raises
    when there are fewer devices than `n_devices`. `devices` may repeat a
    device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


def shard_bounds(total: int, mesh: Mesh, size: Optional[int] = None):
    """[(lo, hi)] of each slot's consecutive shard of a leading axis of
    `total`: `size` rows a slot (default: total split evenly, rounded
    up); the last shards are short or empty when `total` is less than
    `size` times the slots."""
    if size is None:
        size = -(-total // len(mesh))
    return [(min(d * size, total), min((d + 1) * size, total))
            for d in range(len(mesh))]


def shard_batch(mesh: Mesh, batch: torch.Tensor,
                size: Optional[int] = None) -> List[torch.Tensor]:
    """Split the leading axis of `batch` into consecutive per-slot shards
    (`shard_bounds`), each on its slot's device (the counterpart of a
    `device_put` with `batch_sharding`)."""
    return [batch[lo:hi].to(dev, non_blocking=True)
            for (lo, hi), dev in zip(shard_bounds(batch.shape[0], mesh, size),
                                     mesh)]


def replicate(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """`t` on every slot's device, copied once per device (the counterpart
    of a `device_put` with the `replicated` sharding)."""
    on: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        on[dev] = t.to(dev, non_blocking=True)
    return [on[dev] for dev in mesh]


def all_gather(shards: Sequence[torch.Tensor],
               mesh: Mesh) -> List[torch.Tensor]:
    """`jax.lax.all_gather(x, axis=0, tiled=True)`: every slot gets the
    concatenation of all slots' shards, in slot order, on its device."""
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards for {len(mesh)} slots")
    on: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        on[dev] = torch.cat([s.to(dev, non_blocking=True) for s in shards])
    return [on[dev] for dev in mesh]


def psum_scatter(parts: Sequence[torch.Tensor], mesh: Mesh,
                 size: Optional[int] = None) -> List[torch.Tensor]:
    """`jax.lax.psum_scatter(x, scatter_dimension=0, tiled=True)`: slot d
    gets the sum over the slots s of `parts[s]`'s d-th consecutive shard
    (`shard_bounds` with `size`), on its own device, added in slot
    order."""
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} parts for {len(mesh)} slots")
    out = []
    for (lo, hi), dev in zip(shard_bounds(parts[0].shape[0], mesh, size),
                             mesh):
        acc = parts[0][lo:hi].to(dev, non_blocking=True)
        for p in parts[1:]:
            acc = acc + p[lo:hi].to(dev, non_blocking=True)
        out.append(acc)
    return out
