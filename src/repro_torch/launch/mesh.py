"""Shard meshes: which device holds each row shard of the sharded tier.

The reference builds a ``jax.sharding.Mesh`` and runs one ``shard_map``
over it; that is a single controller issuing every shard's work, and so is
this port: one process launches each shard's kernel on the shard's device,
with no ``torch.distributed``. A :class:`ShardMesh` is the tuple of those
devices, shard ``s`` on ``mesh[s]``. One device may hold several shards
(four row shards on one card launch four kernels there), which is how the
tier runs on a single GPU and how the CPU tests run 1, 4 or 8 shards in one
process.

Defined as functions, never module-level constants, so that importing this
module touches no device.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

import torch

from ..device import resolve_device

DeviceLike = Union[str, torch.device]


class ShardMesh(tuple):
    """The devices of a row-sharded store, one entry per shard. Every entry
    is checked by :func:`~repro_torch.device.resolve_device`: a CUDA device
    on a machine without a card raises."""

    def __new__(cls, devices: Iterable[DeviceLike]) -> "ShardMesh":
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a shard mesh needs at least one shard")
        return super().__new__(cls, devs)


def make_mesh_for_devices(n_devices: Optional[int] = None,
                          device: Optional[DeviceLike] = None,
                          n_shards: Optional[int] = None) -> ShardMesh:
    """One shard per visible CUDA device by default (the first
    ``n_devices`` of them when given). ``n_shards`` places that many
    shards round-robin over those devices. ``device="cpu"`` puts every
    shard on the CPU; a device with an index (``"cuda:1"``) is the only
    device used."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)                 # raises without a card
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"n_devices={n_devices} outside [1, {count}]")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [dev]
    n_shards = len(devices) if n_shards is None else int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    return ShardMesh(devices[s % len(devices)] for s in range(n_shards))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[DeviceLike] = None) -> ShardMesh:
    """The serving mesh: one shard per visible card (the reference's
    16 x 16 pod, or 2 x 16 x 16 across pods, is a TPU layout).
    ``device="cpu"`` is one CPU shard. ``multi_pod=True`` raises: one host
    has no pod axis to span (the rule of ``cross_pod_int8=True`` in
    ``training/train_step.py``)."""
    if multi_pod:
        raise ValueError("multi_pod=True: one host has no pod axis; the "
                         "production mesh is the host's cards")
    return make_mesh_for_devices(device=device)


def mesh_device_count(mesh: ShardMesh) -> int:
    """Shards of the mesh (the reference's device count: one shard each)."""
    return len(mesh)
