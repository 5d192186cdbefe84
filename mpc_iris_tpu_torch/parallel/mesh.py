"""Device mesh for the match workload (counterpart of
``mpc_iris_tpu/parallel/mesh.py``).

Axes:
- ``"db"``: shards the template-database entry axis (the big axis, millions
  of entries).
- ``"batch"``: shards the query batch (data parallel).

The K = 12,800 contraction always stays within one device, so the
collectives only carry per-query winner triples, spectra and reply blocks,
never share planes.

A :class:`Mesh` is a numpy object grid ``[db, batch]`` of ``torch.device``
beside a grid of the rank (process) that owns each entry. A device may
appear more than once: ``[cuda:0] * 4`` is four shards on one card, run one
after another, the counterpart of the JAX tests' virtual CPU devices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def mesh_shape_for(n_devices: int, batch_size: int | None = None) -> tuple[int, int]:
    """Pick (db, batch) axis sizes for ``n_devices`` (copy of
    ``mpc_iris_tpu.parallel.mesh.mesh_shape_for``).

    The DB axis gets all devices unless the query batch is large enough to
    warrant splitting; batch axis sizes must divide the batch.
    """
    if batch_size is None or batch_size <= 1 or n_devices <= 1:
        return n_devices, 1
    batch_axis = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and batch_size % cand == 0 and n_devices >= 2 * cand:
            batch_axis = cand
            break
    return n_devices // batch_axis, batch_axis


def _party() -> tuple[int, int]:
    """(this process's rank, process count) of the party's process group;
    (0, 1) when no group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A [db, batch] grid of devices with the rank that owns each.

    ``devices``: object array [db, batch] of ``torch.device``; ``ranks``: int
    array of the same shape; ``process_index``: this process's rank (the
    party's rank by default)."""

    axis_names = ("db", "batch")

    def __init__(self, devices: np.ndarray, ranks: np.ndarray,
                 process_index: int | None = None):
        if devices.ndim != 2 or ranks.shape != devices.shape:
            raise ValueError("mesh devices and ranks must be equal [db, batch] grids")
        types = {d.type for d in devices.flat}
        if len(types) != 1:
            raise ValueError(f"mesh mixes device types {sorted(types)}")
        self.device_type = types.pop()
        if self.device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("mesh: CUDA devices but no CUDA card is available")
        self.devices = devices
        self.ranks = ranks
        rank, self.process_count = _party()
        self.process_index = rank if process_index is None else process_index

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _device(d) -> torch.device:
    """A device with its index: "cuda" is the current card (as a tensor's
    ``.device`` names it), and raises without a card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("mesh: CUDA devices but no CUDA card is available")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _default_devices() -> list[tuple[int, torch.device]]:
    """Every CUDA device of every rank, as (rank, device) pairs in rank
    order: each rank contributes the cards it sees (give ranks on one host
    their own cards with CUDA_VISIBLE_DEVICES). Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA card is available; pass "
                           "devices=[torch.device('cpu')] * k for a CPU mesh")
    local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    rank, count = _party()
    if count == 1:
        return [(0, d) for d in local]
    per_rank = [None] * count
    dist.all_gather_object(per_rank, [str(d) for d in local])
    return [(r, torch.device(d)) for r, devs in enumerate(per_rank) for d in devs]


def make_mesh(db: int | None = None, batch: int = 1, devices=None) -> Mesh:
    """Build a [db, batch] mesh over the given (or all) devices.

    ``devices``: a list of ``torch.device`` (owned by this process), or of
    ``(rank, torch.device)`` pairs (a party of several processes); by default
    every CUDA device of every rank. Devices may repeat. As in the reference,
    a list longer than ``db * batch`` is cut to its first ``db * batch``.
    """
    if devices is None:
        pairs = _default_devices()
    else:
        rank = _party()[0]
        pairs = [(int(x[0]), _device(x[1])) if isinstance(x, tuple)
                 else (rank, _device(x)) for x in devices]
    if db is None:
        db = len(pairs) // batch
    if db * batch != len(pairs):
        pairs = pairs[: db * batch]
    if db < 1 or len(pairs) != db * batch:
        raise ValueError(f"make_mesh: {len(pairs)} devices cannot form a "
                         f"[{db}, {batch}] mesh")
    grid = np.empty(len(pairs), dtype=object)
    grid[:] = [d for _, d in pairs]
    ranks = np.array([r for r, _ in pairs], dtype=np.int64)
    return Mesh(grid.reshape(db, batch), ranks.reshape(db, batch))
