"""Multi-process party topology (counterpart of
``mpc_iris_tpu/parallel/multihost.py``).

Two distinct distribution layers:

1. **Within one MPC party**: all of the party's processes form ONE
   ``torch.distributed`` process group and one :class:`~.mesh.Mesh`; the
   party's DB shard axis spans every card of the group, and winner and
   reply reductions ride the group's collectives (collectives.py).

2. **Between parties and the coordinator**: NEVER a shared process group;
   each party stays cryptographically isolated. Share and reply tensors
   travel over host networking (the protocol roles, TCP), staged through
   host memory.

Typical party bring-up over N processes, one card each:

    from mpc_iris_tpu_torch.parallel import multihost, make_mesh
    multihost.init_party("10.0.0.1:9999", num_processes=N, process_id=rank)
    mesh = make_mesh()                               # every rank's cards
    shares = np.memmap("mpc.share-0", dtype=np.uint16, shape=(N_DB, 12800))
    engine = ShardedShareEngine(shares, mesh)        # GLOBAL-indexed source

The engines take the GLOBAL share or masks source (a shared-filesystem
memmap or any [N, ...]-indexable array) and each process reads ONLY its own
:func:`local_entry_spans`; other ranks' rows are never touched. A host that
must fetch rows from remote storage first writes them into a global-shaped
sparse local file at these offsets; the engines take no rank-compacted
arrays.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mpc_iris_tpu_torch.parallel.mesh import _party


def init_party(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join this party's process group (no-op for a single process).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous.
    ``backend``: None means NCCL, for ranks that each have their own card,
    and raises without a card; "gloo" only when the caller names it (gloo
    also serves ranks that share one card, which NCCL refuses).
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_party: backend None means NCCL, but no CUDA "
                               "card is available (name backend='gloo' for CPU ranks)")
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def party_info() -> dict:
    """This process's position within its party."""
    rank, count = _party()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    total = local
    if count > 1:
        per_rank = [None] * count
        dist.all_gather_object(per_rank, local)
        total = sum(per_rank)
    return {"process_index": rank, "process_count": count,
            "local_devices": local, "global_devices": total}


def local_entry_spans(total_rows: int, chunk: int, mesh) -> list[tuple[int, int]]:
    """Contiguous [start, end) DB-row spans THIS process loads under the
    sharded engines' strided-by-chunk layout, one per global block; empty
    spans at the DB tail are omitted.

    ``chunk`` is clamped exactly as the engines clamp it
    (``sharded.effective_chunk``, on the mesh's device type), so the spans
    always describe the rows the engine reads: pass the value you pass the
    engine."""
    from mpc_iris_tpu_torch.parallel.sharded import effective_chunk, local_db_span

    lo, hi = local_db_span(mesh)
    d = mesh.shape["db"]
    chunk = effective_chunk(chunk, total_rows, d, mesh.device_type)
    spans = []
    for j in range(max(1, -(-total_rows // (chunk * d)))):
        start = (j * d + lo) * chunk
        end = min(total_rows, start + (hi - lo) * chunk)
        if end > start:
            spans.append((start, end))
    return spans
