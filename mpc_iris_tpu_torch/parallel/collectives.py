"""Cross-device collectives for exact fraction minima (counterpart of
``mpc_iris_tpu/parallel/collectives.py``).

No built-in reduction carries the exact rational comparator, so the global
winner is combined by gathering each shard's winner triple (n, d, index),
12 bytes per query per shard, and folding them with the same exact
comparator used per chunk (``ops.select.fold_candidates``).

Within one process the triples of this process's shards are gathered onto
one device. Across the processes of a party, each rank folds its own shards
first and the ranks then exchange one folded triple each with
``torch.distributed.all_gather_into_tensor``. NCCL tensors stay on the card;
gloo is the CPU transport, so for it the tensors are copied to the host and
back explicitly (the backend is the caller's choice, made in
``multihost.init_party``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mpc_iris_tpu_torch.ops.select import fold_candidates


def all_gather_cat(t: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Concatenate every rank's ``t`` (equal shapes) along ``axis``, in rank
    order, over ``group``; the result on ``t``'s device. The bytes travel as
    uint8 (neither NCCL nor gloo carries int16, the reply blocks' type)."""
    x = t.movedim(axis, 0).contiguous()
    if dist.get_backend(group) == "gloo":
        x = x.cpu()
    raw = x.view(torch.uint8)
    out = raw.new_empty((dist.get_world_size(group) * raw.shape[0], *raw.shape[1:]))
    dist.all_gather_into_tensor(out, raw, group=group)
    return out.view(t.dtype).to(t.device).movedim(0, axis)


def fraction_allmin(n, d, idx, device, group=None):
    """Exact fraction minimum over shards.

    Args:
      n, d, idx: sequences of this process's per-shard int32 [...] winner
        triples (d == 0 means invalid, +inf), each on its shard's device.
      device: where the triples are gathered and the result lives (the
        first device of the queries' batch column).
      group: the party's process group when it has several processes, else
        None (no collective).

    Returns (n, d, idx) on ``device``: the global minimum fraction, ties
    keeping the smallest *global index*. Shard order is not index order
    under the strided-by-chunk layout, so the fold compares the carried
    indices, never the gather slots. The lexicographic (fraction, index)
    minimum is associative and commutative, so folding each rank's shards
    and then the ranks' results gives the same winner as one fold over all
    shards.
    """
    n, d, idx = fold_candidates(*(torch.stack([t.to(device) for t in ts])
                                  for ts in (n, d, idx)), axis=0)
    if group is None:
        return n, d, idx
    g = all_gather_cat(torch.stack([n, d, idx])[None], 0, group)
    return fold_candidates(g[:, 0], g[:, 1], g[:, 2], axis=0)
