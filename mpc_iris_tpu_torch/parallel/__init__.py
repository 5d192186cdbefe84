"""Sharding and multi-process execution (counterpart of
``mpc_iris_tpu/parallel``).

- the DB-entry axis shards across devices over the ``"db"`` axis of a
  ``mesh.Mesh`` (each device scans its own resident shard; a device may
  hold several shards);
- query batches shard across ``"batch"`` (data parallel);
- the global match winner is combined with an exact integer-fraction
  minimum over the shards (all-gather of per-shard winner triples);
- a party of several processes is one ``torch.distributed`` process group
  (``multihost``); party parallelism stays *outside* it: each MPC party is
  its own group, and parties exchange u16 share tensors over host networking.
"""

from mpc_iris_tpu_torch.parallel import multihost
from mpc_iris_tpu_torch.parallel.collectives import fraction_allmin
from mpc_iris_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from mpc_iris_tpu_torch.parallel.sharded import (
    ShardedKeyedShareEngine,
    ShardedMasksEngine,
    ShardedPlaintextEngine,
    ShardedShareEngine,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "ShardedPlaintextEngine",
    "ShardedKeyedShareEngine",
    "ShardedShareEngine",
    "ShardedMasksEngine",
    "fraction_allmin",
    "multihost",
]
