"""mpc_iris_tpu_torch — the plaintext match, threshold-audit, MPC
participant, sharded and serving paths of ``mpc_iris_tpu`` on PyTorch and
CUDA (NVIDIA Hopper, sm_90a).

The JAX package ``mpc_iris_tpu`` is the reference; this package mirrors its
layout and names so each function has an obvious counterpart:

- ``ops``       encode, rotations, exact fraction selection, int8 and share
                dots, the fraction spectrum scans, the exact threshold
                compare, ChaCha20 share regeneration, and the four
                hand-written CUDA kernels: ``ops.select.select_chunk``
                (counterpart of ``ops/select_pallas.py``),
                ``ops.packed_match.match_packed_small_b``,
                ``ops.packed_match.fractions_packed_small_b`` and
                ``ops.chacha.share_planes_kernel``; ``ops._build`` compiles
                ``csrc/*.cu`` with nvcc and loads them via ctypes
- ``models``    ``PlaintextEngine`` over a packed or dense template DB
                (``match``, ``distances``, ``min_fractions``,
                ``find_under``); the MPC engines ``ShareEngine``,
                ``KeyedShareEngine`` and ``MasksEngine``
- ``protocol``  the MPC serving roles over TCP: ``ParticipantServer``,
                ``Coordinator`` (rounds uploaded from pinned memory and
                decoded on its device), ``QueryServer`` and its clients,
                the reference, batched and chain wires, TLS and key
                agreement; ``party_proc`` runs participants in processes
                of their own
- ``parallel``  the sharded engines over a mesh of devices (a device may
                hold several shards), the exact cross-shard winner fold,
                and a party of several processes (``torch.distributed``)

It imports ``torch`` and nothing of ``jax`` or of the JAX package: what it
needs of the JAX package's JAX-free modules is copied (``constants``,
``types``, and ``protocol``'s ``wire``, ``pump``, ``drain``, ``keyagree``,
``tlsutil`` and ``participant``).
"""

from mpc_iris_tpu_torch.constants import (
    BITS,
    BITS_BYTES,
    COLS,
    MAX_ROTATION,
    N_ROTATIONS,
    ROTATIONS,
    ROWS,
)
from mpc_iris_tpu_torch.types import Bits, EncodedBits, Template

__version__ = "0.1.0"

__all__ = [
    "BITS",
    "BITS_BYTES",
    "COLS",
    "MAX_ROTATION",
    "N_ROTATIONS",
    "ROTATIONS",
    "ROWS",
    "Bits",
    "EncodedBits",
    "Template",
    "__version__",
]
