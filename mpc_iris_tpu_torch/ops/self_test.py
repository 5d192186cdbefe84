"""Runtime canary of the plaintext match and audit paths (counterpart of
``mpc_iris_tpu/ops/dot.py::kernel_self_test``, plaintext dots only, plus one
check per hand-written kernel)."""

from __future__ import annotations

import numpy as np
import torch

from mpc_iris_tpu.constants import BITS
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.packed_match import (
    check_fractions_packed_small_b,
    check_match_packed_small_b,
)
from mpc_iris_tpu_torch.ops.select import check_select_chunk

_self_tested: set[str] = set()


def kernel_self_test(device) -> None:
    """Runtime canary, once per process and device; raises on any mismatch.

    Checks the int8 product against a NumPy oracle, and on CUDA each
    hand-written kernel against its plain version on a small input with
    planted rotation and DB-index ties (the traps the exact tie rules guard).
    """
    device = torch.device(device)
    if str(device) in _self_tested:
        return
    rng = np.random.default_rng(0xC0DE)
    q = rng.integers(-1, 2, size=(32, BITS)).astype(np.int8)
    m = rng.integers(0, 2, size=(8, BITS)).astype(np.int8)
    got = dot_bits_batch(torch.from_numpy(q).to(device),
                         torch.from_numpy(m).to(device)).cpu().numpy()
    want = q.astype(np.int64) @ m.astype(np.int64).T
    if not np.array_equal(got, want):
        raise RuntimeError(
            f"int8 dot self-test FAILED on {device}: integer matmul semantics "
            "changed; results would be corrupt")
    if device.type == "cuda":
        check_select_chunk(device)
        check_match_packed_small_b(device)
        check_fractions_packed_small_b(device)
    _self_tested.add(str(device))
