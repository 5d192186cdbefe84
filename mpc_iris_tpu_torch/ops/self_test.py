"""Runtime canary of the port (counterpart of
``mpc_iris_tpu/ops/dot.py::kernel_self_test``): the int8 product, the share
dot at extreme shares, and one check per hand-written kernel."""

from __future__ import annotations

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS
from mpc_iris_tpu_torch.ops.chacha import check_share_planes
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch, dot_share_batch, shares_to_planes
from mpc_iris_tpu_torch.ops.packed_match import (
    check_fractions_packed_small_b,
    check_match_packed_small_b,
)
from mpc_iris_tpu_torch.ops.select import check_select_chunk
from mpc_iris_tpu_torch.utils.profiling import annotate

_self_tested: set[str] = set()


def kernel_self_test(device) -> None:
    """Runtime canary, once per process and device; raises on any mismatch.

    Checks the int8 product and the wrapping-u16 share dot (extreme shares
    0xFFFF and 0x8000) against NumPy oracles, and on CUDA each hand-written
    kernel against its plain version on a small input with its traps planted
    (rotation and DB-index ties; the keystream's u64 nonce carry).
    """
    device = torch.device(device)
    if str(device) in _self_tested:
        return
    with annotate("iris.setup.kernel_self_test"):
        _self_test(device)
    _self_tested.add(str(device))


def _self_test(device: torch.device) -> None:
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
    # 8 share rows: the card's int8 product needs N % 8 == 0 (and M > 16)
    s = rng.integers(0, 1 << 16, size=(8, BITS)).astype(np.uint16)
    s[0, :] = 0xFFFF
    s[1, :] = 0x8000
    s[2, :2] = [0, 0xFFFF]
    lo, hi = shares_to_planes(torch.from_numpy(s.view(np.int16)).to(device))
    got = dot_share_batch(torch.from_numpy(q).to(device), lo, hi).cpu().numpy()
    want = (q.astype(np.int64) @ s.astype(np.int64).T) & 0xFFFF
    if not np.array_equal(got, want):
        raise RuntimeError(
            f"share-dot self-test FAILED on {device}: {got.tolist()} != "
            f"{want.tolist()}; results would be corrupt")
    if device.type == "cuda":
        check_share_planes(device)
        check_select_chunk(device)
        check_match_packed_small_b(device)
        check_fractions_packed_small_b(device)
