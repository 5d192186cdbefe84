"""The port's match_packed_small_b (mpc_iris_tpu_torch.ops.packed_match; its
plain version on the CPU) against the JAX kernel match_packed_small_b in
interpret mode and the JAX packed scan. Exact: integers equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.constants import BITS_BYTES
from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu.ops import packed_match as jpm
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import decode as tdec
from mpc_iris_tpu_torch.ops import packed_match as tpm


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _world(rng, n, chunk=512):
    pat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    msk[5] = 0  # all-invalid entry
    pat[700 % n], msk[700 % n] = pat[300 % n], msk[300 % n]  # duplicate pair
    return pat, msk


def _both(qpat, qmsk, pat, msk, chunk=512):
    """(port, JAX kernel, JAX scan) int32 [3, B] on the same inputs."""
    pat_c, _ = jeng._pad_chunks(pat, chunk)
    msk_c, _ = jeng._pad_chunks(msk, chunk)
    q_enc, q_mask = jeng.prepare_query_planes(qpat, qmsk)
    port = tpm.match_packed_small_b(
        *teng.prepare_query_planes(_t(qpat), _t(qmsk)), _t(pat_c), _t(msk_c))
    jk = jpm.match_packed_small_b(q_enc, q_mask, jnp.asarray(pat_c),
                                  jnp.asarray(msk_c), tile_n=512, interpret=True)
    js = jeng._match_scan_packed(q_enc, q_mask, jnp.asarray(pat_c),
                                 jnp.asarray(msk_c), fused=False)
    return port.numpy(), np.asarray(jk), np.asarray(js)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_matches_jax_kernel_and_scan(rng, b):
    """Padded tail (1000 -> 1024 rows), an all-invalid entry, a duplicate
    pair, and a planted self-match."""
    pat, msk = _world(rng, 1000)
    qpat = pat[rng.integers(0, 1000, b)].copy()
    qmsk = msk[rng.integers(0, 1000, b)].copy()
    qpat[0], qmsk[0] = pat[300], msk[300]
    port, jk, js = _both(qpat, qmsk, pat, msk)
    np.testing.assert_array_equal(port, jk)
    np.testing.assert_array_equal(port, js)
    assert port[2, 0] == 300 and port[0, 0] == 0  # lower index of the pair


def test_planted_traps(rng):
    """The kernel canary's case: sparse masks (rotation ties as different
    pairs), duplicates at rows 129/257, an all-invalid query."""
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng)
    port, jk, js = _both(qpat, qmsk, pat, msk)
    np.testing.assert_array_equal(port, jk)
    np.testing.assert_array_equal(port, js)
    assert port[2, 0] == 129
    assert port[1, 2] == 0 and port[2, 2] == 0


def _kernel_arithmetic(q_enc, q_mask, db_pat, db_msk):
    """The CUDA kernel's arithmetic, emulated with numpy popcounts over the
    query words it is given and the packed DB words: den = popc(qm & dm),
    num = popc((qp ^ dp) & qm & dm). Returns (num, den) int32 [B, 32, N]."""
    qp, qm = (x.numpy().view(np.uint32) for x in tpm._query_words(q_enc, q_mask))
    dp = db_pat.numpy().reshape(-1, BITS_BYTES).view(np.uint32)
    dm = db_msk.numpy().reshape(-1, BITS_BYTES).view(np.uint32)
    both = qm[:, :, None, :] & dm[None, None]
    den = np.bitwise_count(both).sum(-1, dtype=np.int32)
    num = np.bitwise_count((qp[:, :, None, :] ^ dp[None, None]) & both).sum(-1, dtype=np.int32)
    return num, den


def test_kernel_arithmetic_equals_reference(rng):
    """The popcount identity the CUDA kernel rests on gives the reference's
    integer pairs, and with its index-aware selection the same winners."""
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=300)
    pat_c, _ = teng._pad_chunks(pat, 128)
    msk_c, _ = teng._pad_chunks(msk, 128)
    q_enc, q_mask = teng.prepare_query_planes(_t(qpat), _t(qmsk))
    num, den = _kernel_arithmetic(q_enc, q_mask, _t(pat_c), _t(msk_c))
    assert (den[:, 31] == 0).all()  # the dummy row
    enc, m = teng._unpack_encode_chunk(_t(pat_c).reshape(-1, BITS_BYTES),
                                       _t(msk_c).reshape(-1, BITS_BYTES))
    want_num, want_den = teng._plaintext_chunk_fractions(q_enc, q_mask, enc, m)
    np.testing.assert_array_equal(num[:, :31].transpose(0, 2, 1), want_num.numpy())
    np.testing.assert_array_equal(den[:, :31].transpose(0, 2, 1), want_den.numpy())
    n_r, d_r, _ = tdec.fraction_min_rotations(_t(num), _t(den), axis=1)
    got = torch.stack(tdec.fraction_argmin(n_r, d_r)).numpy()
    want = tpm.match_packed_small_b_reference(q_enc, q_mask, _t(pat_c), _t(msk_c))
    np.testing.assert_array_equal(got, want.numpy())


def test_small_b_ok_policy():
    assert tpm.SMALL_B_MAX == jpm.SMALL_B_MAX
    assert tpm.small_b_ok(1) and tpm.small_b_ok(8)
    assert not tpm.small_b_ok(0) and not tpm.small_b_ok(9)


def test_rejects_bad_inputs(rng):
    pat, msk = _world(rng, 64)
    q_enc, q_mask = teng.prepare_query_planes(_t(pat[:2]), _t(msk[:2]))
    db = _t(pat).reshape(1, 64, BITS_BYTES)
    with pytest.raises(ValueError):
        tpm.match_packed_small_b(q_enc[:, :30], q_mask[:, :30], db, db)
    with pytest.raises(ValueError):
        tpm.match_packed_small_b(q_enc, q_mask, db, db[:, :32])


def test_cpu_tensors_never_launch(rng):
    pat, msk = _world(rng, 64)
    before = tpm.match_packed_small_b.launches
    q_enc, q_mask = teng.prepare_query_planes(_t(pat[:2]), _t(msk[:2]))
    db_pat, db_msk = (_t(x).reshape(1, 64, BITS_BYTES) for x in (pat, msk))
    tpm.match_packed_small_b(q_enc, q_mask, db_pat, db_msk)
    assert tpm.match_packed_small_b.launches == before
