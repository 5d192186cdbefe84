"""The port's select_chunk (mpc_iris_tpu_torch.ops.select; its plain version
on the CPU) against the JAX kernel select_chunk run in interpret mode, on the
cases of tests/test_select_pallas.py. Exact: integers equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.constants import BITS, N_ROTATIONS
from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu.ops import decode as jdec
from mpc_iris_tpu.ops import select_pallas as jsel
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import select as tsel


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_select(dot, den, offset, tile_n=512):
    b = dot.shape[0] // 32
    got = jsel.select_chunk(jnp.asarray(dot), jnp.asarray(den), offset,
                            tile_b=8 if b % 8 == 0 else 1, tile_n=tile_n,
                            interpret=True)
    return np.stack([np.asarray(g) for g in got])


def _port_select(dot, den, offset):
    return torch.stack(tsel.select_chunk(_t(dot), _t(den), offset)).numpy()


def test_layout_constants():
    assert tsel.N_ROT_PAD == jsel.N_ROT_PAD
    np.testing.assert_array_equal(tsel.ROT_BITREV, jsel.ROT_BITREV)


def test_select_chunk_oracle(rng):
    """tests/test_select_pallas.py::test_select_chunk_oracle, both packages."""
    b, n = 8, 2048
    den = rng.integers(0, 12801, size=(b, 32, n)).astype(np.int64)
    num = np.minimum(rng.integers(0, 12801, size=(b, 32, n)), den).astype(np.int64)
    den[:, 31, :] = 0
    dot = (den - 2 * num).reshape(b * 32, n).astype(np.int32)
    den = den.reshape(b * 32, n).astype(np.int32)
    got = _port_select(dot, den, 37)
    np.testing.assert_array_equal(got, _jax_select(dot, den, 37))
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(den > 0, ((den - dot) >> 1) / den, np.inf).reshape(b, 32, n)
    best = frac.min(axis=1)
    assert (got[2] == best.argmin(axis=1) + 37).all()


def test_select_chunk_planted_traps(rng):
    """Rotation ties as different pairs, congruent-mod-128 duplicates, an
    all-invalid query, and int16 inputs; plus the expected winners."""
    dot, den = tsel.planted_select_case(rng, n_cols=1024)
    got = _port_select(dot, den, 11)
    np.testing.assert_array_equal(got, _jax_select(dot, den, 11))
    assert got[:, 0].tolist() == [0, 2, 16]
    assert got[2, 1] == 129 + 11
    assert got[1, 2] == 0 and got[2, 2] == 11
    got16 = _port_select(dot.astype(np.int16), den.astype(np.int16), 11)
    np.testing.assert_array_equal(got16, got)


@pytest.mark.parametrize("n_cols", [1, 300, 1000])
def test_select_chunk_ragged_against_xla_selection(rng, n_cols):
    """Shapes the TPU kernel's tiles refuse: held against the JAX package's
    XLA selection (decode.fraction_min_rotations + fraction_argmin)."""
    dot, den = tsel.planted_select_case(rng, n_cols=1024)
    dot, den = dot[:, :n_cols], den[:, :n_cols]
    got = _port_select(dot, den, 5)
    rev = jsel.ROT_BITREV
    d3 = den.reshape(3, 32, n_cols)[:, rev]
    t3 = dot.reshape(3, 32, n_cols)[:, rev]
    n_r, d_r, _ = jdec.fraction_min_rotations((d3 - t3) >> 1, d3, axis=1)
    want = jdec.fraction_argmin(n_r, d_r, axis=-1, index_offset=5)
    np.testing.assert_array_equal(got, np.stack([np.asarray(w) for w in want]))


def test_select_chunk_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tsel.select_chunk(torch.zeros(31, 8, dtype=torch.int32),
                          torch.zeros(31, 8, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsel.select_chunk(torch.zeros(32, 8, dtype=torch.int32),
                          torch.zeros(32, 9, dtype=torch.int32))


def test_fold_candidates(rng):
    for size in (1, 5, 8):
        d = rng.integers(0, 3, size=(4, size)).astype(np.int32)
        n = np.minimum(rng.integers(0, 3, size=(4, size)), d).astype(np.int32)
        i = rng.permutation(4 * size).reshape(4, size).astype(np.int32)
        got = tsel.fold_candidates(_t(n), _t(d), _t(i))
        want = jsel.fold_candidates(jnp.asarray(n), jnp.asarray(d), jnp.asarray(i))
        np.testing.assert_array_equal(torch.stack(got).numpy(),
                                      np.stack([np.asarray(w) for w in want]))


def _dense_case(rng, b=8, chunk=2048):
    q_enc = rng.integers(-1, 2, size=(b, N_ROTATIONS, BITS)).astype(np.int8)
    q_mask = (q_enc != 0).astype(np.int8)
    db_enc = rng.integers(-1, 2, size=(1, chunk, BITS)).astype(np.int8)
    db_mask = (db_enc != 0).astype(np.int8)
    return q_enc, q_mask, db_enc, db_mask


def test_fused_scan_ties_prefer_low_index(rng):
    """tests/test_select_pallas.py::test_select_chunk_ties_prefer_low_index:
    the port's fused scan against JAX's (interpret mode) and the XLA scan."""
    q_enc, q_mask, db_enc, db_mask = _dense_case(rng)
    for pos in (700, 1500):
        db_enc[0, pos], db_mask[0, pos] = db_enc[0, 100], db_mask[0, 100]
    args = tuple(map(_t, (q_enc, q_mask, db_enc, db_mask)))
    got = teng._match_scan_fused(*args).numpy()
    np.testing.assert_array_equal(got, teng._match_scan(*args).numpy())
    np.testing.assert_array_equal(got, np.asarray(jeng._match_scan_fused(
        q_enc, q_mask, db_enc, db_mask, interpret=True)))


@pytest.mark.parametrize("lo,hi", [(129, 257), (1, 1025), (640, 1920)])
def test_congruent_duplicate_index_tie(rng, lo, hi):
    """tests/test_select_pallas.py::test_congruent_duplicate_index_tie: exact
    duplicates at columns congruent mod 128 tie to the LOWER index."""
    n, b = 2048, 8
    dpat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    dmsk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    dpat[hi], dmsk[hi] = dpat[lo], dmsk[lo]
    enc, mask = (x.reshape(1, n, BITS) for x in
                 teng._unpack_encode_chunk(_t(dpat), _t(dmsk)))
    q_enc, q_mask = teng.prepare_query_planes(_t(dpat[[lo] * b]), _t(dmsk[[lo] * b]))
    got = teng._match_scan_fused(q_enc, q_mask, enc, mask).numpy()
    want = np.asarray(jeng._match_scan_fused(
        q_enc.numpy(), q_mask.numpy(), enc.numpy(), mask.numpy(), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got[2] == lo).all()


def test_cpu_tensors_never_launch(rng):
    before = tsel.select_chunk.launches
    dot, den = tsel.planted_select_case(rng)
    _port_select(dot, den, 0)
    assert tsel.select_chunk.launches == before
