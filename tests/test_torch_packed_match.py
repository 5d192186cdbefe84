"""The port's match_packed_small_b (mpc_iris_tpu_torch.ops.packed_match; its
plain version on the CPU) against the JAX kernel match_packed_small_b in
interpret mode and the JAX packed scan. Exact: integers equal."""

import contextlib
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.constants import BITS_BYTES
from mpc_iris_tpu.ops.select_pallas import N_ROT_PAD
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


LSB = np.uint32(0x01010101)


def _fragments(db_pat, db_msk):
    """The kernel's register-A operand, emulated from the packed uint32
    words: for each K-step (byte slab jj, bit-plane b) and entry, the 32 int8
    values of 8 words w: mask (w_m >> b) & 0x01010101 and encoding
    ((w_p & w_m) >> b & 0x01010101) * 0xFE + mask. Returns (enc, mask) int8
    [E, 50, 8, 32]: entry, jj, bit-plane, K within the step."""
    wp = db_pat.numpy().reshape(-1, BITS_BYTES).view(np.uint32).reshape(-1, 50, 1, 8)
    wm = db_msk.numpy().reshape(-1, BITS_BYTES).view(np.uint32).reshape(-1, 50, 1, 8)
    shift = np.arange(8, dtype=np.uint32)[None, None, :, None]
    am = (wm >> shift) & LSB
    ae = ((wp & wm) >> shift & LSB) * np.uint32(0xFE) + am
    return (x.view(np.int8).reshape(-1, 50, 8, tpm.SLAB) for x in (ae, am))


def _kernel_arithmetic(q_enc, q_mask, db_pat, db_msk, qg):
    """The CUDA kernels' arithmetic, emulated in numpy on the operands they
    are given: the query slabs of ``_query_tiles`` (un-tiled from wgmma's
    shared-memory layout; at qg = 8 the [512, K] rows in packed_gemm's K
    order, which is the fragments' order) and the register fragments of
    :func:`_fragments` (at qg = 8 the A tiles the kernel expands into shared
    memory, the same values), as int32 products over the 400 K-steps, then
    num = (den - dot) >> 1. Returns (num, den) int32 [B, 32, E]."""
    qt = tpm._query_tiles(q_enc, q_mask, qg).numpy()
    g, n = -(-q_enc.shape[0] // qg), 32 * qg
    if qg == tpm.GROUP8:
        assert qt.shape == (2 * n, 50 * 8 * tpm.SLAB)
        qk = qt.reshape(2, n, -1)
    else:
        # g, jj, bit, o, nh, kh, nl, kl -> o, g, nh, nl, jj, bit, kh, kl = [2, G*N, K]
        qk = qt.transpose(3, 0, 4, 6, 1, 2, 5, 7).reshape(2, g * n, -1)
    ae, am = _fragments(db_pat, db_msk)
    # float64 products are exact here (|sums| <= 12,800)
    dot = (qk[0].astype(np.float64) @ ae.reshape(ae.shape[0], -1).T.astype(np.float64))
    den = (qk[1].astype(np.float64) @ am.reshape(am.shape[0], -1).T.astype(np.float64))
    dot, den = (x.astype(np.int32).reshape(g * qg, N_ROT_PAD, -1)[:q_enc.shape[0]]
                for x in (dot, den))
    return (den - dot) >> 1, den


def test_bitplane_perm_equals_jax():
    np.testing.assert_array_equal(tpm._bitplane_perm(), jpm._bitplane_perm())


@pytest.mark.parametrize("bit", range(8))
def test_fragments_equal_jax_unpack_planes(rng, bit):
    """The register fragments of bit-plane ``bit``, over all 50 byte slabs,
    are the JAX kernel's unpacked planes (_unpack_planes) of that bit."""
    pat, msk, _, _ = tpm.planted_packed_case(rng, n=300)
    ae, am = _fragments(_t(pat), _t(msk))
    want_e, want_m = jpm._unpack_planes(jnp.asarray(pat.astype(np.int32)),
                                        jnp.asarray(msk.astype(np.int32)), bit)
    np.testing.assert_array_equal(ae[:, :, bit].reshape(300, BITS_BYTES), np.asarray(want_e))
    np.testing.assert_array_equal(am[:, :, bit].reshape(300, BITS_BYTES), np.asarray(want_m))


@pytest.mark.parametrize("n_chunks,chunk", [(3, 128), (3, 100)])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_kernel_arithmetic_equals_reference(rng, b, n_chunks, chunk):
    """The tensor-core arithmetic the CUDA kernels run, on their operand
    layouts (every query group size of the launch plan), gives the
    reference's integer pairs, and with the index-aware selection the same
    winners; 3 x 100 entries is a count no entry tile divides."""
    n = n_chunks * chunk - 7
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=n, b=b)
    pat_c, _ = teng._pad_chunks(pat, chunk)
    msk_c, _ = teng._pad_chunks(msk, chunk)
    q_enc, q_mask = teng.prepare_query_planes(_t(qpat), _t(qmsk))
    enc, m = teng._unpack_encode_chunk(_t(pat_c).reshape(-1, BITS_BYTES),
                                       _t(msk_c).reshape(-1, BITS_BYTES))
    want_num, want_den = teng._plaintext_chunk_fractions(q_enc, q_mask, enc, m)
    want = tpm.match_packed_small_b_reference(q_enc, q_mask, _t(pat_c), _t(msk_c))
    got = torch.empty_like(want)
    for q0, nq, qg in tpm._launch_plan(b):
        num, den = _kernel_arithmetic(q_enc[q0:q0 + nq], q_mask[q0:q0 + nq],
                                      _t(pat_c), _t(msk_c), qg)
        assert (den[:, 31] == 0).all() and (num[:, 31] == 0).all()  # the dummy row
        np.testing.assert_array_equal(num[:, :31].transpose(0, 2, 1), want_num[q0:q0 + nq].numpy())
        np.testing.assert_array_equal(den[:, :31].transpose(0, 2, 1), want_den[q0:q0 + nq].numpy())
        n_r, d_r, _ = tdec.fraction_min_rotations(_t(num), _t(den), axis=1)
        got[:, q0:q0 + nq] = torch.stack(tdec.fraction_argmin(n_r, d_r))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got[2, 0] == 129


def test_group_of_eight_traps_equal_jax(rng):
    """B = 8 as the group of 8 computes it (its operand's arithmetic,
    :func:`_kernel_arithmetic` at qg = 8, then the exact selection) equals
    the JAX kernel in interpret mode and the JAX scan on ties that the
    kernel splits: query 0's self-match at 129, copied to 193 (the other
    consumer warpgroup of its 128-entry tile) and 257 (another tile); the
    sparse masks' rotation ties; an all-invalid entry (7); a zero query (2);
    1,000 entries and a zero-padded tail to 1,024."""
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=1000, b=8)
    pat[193], msk[193] = pat[129], msk[129]
    port, jk, js = _both(qpat, qmsk, pat, msk)
    pat_c, _ = teng._pad_chunks(pat, 512)
    msk_c, _ = teng._pad_chunks(msk, 512)
    q_enc, q_mask = teng.prepare_query_planes(_t(qpat), _t(qmsk))
    num, den = _kernel_arithmetic(q_enc, q_mask, _t(pat_c), _t(msk_c), tpm.GROUP8)
    n_r, d_r, _ = tdec.fraction_min_rotations(_t(num), _t(den), axis=1)
    got = torch.stack(tdec.fraction_argmin(n_r, d_r)).numpy()
    np.testing.assert_array_equal(got, jk)
    np.testing.assert_array_equal(port, jk)
    np.testing.assert_array_equal(port, js)
    assert got[2, 0] == 129 and got[0, 0] == 0
    assert got[1, 2] == 0 and got[2, 2] == 0


def test_group_of_eight_spectrum_equals_jax(rng):
    """B = 8's audit spectrum as the group of 8 computes it (its operand's
    arithmetic, :func:`_kernel_arithmetic` at qg = 8, then each entry's
    exact rotation minimum) equals ``fractions_packed_small_b_reference``
    and the JAX kernel in interpret mode, as (n, d) pairs: the traps of
    :func:`test_group_of_eight_traps_equal_jax` (the self-match at 129, 193
    and 257, the sparse masks' rotation ties, entry 7, the zero query 2,
    1,000 entries and a zero-padded tail to 1,024)."""
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=1000, b=8)
    pat[193], msk[193] = pat[129], msk[129]
    pat_c, _ = teng._pad_chunks(pat, 512)
    msk_c, _ = teng._pad_chunks(msk, 512)
    q_enc, q_mask = teng.prepare_query_planes(_t(qpat), _t(qmsk))
    num, den = _kernel_arithmetic(q_enc, q_mask, _t(pat_c), _t(msk_c), tpm.GROUP8)
    n_r, d_r, _ = tdec.fraction_min_rotations(_t(num), _t(den), axis=1)
    got = torch.stack([n_r, d_r]).numpy()
    want = tpm.fractions_packed_small_b_reference(q_enc, q_mask, _t(pat_c), _t(msk_c)).numpy()
    jk = np.asarray(jpm.fractions_packed_small_b(*jeng.prepare_query_planes(qpat, qmsk),
                                                 jnp.asarray(pat_c), jnp.asarray(msk_c),
                                                 interpret=True))
    assert got.shape == (2, 8, 1024)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.uint16), jk)
    assert not got[0, 0, [129, 193, 257]].any() and got[1, 0, [129, 193, 257]].all()
    assert not got[:, :, 7].any() and not got[:, :, 1000:].any() and not got[:, 2].any()
    # the sparse masks' rotation ties: the least fraction as another pair at
    # a later rotation, which the earliest rotation's pair beats
    n_min, d_min = got[:, :, None].astype(np.int64)
    nums, dens = num[:, :31].astype(np.int64), den[:, :31].astype(np.int64)
    assert ((nums * d_min == n_min * dens) & (dens > 0) & (dens != d_min)).any()


@pytest.mark.parametrize("b,plan", [
    (1, [(0, 1, 1)]), (2, [(0, 2, 2)]), (3, [(0, 3, 4)]), (4, [(0, 4, 4)]),
    (7, [(0, 4, 4), (4, 3, 4)]), (8, [(0, 8, 8)]), (13, [(0, 12, 4), (12, 1, 1)]),
    (33, [(0, 32, 4), (32, 1, 1)])])
def test_launch_plan_covers_the_batch(b, plan):
    assert tpm._launch_plan(b) == plan


class _Launches:
    """Stands in for the kernel library, ``launch_select`` and
    ``launch_fractions``: records each launch as (kernel family, group size,
    queries)."""

    def __init__(self):
        self.calls = []

    def match_packed_small_b_launch(self, qg, qt, dp, dm, n, nq, part, out, stride, stream):
        self.calls.append(("b", qg, nq))
        return 0

    def fractions_packed_small_b_launch(self, qg, qt, dp, dm, n, nq, scratch, out, plane,
                                        stream):
        self.calls.append(("c", qg, nq))
        return 0

    def match_packed_g8_scratch(self, n):
        return 1

    def fractions_packed_g8_scratch(self, n):
        return 1

    def packed_tile_entries(self, qg):
        return 128

    def one(self, family):
        return lambda *args: self.calls.append((family, 1, 1))


@pytest.mark.parametrize("b", [1, 2, 3, 5, 7, 8, 13])
def test_spectrum_and_match_take_one_plan(rng, monkeypatch, b):
    """Both dispatchers walk ``_launch_plan``: the spectrum (c) makes the
    match's (b) launches, group for group (at B = 8 one group of 8), each
    launch holding the same queries; recorded on the CPU in place of the
    kernel library."""
    fake = _Launches()
    pat, msk = _world(rng, 64)
    q_enc, q_mask = teng.prepare_query_planes(_t(pat[rng.integers(0, 64, b)]),
                                              _t(msk[rng.integers(0, 64, b)]))
    db_pat, db_msk = (_t(x).reshape(1, 64, BITS_BYTES) for x in (pat, msk))
    monkeypatch.setattr(tpm, "_launch_args", lambda name, *args: (fake, 64))
    monkeypatch.setattr(tpm, "launch_select", fake.one("b"))
    monkeypatch.setattr(tpm, "launch_fractions", fake.one("c"))
    monkeypatch.setattr(tpm, "start_query_check", lambda qe, qm: None)
    monkeypatch.setattr(tpm, "require_bit_valued", lambda name, check: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    tpm.match_packed_small_b(q_enc, q_mask, db_pat, db_msk)
    tpm.fractions_packed_small_b(q_enc, q_mask, db_pat, db_msk)
    plan = [(qg, nq) for _, nq, qg in tpm._launch_plan(b)]
    assert [c[1:] for c in fake.calls if c[0] == "b"] == plan
    assert [c[1:] for c in fake.calls if c[0] == "c"] == plan
    assert (plan == [(tpm.GROUP8, 8)]) == (b == 8)


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


def test_group8_probe_rehearses_on_the_cpu():
    """``scripts/packed_match_g8_probe_torch.py --device cpu``: the plan and
    the operand's shape at B = 8, and the plain versions' winners and
    spectrum on the probe's planted cases (query 0 the self-match at 5, then
    at 129: n = 0 there)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "scripts/packed_match_g8_probe_torch.py", "--device",
                          "cpu"], cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "rehearsal N=64: winners [5," in out.stdout
    assert "rehearsal N=700: winners [129," in out.stdout
    assert "spectrum of query 0 at 5: (0, " in out.stdout
    assert "spectrum of query 0 at 129: (0, " in out.stdout
