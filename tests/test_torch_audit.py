"""The port's threshold audit (mpc_iris_tpu_torch: the exact threshold
compare, the fraction spectrum scans, the packed audit-spectrum kernel's
plain version, the device compaction, and PlaintextEngine.min_fractions /
find_under) against the JAX package's, on the same numpy inputs, on the CPU.
Exact, tolerance 0: uint16 spectra, compaction outputs, f64 values and every
match list's (index, f64 distance, n, d) equal.

The JAX engines use chunks that are not multiples of 512, so their packed
small-batch dispatch stays off the Pallas interpret path; the one
interpret-mode call is at 1,024 entries.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.models import PlaintextEngine as JaxEngine
from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu.ops import decode as jdec
from mpc_iris_tpu.ops import packed_match as jpm
from mpc_iris_tpu_torch.models import AuditLimitExceeded, PlaintextEngine
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import decode as tdec
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops import scan as tscan
import test_threshold
from test_threshold import audit_world, check_against_oracle  # noqa: F401 (fixture)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows(lists):
    return [[(m.index, m.distance, m.numerator, m.denominator) for m in row]
            for row in lists]


# ------------------------------------------------- exact threshold compare (host)


def _scale_case():
    """1M entries exactly on the threshold 1/2, some strictly under: every
    element goes through the exact settle."""
    rng = np.random.default_rng(7)
    n = np.ones(1_000_000, dtype=np.int64)
    n[rng.integers(0, n.size, 117)] = 0
    return n, np.full(n.size, 2, dtype=np.int64), [0.5]


def _spectrum_case():
    nd = test_threshold.TestCompactionProperties._spectrum(5, 2, 4096)
    present = float(tdec.fractions_to_f64_np(nd[0, 0, 3], nd[1, 0, 3]))  # 300/800
    return nd[0], nd[1], [0.375, present, math.nextafter(present, 1),
                          math.nextafter(present, 0), 1e-40, 1e39]


T3 = 1.0 / 3.0
MASK_CASES = {
    # f64(1/3) rounds down, so 100/300 rounds onto it but lies above it
    "boundary-rationals": lambda: ([100, 1, 1], [300, 4, 0], [T3, math.nextafter(T3, 1)]),
    "on-representable-distance": lambda: ([1, 1], [2, 2], [0.5, math.nextafter(0.5, 1)]),
    "degenerate-thresholds": lambda: ([0, 3], [5, 7], [0.0, -1.0, math.nan, math.inf]),
    # 1000 * 2**54 > 2**63: the settle falls back to Python-integer math
    "object-math-fallback": lambda: ([1000, 1, 999], [3000, 3000, 3000],
                                     [T3, math.nextafter(T3, 1)]),
    "adversarial-boundary-scale": _scale_case,
    "random-spectrum": _spectrum_case,
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_threshold_helpers_equal_jax(case):
    nums, dens, thresholds = MASK_CASES[case]()
    np.testing.assert_array_equal(tdec.fractions_to_f64_np(nums, dens),
                                  jdec.fractions_to_f64_np(nums, dens))
    for t in thresholds:
        got = tdec.under_threshold_mask_np(nums, dens, t)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, jdec.under_threshold_mask_np(nums, dens, t))
    if case == "boundary-rationals":
        assert tdec.under_threshold_mask_np(nums, dens, T3).tolist() == [False, True, False]
    if case == "object-math-fallback":
        assert tdec.under_threshold_mask_np(nums, dens, T3).tolist() == [False, True, True]


# ------------------------------------------------- spectrum scans and kernel (c)

SCAN_CHUNK = 200  # 700 entries -> 4 chunks, the last padded; 129 and 257 in two chunks


@pytest.fixture(scope="module")
def planted():
    """planted_packed_case at 700 entries and 13 queries: sparse masks past
    row 257 (rotation ties as different pairs), the duplicate pair 129/257
    (query 0's self-match), the all-invalid entry 7, an all-invalid query 2."""
    return tpm.planted_packed_case(np.random.default_rng(0xA0D1), n=700, b=13)


@pytest.fixture(scope="module", params=["packed", "dense"])
def scan_engines(request, planted):
    pat, msk, _, _ = planted
    return (PlaintextEngine(pat, msk, device="cpu", chunk=SCAN_CHUNK, storage=request.param),
            JaxEngine(pat, msk, chunk=SCAN_CHUNK, storage=request.param))


@pytest.mark.parametrize("b", [1, 8, 13])
def test_fractions_scans_equal_jax(planted, scan_engines, b):
    _, _, qpat, qmsk = planted
    port, ref = scan_engines
    q_enc, q_mask = tscan.prepare_query_planes(_t(qpat[:b]), _t(qmsk[:b]))
    jq_enc, jq_mask = jeng.prepare_query_planes(qpat[:b], qmsk[:b])
    planes = port._db.planes
    if port._db.storage == "packed":
        got = tscan._fractions_scan_packed(q_enc, q_mask, *planes, fused=False)
        want = jeng._fractions_scan_packed(jq_enc, jq_mask, ref.db_pat, ref.db_msk)
        # the kernel wrapper and the dispatch take the same plain scan here
        assert torch.equal(tpm.fractions_packed_small_b(q_enc, q_mask, *planes), got)
        assert torch.equal(teng.fractions_scan_packed_auto(q_enc, q_mask, *planes), got)
    else:
        got = tscan._fractions_scan(q_enc, q_mask, *planes)
        want = jeng._fractions_scan(jq_enc, jq_mask, ref.db_enc, ref.db_mask)
    assert torch.equal(port._db.spectrum(q_enc, q_mask), got)
    assert got.dtype == torch.int16 and got.shape == (2, b, 800)
    np.testing.assert_array_equal(got.numpy().astype(np.uint16), np.asarray(want))
    n, d = got.numpy()
    assert n[0, 129] == 0 and n[0, 257] == 0 and d[0, 129] == d[0, 257] > 0
    assert not n[:, 7].any() and not d[:, 7].any()          # all-invalid entry
    assert not d[:, 700:].any()                             # padded tail
    if b > 2:
        assert not d[2].any()                               # all-invalid query


def test_fractions_kernel_plain_equals_jax_interpret(rng):
    """The only interpret-mode call: 1,024 entries, chunk 512, B = 2."""
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=1024, b=2)
    pat_c, _ = teng._pad_chunks(pat, 512)
    msk_c, _ = teng._pad_chunks(msk, 512)
    got = tpm.fractions_packed_small_b(*tscan.prepare_query_planes(_t(qpat), _t(qmsk)),
                                       _t(pat_c), _t(msk_c))
    want = jpm.fractions_packed_small_b(*jeng.prepare_query_planes(qpat, qmsk),
                                        jnp.asarray(pat_c), jnp.asarray(msk_c),
                                        interpret=True)
    np.testing.assert_array_equal(got.numpy().astype(np.uint16), np.asarray(want))


# ------------------------------------------------- device compaction


def _planted_spectrum():
    pat, msk, qpat, qmsk = tpm.planted_packed_case(np.random.default_rng(3), n=700, b=3)
    pat_c, _ = teng._pad_chunks(pat, 128)
    msk_c, _ = teng._pad_chunks(msk, 128)
    nd = tscan._fractions_scan_packed(*tscan.prepare_query_planes(_t(qpat), _t(qmsk)),
                                      _t(pat_c), _t(msk_c), fused=False)
    return nd.numpy().astype(np.uint16)


COMPACT_CASES = {
    "random": lambda: test_threshold.TestCompactionProperties._spectrum(11, 3, 5000),
    "planted": _planted_spectrum,
}


@pytest.mark.parametrize("k", [4096, 64, 1])
@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compaction_equals_jax(case, k):
    nd = COMPACT_CASES[case]()
    b, np_ = nd.shape[1:]
    dist = tdec.fractions_to_f64_np(nd[0], nd[1])
    present = float(np.sort(dist[0][np.isfinite(dist[0])])[300])
    overflowed = False
    for t in (0.375, present, math.nextafter(present, 0), 0.9):
        t_hi = np.float32(t * (1.0 + 1e-4))
        meta, nd_c = teng._compact_under_device(_t(nd.astype(np.int16)), t_hi, k)
        meta, nd_c = meta.numpy(), nd_c.numpy()
        want_meta, want_nd = jeng._compact_under_jit(jnp.asarray(nd), t_hi, k=k)
        assert meta.dtype == np.int32 and meta.shape == (b, k + 1)
        np.testing.assert_array_equal(meta, np.asarray(want_meta))
        np.testing.assert_array_equal(nd_c.astype(np.uint16), np.asarray(want_nd))
        for q in range(b):
            count, idx = int(meta[q, 0]), meta[q, 1:]
            kept = min(count, k)
            assert (np.diff(idx[:kept]) > 0).all()               # ascending
            assert (idx[kept:] == -1).all() and not nd_c[:, q, kept:].any()
            np.testing.assert_array_equal(nd_c[:, q, :kept], nd[:, q, idx[:kept]])
            overflowed |= count > k
        if k == 1:
            assert overflowed  # the count exceeds k, for the caller's fallback


# ------------------------------------------------- the engine against JAX's


@pytest.fixture(scope="module", params=["packed", "dense"])
def audit_engines(request, audit_world):
    dpat, dmsk, _, _, _ = audit_world
    return (PlaintextEngine(dpat, dmsk, device="cpu", chunk=16, storage=request.param),
            JaxEngine(dpat, dmsk, chunk=16, storage=request.param))


def test_min_fractions_equals_jax_engine(audit_world, audit_engines):
    _, _, qpat, qmsk, oracle = audit_world
    port, ref = audit_engines
    nd = port.min_fractions(qpat, qmsk)
    assert nd.dtype == np.uint16 and nd.shape == (2, 3, 61)
    np.testing.assert_array_equal(nd, ref.min_fractions(qpat, qmsk))
    np.testing.assert_array_equal(tdec.fractions_to_f64_np(nd[0], nd[1]), oracle)


def _finite(oracle):
    return oracle[np.isfinite(oracle)]


FIND_UNDER_CASES = {
    # name: (thresholds from the oracle, compact_k)
    "oracle-thresholds": (lambda o: [0.25, float(np.median(_finite(o))), 1e-9, 2.0], None),
    "compacted": (lambda o: [0.25, float(np.median(_finite(o))), 1e-9,
                             float(_finite(o)[5]), 2.0], 48),
    "planted-duplicate": (lambda o: [1e-12, 0.0], 48),
    "subnormal-and-huge": (lambda o: [1e-40, 1e39], 48),
    "overflow": (lambda o: [0.9], 4),
}


@pytest.mark.parametrize("case", list(FIND_UNDER_CASES))
def test_find_under_equals_jax_engine(audit_world, audit_engines, case):
    _, _, qpat, qmsk, oracle = audit_world
    port, ref = audit_engines
    thresholds, compact_k = FIND_UNDER_CASES[case]
    for t in thresholds(oracle):
        got = port.find_under(qpat, qmsk, t, compact_k=compact_k)
        assert _rows(got) == _rows(ref.find_under(qpat, qmsk, t, compact_k=compact_k)), t
        assert _rows(got) == _rows(port.find_under(qpat, qmsk, t)), t  # == the full path
        if not (oracle == t).any():
            # on a present f64 distance the exact rational compare decides,
            # which the f64 oracle cannot
            check_against_oracle(got, oracle, t)
        if t in (1e-12, 1e-40):
            assert [(m.index, m.distance) for m in got[0]] == [(7, 0.0), (20, 0.0)]
        if t == 0.0:
            assert got == [[], [], []]


@pytest.mark.parametrize("compact_k", [48, None])
def test_find_under_limit_raises(audit_world, audit_engines, compact_k):
    _, _, qpat, qmsk, _ = audit_world
    port, ref = audit_engines
    with pytest.raises(AuditLimitExceeded):
        port.find_under(qpat, qmsk, 0.9, limit=2, compact_k=compact_k)
    with pytest.raises(jeng.AuditLimitExceeded):
        ref.find_under(qpat, qmsk, 0.9, limit=2, compact_k=compact_k)
    assert _rows(port.find_under(qpat, qmsk, 1e-9, limit=2, compact_k=compact_k)) == \
        _rows(ref.find_under(qpat, qmsk, 1e-9, limit=2, compact_k=compact_k))
