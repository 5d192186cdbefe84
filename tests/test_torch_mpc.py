"""The port's MPC engines and coordinator decode steps (mpc_iris_tpu_torch:
ShareEngine, KeyedShareEngine, MasksEngine, the four ``_sum_decode_*``
steps) against the JAX package's, on the same numpy inputs, on the CPU; and
the JAX package's TCP roles serving the port's engines. Exact: uint16 reply
tensors, int32 decode outputs, checksums and winners equal (tolerance 0)."""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_iris_tpu import native
from mpc_iris_tpu.constants import BITS, BITS_BYTES, N_ROTATIONS
from mpc_iris_tpu.models import KeyedShareEngine as JaxKeyed
from mpc_iris_tpu.models import MasksEngine as JaxMasks
from mpc_iris_tpu.models import ShareEngine as JaxShare
from mpc_iris_tpu.ops import chacha as jcha
from mpc_iris_tpu.ops.decode import decode_distance_batch_np
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.protocol import coordinator as jcoord
from mpc_iris_tpu.types import Template
from mpc_iris_tpu_torch.models import KeyedShareEngine, MasksEngine, ShareEngine
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import chacha as tcha
from mpc_iris_tpu_torch.protocol import coordinator as tcoord

CPU = torch.device("cpu")
PLANE_CHUNK = 2 * BITS * 8  # resident lo/hi planes of one 8-entry chunk


def _queries(rng, b=2):
    return (rng.integers(0, 256, (b, BITS_BYTES), dtype=np.uint8),
            rng.integers(0, 256, (b, BITS_BYTES), dtype=np.uint8))


def _q_enc(qpat, qmsk):
    return teng.prepare_query_planes(torch.from_numpy(qpat), torch.from_numpy(qmsk))[0]


@pytest.fixture(scope="module")
def share21():
    rng = np.random.default_rng(0x5EA)
    share = rng.integers(0, 1 << 16, size=(21, BITS), dtype=np.uint16)
    share[0] = 0xFFFF
    share[1] = 0x8000
    return share, *_queries(rng)


# ------------------------------------------------------------------ ShareEngine


def test_share_engine_equals_jax(share21):
    share, qpat, qmsk = share21
    port = ShareEngine(share, device=CPU, chunk=8)
    ref = JaxShare(share, chunk=8)
    got = port.dots(qpat, qmsk)
    assert got.dtype == np.uint16 and got.shape == (2, 21, N_ROTATIONS)
    np.testing.assert_array_equal(got, ref.dots(qpat, qmsk))
    for entry_major, axis in ((False, 1), (True, 0)):
        np.testing.assert_array_equal(
            np.concatenate(list(port.stream(qpat, qmsk, entry_major=entry_major)), axis=axis),
            np.concatenate(list(ref.stream(qpat, qmsk, entry_major=entry_major)), axis=axis))


def test_share_engine_out_of_core_equals_resident(share21):
    share, qpat, qmsk = share21
    resident = ShareEngine(share, device=CPU, chunk=8)
    ooc = ShareEngine(share, device=CPU, chunk=8, hbm_budget=PLANE_CHUNK)
    pure = ShareEngine(share, device=CPU, chunk=8, hbm_budget=0)
    assert (resident.resident_entries, ooc.resident_entries, pure.resident_entries) == (21, 8, 0)
    want = resident.dots(qpat, qmsk)
    for eng in (ooc, pure):
        np.testing.assert_array_equal(eng.dots(qpat, qmsk), want)
        np.testing.assert_array_equal(
            np.concatenate(list(eng.stream(qpat, qmsk, entry_major=True))),
            want.transpose(1, 0, 2))
    assert not pure._prefetch  # an explicit budget never prefetches


def test_share_engine_default_budget_prefetch(share21, monkeypatch):
    share, qpat, qmsk = share21
    want = JaxShare(share, chunk=8).dots(qpat, qmsk)
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", "1")  # default policy, 0 resident
    eng = ShareEngine(share, device=CPU, chunk=8)
    assert eng.resident_entries == 0 and not eng._explicit_budget
    np.testing.assert_array_equal(eng.dots(qpat, qmsk), want)
    assert teng._OOC_POOL is not None  # the worker was engaged
    # random access after the sequential pass evicts stale prefetches
    q = _q_enc(qpat, qmsk)
    np.testing.assert_array_equal(teng._host_u16(eng.dots_chunk(q, 1)), want[:, 8:16])
    assert set(eng._prefetch) <= {2}
    # an explicit budget under the same environment turns prefetch off
    nopf = ShareEngine(share, device=CPU, chunk=8, hbm_budget=0)
    np.testing.assert_array_equal(nopf.dots(qpat, qmsk), want)
    assert not nopf._prefetch


def test_share_engine_prefetch_invalidated_by_refresh(share21, monkeypatch):
    share, qpat, qmsk = share21
    grown = np.concatenate([share, share[:3] ^ np.uint16(0x5A5A)])
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", "1")
    eng = ShareEngine(share, device=CPU, chunk=8)
    eng.dots_chunk(_q_enc(qpat, qmsk), 1)  # prefetches chunk 2, the padded tail
    assert 2 in eng._prefetch
    epoch = eng._prefetch_epoch
    assert eng.refresh(grown) == 3
    assert not eng._prefetch and eng._prefetch_epoch == epoch + 1
    np.testing.assert_array_equal(eng.dots(qpat, qmsk), JaxShare(grown, chunk=8).dots(qpat, qmsk))


@pytest.mark.parametrize("budget", [None, PLANE_CHUNK])
def test_share_engine_refresh_equals_fresh(share21, budget):
    share, qpat, qmsk = share21
    eng = ShareEngine(share[:13], device=CPU, chunk=8, hbm_budget=budget)
    assert eng.refresh(share) == 8
    np.testing.assert_array_equal(eng.dots(qpat, qmsk), JaxShare(share, chunk=8).dots(qpat, qmsk))
    with pytest.raises(ValueError, match="append-only"):
        eng.refresh(share[:4])


def test_out_of_core_default_budget_reserves_stream_headroom(monkeypatch):
    """Out of core, the default budget reserves one streamed chunk's device
    transients: two raw chunks, the lo/hi split's int32 temporaries and
    planes (7 plane chunks together), and the batch-scaled product and reply
    blocks; a budget that holds every chunk reserves nothing."""
    share = np.zeros((1024, BITS), dtype=np.uint16)
    plane_bytes = 2 * BITS * 64
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", str(10 * plane_bytes))
    assert ShareEngine(share, device=CPU, chunk=64, batch_hint=8)._n_resident == 2
    assert ShareEngine(share, device=CPU, chunk=64, batch_hint=1)._n_resident == 2
    assert ShareEngine(share, device=CPU, chunk=64, batch_hint=128)._n_resident == 1
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", str(16 * plane_bytes))
    assert ShareEngine(share, device=CPU, chunk=64, batch_hint=8)._n_resident == 16
    assert ShareEngine(share, device=CPU, chunk=64,
                       hbm_budget=5 * plane_bytes)._n_resident == 5


# ------------------------------------------------------------------ MasksEngine


@pytest.mark.parametrize("n", [21, 64])
def test_masks_engine_equals_jax(n):
    rng = np.random.default_rng(n)
    masks = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    masks[3] = 0
    _, qmsk = _queries(rng, 3)
    want = JaxMasks(masks, chunk=8).dots(qmsk)
    for storage in ("auto", "dense", "packed"):
        eng = MasksEngine(masks, device=CPU, chunk=8, storage=storage)
        assert eng.storage == ("dense" if storage == "auto" else storage)
        np.testing.assert_array_equal(eng.dots(qmsk), want)
        np.testing.assert_array_equal(
            np.concatenate(list(eng.stream(qmsk, entry_major=True))), want.transpose(1, 0, 2))
        np.testing.assert_array_equal(np.concatenate(list(eng.stream(qmsk)), axis=1), want)


@pytest.mark.parametrize("storage", ["dense", "packed"])
def test_masks_refresh_cost_is_o_added(storage):
    rng = np.random.default_rng(72)
    masks = rng.integers(0, 256, (72, BITS_BYTES), dtype=np.uint8)
    _, qm = _queries(rng)
    for start, want_put in ((64, [16, 17]), (62, [15, 16, 17])):
        eng = MasksEngine(masks[:start], device=CPU, chunk=4, storage=storage)
        kept = list(eng._blocks)
        put, orig = [], eng._put_chunk
        eng._put_chunk = lambda c: (put.append(c), orig(c))[1]
        assert eng.refresh(masks) == 72 - start
        assert put == want_put  # only the padded tail and the new chunks
        assert all(a is b for a, b in zip(eng._blocks, kept[:len(kept) - (start % 4 > 0)]))
        np.testing.assert_array_equal(eng.dots(qm), JaxMasks(masks, chunk=4).dots(qm))
    assert eng.refresh(masks) == 0


def test_masks_auto_boundary_is_the_reference():
    assert MasksEngine(np.zeros((3, BITS_BYTES), np.uint8), device=CPU).storage == "dense"
    big = np.zeros((400_001, BITS_BYTES), np.uint8)
    assert MasksEngine(big, device=CPU, chunk=1 << 20).storage == "packed"


# ------------------------------------------------------------------ KeyedShareEngine


@pytest.fixture(scope="module")
def keyed_world():
    rng = np.random.default_rng(17)
    enc = np.stack([encode_template(Template.random(rng)).data for _ in range(21)])
    key = native.derive_insecure_key(99)
    return key, native.share_split(enc, 3, key), *_queries(rng, 1)


@pytest.mark.parametrize("s", [0, 1])
@pytest.mark.parametrize("budget,resident", [(None, 21), (PLANE_CHUNK, 8), (0, 0)])
def test_keyed_engine_equals_file_engines(keyed_world, s, budget, resident):
    """Full-resident, head + tail and pure regeneration against the JAX and
    the port's file-backed ShareEngine over the prepared share."""
    key, shares, qpat, qmsk = keyed_world
    keyed = KeyedShareEngine(key, s, 21, device=CPU, chunk=8, hbm_budget=budget)
    assert keyed.resident_entries == resident
    want = JaxShare(shares[s], chunk=8).dots(qpat, qmsk)
    np.testing.assert_array_equal(keyed.dots(qpat, qmsk), want)
    np.testing.assert_array_equal(ShareEngine(shares[s], device=CPU, chunk=8).dots(qpat, qmsk),
                                  want)
    np.testing.assert_array_equal(
        np.concatenate(list(keyed.stream(qpat, qmsk, entry_major=True))),
        np.concatenate(list(JaxKeyed(key, s, 21, chunk=8, hbm_budget=budget)
                            .stream(qpat, qmsk, entry_major=True))))


@pytest.mark.parametrize("sid", [0x80000000, 0xFFFFFFFE])
def test_keyed_engine_high_stream_id(sid):
    key = bytes(range(32))
    rows = np.asarray(jcha.share_rows(jcha.key_words(key), sid, 0, 12))
    qpat, qmsk = _queries(np.random.default_rng(1), 1)
    np.testing.assert_array_equal(
        KeyedShareEngine(key, sid, 12, device=CPU, chunk=8, hbm_budget=0).dots(qpat, qmsk),
        JaxShare(rows, chunk=8).dots(qpat, qmsk))
    with pytest.raises(ValueError, match="stream id"):
        KeyedShareEngine(key, sid + 0x80000000, 12, device=CPU)


@pytest.mark.parametrize("budget", [None, 2 * PLANE_CHUNK, 0])
def test_keyed_fold_pass_equals_dots_and_jax(budget):
    key = native.derive_insecure_key(7)
    qpat, qmsk = _queries(np.random.default_rng(23), 2)
    eng = KeyedShareEngine(key, 1, 40, device=CPU, chunk=8, hbm_budget=budget)
    q = _q_enc(qpat, qmsk)
    whole = int(eng.fold_pass_fn()(q))
    assert whole == int(eng.dots(qpat, qmsk).astype(np.uint32).sum() & 0xFFFFFFFF)
    ref = JaxKeyed(key, 1, 40, chunk=8, hbm_budget=budget)
    assert whole == int(np.asarray(ref.fold_pass_fn()(q.numpy())))
    for segments in (2, 3, 5, 99):
        assert int(eng.fold_pass_fn(segments=segments)(q)) == whole


def test_keyed_fold_pass_rejects_phantom_rows():
    with pytest.raises(ValueError, match="phantom"):
        KeyedShareEngine(bytes(32), 0, 21, device=CPU, chunk=8).fold_pass_fn()


def test_keyed_batch_hint_keeps_fewer_resident(monkeypatch):
    """The default headroom grows with batch_hint: a larger hint keeps fewer
    chunks resident (the property; the sizes are the port's own)."""
    key = native.derive_insecure_key(11)
    # 10 chunks of planes: the whole 8-chunk head fits at B = 1
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", str(10 * 2 * BITS * 128))
    counts = [KeyedShareEngine(key, 0, 1024, device=CPU, chunk=128,
                               batch_hint=b)._n_resident for b in (1, 256, 1024)]
    assert counts[0] == 8 and counts[0] > counts[1] > counts[2] == 0
    qpat, qmsk = _queries(np.random.default_rng(5), 1)
    np.testing.assert_array_equal(
        KeyedShareEngine(key, 0, 24, device=CPU, chunk=8, batch_hint=1).dots(qpat, qmsk),
        KeyedShareEngine(key, 0, 24, device=CPU, chunk=8, batch_hint=2**27).dots(qpat, qmsk))


def test_keyed_refresh_grows_count_and_head():
    key = native.derive_insecure_key(8)
    qpat, qmsk = _queries(np.random.default_rng(8))
    eng = KeyedShareEngine(key, 1, 6, device=CPU, chunk=4, hbm_budget=2 * BITS * 4 * 3)
    assert eng._n_resident == 2
    assert eng.refresh(20) == 14 and eng._n_resident == 3
    np.testing.assert_array_equal(eng.dots(qpat, qmsk),
                                  JaxKeyed(key, 1, 20, chunk=4).dots(qpat, qmsk))
    with pytest.raises(ValueError, match="append-only"):
        eng.refresh(3)


# ------------------------------------------------------------------ coordinator decode


def _decode_inputs(rng, n, b):
    """P = 3 share blocks that wrap mod 2^16, with planted zero-distance
    entries (duplicates at 3 and 9) and equal fractions across rotations."""
    den = rng.integers(2, 60, (n, b, N_ROTATIONS)).astype(np.int64)
    num = 1 + rng.integers(0, 1000, den.shape) % (den - 1)  # 0 < n/d < 1
    den[5], num[5] = 0, 0  # an all-invalid entry
    den[[3, 9], :, 7], num[[3, 9], :, 7] = 40, 0  # zero distance, duplicated
    den[4], num[4] = 4, 3
    num[4, :, 2], den[4, :, 2] = 1, 2
    num[4, :, 1], den[4, :, 1] = 2, 4  # the earlier rotation of an equal fraction
    dots = (den.astype(np.int64) - 2 * num) & 0xFFFF
    s0 = rng.integers(0, 1 << 16, den.shape).astype(np.int64)
    s1 = np.full(den.shape, 0xFFFF, np.int64)
    shares = [s0, s1, (dots - s0 - s1) & 0xFFFF]
    return tuple(s.astype(np.uint16) for s in shares), den.astype(np.uint16)


def _t16(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16))


def test_decode_steps_equal_jax():
    rng = np.random.default_rng(0xDEC)
    shares, den = _decode_inputs(rng, 37, 3)
    t_shares, t_den = tuple(map(_t16, shares)), _t16(den)
    pairs = [
        (tcoord._sum_decode_argmin_device_batch, jcoord._sum_decode_argmin_device_batch, None),
        (tcoord._sum_decode_minfrac_device_batch, jcoord._sum_decode_minfrac_device_batch, None),
        (tcoord._sum_decode_argmin_device, jcoord._sum_decode_argmin_device, 1),
        (tcoord._sum_decode_minfrac_device, jcoord._sum_decode_minfrac_device, 1),
    ]
    for port, ref, q in pairs:
        if q is None:
            got = port(t_shares, t_den)
            want = ref(shares, den)
        else:
            got = port(tuple(s[:, q] for s in t_shares), t_den[:, q])
            want = ref(tuple(np.ascontiguousarray(s[:, q]) for s in shares),
                       np.ascontiguousarray(den[:, q]))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    win = tcoord._sum_decode_argmin_device_batch(t_shares, t_den).numpy()
    assert (win[0] == 0).all() and (win[2] == 3).all()  # the lower duplicate
    nd = tcoord._sum_decode_minfrac_device_batch(t_shares, t_den).numpy()
    assert (nd[:, 4] == [[2] * 3, [4] * 3]).all() and (nd[1, 5] == 0).all()
    # int32 inputs decode alike
    got = tcoord._sum_decode_argmin_device_batch(
        tuple(torch.from_numpy(s.astype(np.int32)) for s in shares), torch.from_numpy(den))
    np.testing.assert_array_equal(got.numpy(), win)


def test_frac_less_host_equals_jax():
    cases = [(1, 2, 2, 4), (1, 3, 1, 2), (0, 0, 1, 2), (1, 2, 0, 0), (0, 0, 0, 0), (5, 7, 3, 5)]
    for c in cases:
        assert tcoord._frac_less_host(*c) == jcoord._frac_less_host(*c)


def test_three_party_reconstruction_equals_template_distance():
    """Sum of the three parties' dot shares (two keyed, one file) decodes to
    Template.distance for every (query, entry)."""
    rng = np.random.default_rng(42)
    db = [Template.random(rng) for _ in range(19)]
    queries = [db[4].rotated(3), Template.random(rng)]
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(3)
    shares = native.share_split(enc, 3, key)
    masks = np.stack([t.mask.data for t in db])
    qpat = np.stack([q.pattern.data for q in queries])
    qmsk = np.stack([q.mask.data for q in queries])
    parties = [KeyedShareEngine(key, 0, 19, device=CPU, chunk=8),
               KeyedShareEngine(key, 1, 19, device=CPU, chunk=8, hbm_budget=0),
               ShareEngine(shares[2], device=CPU, chunk=8)]
    dots = sum(p.dots(qpat, qmsk).astype(np.int64) for p in parties) & 0xFFFF
    dens = MasksEngine(masks, device=CPU, chunk=8).dots(qmsk)
    for qi, q in enumerate(queries):
        dist = decode_distance_batch_np(dots[qi].astype(np.uint16), dens[qi])
        np.testing.assert_array_equal(dist, [q.distance(t) for t in db])
    assert dots[0, 4].tolist() != [0] * N_ROTATIONS


# ------------------------------------------------------------------ interop over TCP


def test_jax_roles_serve_port_engines():
    """The JAX ParticipantServer serves two port KeyedShareEngines and one
    port ShareEngine; the JAX Coordinator runs over the port's MasksEngine.
    Its winner equals the oracle and the all-JAX run (single and batched)."""
    from mpc_iris_tpu.protocol import Coordinator, ParticipantServer

    rng = np.random.default_rng(23)
    db = [Template.random(rng) for _ in range(17)]
    query = Template.random(rng)
    db[11] = query.rotated(-4)
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(7)
    shares = native.share_split(enc, 3, key)
    masks = np.stack([t.mask.data for t in db])
    port = ([KeyedShareEngine(key, 0, 17, device=CPU, chunk=8),
             KeyedShareEngine(key, 1, 17, device=CPU, chunk=8, hbm_budget=0),
             ShareEngine(shares[2], device=CPU, chunk=8)],
            MasksEngine(masks, device=CPU, chunk=8))
    ref = ([JaxKeyed(key, 0, 17, chunk=8), JaxKeyed(key, 1, 17, chunk=8),
            JaxShare(shares[2], chunk=8)], JaxMasks(masks, chunk=8))

    async def serve(parties, masks_engine, wire, ask):
        servers = [ParticipantServer(e, "127.0.0.1", 0, wire=wire) for e in parties]
        addrs = [await s.start() for s in servers]
        try:
            return await ask(Coordinator(masks_engine, addrs, strict_scan=True))
        finally:
            for s in servers:
                await s.close()

    async def go(parties, masks_engine):
        # the reference wire streams [B, c, 31] blocks, the batched wire
        # entry-major [c, B, 31] ones
        return (await serve(parties, masks_engine, "reference", lambda c: c.query(query)),
                await serve(parties, masks_engine, "batched",
                            lambda c: c.query_batch([query, db[2]])))

    (one, batch), (one_ref, batch_ref) = asyncio.run(go(*port)), asyncio.run(go(*ref))
    oracle = np.array([query.distance(t) for t in db])
    assert (one.index, one.distance, one.total) == (11, oracle.min(), 17) == (
        one_ref.index, one_ref.distance, one_ref.total)
    assert [(o.index, o.distance) for o in batch] == [(o.index, o.distance) for o in batch_ref]
    assert [o.index for o in batch] == [11, 2]


@pytest.mark.parametrize("module", ["mpc_iris_tpu_torch.ops.chacha",
                                    "mpc_iris_tpu_torch.models",
                                    "mpc_iris_tpu_torch.protocol",
                                    "mpc_iris_tpu_torch.parallel",
                                    *(f"mpc_iris_tpu_torch.protocol.{m}" for m in (
                                        "wire", "pump", "drain", "keyagree", "tlsutil",
                                        "participant", "coordinator", "party_proc")),
                                    "mpc_iris_tpu_torch.smoke_data"])
def test_import_leaves_jax_out(module):
    code = (f"import sys, {module}; assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not [m for m in sys.modules if m.split('.')[0] == 'mpc_iris_tpu'], "
            "'a module of the JAX package imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parent.parent)


def test_cpu_keys_never_launch():
    before = tcha.share_planes_kernel.launches
    key = native.derive_insecure_key(2)
    eng = KeyedShareEngine(key, 0, 16, device=CPU, chunk=8, hbm_budget=0)
    qpat, qmsk = _queries(np.random.default_rng(2), 1)
    eng.dots(qpat, qmsk)
    tcha.share_planes_kernel(tcha.key_tensor(key, CPU), 0, 0, 1)
    assert tcha.share_planes_kernel.launches == before


def test_engines_need_explicit_device(share21):
    """The MPC engines run on the card unless the caller asks for the CPU:
    with no device given they take "cuda", which raises without a card."""
    share = share21[0]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot be shown")
    for make in (lambda: ShareEngine(share),
                 lambda: MasksEngine(np.zeros((3, BITS_BYTES), np.uint8)),
                 lambda: KeyedShareEngine(bytes(32), 0, 16),
                 lambda: KeyedShareEngine(bytes(32), 0, 16, device=torch.device("cuda"))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
