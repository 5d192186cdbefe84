"""The yardstick on its own: what the benchmark imports, the reference
against the oracles, the work functions at the cells' shapes, and the trace
arithmetic."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark import manifest as mf
from benchmark import trace as tr
from benchmark.peaks import HBM_BYTES_PER_S, INT8_OPS
from benchmark.reference import keyed_share, plaintext

M = mf.load_manifest()
BANNED = {"jax", "jaxlib", "flax", "mpc_iris_tpu", "bench"}


def _modules_after(code: str) -> set[str]:
    """Top-level names in ``sys.modules`` after ``code``, in a fresh process."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=mf.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax():
    """Every file of the harness loaded and a cell run end to end: no JAX,
    no JAX package, no bench.py, by whole top-level names (the port's name
    begins with the JAX package's)."""
    code = ("import time\nfrom benchmark import harness, manifest as mf, control, run\n"
            "m = mf.load_manifest()\n"
            "for x in m['per_layer']: mf.metric_reader(x['name'])\n"
            "for w in m['workloads']:\n"
            "    t = mf.traffic(w['traffic']); mf.entry(t['entry']); mf.work(t['entry'])\n"
            "    mf.faults(t['entry'])\n"
            "harness.run_cell('plain3m-match-b1', 1, 0.2, True, 'cpu', time.perf_counter(),\n"
            "    overrides={'config': {'entries': 300}, 'traffic': {'distinct_requests': 2,\n"
            "    'check_queries': 2}})")
    loaded = _modules_after(code)
    assert "mpc_iris_tpu_torch" in loaded
    assert not loaded & BANNED, loaded & BANNED


def test_the_reference_imports_nothing_of_the_port():
    loaded = _modules_after("import benchmark.reference.plaintext, "
                            "benchmark.reference.keyed_share, benchmark.data, "
                            "benchmark.peaks")
    assert not loaded & (BANNED | {"mpc_iris_tpu_torch"})


def test_rotation_matches_the_oracle():
    from mpc_iris_tpu_torch.types import Bits

    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (5, data.BITS_BYTES), dtype=np.uint8)
    amounts = np.array([-15, -1, 0, 7, 15])
    got = data.rotate_packed(packed, amounts)
    for row, r, g in zip(packed, amounts, got):
        assert np.array_equal(Bits(row).rotated(int(r)).data, g)


def test_plaintext_reference_matches_template_distance():
    """Winner and audit against the scalar oracle ``Template.distance``,
    with planted ties (a duplicate entry, equal fractions)."""
    from mpc_iris_tpu_torch.types import Bits, Template

    rng = np.random.default_rng(2)
    n = 40
    pat = rng.integers(0, 256, (n, data.BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, data.BITS_BYTES), dtype=np.uint8)
    pat[30], msk[30] = pat[4], msk[4]  # equal fractions: the lower index wins
    qp = data.rotate_packed(pat[[4, 9]], np.array([3, -12]))
    qm = data.rotate_packed(msk[[4, 9]], np.array([3, -12]))
    qp = np.concatenate([qp, rng.integers(0, 256, (2, data.BITS_BYTES), dtype=np.uint8)])
    qm = np.concatenate([qm, rng.integers(0, 256, (2, data.BITS_BYTES), dtype=np.uint8)])
    dist = np.array([[Template(Bits(qp[q]), Bits(qm[q])).distance(Template(Bits(pat[e]), Bits(msk[e])))
                      for e in range(n)] for q in range(4)])
    win = plaintext.match(pat, msk, qp, qm, "cpu", block=16)
    for q, (i, num, den, d) in enumerate(win):
        assert i == int(np.argmin(dist[q])) and d == dist[q].min() and d == num / den
    assert win[0][0] == 4 and win[0][3] == 0.0
    t = float(np.sort(dist[2])[3])  # three entries strictly under it
    hits = plaintext.audit(pat, msk, qp, qm, t, "cpu", block=16)
    assert [len(h) for h in hits][2] == 3
    for q in range(4):
        want = sorted((dist[q][e], e) for e in range(n) if dist[q][e] < t)
        assert [(d, i) for i, _, _, d in hits[q]] == want
    assert [h[0] for h in hits[0][:2]] == [4, 30]


def test_the_winner_fold_past_2_22_entries():
    """The reference's running winner, fed synthetic blocks at DB indices
    past 2^22: the lower index among equal fractions, within a block and
    across a block boundary; a strictly lower fraction in a later block
    wins; indices come back whole."""
    inf = plaintext.INVALID
    best = plaintext.Winners.none(3, "cpu")
    key = torch.tensor([[9, 5, 7, 5], [inf, inf, inf, inf], [4, 6, 4, 9]])
    n, d = key * 10 + torch.arange(4), key * 100 + torch.arange(4)
    start = (1 << 22) + 5
    best = best.fold(key, n, d, start)
    assert best.index.tolist() == [start + 1, 0, start]
    assert best.key.tolist() == [5, inf, 4] and best.n.tolist() == [51, 0, 40]
    assert best.d.tolist() == [501, 0, 400]
    start2 = 12_000_000 - 2  # the next block: equal, higher, lower keys
    key2 = torch.tensor([[8, 5], [inf, 7], [3, 3]])
    best = best.fold(key2, key2 * 10 + 2, key2 * 100 + 2, start2)
    assert best.index.tolist() == [start + 1, start2 + 1, start2]
    assert best.key.tolist() == [5, 7, 3] and best.n.tolist() == [51, 72, 32]
    assert best.d.tolist() == [501, 702, 302]


def test_keystream_matches_rfc8439_and_the_port():
    """The numpy ChaCha20 against RFC 8439's block test vector (section
    2.3.2) and the port's share rows, at the nonce carry."""
    key = bytes(range(32))
    # RFC 8439 2.3.2: counter 1, nonce 00:00:00:09 00:00:00:4a 00:00:00:00;
    # as a share row: block 1 of stream 0x09000000, row 0x4a000000
    row = keyed_share.share_rows(key, 0x09000000, np.array([0x4A000000]))[0]
    block1 = row[32:64].view("<u4")
    assert block1[0] == 0xE4E7F110 and block1[15] == 0x4E3C50A2
    from mpc_iris_tpu_torch.ops.chacha import key_tensor, share_rows

    rows = np.array([0, 5, 0xFFFFFFFF, 0x100000000])
    ours = keyed_share.share_rows(key, 3, rows)
    want = share_rows(key_tensor(key, "cpu"), 3, 0xFFFFFFFF, 2)  # the carry inside a launch
    assert np.array_equal(ours[2:], want.numpy().astype(np.uint16))
    for r, got in zip(rows[:2], ours):
        want = share_rows(key_tensor(key, "cpu"), 3, int(r), 1)
        assert np.array_equal(got, want[0].numpy().astype(np.uint16))


def test_reply_matches_the_u16_oracle():
    from mpc_iris_tpu_torch.ops.dot import dot_u16_oracle
    from mpc_iris_tpu_torch.ops.encode import encode_template
    from mpc_iris_tpu_torch.types import Bits, EncodedBits, Template

    rng = np.random.default_rng(3)
    share = keyed_share.share_rows(bytes(32), 0, np.arange(3))
    qp = rng.integers(0, 256, (2, data.BITS_BYTES), dtype=np.uint8)
    qm = rng.integers(0, 256, (2, data.BITS_BYTES), dtype=np.uint8)
    got = keyed_share.reply(share, qp, qm, "cpu")
    assert got.shape == (3, 2, 31)
    for q in range(2):
        enc = encode_template(Template(Bits(qp[q]), Bits(qm[q])))
        for k, r in enumerate(data.ROTATIONS):
            rot = EncodedBits(enc.data).rotated(r).data
            for e in range(3):
                assert got[e, q, k] == dot_u16_oracle(rot, share[e])
    low = keyed_share.reply(keyed_share.quantized(share, 8), qp, qm, "cpu")
    assert (low != got).mean() > 0.9


def test_planted_clusters_are_rotated_flipped_copies():
    """Each planted copy is its source rotated within the 31 rotations, mask
    and pattern alike, with at most ``flip_bits`` pattern bits flipped; the
    same seed plants the same."""
    cl = data.plan_clusters({"db_clusters": [[2, 3], [1, 5]]}, 200, 9)
    assert list(cl.sizes) == [3, 3, 5] and len(set(cl.at) | set(cl.sources)) == 14
    pat, msk = data.make_db(200, 9, "cpu", cl, flip_bits=8)
    again = data.make_db(200, 9, "cpu", cl, flip_bits=8)
    assert np.array_equal(pat, again[0]) and np.array_equal(msk, again[1])
    plain = data.make_db(200, 9, "cpu")
    untouched = np.setdiff1d(np.arange(200), cl.at)
    assert np.array_equal(pat[untouched], plain[0][untouched])
    t = {"batch": 4, "distinct_requests": 6, "duplicate_share": 0.5, "flip_bits": 8}
    pools = [data.make_pool(t, seed, (pat, msk), cl) for seed in (1, 2)]
    for pool in pools:  # each cluster's query at the same place for every seed
        assert [pool.source[k * 6 // 3, k % 4] for k in range(3)] == list(cl.sources)
        assert (pool.source >= 0).sum() == 12
        others = pool.source[pool.source >= 0][~np.isin(pool.source[pool.source >= 0],
                                                         cl.sources)]
        assert not np.isin(others, cl.at).any()
    for s, c in zip(np.repeat(cl.sources, cl.sizes), cl.at):
        fits = [r for r in data.ROTATIONS
                if np.array_equal(data.rotate_packed(msk[s:s + 1], [r])[0], msk[c])]
        assert fits, (s, c)
        flipped = [int(np.unpackbits(data.rotate_packed(pat[s:s + 1], [r])[0] ^ pat[c]).sum())
                   for r in fits]
        assert 1 <= min(flipped) <= 8


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_work_at_the_cell_shapes(name):
    cell = mf.cell(M, name)
    config, traffic = mf.config(cell["config"]), mf.traffic(cell["traffic"])
    w = mf.work(traffic["entry"]).work(config, traffic)
    n, b = config["entries"], traffic["batch"]
    assert w["comparisons"] == n * b
    assert w["int8_ops"] == 4 * b * 31 * 12_800 * n
    if traffic["entry"] == "keyed_stream":
        assert w["share_bytes"] == 25_600_000_000 and w["reply_bytes"] == 496_000_000
        assert w["request_bytes"] == w["share_bytes"] + w["reply_bytes"]
    else:
        assert w["db_bytes"] == w["request_bytes"] == 9_600_000_000
    if traffic["entry"] == "find_under":
        # B = 8: one int8 launch of two groups of 4, bound by its operations
        assert w["packed_fractions_bound_s"] == pytest.approx(4 * 8 * 31 * 12_800 * n / INT8_OPS)
        assert w["packed_fractions_bound_s"] > w["db_bytes"] / HBM_BYTES_PER_S


def test_int8_launches_follow_the_port():
    from mpc_iris_tpu_torch.ops.packed_match import _launch_plan

    from benchmark.work.find_under import int8_launches

    for b in range(1, 9):
        assert int8_launches(b) == [q for _, q, g in _launch_plan(b) if g > 1]


def _event(name, start, dur, device="CPU", card=0):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                           device_type=lambda: getattr(DeviceType, device),
                           device_index=lambda: card)


def test_trace_arithmetic():
    """Two requests of 100 ns; device ops cover 30 + 20 (overlapping 10) and
    10 of them; the idle gaps are labelled by the innermost host op."""
    events = [
        _event("request", 0, 100), _event("request", 100, 100),
        _event("request", 0, 100, "CUDA"),  # the span mirrored on the device's timeline
        _event("aten::copy_", 40, 60), _event("cudaEventSynchronize", 150, 40),
        _event("k1", 10, 30, "CUDA"), _event("k2", 30, 20, "CUDA"),
        _event("Memcpy DtoH (Device -> Pinned)", 120, 10, "CUDA"),
        _event("k_outside", 300, 50, "CUDA"),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = tr.reduce(prof)
    assert t.requests == 2 and t.window_s == pytest.approx(200e-9)
    assert t.busy_s == pytest.approx(50e-9) and t.idle_pct == pytest.approx(75.0)
    assert t.device_seconds(lambda n: "DtoH" in n) == pytest.approx(10e-9)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(70e-9)  # 50 .. 120
    assert gaps["cudaEventSynchronize"] == pytest.approx(70e-9)  # 130 .. 200
    assert gaps["request"] == pytest.approx(10e-9)  # 0 .. 10
    assert [k for k, _ in t.breakdown()["device_ops"]][:1] == ["k1"]
    assert t.busy_by_card == {0: t.busy_s}


SPANS = [(0, 100), (100, 200)]
HOST = [(0, 100, "request"), (100, 200, "request"), (40, 100, "aten::copy_"),
        (150, 190, "cudaEventSynchronize")]
OPS = [("k1", 0, 10, 30), ("k2", 0, 30, 20), ("Memcpy DtoH", 0, 120, 10), ("late", 0, 300, 50)]


def test_busy_by_card():
    """Synthetic operations (name, card, start, duration): on one card the
    card's busy time is the device's, with the same gaps; with a second
    card overlapping the first, each card's time is its own, the device's
    is their union (below the sum), and the gaps and their labels are
    those of the union."""
    one = tr.from_events(SPANS, list(HOST), OPS)
    assert one.busy_s == pytest.approx(50e-9) and one.idle_pct == pytest.approx(75.0)
    assert one.busy_by_card == {0: one.busy_s}
    assert one.gaps == [("request", 10e-9), ("aten::copy_", 70e-9),
                        ("cudaEventSynchronize", 70e-9)]
    assert [op[0] for op in one.device_ops] == ["k1", "k2", "Memcpy DtoH"]
    ops = OPS + [("k3", 1, 20, 40), ("k4", 1, 170, 40)]  # card 1: 20 .. 60, 170 .. 200
    two = tr.from_events(SPANS, list(HOST), ops)
    assert two.busy_by_card == pytest.approx({0: 50e-9, 1: 70e-9})
    assert two.busy_s == pytest.approx(90e-9)  # 10 .. 60, 120 .. 130, 170 .. 200
    assert max(two.busy_by_card.values()) <= two.busy_s < sum(two.busy_by_card.values())
    assert two.idle_pct == pytest.approx(55.0)
    flat = tr.from_events(SPANS, list(HOST), [(name, 0, s, d) for name, _, s, d in ops])
    assert (two.busy_s, two.gaps, two.device_ops) == (flat.busy_s, flat.gaps, flat.device_ops)
    assert two.gaps == [("request", 10e-9), ("aten::copy_", 60e-9),
                        ("cudaEventSynchronize", 40e-9)]


def _ctx(**work):
    ops = [("pk_select_kernel<1>", 0, 2_000_000), ("fold_parts_kernel", 0, 100_000),
           ("sm90_xmma_gemm_s8s8", 0, 3_000_000), ("packed_fractions_kernel<4, 2>", 0,
                                                      40_000_000),
           ("Memcpy DtoH (Device -> Pinned)", 0, 1_000_000)]
    trace = tr.Trace(window_s=0.01, busy_s=0.004, requests=1, device_ops=ops)
    return SimpleNamespace(trace=trace, work=work, config={}, traffic={})


def test_readers():
    ctx = _ctx(db_bytes=9.6e9, request_bytes=9.6e9, share_bytes=2.56e10, reply_bytes=4.96e8,
               int8_ops=1.0e13, packed_fractions_bound_s=0.0193)
    read = {m["name"]: mf.metric_reader(m["name"]).read(ctx) for m in M["per_layer"]}
    assert read["device_idle_pct"] == read["device_idle_pct.bulk"] == pytest.approx(60.0)
    assert read["device_idle_pct.b1"] == pytest.approx(60.0)
    assert read["kernels_roofline"] == pytest.approx(100 * 9.6e9 / HBM_BYTES_PER_S / 0.004)
    assert read["kernels_roofline.b1"] == read["kernels_roofline"]
    assert read["pk_select_roofline"] == pytest.approx(100 * 9.6e9 / HBM_BYTES_PER_S / 0.0021)
    assert read["share_dots_roofline"] == pytest.approx(100 * 2.56e10 / HBM_BYTES_PER_S / 0.003)
    assert read["scan_products_roofline"] == pytest.approx(100 * 1e13 / INT8_OPS / 0.003)
    assert read["packed_fractions_roofline"] == pytest.approx(100 * 0.0193 / 0.04)
    assert read["reply_copy_gbps"] == pytest.approx(4.96e8 / 0.001 / 1e9)
    empty = SimpleNamespace(trace=tr.Trace(0.01, 0.004, 1, []), work=ctx.work, config={},
                            traffic={})
    for name in ("pk_select_roofline", "share_dots_roofline", "scan_products_roofline",
                 "packed_fractions_roofline", "reply_copy_gbps"):
        assert mf.metric_reader(name).read(empty) is None


@pytest.mark.gpu
def test_four_cards_in_one_trace():
    """Products on each of four cards under the benchmark's profiler: the
    trace keeps each card's busy time, and the device's lies between the
    busiest card's and the sum."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    xs = [torch.ones(4096, 4096, device=f"cuda:{i}") for i in range(4)]
    for i, x in enumerate(xs):
        x @ x
        torch.cuda.synchronize(i)
    with tr.profiler() as prof:
        with torch.profiler.record_function(tr.SPAN):
            for _ in range(8):
                ys = [x @ x for x in xs]
            for i in range(4):
                torch.cuda.synchronize(i)
    t = tr.reduce(prof)
    print(f"busy_s {t.busy_s!r}, window_s {t.window_s!r}, by card {t.busy_by_card!r}")
    assert all(float(y[0, 0]) == 4096 for y in ys)
    assert sorted(t.busy_by_card) == [0, 1, 2, 3]
    assert max(t.busy_by_card.values()) <= t.busy_s <= sum(t.busy_by_card.values()) + 1e-12


@pytest.mark.gpu
def test_a_small_run_on_the_card():
    """The card's run of a small cell: correct, and its control not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from benchmark import control, harness

    small = {"config": {"entries": 20_000},
             "traffic": {"distinct_requests": 4, "db_clusters": [[1, 7], [1, 70]],
                         "compact_k": 32}}
    for w in [x["name"] for x in M["workloads"]]:
        run = harness.run_cell(w, 5, 1.0, True, "cuda", time.perf_counter(), overrides=small)
        assert run.correct, (w, run.checks)
        assert not control.control_run(w, 5, "cuda", overrides=small).correct
