"""The port's fused-regen probe kernels on the CPU: ``ops/gemm.py``
(``int8_gemm``, counterpart of scripts/mm_probe.py and mm_ktile_probe.py) and
``ops/keyed_dot.py`` (``keyed_share_dots``, counterpart of
scripts/fused_regen_probe.py), their plain versions against the JAX package
on the same numpy inputs, one case against the JAX probe kernel itself in
interpret mode, the operand layouts the CUDA kernels read, the wrappers'
device contract and the probe runner's CPU rehearsal. Every comparison is
exact (tolerance 0). The kernels themselves run in tests/test_torch_gpu.py
on a card.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.ops import chacha as jcha
from mpc_iris_tpu.ops import dot as jdot
from mpc_iris_tpu_torch.constants import BITS
from mpc_iris_tpu_torch.models.engines import KeyedShareEngine, _queries_to_natural_k
from mpc_iris_tpu_torch.ops import chacha as tcha
from mpc_iris_tpu_torch.ops import gemm as tgemm
from mpc_iris_tpu_torch.ops import keyed_dot as tkd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = bytes(range(32))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite's workers share the host's cores: torch's intra-op threads
    of several workers spin against each other on the plain ChaCha20's
    thousands of elementwise ops (a 0.5 s case took 70 s with six workers),
    so these tests run torch on one thread and restore the setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.cache
def _ternary(m: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed + m).integers(-1, 2, (m, BITS), dtype=np.int8)


@functools.cache
def _jax_planes_256(sid: int, row0: int):
    kw = jnp.asarray(jcha.key_words(KEY))
    return jcha.share_planes_natural(kw, sid, np.uint32(row0), 256)


def _jax_planes(sid: int, row0: int, n: int):
    """The JAX planes of rows [row0, row0 + n), n <= 256: a prefix of one
    256-row call (one compile of the JAX ChaCha20 for every case)."""
    return tuple(p[:n] for p in _jax_planes_256(sid, row0))


# ------------------------------------------------------------------ int8_gemm


@pytest.mark.parametrize("m", [8, 248])
@pytest.mark.parametrize("n", [64, 300])
def test_int8_gemm_reference_equals_jax_i4(m, n):
    """int4-range operands (the TPU probe's int4 family) through the JAX
    ``dot_bits_batch_i4`` and the port's plain product."""
    rng = np.random.default_rng(m * 1000 + n)
    q = rng.integers(-1, 2, (m, BITS), dtype=np.int8)
    db = rng.integers(-8, 8, (n, BITS), dtype=np.int8)
    want = np.asarray(jdot.dot_bits_batch_i4(jnp.asarray(q), jnp.asarray(db)))
    got = tgemm.int8_gemm_reference(torch.from_numpy(q), torch.from_numpy(db))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_gemm_full_range_and_cpu_contract():
    """The full int8 range at its extremes (|sum| up to 12,800 x 2^14)
    against numpy int64; a CPU tensor takes the plain version and launches
    nothing; bad operands raise."""
    rng = np.random.default_rng(11)
    q = rng.integers(-128, 128, (40, BITS), dtype=np.int8)
    db = rng.integers(-128, 128, (70, BITS), dtype=np.int8)
    q[0], db[0], db[1] = -128, -128, 127
    want = q.astype(np.int64) @ db.astype(np.int64).T
    before = tgemm.int8_gemm.launches
    got = tgemm.int8_gemm(torch.from_numpy(q), torch.from_numpy(db))
    assert tgemm.int8_gemm.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == BITS * 2**14
    with pytest.raises(TypeError):
        tgemm.int8_gemm(torch.from_numpy(q).int(), torch.from_numpy(db))
    with pytest.raises(ValueError):
        tgemm.int8_gemm(torch.from_numpy(q), torch.from_numpy(db[:, :128]))


def test_wgmma_slabs_layout():
    """Element (m, k) of the first operand lands where the keyed kernels'
    shared-memory descriptors read it: tile m // rows, K-step k // 32, 8-row
    group, 16-byte K half, row in the group, byte (no swizzle); rows past M
    zero. The rows are the keyed kernels' query tiles; int8_gemm's query
    tile (the plan's query_rows) covers M the same way."""
    rng = np.random.default_rng(5)
    q = rng.integers(-128, 128, (70, 256), dtype=np.int8)
    for rows in tgemm.QUERY_TILES:
        x = tgemm.wgmma_slabs(torch.from_numpy(q), rows).numpy()
        g = -(-70 // rows)
        assert x.shape == (g, 256 // 32, rows // 8, 2, 8, 16)
        m, k = np.meshgrid(np.arange(70), np.arange(256), indexing="ij")
        r = m % rows
        np.testing.assert_array_equal(
            x[m // rows, k // 32, r // 8, (k % 32) // 16, r % 8, k % 16], q)
        assert x.reshape(g * rows, -1).astype(np.int64).__abs__().sum() == np.abs(
            q.astype(np.int64)).sum()  # nothing else is nonzero
    assert [tgemm.gemm_plan(m, 1).query_rows for m in (1, 32, 33, 64, 65, 128, 129, 4096)] == [
        32, 32, 64, 64, 128, 128, 256, 256]


# (M, N): the keyed pass at B = 1 and 8 and the scan's B = 128 products over a
# 16,384-row chunk, every query tile's edge, a ragged DB edge, one DB row, a
# grid of several sweeps
@pytest.mark.parametrize("m,n", [(31, 16_384), (248, 16_384), (4_096, 16_384), (1, 1),
                                 (32, 129), (33, 16_383), (256, 1_000), (257, 513),
                                 (7_936, 300), (100, 1_000_000)])
def test_gemm_plan_covers_and_balances(m, n):
    """int8_gemm's plan: the smallest query tile of 32, 64, 128, 256 that
    holds M (M <= 256 is one tile: the kernel reads each DB row once), tiles
    covering every query and DB row (the ragged edge included, the TMA
    box zero-filling past it), a persistent grid of at most one block an SM
    that no tile outnumbers, and no SM carrying more DB rows than the best
    split of N over the SMs at wgmma's 64-row granularity allows, but for
    half a tile: at N = 16,384 that is 128 rows, so 128 blocks of 128 rows
    (M <= 256) leave no SM more to stream than 132 blocks would."""
    sms = tgemm.H100_SMS
    plan = tgemm.gemm_plan(m, n, sms)
    assert plan.query_rows == next((t for t in tgemm.QUERY_TILES if m <= t), 256)
    assert (plan.query_tiles == 1) == (m <= 256)
    assert (plan.query_tiles - 1) * plan.query_rows < m <= plan.query_tiles * plan.query_rows
    assert (plan.db_tiles - 1) * tgemm.DB_TILE < n <= plan.db_tiles * tgemm.DB_TILE
    assert plan.grid == min(plan.tiles, sms) and plan.sweeps * plan.grid >= plan.tiles
    if m <= 256:
        best = -(-n // (sms * 64)) * 64  # the busiest SM's DB rows at 64-row granularity
        assert plan.sweeps * tgemm.DB_TILE <= best + 64
    if (m, n) in ((31, 16_384), (248, 16_384)):
        assert plan.grid == 128 and plan.sweeps == 1  # every DB row read once, by one block
        assert plan.sweeps * tgemm.DB_TILE == -(-n // (sms * 64)) * 64 == 128
    if m == 4_096:
        assert plan.tiles == 2_048 and plan.sweeps == 16  # query tile fastest: 16 sweeps


# ----------------------------------------------------------- keyed_share_dots


@pytest.mark.parametrize("sid", [1, 0xFFFFFFFE])
@pytest.mark.parametrize("row0", [1792, 0xFFFFFFD0])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("m", [8, 31, 248])
def test_keyed_share_dots_reference_equals_jax(m, n, row0, sid):
    """The plain version against the JAX probe's own oracle
    (fused_regen_probe.py check(): share_planes_natural + dot_share_batch);
    at row0 0xFFFFFFD0 the u64 nonce carries mid-range."""
    q = _ternary(m)
    want = np.asarray(jdot.dot_share_batch(jnp.asarray(q), *_jax_planes(sid, row0, n)))
    got = tkd.keyed_share_dots_reference(torch.from_numpy(q), tcha.key_tensor(KEY, "cpu"),
                                         sid, row0, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy() & 0xFFFF, want.astype(np.int64))


def _load_probe():
    spec = importlib.util.spec_from_file_location(
        "fused_regen_probe", os.path.join(REPO, "scripts", "fused_regen_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keyed_share_dots_equals_jax_probe_kernel():
    """The TPU probe kernel itself (serial body, interpret mode) at its
    regression shape: row0 0xFFFFFFD0, the carry flipping mid-tile."""
    probe = _load_probe()
    m, n, row0, sid = 8, 64, 0xFFFFFFD0, 1
    fn = probe.make_kernel(m, n, tile_m=8, tile_n=64, tile_k=1600, regen_rows=32,
                           interleave=False, interpret=True)
    q = _ternary(m)
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(jcha.key_words(KEY)), sid,
                         np.uint32(row0)))
    for variant in tkd.VARIANTS:
        got = tkd.keyed_share_dots(torch.from_numpy(q), tcha.key_tensor(KEY, "cpu"), sid,
                                   row0, n, variant=variant)
        np.testing.assert_array_equal(got.numpy() & 0xFFFF, want.astype(np.int64))


def test_kernel_k_order_and_block_bytes():
    """What the fused kernel computes from, emulated: each ChaCha block's
    words become lo/hi K-steps by two byte permutes (bytes 0, 2 of a word
    pair; bytes 1, 3), offset -128, in the share file's K order; the query
    permuted from natural to that order gives the same dots."""
    kw = tcha.key_tensor(KEY, "cpu")
    n, row0, sid = 5, 0xFFFFFFFE, 7
    words = torch.stack(tcha._row_block_words(kw, sid, row0, n), dim=-1).numpy()  # [n, 400, 16]
    w = words.astype(np.uint32).view(np.uint8).reshape(n, 400, 8, 2, 4)  # word pair c, word, byte
    lo = w[..., [0, 2]].reshape(n, 400, 8, 4)  # x[2c].b0, .b2, x[2c+1].b0, .b2
    hi = w[..., [1, 3]].reshape(n, 400, 8, 4)
    lo = (lo.reshape(n, BITS) ^ 0x80).view(np.int8)
    hi = (hi.reshape(n, BITS) ^ 0x80).view(np.int8)
    file_u16 = tcha.share_rows(kw, sid, row0, n).numpy()
    np.testing.assert_array_equal(lo.astype(np.int64), (file_u16 & 0xFF) - 128)
    np.testing.assert_array_equal(hi.astype(np.int64), (file_u16 >> 8) - 128)
    q_nat = torch.from_numpy(_ternary(31))
    q_file = q_nat[:, tkd._file_order_index(torch.device("cpu"))].numpy().astype(np.int64)
    lo_nat, hi_nat = (p.numpy().astype(np.int64) for p in tcha.share_planes_natural(kw, sid,
                                                                                     row0, n))
    qn = q_nat.numpy().astype(np.int64)
    np.testing.assert_array_equal(q_file @ lo.astype(np.int64).T, qn @ lo_nat.T)
    np.testing.assert_array_equal(q_file @ hi.astype(np.int64).T, qn @ hi_nat.T)


def test_block_shape():
    assert [tkd.block_shape(m) for m in (1, 31, 32, 33, 64, 65, 128, 129, 248, 7936)] == [
        (2, 32), (2, 32), (2, 32), (2, 64), (2, 64), (2, 128), (2, 128), (1, 128), (1, 128),
        (1, 128)]


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_serial_shape_fills_the_card(b):
    """The serial kernel's blocks at B <= 8 (31 B query rows): one warpgroup
    and 32 DB rows a block, so a 16,384-row chunk launches 512 blocks (more
    than 2 x 132); the accumulator budget (lo and hi of 32 DB rows against
    the query tile, int32: 128 registers a thread at most, 64 KB a block at
    B = 8) leaves room for at least two blocks an SM, in registers and in
    shared memory."""
    m = 31 * b
    shape = tkd.serial_shape(m)
    assert tkd.serial_grid(m, 16_384) == 512 >= 2 * tgemm.H100_SMS
    assert shape.query_rows >= m and (shape.query_rows == 32 or 2 * m > shape.query_rows)
    # lo and hi of 32 DB rows against the query tile, int32, over 128 threads
    acc_bytes = 2 * tkd.SERIAL_DB_ROWS * shape.query_rows * 4
    assert shape.accumulators * 4 * tkd.SERIAL_THREADS == acc_bytes
    assert shape.accumulators <= 128
    state = 72 if shape.per_thread == 2 else 48
    regs = tkd.SERIAL_THREADS * (shape.accumulators + state)
    assert shape.blocks_per_sm >= 2 and shape.blocks_per_sm * regs <= tkd.REGISTERS_PER_SM
    assert 2 * (shape.smem + 1024) <= 233_472  # two blocks' shared memory (228 KB an SM)
    assert 400 % shape.steps == 0  # stages tile a row of 400 ChaCha blocks
    if b == 8:  # two blocks' accumulators are half the 256 KB register file
        assert (shape.query_rows, shape.per_thread, shape.buffers) == (256, 2, 1)
        assert 2 * acc_bytes == tkd.REGISTERS_PER_SM * 4 // 2
    if b == 1:
        assert (shape.query_rows, shape.per_thread, shape.buffers) == (32, 1, 2)


@pytest.mark.parametrize("m,rows", [(31, 32), (33, 64), (248, 256), (300, 256), (5, 128)])
def test_query_slabs_is_file_order_wgmma_slabs(m, rows):
    """The fused kernels' query operand by one pad and one gather equals
    wgmma_slabs of the query's columns in the share file's K order (rows
    past M zero, several tiles past one tile's rows)."""
    q = torch.from_numpy(_ternary(m))
    want = tgemm.wgmma_slabs(q[:, tkd._file_order_index(torch.device("cpu"))], rows)
    got = tkd.query_slabs(q, rows)
    assert got.shape == (-(-m // rows), rows * BITS)
    assert torch.equal(got.reshape(-1), want.reshape(-1))


def test_serial_stage_layout_is_wgmma_slabs():
    """Where the serial kernel stores a regenerated K-step (a mirror of its
    address arithmetic: thread row r's 16 bytes of a core matrix at
    (r / 8) x 256 + (r % 8) x 16, the K half 128 further, lo rows 0-31 and
    hi rows 32-63 of a 2,048-byte slab a K-step) is exactly wgmma_slabs's
    layout of the 64 rows [lo; hi] with one tile of 64 rows: the layout the
    kernel's A descriptors (LBO 128, SBO 256) read."""
    rng = np.random.default_rng(11)
    steps = 8
    lo = rng.integers(-128, 128, (32, steps * 32), dtype=np.int8)
    hi = rng.integers(-128, 128, (32, steps * 32), dtype=np.int8)
    stage = np.zeros(steps * 2048, dtype=np.int8)
    for r in range(32):
        cm = (r // 8) * 256 + (r % 8) * 16
        for s in range(steps):
            for plane, base in ((lo, 0), (hi, 4 * 256)):
                off = s * 2048 + base + cm
                stage[off:off + 16] = plane[r, s * 32:s * 32 + 16]
                stage[off + 128:off + 144] = plane[r, s * 32 + 16:s * 32 + 32]
    want = tgemm.wgmma_slabs(torch.from_numpy(np.concatenate([lo, hi])), 64).numpy()
    np.testing.assert_array_equal(stage, want.reshape(-1))


def test_keyed_share_dots_cpu_contract():
    """A CPU query takes the plain version for both variants and launches
    nothing; bad arguments raise."""
    q = torch.from_numpy(_ternary(31))
    kw = tcha.key_tensor(KEY, "cpu")
    before = dict(tkd.keyed_share_dots.launches)
    want = tkd.keyed_share_dots_reference(q, kw, 3, 100, 40)
    for variant in tkd.VARIANTS:
        assert torch.equal(tkd.keyed_share_dots(q, kw, 3, 100, 40, variant=variant), want)
    assert tkd.keyed_share_dots.launches == before
    with pytest.raises(ValueError):
        tkd.keyed_share_dots(q, kw, 3, 100, 40, variant="interleave")
    with pytest.raises(ValueError):
        tkd.keyed_share_dots(q.int(), kw, 3, 100, 40)
    with pytest.raises(ValueError):
        tkd.keyed_share_dots(q, kw.long(), 3, 100, 40)
    with pytest.raises(ValueError):
        tkd.keyed_share_dots(q, kw, 3, 2**32, 40)


def test_keyed_pass_families_equal_engine_fold():
    """Every family's keyed pass gives the checksum of
    KeyedShareEngine.fold_pass_fn on the same queries (ragged last chunk
    excluded: the engine folds whole chunks)."""
    count, chunk = 96, 32
    eng = KeyedShareEngine(KEY, 2, count, device="cpu", chunk=chunk, hbm_budget=0)
    q_enc = torch.from_numpy(_ternary(62).reshape(2, 31, BITS))
    want = int(eng.fold_pass_fn()(q_enc))
    q_nat = _queries_to_natural_k(q_enc).reshape(62, BITS)
    kw = tcha.key_tensor(KEY, "cpu")
    for family in tkd.FAMILIES:
        assert tkd.keyed_pass_checksum(family, q_nat, kw, 2, count, chunk) == want
    with pytest.raises(ValueError):
        tkd.share_dots_chunk("xla", q_nat, kw, 2, 0, chunk)


def test_probe_runner_cpu_rehearsal(tmp_path):
    """scripts/fused_mm_regen_probe_torch.py --device cpu at a tiny size:
    every family in its own process, every check passing, no times."""
    out = tmp_path / "matrix.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "fused_mm_regen_probe_torch.py"),
         "--device", "cpu", "--rows", "64", "--batches", "1", "--product-rows", "31",
         "--out", str(out)], capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})  # as one_torch_thread
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert [f["family"] for f in doc["families"]] == list(tkd.FAMILIES)
    for fam in doc["families"]:
        assert fam["outcome"] == "ok"
        kinds = [r["kind"] for r in fam["records"]]
        assert kinds.count("keyed-chunk") == 1
        assert kinds.count("product") == (fam["family"] in ("library", "gemm"))
        assert all(r["max_abs_err"] == 0 and "ms" not in r for r in fam["records"])
    assert "checksums agree across families: True" in proc.stdout


@pytest.mark.parametrize("script,argv", [
    ("probe_kernels_old_vs_new_torch.py", ["--old", "build/parent/mpc_iris_tpu_torch/csrc"]),
    ("probe_kernels_old_vs_new_torch.py", ["--old", "build/parent/mpc_iris_tpu_torch/csrc",
                                           "--kernels", "pk_dot"]),
    ("keyed_serial_variants_torch.py", []),
    ("b1_packed_variants_torch.py", []),
])
def test_card_scripts_refuse_the_cpu(script, argv):
    """The old-against-new and variant scripts import without jax and refuse
    to run without a card (they time nothing on the CPU); the source lines
    the serial-variant script patches are where it expects them."""
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", script), *argv],
                          capture_output=True, text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1 and "needs a CUDA card" in proc.stderr, proc.stderr
    assert "jax" not in proc.stderr
    if script == "keyed_serial_variants_torch.py":
        spec = importlib.util.spec_from_file_location("variants", os.path.join(REPO, "scripts",
                                                                              script))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with open(os.path.join(REPO, "mpc_iris_tpu_torch", "csrc", "keyed_share_dot.cu")) as f:
            cu = f.read()
        assert mod._PRODUCTS in cu and "#undef SERIAL" in cu
        assert all(tkd.serial_shape(31 * b).launch_args == shapes[0]
                   for b, shapes in mod.SHAPES.items())


def test_chip_smoke_probe_phase_on_cpu(monkeypatch):
    """chip_smoke.py's probe phase rehearsed on the CPU at a tiny size (the
    plain versions; no launches, no times): every check passes and it
    returns the three kernels' entries of the kernels line."""
    import chip_smoke
    from mpc_iris_tpu_torch.models.engines import PlaintextEngine
    from mpc_iris_tpu_torch.smoke_data import make_db

    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "KEYED_DB", 128)
    pat, msk, _, _, qpat, qmsk = make_db(np.random.default_rng(0), 256)
    packed = PlaintextEngine(pat, msk, device="cpu", storage="packed", chunk=64)
    entries = chip_smoke.probe_phase(torch.device("cpu"), packed, qpat, qmsk, "cpu")
    assert [e["name"] for e in entries] == [
        "int8_gemm", "keyed_share_dots_serial", "keyed_share_dots_pipelined"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert set(e) == keys and e["max_abs_err"] == 0 and e["bound_by"] in (
            "bytes", "operations")
        assert os.path.exists(os.path.join(REPO, e["source"]))
        for where in e["replaces"].split(", "):  # int8_gemm replaces g1-g3
            path, line = where.split(":")
            with open(os.path.join(REPO, path)) as f:
                assert "pallas_call" in f.read()
            assert int(line) > 0
    assert entries[0]["replaces"].count(", ") == 2
    assert entries[0]["library_ms"] is not None and entries[1]["library_ms"] is None
