"""The port's streaming, morph and bisect probe kernels on the CPU
(``ops/stream_probes.py``, counterpart of scripts/dma_probe.py,
scripts/morph_probe.py and scripts/select_bisect.py): the plain versions
against the JAX probe kernels themselves, run in TPU interpret mode with the
probes' module constants set small, in every variant, stage and mode of the
probes' main, main2 and main3 (make3 reached through main3), on random inputs
in each probe's range and on inputs full of exact ties with a tile of zero
denominators; the probes' oddities pinned one by one; the wrappers' contract;
the three runners' CPU rehearsals; chip_smoke.py's phase on the CPU; and the
guard that every TPU kernel of the repo has its counterpart. Every comparison
is exact (tolerance 0). The kernels themselves run in tests/test_torch_gpu.py
on a card.
"""

import functools
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_iris_tpu_torch.ops import _build
from mpc_iris_tpu_torch.ops import stream_probes as sp
from mpc_iris_tpu_torch.ops.select_probes import select_variant_reference
from mpc_iris_tpu_torch.smoke_data import tie_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 512, 4096        # the stream probes: 16 queries, 2 x 2 blocks of (256, 2,048)
BB, BN = 16, 4096       # select_bisect: b queries x n columns, two tiles of 2,048


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread, as the other probe files (workers share the
    host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.cache
def _probe(name: str, rows: int = B, cols: int = N):
    """The probe module with its shape constants set (its grids read them
    when a kernel is made): one module, so one compile, a shape."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.N = rows, cols
    return mod


@functools.cache
def _inputs(kind: str, rows: int = B, cols: int = N):
    """numpy int32 dot, den [rows, cols]. ``random``: dma_probe.py's range
    (dot in [-100, 100), den in [0, 100)); ``bisect``: select_bisect.py's
    (dot in [-12,800, 12,800], den in [0, 12,800]); ``ties``:
    smoke_data.tie_case (denominators 1-4, many equal fractions, the
    congruent duplicates of query 1), with queries 2 and 3 given zero
    denominators and dot >= 0 over the whole first column tile, so that
    stage 3's v is <= 0 there and a later tile wins its fold."""
    rng = np.random.default_rng(rows + cols)
    if kind == "ties":
        dot, den = tie_case(rows // 32, cols)
        dot[64:128, :2048] = rng.integers(0, 100, (64, 2048))
        den[64:128, :2048] = 0
        return dot, den
    lo, hi = (-100, 100) if kind == "random" else (-12_800, 12_801)
    dot = rng.integers(lo, hi, (rows, cols)).astype(np.int32)
    den = rng.integers(0, hi, (rows, cols)).astype(np.int32)
    return dot, den


def _jax(run, *args):
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, run(*args))


def _equal(got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def _torch(dot, den):
    return torch.from_numpy(dot), torch.from_numpy(den)


# dma_probe.py's main, variant by variant: the probe's keywords, and the
# port's (den None for the one-input variant; prefetch and dimsem change no
# value, so those variants are dma_variant's defaults)
DMA = {
    "2in plain": ({}, {}),
    "1in plain": ({"two_inputs": False}, {"den": None}),
    "2in revisit": ({"revisit": True}, {"revisit": True}),
    "2in prefetch": ({"prefetch": True}, {}),
    "2in pre+revis": ({"prefetch": True, "revisit": True}, {"revisit": True}),
    "2in dimsem par": ({"dimsem": ("parallel", "arbitrary")}, {}),
    "2in arb+arb": ({"dimsem": ("arbitrary", "arbitrary")}, {}),
    "2in tile 512x4k": ({"tiles": (512, 4096)}, {"tiles": (512, 4096)}),
    "2in tile 1024x2k": ({"tiles": (1024, 2048)}, {"tiles": (1024, 2048)}),
}


def test_dma_table_is_the_probes_main():
    """The runners' and chip_smoke.py's variant table names main's nine."""
    assert [label for label, _, _ in sp.DMA_MAIN] == list(DMA)
    for label, two, kw in sp.DMA_MAIN:
        want = dict(DMA[label][1])
        assert two == ("den" not in want)
        want.pop("den", None)
        assert kw == want


@functools.cache
def _jax_dma(label: str, rows: int):
    return _probe("dma_probe", rows).variant(label, **DMA[label][0])[1]


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("label", list(DMA))
def test_dma_variant_equals_jax_probe(label, kind):
    rows = 1024 if label == "2in tile 1024x2k" else B
    dot, den = _inputs(kind, rows)
    want = _jax(_jax_dma(label, rows), jnp.asarray(dot), jnp.asarray(den))
    td, te = _torch(dot, den)
    kw = {"den": te, **DMA[label][1]}
    _equal(sp.dma_variant(td, **kw), want)


@functools.cache
def _jax_stage(stage: int):
    return _probe("morph_probe").make(stage)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("stage", sp.STAGES)
def test_morph_stage_equals_jax_probe(stage, kind):
    dot, den = _inputs(kind)
    want = _jax(_jax_stage(stage), jnp.asarray(dot), jnp.asarray(den))
    _equal(sp.morph_stage(*_torch(dot, den), stage), want)


def test_stage3_later_tile_wins_only_past_zero():
    """Stage 3's fold compares v2 v1 < v1 v2, never true: a later tile
    replaces the kept one only when the kept v <= 0 < its own. Queries 2 and
    3 of the tie inputs have v <= 0 in tile 0, so they take tile 1's v; the
    others keep tile 0's, however much smaller tile 1's is."""
    dot, den = _inputs("ties")
    v = ((den.astype(np.int64) - dot) >> 1) + den
    v = v.reshape(16, 32, 2, 2048).sum(1)[..., :128]  # [query, tile, lane]
    n, d, i = sp.morph_stage(*_torch(dot, den), 3)
    assert torch.equal(n, d) and torch.equal(n, i)
    assert (v[2:4, 0] <= 0).all() and (v[2:4, 1] > 0).all()
    np.testing.assert_array_equal(n[2:4].numpy(), v[2:4, 1])
    assert (v[4:, 0] > 0).all() and (v[4:, 1] < v[4:, 0]).any()
    np.testing.assert_array_equal(n[4:].numpy(), v[4:, 0])


# morph_probe.py's main2 (sp.MORPH2_MAIN), and make2 without scratch with
# compute at both widths, which main2 does not run
MORPH2 = [kw for _, kw in sp.MORPH2_MAIN] + [{"compute": True},
                                              {"compute": True, "out_lanes": 384}]


@functools.cache
def _jax_make2(i: int):
    return _probe("morph_probe").make2("x", **MORPH2[i])[1]


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("i", range(len(MORPH2)))
def test_morph2_equals_jax_probe(i, kind):
    dot, den = _inputs(kind)
    want = _jax(_jax_make2(i), jnp.asarray(dot), jnp.asarray(den))
    _equal(sp.morph2(*_torch(dot, den), **MORPH2[i]), want)


def test_morph2_without_scratch_holds_tile_0():
    """Without scratch only j = 0 writes: tile 0's trees, whatever tile 1
    holds."""
    dot, den = _inputs("random")
    td, te = _torch(dot, den)
    got = sp.morph2(td, te, compute=True, out_lanes=384)
    assert torch.equal(got, sp.morph2(td[:, :2048].contiguous(), te[:, :2048].contiguous(),
                                      compute=True, out_lanes=384))
    assert not torch.equal(got, sp.morph2(td, te, scratch=3, compute=True, out_lanes=384))


@functools.cache
def _main3():
    """morph_probe.py's main3 at (B, N) with timeit recording each timed
    function with its arguments and outputs: select_chunk, then make3 without
    and with the lane tree."""
    mod = _probe("morph_probe")
    calls = []

    def record(fn, *args, iters=5):
        with pltpu.force_tpu_interpret_mode():
            calls.append((fn, args, jax.tree.map(np.asarray, fn(*args))))
        return 1.0

    mod.timeit = record
    mod.main3()
    return calls


@pytest.mark.parametrize("lane_tree", [False, True])
def test_morph3_through_main3(lane_tree):
    """make3 is reachable only through main3: its kernel, recorded there, on
    main3's own inputs and on the tie inputs."""
    calls = _main3()
    assert len(calls) == 3 and len(calls[0][1]) == 3  # select_chunk(dot, den, 0) first
    run, (dot, den), want = calls[1 + lane_tree]
    _equal(sp.morph3(torch.from_numpy(np.array(dot)), torch.from_numpy(np.array(den)),
                     lane_tree), want)
    tdot, tden = _inputs("ties")
    _equal(sp.morph3(*_torch(tdot, tden), lane_tree), _jax(run, jnp.asarray(tdot),
                                                           jnp.asarray(tden)))


def test_morph3_lane_tree_is_index_aware():
    """With the lane tree every lane holds one winner, the lexicographic
    minimum over (fraction, index) of the 128 lane winners."""
    dot, den = _inputs("ties")
    td, te = _torch(dot, den)
    lanes = sp.morph3(td, te).reshape(16, 3, 128)
    tree = sp.morph3(td, te, lane_tree=True).reshape(16, 3, 128)
    assert torch.equal(tree, tree[..., :1].expand(-1, -1, 128))
    for q in range(16):
        n, d, i = (lanes[q, k].tolist() for k in range(3))
        valid = [(n[l] / d[l] if d[l] > 0 else float("inf"), i[l], l) for l in range(128)]
        best = min(valid)[2]
        assert tree[q, :, 0].tolist() == [n[best], d[best], i[best]]


@functools.cache
def _jax_bisect(mode: str, tile_b: int, tile_n: int):
    return _probe("select_bisect").make(mode, tile_b, tile_n)


@pytest.mark.parametrize("kind", ["bisect", "ties"])
@pytest.mark.parametrize("tiles", sp.BISECT_TILES)
@pytest.mark.parametrize("mode", sp.MODES)
def test_bisect_equals_jax_probe(mode, tiles, kind):
    dot, den = _inputs(kind, BB * 32, 2 * tiles[1])  # two column tiles
    off = 7 if kind == "bisect" else 0
    want = _jax(_jax_bisect(mode, *tiles), jnp.asarray(dot), jnp.asarray(den), off)
    _equal(sp.bisect(*_torch(dot, den), off, mode, *tiles), want)


def test_bisect_keeps_the_last_tile():
    """Every tile overwrites: ``full`` is s1's i32 select on the last tile
    alone, its index past (J - 1) tile_n + off; ``dma`` reads rows 0 ..
    tile_b - 1 of each block, not a row per query."""
    dot, den = _inputs("bisect", BB * 32, BN)
    td, te = _torch(dot, den)
    got = torch.stack(sp.bisect(td, te, 5, "full"))
    want = torch.stack(select_variant_reference(td[:, 2048:].contiguous(),
                                                te[:, 2048:].contiguous(), 5 + 2048, "i32"))
    assert torch.equal(got, want) and (got[2] >= 2048 + 5).all()
    n, d, i = sp.bisect(td, te, 0, "dma", 4)
    assert n[:, 0].tolist() == [int(dot[32 * 4 * (q // 4) + q % 4, 2048]
                                    + den[32 * 4 * (q // 4) + q % 4, 2048]) for q in range(BB)]
    assert not d.any() and not i.any()


def test_stream_probes_cpu_contract():
    """CPU tensors take the plain versions and launch nothing; what the
    kernels do not take raises on every device."""
    dot, den = (torch.from_numpy(x) for x in _inputs("random", 1024))
    before = [getattr(sp, p).launches for p in sp.PROBES]
    for _, kernel, plain in (sp.main_variants("dma_variant", dot, den)
                             + sp.main_variants("morph2", dot, den)):
        got, want = kernel(), plain()
        assert torch.equal(got, want)
    assert [getattr(sp, p).launches for p in sp.PROBES] == before
    bad = [lambda: sp.dma_variant(dot.to(torch.int16), den.to(torch.int16)),
           lambda: sp.dma_variant(dot, den[:256]),                      # shapes differ
           lambda: sp.dma_variant(dot, den, tiles=(8, 2048)),           # not whole queries
           lambda: sp.dma_variant(dot, den, tiles=(256, 1024)),         # not a tile of 2,048+
           lambda: sp.dma_variant(dot[:, :3072], den[:, :3072]),        # N % tn
           lambda: sp.dma_variant(dot, den, tiles=(2048, 2048)),        # B % tb
           lambda: sp.morph_stage(dot, den, 6),
           lambda: sp.morph_stage(dot, None, 0),                        # den is not optional
           lambda: sp.morph2(dot, den, scratch=1),
           lambda: sp.morph2(dot, den, out_lanes=256),
           lambda: sp.morph3(dot[:, :2048 + 128], den[:, :2048 + 128]),
           lambda: sp.bisect(dot, den, 0, "rows"),
           lambda: sp.bisect(dot, den, 0, "full", 3),                   # b % tile_b
           lambda: sp.bisect(dot, den, 0, "full", 64),                  # past a slab
           lambda: sp.bisect(dot, den, 0, "full", 8, 16384)]            # above 8,192
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_c_signatures_match_the_build():
    """Every exported C launch function of csrc/*.cu is bound in
    _build._SIGNATURES with as many arguments: the library is built only on
    the card, so this is the check a CPU can make."""
    exported = {}
    for path in _build.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            exported[name] = len([p for p in params.split(",") if p.strip()])
    assert {"stream_probe_launch", "probe_trees_launch", "probe_fold_launch"} <= set(exported)
    assert set(exported) == set(_build._SIGNATURES)
    for name, count in exported.items():
        assert len(_build._SIGNATURES[name][0]) == count, name


RUNNERS = (("dma_probe_torch.py", "--device", "cpu", "--b", "1024", "--n", "4096"),
           ("morph_probe_torch.py", "--device", "cpu", "--part", "all", "--b", "512",
            "--n", "4096"),
           ("select_bisect_torch.py", "--device", "cpu", "--b", "8", "--n", "16384"))


def test_runners_cpu_rehearsal():
    """The three runners at a small size on the CPU, in one process that
    imports nothing of JAX or of the JAX package: every variant equals its
    plain version, no time is printed; a shape the kernels do not take
    exits 2."""
    runs = [(argv, 0) for argv in RUNNERS] + [(RUNNERS[0][:-1] + ("3000",), 2)]
    code = ("import runpy, sys\n"
            f"for argv, rc in {runs!r}:\n"
            f"    sys.argv = [{os.path.join(REPO, 'scripts')!r} + '/' + argv[0], *argv[1:]]\n"
            "    try:\n"
            "        runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == rc, (argv, e.code)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mpc_iris_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("== plain version: True") == 9 + 6 + 5 + 2 + 10
    assert "False" not in proc.stdout and " ms" not in proc.stdout
    assert "must divide" in proc.stderr


def test_chip_smoke_stream_probe_phase_on_cpu(monkeypatch):
    """chip_smoke.py's stream probe phase rehearsed on the CPU at a small
    size (the plain versions; no launches, no times): every check passes and
    it returns the five functions' entries of the kernels line."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "STREAM_SHAPE", (1024, 4096))
    monkeypatch.setattr(chip_smoke, "BISECT_SHAPE", (8, 16384))
    entries = chip_smoke.stream_probe_phase(torch.device("cpu"), 0, "cpu")
    assert [e["name"] for e in entries] == list(sp.PROBES)
    assert [e["replaces"] for e in entries] == [
        "scripts/dma_probe.py:27", "scripts/morph_probe.py:28", "scripts/morph_probe.py:170",
        "scripts/morph_probe.py:305", "scripts/select_bisect.py:24"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert set(e) == keys and e["max_abs_err"] == 0 and e["library_ms"] is None
        assert e["source"] == "mpc_iris_tpu_torch/csrc/stream_probes.cu"
        assert e["bound_by"] == "bytes"


def _pallas_sites():
    """(file, line) of every pl.pallas_call in the JAX package and the
    probe scripts."""
    sites = []
    paths = [os.path.join(root, f) for root, _, files in os.walk(os.path.join(REPO, "mpc_iris_tpu"))
             for f in files if f.endswith(".py")]
    paths += [os.path.join(REPO, "scripts", f) for f in os.listdir(os.path.join(REPO, "scripts"))
              if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for k, line in enumerate(f, 1):
                if "pallas_call(" in line and not line.lstrip().startswith("#"):
                    sites.append((os.path.relpath(path, REPO), k))
    return sorted(sites)


def test_every_tpu_kernel_has_a_hopper_counterpart():
    """The guard: every file that reaches pl.pallas_call (18 sites) is named
    by a "replaces" of chip_smoke.py's kernels line, each such line a def in
    its file, kernel (c)'s two routes (the int8 kernel and, for a group of
    one query, pk_fractions) each have an entry, and PERF.md's kernel table
    has no row left to port."""
    sites = _pallas_sites()
    assert len(sites) == 18, sites
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    for name, source in (("fractions_packed_small_b", "packed_fractions.cu"),
                         ("pk_fractions", "b1_packed.cu")):
        entry = smoke[smoke.index(f'{{"name": "{name}"'):][:300]
        assert f"mpc_iris_tpu_torch/csrc/{source}" in entry, entry
        assert '"replaces": "mpc_iris_tpu/ops/packed_match.py:227"' in entry, entry
    replaces = set(re.findall(r"((?:scripts|mpc_iris_tpu)/[\w/]+\.py):(\d+)", smoke))
    missing = {path for path, _ in sites} - {path for path, _ in replaces}
    assert not missing, f"TPU kernels with no Hopper counterpart in chip_smoke.py: {missing}"
    for path, line in replaces:
        with open(os.path.join(REPO, path)) as f:
            assert "def " in f.read().splitlines()[int(line) - 1], (path, line)
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    table = perf[perf.index("## 6. Findings"):perf.index("## 7. Open questions")]
    rows = [r for r in table.splitlines() if r.startswith("| ")]
    assert len(rows) > 2
    assert not [r for r in rows if "to port" in r], "PERF.md §6 still lists a kernel to port"
