"""The port's select compare-arithmetic probe kernels on the CPU
(``ops/select_probes.py``, counterpart of scripts/select_variants.py and
scripts/select_i16_probe.py): the plain versions against the JAX probe
kernels themselves, run in TPU interpret mode, on random inputs in the
probes' range, on inputs full of exact ties (where the keep-first pairing
decides the index), on the f32 disagreement pair and on an int16 wrap; the
wrappers' device contract; the two runners' CPU rehearsals. Every comparison
is exact (tolerance 0). The kernels themselves run in tests/test_torch_gpu.py
on a card.
"""

import functools
import importlib.util
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_iris_tpu_torch.ops import select_probes as sp
from mpc_iris_tpu_torch.smoke_data import tie_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 16, 4096  # two query tiles of 8 and two column tiles of 2,048


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


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _variants():
    return _load("select_variants")


@functools.cache
def _i16_probe():
    mod = _load("select_i16_probe")
    mod.B, mod.N = B, N  # the probe reads its shape from these module globals
    return mod


@functools.cache
def _inputs(kind: str):
    """numpy int32 dot, den [B*32, N]: ``random`` the probes' range (den, num
    uniform in [0, 12,800], num <= den); ``ties`` smoke_data.tie_case."""
    if kind == "ties":
        return tie_case(B, N)
    rng = np.random.default_rng(11)
    den = rng.integers(0, 12_801, (B * 32, N))
    num = np.minimum(rng.integers(0, 12_801, den.shape), den)
    return (den - 2 * num).astype(np.int32), den.astype(np.int32)


OFF = {"random": 5, "ties": 0}  # the column offset each input is run at


@functools.cache
def _jax_select_fn(compare: str, tile_n: int):
    """The probe's jitted select, made once a (compare, tile_n): one compile."""
    sel = {"i32": "sel_i32", "f32": "sel_f32", "f32_exact": "sel_f32_exact"}[compare]
    return _variants().make_select(getattr(_variants(), sel), tile_n=tile_n)


@functools.cache
def _jax_select(compare: str, kind: str, tile_n: int = 2048):
    """The JAX probe kernel's (n, d, idx) on ``_inputs(kind)``, once a case."""
    run = _jax_select_fn(compare, tile_n)
    dot, den = _inputs(kind)
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(x) for x in run(jnp.asarray(dot), jnp.asarray(den), OFF[kind])]


@functools.cache
def _jax_lanes_fn(i16_tree: bool):
    return _i16_probe().make(i16_tree)


def _jax_lanes(i16_tree: bool, dot16, den16):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(_jax_lanes_fn(i16_tree)(jnp.asarray(dot16), jnp.asarray(den16)))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("compare", sp.COMPARES)
def test_select_variant_equals_jax_probe(compare, kind):
    dot, den = _inputs(kind)
    want = _jax_select(compare, kind)
    got = sp.select_variant(torch.from_numpy(dot), torch.from_numpy(den), OFF[kind], compare)
    assert all(g.dtype == torch.int32 and g.shape == (B, 1) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_select_variant_tile_n_is_part_of_the_function():
    """Query 1 of the tie case holds 0/4 at column 129 and 0/2 at column 257
    (congruent mod 128): a tile of 2,048 keeps 257, whose keep-first tree
    pairs them with 257 first; a tile of 256 keeps 129 by the fold in tile
    order. On both packages alike."""
    dot, den = _inputs("ties")
    for tile_n, want in ((2048, (0, 2, 257)), (256, (0, 4, 129))):
        jax_out = _jax_select("i32", "ties", tile_n)
        got = sp.select_variant(torch.from_numpy(dot), torch.from_numpy(den), 0, "i32", tile_n)
        for g, w in zip(got, jax_out):
            np.testing.assert_array_equal(g.numpy(), w)
        assert tuple(int(x[1, 0]) for x in got) == want


def test_f32_disagreement_on_both_packages():
    """12,799/12,800 against 12,798/12,799: int32 products 163,814,401 and
    163,814,400, both 163,814,400 in float32, so f32 keeps the first
    (column 0) and the exact compares take the second (column 1,024)."""
    dot, den = _inputs("ties")
    for compare, want in (("i32", (12_798, 12_799, 1024)), ("f32", (12_799, 12_800, 0)),
                          ("f32_exact", (12_798, 12_799, 1024))):
        jax_out = tuple(int(x[0, 0]) for x in _jax_select(compare, "ties"))
        got = tuple(int(x[0, 0]) for x in sp.select_variant(torch.from_numpy(dot),
                                                              torch.from_numpy(den), 0, compare))
        assert jax_out == got == want, compare


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("i16_tree", [False, True])
def test_select_lanes_equals_jax_probe(i16_tree, kind):
    dot, den = (x.astype(np.int16) for x in _inputs(kind))
    want = _jax_lanes(i16_tree, dot, den)
    got = sp.select_lanes(torch.from_numpy(dot), torch.from_numpy(den), i16_tree)
    assert got.dtype == torch.int32 and got.shape == (B, 3 * sp.LANES)
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_lanes_int16_wrap_on_both_packages():
    """Outside the probe's domain (den - dot = 32,800 > 32,767) the int16
    tree's numerator wraps to -16,368 and wins its lane; the int32 tree's is
    16,400 and loses it."""
    dot = np.full((B * 32, N), 100, np.int16)
    den = np.full((B * 32, N), 12_800, np.int16)
    dot[5, 7] = -20_000
    out = {}
    for i16_tree in (False, True):
        got = sp.select_lanes(torch.from_numpy(dot), torch.from_numpy(den), i16_tree).numpy()
        np.testing.assert_array_equal(got, _jax_lanes(i16_tree, dot, den))
        out[i16_tree] = got[0, [7, 128 + 7, 256 + 7]].tolist()
    assert out == {False: [6_350, 12_800, 7], True: [-16_368, 12_800, 7]}


def test_select_probes_cpu_contract():
    """CPU tensors take the plain version and launch nothing; what the
    kernels do not take raises on every device."""
    dot, den = (torch.from_numpy(x) for x in _inputs("random"))
    before = dict(sp.select_variant.launches), dict(sp.select_lanes.launches)
    assert all(torch.equal(g, w) for g, w in zip(
        sp.select_variant(dot, den, 2, "f32_exact", 1024),
        sp.select_variant_reference(dot, den, 2, "f32_exact", 1024)))
    d16, e16 = dot.to(torch.int16), den.to(torch.int16)
    assert torch.equal(sp.select_lanes(d16, e16, True), sp.select_lanes_reference(d16, e16, True))
    assert (dict(sp.select_variant.launches), dict(sp.select_lanes.launches)) == before
    bad = [lambda: sp.select_variant(dot, den, 0, "f16"),
           lambda: sp.select_variant(dot[:32 * 4], den[:32 * 4]),     # B = 4: not a tile_b
           lambda: sp.select_variant(dot[:, :3072], den[:, :3072]),   # N % tile_n
           lambda: sp.select_variant(dot, den, 0, "i32", 384),         # not a power of two
           lambda: sp.select_variant(dot, den, 0, "i32", 4096),        # above 2,048
           lambda: sp.select_variant(d16, e16),                        # int16
           lambda: sp.select_lanes(dot, den),                          # int32
           lambda: sp.select_lanes(d16, e16[:, :2048])]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("script", ["select_variants_torch.py", "select_i16_probe_torch.py"])
def test_runner_cpu_rehearsal(script, monkeypatch, capsys):
    """Each runner at a small size on the CPU, run as ``__main__`` in this
    process: every wrapper equals its plain version and no time is printed
    (tests/test_torch_b1_probe.py runs all three runners in a process that
    imports no JAX)."""
    path = os.path.join(REPO, "scripts", script)
    monkeypatch.setattr(sys, "argv", [path, "--device", "cpu", "--b", "8", "--n", "4096"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(path, run_name="__main__")
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    assert "ms" not in out
    assert out.count("== plain version: True") == (3 if "variants" in script else 2)
