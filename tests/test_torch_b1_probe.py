"""The port's B = 1 packed-dot probe kernels on the CPU (``ops/b1_packed.py``,
counterpart of scripts/b1_kernel_probe.py): ``prep_query`` against the
probe's, the plain versions of pk-dot and pk-select against the JAX probe
kernels themselves in interpret mode, the pk-dot epilogue against the
probe's on crafted rotation and index ties (where pk-dot and pk-select
differ), the kernels' query layout, the wrappers' device contract, the
runner's CPU check and chip_smoke.py's phase rehearsed on the CPU. Every
comparison is exact (tolerance 0). The kernels themselves run in
tests/test_torch_gpu.py on a card.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.ops.decode import fraction_argmin, fraction_min_rotations
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES, N_ROTATIONS
from mpc_iris_tpu_torch.ops import b1_packed as bp
from mpc_iris_tpu_torch.ops.packed_match import _query_tiles
from mpc_iris_tpu_torch.ops.scan import _match_scan_packed, prepare_query_planes
from mpc_iris_tpu_torch.ops.select import select_chunk_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def _probe():
    spec = importlib.util.spec_from_file_location(
        "b1_kernel_probe", os.path.join(REPO, "scripts", "b1_kernel_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _db(n: int, seed: int):
    """Random packed DB [n, 1600] x2; the query a copy of entry 17 (the
    probe's planted self-match), its duplicate at n - 3 (a later index)."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    pat[n - 3], msk[n - 3] = pat[17], msk[17]
    return pat, msk, pat[17:18].copy(), msk[17:18].copy()


def _torch_args(n: int, seed: int):
    pat, msk, qpat, qmsk = _db(n, seed)
    qe, qm = bp.prep_query(torch.from_numpy(qpat), torch.from_numpy(qmsk))
    return qe, qm, torch.from_numpy(pat), torch.from_numpy(msk)


@functools.cache
def _jax_fn(variant: str, n: int):
    """The probe's jitted function, made once a shape (one compile)."""
    make = _probe().make_pk_dot if variant == "pk-dot" else _probe().make_pk_select
    return make(n, 512, interpret=True)


def _jax_run(variant: str, n: int, seed: int):
    pat, msk, qpat, qmsk = _db(n, seed)
    qe, qm = _probe().prep_query(qpat, qmsk)
    return np.asarray(_jax_fn(variant, n)(qe, qm, jnp.asarray(pat), jnp.asarray(msk)))


@jax.jit
def _jax_products(qe, qm, pat, msk):
    """The probe's own unpack (``_unpack_planes``) and slab dots over a whole
    DB, packed as its pk-dot kernel packs them."""
    pat32, msk32 = pat.astype(jnp.int32), msk.astype(jnp.int32)
    dot = den = 0
    for b in range(8):
        enc_b, m_b = _probe()._unpack_planes(pat32, msk32, b)
        ks = slice(b * BITS_BYTES, (b + 1) * BITS_BYTES)
        dot = dot + jax.lax.dot_general(qe[:, ks], enc_b, _probe().DIMS,
                                        preferred_element_type=jnp.int32)
        den = den + jax.lax.dot_general(qm[:, ks], m_b, _probe().DIMS,
                                        preferred_element_type=jnp.int32)
    return ((den - dot) >> 1) | (den << 16)


def test_bitplane_perm_equals_probe():
    np.testing.assert_array_equal(bp.bitplane_perm(), _probe().bitplane_perm())


@pytest.mark.parametrize("seed", [1, 2])
def test_prep_query_equals_probe(seed):
    _, _, qpat, qmsk = _db(1024, seed)
    qmsk = qmsk.copy()
    qmsk[0, :100] = 0  # masked bytes: zero columns of the encoding there
    want = _probe().prep_query(qpat, qmsk)
    got = bp.prep_query(torch.from_numpy(qpat), torch.from_numpy(qmsk))
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 and g.shape == (32, BITS)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,seed", [(1024, 1), (1024, 5)])
def test_pk_dot_reference_equals_jax_probe(n, seed):
    """The probe's pk-dot (kernel in interpret mode and its XLA epilogue)
    against pk_dot_reference and pk_dot_winner; the packed products against
    the probe's own unpack (``_unpack_planes``) and slab dots on jnp."""
    args = _torch_args(n, seed)
    packed = bp.pk_dot_reference(*args)
    assert packed.dtype == torch.int32 and packed.shape == (32, n)
    np.testing.assert_array_equal(bp.pk_dot_winner(packed).numpy(), _jax_run("pk-dot", n, seed))
    pat, msk, qpat, qmsk = _db(n, seed)
    want = _jax_products(*_probe().prep_query(qpat, qmsk), jnp.asarray(pat), jnp.asarray(msk))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,seed", [(1024, 1), (1024, 5)])
def test_pk_select_reference_equals_jax_probe(n, seed):
    want = _jax_run("pk-select", n, seed)
    got = bp.pk_select_reference(*_torch_args(n, seed))
    assert got.dtype == torch.int32 and got.shape == (3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[2, 0]) == 17 and int(got[0, 0]) == 0  # the self-match, not its duplicate


@jax.jit
def _jax_epilogue(out):
    """The probe's epilogue of make_pk_dot (b1_kernel_probe.py:129-139)."""
    num = (out & 0xFFFF)[None, :N_ROTATIONS]
    den = jax.lax.shift_right_logical(out, 16)[None, :N_ROTATIONS]
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)
    n_c, d_c, i_c = fraction_argmin(n_r, d_r, axis=-1, index_offset=jnp.int32(0))
    return jnp.stack([n_c, d_c, i_c])


def _crafted(seed: int):
    """num, den [32, 300]: every fraction above 3/4, row 31 (the dummy) 0/0."""
    den = np.random.default_rng(seed).integers(100, 12_801, (32, 300))
    num = (den * 3 + 3) // 4
    den[31] = num[31] = 0
    return num, den


def _both_epilogues(num, den):
    packed = (num | (den << 16)).astype(np.int32)
    return (np.asarray(_jax_epilogue(jnp.asarray(packed))),
            bp.pk_dot_winner(torch.from_numpy(packed)).numpy())


def test_pk_dot_winner_rotation_tie_differs_from_pk_select():
    """Entry 2: rotation 1 (position 16) holds 1/2, rotation 2 (position 8)
    holds 2/4, every other place more. The probe's epilogue keeps the lowest
    POSITION: (2, 4); pk-select's earliest-rotation rule gives (1, 2). Index
    and fraction agree."""
    num, den = _crafted(4)
    num[16, 2], den[16, 2] = 1, 2
    num[8, 2], den[8, 2] = 2, 4
    for got in _both_epilogues(num, den):
        np.testing.assert_array_equal(got, [[2], [4], [2]])
    # pk-select's selection on the same products (rows in the bit-reversed feed)
    dot = torch.from_numpy((den - 2 * num).astype(np.int32))
    got = torch.stack(select_chunk_reference(dot, torch.from_numpy(den.astype(np.int32))))
    np.testing.assert_array_equal(got.numpy(), [[1], [2], [2]])


def test_pk_dot_winner_index_ties():
    """Equal fractions at entries 129 and 257 (as different pairs, at
    different positions) and an all-invalid entry 0: the lowest index wins,
    with its own lowest position's pair."""
    num, den = _crafted(6)
    num[:, 0] = den[:, 0] = 0
    num[20, 129], den[20, 129] = 3, 9
    num[4, 129], den[4, 129] = 2, 6
    num[1, 257], den[1, 257] = 1, 3
    for got in _both_epilogues(num, den):
        np.testing.assert_array_equal(got, [[2], [6], [129]])


def test_query_slabs_are_kernel_b_tiles():
    """The kernels' query operand: with the rows put back in rotation order
    it is kernel (b)'s operand of a group of one (_query_tiles)."""
    _, _, qpat, qmsk = _db(1024, 3)
    qp, qm = torch.from_numpy(qpat), torch.from_numpy(qmsk)
    qe, qmk = bp.prep_query(qp, qm)
    rev = torch.as_tensor(bp.ROT_BITREV)
    assert torch.equal(bp._query_slabs(qe[rev], qmk[rev]),
                       _query_tiles(*prepare_query_planes(qp, qm), 1)[0])


def test_pk_wrappers_cpu_contract():
    """CPU tensors take the plain versions and launch nothing; both equal the
    unfused packed scan (the probe's --check); bad arguments raise."""
    qe, qm, pat, msk = _torch_args(1024, 1)
    before = bp.pk_dot.launches, bp.pk_select.launches
    want = _match_scan_packed(*prepare_query_planes(*(torch.from_numpy(x) for x in
                                                      _db(1024, 1)[2:])),
                              pat.reshape(2, 512, BITS_BYTES), msk.reshape(2, 512, BITS_BYTES),
                              fused=False)
    assert torch.equal(bp.pk_dot(qe, qm, pat, msk), bp.pk_dot_reference(qe, qm, pat, msk))
    assert torch.equal(bp.pk_dot_winner(bp.pk_dot(qe, qm, pat, msk)), want)
    assert torch.equal(bp.pk_select(qe, qm, pat, msk), want)
    assert (bp.pk_dot.launches, bp.pk_select.launches) == before
    bad = [lambda f: f(qe[:31], qm[:31], pat, msk),                # not 32 rows
           lambda f: f(qe.int(), qm.int(), pat, msk),              # not int8
           lambda f: f(qe, qm, pat[:, :800], msk[:, :800]),        # not 1,600 bytes
           lambda f: f(qe, qm, pat, msk[:512]),                    # shapes differ
           lambda f: f(qe, qm, pat[:0], msk[:0])]                  # no entries
    for fn in (bp.pk_dot, bp.pk_select):
        for call in bad:
            with pytest.raises(ValueError):
                call(fn)


RUNNERS = (("b1_kernel_probe_torch.py", "--check", "--device", "cpu"),
           ("select_variants_torch.py", "--device", "cpu", "--b", "8", "--n", "2048"),
           ("select_i16_probe_torch.py", "--device", "cpu", "--b", "8", "--n", "2048"))


def test_runner_check_on_cpu():
    """scripts/b1_kernel_probe_torch.py --check --device cpu (both variants
    equal the unfused scan), then the two select runners' CPU rehearsals, in
    one process that imports nothing of JAX or of the JAX package; a
    --tile-n that does not divide --db is refused (exit 2), as the probe's
    grid rule."""
    runs = [(argv, 0) for argv in RUNNERS] + [(RUNNERS[0] + ("--db", "1000"), 2)]
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
    assert proc.stdout.count("== _match_scan_packed (unfused) on cpu [winner idx 17]") == 2
    assert proc.stdout.count("wrapper == plain version: True") == 5
    assert "--tile-n 512 must divide --db 1000" in proc.stderr


def test_chip_smoke_b1_select_probe_phase_on_cpu(monkeypatch):
    """chip_smoke.py's b1 and select probe phase rehearsed on the CPU at a
    tiny size (the plain versions; no launches, no times): every check passes
    and it returns the seven kernels' entries of the kernels line."""
    import chip_smoke
    from mpc_iris_tpu_torch.models.engines import PlaintextEngine
    from mpc_iris_tpu_torch.smoke_data import make_db

    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: (fn(), 1.0)[1])
    for name, value in (("S1_SHAPE", (8, 2048)), ("S2_SHAPE", (8, 2048)),
                        ("TIE_SHAPE", (8, 4096))):
        monkeypatch.setattr(chip_smoke, name, value)
    pat, msk, _, _, qpat, qmsk = make_db(np.random.default_rng(0), 1024)
    packed = PlaintextEngine(pat, msk, device="cpu", storage="packed", chunk=256)
    entries = chip_smoke.b1_select_probe_phase(torch.device("cpu"), packed, qpat, qmsk, 0, "cpu")
    assert [e["name"] for e in entries] == [
        "pk_dot", "pk_select", "select_variant_i32", "select_variant_f32",
        "select_variant_f32_exact", "select_lanes_i32", "select_lanes_i16"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert set(e) == keys and e["max_abs_err"] == 0 and e["library_ms"] is None
        assert e["bound_by"] in ("bytes", "operations")
        assert os.path.exists(os.path.join(REPO, e["source"]))
        path, line = e["replaces"].split(":")
        with open(os.path.join(REPO, path)) as f:
            assert "pallas_call" in f.read()
        assert int(line) > 0
