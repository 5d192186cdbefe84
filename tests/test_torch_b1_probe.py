"""The port's B = 1 packed-dot probe kernels on the CPU (``ops/b1_packed.py``,
counterpart of scripts/b1_kernel_probe.py): ``prep_query`` against the
probe's, the plain versions of pk-dot and pk-select against the JAX probe
kernels themselves in interpret mode, the pk-dot epilogue against the
probe's on crafted rotation and index ties (where pk-dot and pk-select
differ), the kernels' query layout, the wrappers' device contract, the
runner's CPU check and chip_smoke.py's phase rehearsed on the CPU; and the
algebra of pk-dot's kernel (csrc/b1_packed.cu, binary: the four
AND-popcount products of the packed operand's rows against the DB's mask
and pattern-and-mask bits) and of the int8 design that
scripts/b1_packed_variants_torch.py times beside it (its query rows against
the mask bits and the pattern-and-mask bits times -2) through
``torch._int_mm``, their operand layouts index by index, and the
accumulator registers each thread holds. Every comparison is exact (tolerance 0). The kernels themselves run
in tests/test_torch_gpu.py on a card.
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
from mpc_iris_tpu_torch.ops.packed_match import _query_tiles, planted_packed_case
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
def _variants():
    """scripts/b1_packed_variants_torch.py, the int8 design's operand layout."""
    spec = importlib.util.spec_from_file_location(
        "b1_packed_variants_torch", os.path.join(REPO, "scripts", "b1_packed_variants_torch.py"))
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


@functools.cache
def _old_vs_new():
    """scripts/probe_kernels_old_vs_new_torch.py, whose old pk-select and
    pk-dot take kernel (b)'s query layout."""
    spec = importlib.util.spec_from_file_location(
        "probe_kernels_old_vs_new_torch",
        os.path.join(REPO, "scripts", "probe_kernels_old_vs_new_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_query_slabs_are_kernel_b_tiles():
    """The old-vs-new runner's query operand of the int8 designs: with the
    rows put back in rotation order it is kernel (b)'s operand of a group of
    one (_query_tiles)."""
    _, _, qpat, qmsk = _db(1024, 3)
    qp, qm = torch.from_numpy(qpat), torch.from_numpy(qmsk)
    qe, qmk = bp.prep_query(qp, qm)
    rev = torch.as_tensor(bp.ROT_BITREV)
    assert torch.equal(_old_vs_new()._query_slabs(qe[rev], qmk[rev]),
                       _query_tiles(*prepare_query_planes(qp, qm), 1)[0])


def _mirror_int8(qe, qm, pat, msk):
    """The int8 design's algebra on the CPU: the stacked query rows [A1 | A2]
    of the runner's dot_den_rows against [m | -2 (p & m)] (K bit-plane-major) in one
    exact int8 product, then the epilogue reading dot(p) from row 16w + g and
    den(p) from row 16w + 8 + g, p = 8w + g."""
    enc, m = bp._unpack_bitplane_major(pat, msk)
    a = torch.cat(_variants().dot_den_rows(qe, qm), dim=1)            # [64, 2K]
    d = torch._int_mm(a, torch.cat([m, enc - m], dim=1).T)   # enc - m = -2 (p & m)
    rows = d.view(4, 2, 8, pat.shape[0])                     # w, dot|den, g, entry
    dot, den = rows[:, 0].reshape(32, -1), rows[:, 1].reshape(32, -1)
    return ((den - dot) >> 1) | (den << 16)


def _bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [R, 1600] -> int8 0/1 [R, 12,800], bit b of byte j at 8 j + b:
    any order serves, the same on both sides of a product."""
    shifts = torch.arange(8, dtype=torch.uint8)
    return ((packed.unsqueeze(-1) >> shifts) & 1).reshape(packed.shape[0], -1).to(torch.int8)


def _mirror_b1(qe, qm, pat, msk):
    """pk_dot's kernel's algebra on the CPU: the operand's 64 rows (mask
    bits, pattern-and-mask bits of each position) against the DB's columns
    (mask bits, pattern-and-mask bits of each entry), the AND-popcounts as
    an exact 0/1 int8 product; then den = mq . md and num = mq . pmd +
    pmq . md - 2 pmq . pmd."""
    a = _bits(bp.pk_dot_operand(qe, qm)[:, :BITS_BYTES])
    cols = torch.stack([_bits(msk), _bits(pat & msk)], dim=1).reshape(-1, BITS)
    d = torch._int_mm(a, cols.T).view(2, 32, -1, 2)        # mq|pmq, p, entry, md|pmd
    den = d[0, :, :, 0]
    return (d[0, :, :, 1] + d[1, :, :, 0] - 2 * d[1, :, :, 1]) | (den << 16)


def _mirror_case(kind: str, n: int):
    """(qe, qm, pat, msk): random planes with an all-masked entry (den = 0)
    and an all-set one; planted_packed_case's rotation ties, duplicates at
    129 and 257 and all-invalid entry against its query 0; or _db's index
    tie (the query at 17 and n - 3)."""
    if kind == "index-tie":
        return _torch_args(n, 2)
    if kind == "planted":
        pat, msk, qpat, qmsk = planted_packed_case(np.random.default_rng(8), n=n, b=1)
    else:
        rng = np.random.default_rng(n)
        pat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
        msk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
        qpat, qmsk = pat[:1].copy(), msk[:1].copy()
        qpat ^= rng.integers(0, 256, qpat.shape, dtype=np.uint8) & 0x11
        msk[0] = 0
        pat[-1] = msk[-1] = 255
    qe, qm = bp.prep_query(torch.from_numpy(qpat), torch.from_numpy(qmsk))
    return qe, qm, torch.from_numpy(pat), torch.from_numpy(msk)


@pytest.mark.parametrize("design", ["b1", "int8"])
@pytest.mark.parametrize("kind,n", [("random", 1), ("random", 255), ("random", 257),
                                    ("random", 1500), ("planted", 700), ("index-tie", 1024)])
def test_pk_dot_kernel_algebra_equals_reference(design, kind, n):
    args = _mirror_case(kind, n)
    want = bp.pk_dot_reference(*args)
    assert torch.equal((_mirror_b1 if design == "b1" else _mirror_int8)(*args), want)
    if n > 1:
        assert int((want >> 16).min()) == 0  # den = 0: the all-masked entry or the dummy row


def test_pk_dot_int8_mirror_any_int8_query():
    """The int8 design is exact for any int8 query rows, not only
    prep_query's {-1, 0, 1} and {0, 1}: A2 repeats qe and the -2 sits on the
    DB side. pk_dot's binary kernel refuses such a query."""
    qe, qm, pat, msk = _mirror_case("random", 64)
    rng = np.random.default_rng(3)
    qe = torch.from_numpy(rng.integers(-128, 128, qe.shape, dtype=np.int8))
    qm = torch.from_numpy(rng.integers(-128, 128, qm.shape, dtype=np.int8))
    assert torch.equal(_mirror_int8(qe, qm, pat, msk), bp.pk_dot_reference(qe, qm, pat, msk))
    good = _mirror_case("random", 64)[:2]
    assert bool(bp.bit_valued(*good))
    for bad in ((qe, qm), (good[0], 2 * good[1]), (-good[0].abs(), good[1] - 1),
                (good[0], 1 - good[1]), (good[0].clone().fill_(-128), good[1])):
        assert not bool(bp.bit_valued(*bad))


def test_pk_dot_operand_layout():
    """pk_dot_operand element by element: byte j of row p holds, at bit b,
    qm(p) at K = b * 1600 + j, byte j of row 32 + p whether qe(p) is -1 there;
    the 32 bytes past 1600 are zero."""
    qe, qm = _mirror_case("planted", 300)[:2]
    got = bp.pk_dot_operand(qe, qm).numpy()
    assert got.shape == (64, bp.Q_ROW) and not got[:, BITS_BYTES:].any()
    row, j, b = np.indices((64, BITS_BYTES, 8), sparse=True)
    src = np.where(row < 32, qm.numpy()[row % 32, b * BITS_BYTES + j],
                   qe.numpy()[row % 32, b * BITS_BYTES + j] == -1)
    np.testing.assert_array_equal((got[:, :BITS_BYTES, None] >> np.arange(8)) & 1, src)


def test_pk_dot_int8_operand_layout():
    """The runner's int8_operand element by element: [jj, b, A, row group, half, row,
    byte] holds row 8 * group + row of A1 or A2 at K = b * 1600 + jj * 32 +
    16 * half + byte, where row 16w + g is qe(8w + g), row 16w + 8 + g is
    qm(8w + g) in A1 and 0 in A2."""
    rng = np.random.default_rng(11)
    qe = rng.integers(-128, 128, (32, BITS), dtype=np.int8)
    qm = rng.integers(-128, 128, (32, BITS), dtype=np.int8)
    got = _variants().int8_operand(torch.from_numpy(qe), torch.from_numpy(qm)).numpy()
    assert got.shape == (50, 8, 2, 8, 2, 8, 16)
    jj, b, which, grp, half, r, byte = np.indices(got.shape, sparse=True)
    row = 8 * grp + r
    w, den_row, g = row // 16, (row // 8) % 2, row % 8
    k = b * 1600 + jj * 32 + 16 * half + byte
    want = np.where(den_row == 1, np.where(which == 0, qm[8 * w + g, k], 0), qe[8 * w + g, k])
    np.testing.assert_array_equal(got, want)


def test_b1_accumulators_hold_the_four_products():
    """mma.sync m16n8k256's int32 accumulator gives lane 4g + t the rows g,
    g + 8 and columns 2t, 2t + 1 of a 16 x 8 tile. In pk_dot's kernel
    m-tile mt's row g is operand row 8 mt + g (mask bits of position 8 mt +
    g) and row g + 8 operand row 32 + 8 mt + g (its pattern-and-mask bits);
    B column c is entry c // 2 of the n-tile, mask bits for even c and
    pattern-and-mask bits for odd c. So lane 4g + t holds den, mq . pmd,
    pmq . md and pmq . pmd of one (position, entry), and the 32 lanes of the
    4 m-tiles hold each (position, entry of the n-tile) once."""
    seen = {}
    for mt in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            regs = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
            a_rows = [8 * mt + r if r < 8 else 32 + 8 * mt + r - 8 for r, _ in regs]
            kinds = [(row // 32, c % 2) for row, (_, c) in zip(a_rows, regs)]
            assert kinds == [(0, 0), (0, 1), (1, 0), (1, 1)]  # mq.md, mq.pmd, pmq.md, pmq.pmd
            assert {row % 32 for row in a_rows} == {8 * mt + g}
            assert {c // 2 for _, c in regs} == {t}
            seen.setdefault(8 * mt + g, set()).add(t)
    assert sorted(seen) == list(range(32)) and all(v == {0, 1, 2, 3} for v in seen.values())


def test_int8_accumulator_rows_hold_dot_and_den():
    """wgmma's m64nN int32 accumulator gives thread (warp w, lane 4g + t) the
    rows 16w + g (registers 4c + x) and 16w + g + 8 (registers 4c + 2 + x),
    at entries 8c + 2t + x. With qe(p) = p + 1 and qm(p) = -(p + 1), the first
    row of every thread is A1's qe(8w + g) and the second its qm(8w + g), A2
    repeating the first and zero in the second: each thread holds dot and
    den of one position, and the 128 threads hold each position's entries
    once."""
    p = torch.arange(32, dtype=torch.int8).view(32, 1).expand(32, BITS)
    a1, a2 = _variants().dot_den_rows(p + 1, -(p + 1))
    seen = {}
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            rows = [16 * w + g + 8 * ((i // 2) % 2) for i in range(128)]
            cols = [8 * (i // 4) + 2 * t + i % 2 for i in range(128)]
            pos = 8 * w + g
            for i, (r, c) in enumerate(zip(rows, cols)):
                h = (i // 2) % 2
                if h == 0:  # dot(pos): qe in both operands
                    assert int(a1[r, 0]) == int(a2[r, 0]) == pos + 1
                else:       # den(pos): qm against the mask bits alone
                    assert int(a1[r, 0]) == -(pos + 1) and not a2[r].any()
                seen.setdefault((pos, h), set()).add(c)
    assert sorted(seen) == [(q, h) for q in range(32) for h in (0, 1)]
    assert all(cols == set(range(256)) for cols in seen.values())


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
