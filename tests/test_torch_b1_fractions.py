"""The B = 1 audit-spectrum kernel (``pk_fractions_kernel``, csrc/b1_packed.cu)
on the CPU: a torch mirror of its epilogue, fed the four AND-popcount
products in the kernel's lane layout (the in-thread fold of the 4 m-tiles,
the xor 4 / 8 / 16 fold of the 8 lanes of an entry, lane 4 g + t4 keeping
n-tile g's entry, the warp's entry ``lane``, and the persistent walk of the
tiles blockIdx + k * grid, each entry written once), against
``fractions_packed_small_b_reference`` and the JAX package's
``fractions_packed_small_b`` in interpret mode, over grid sizes and entry
counts at the tile and wave edges; the planted rotation ties, the
all-invalid entry and the padded tail; ``fractions_packed_small_b`` at B = 1
and 5 (the wrapper on CPU tensors, and its launch plan with the mirror for
the group of one) against the JAX package's packed spectrum scan; and the
bit-valued check that refuses another query. Every comparison is exact
(tolerance 0). The kernel itself runs in tests/test_torch_gpu.py on a card.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu.ops import packed_match as jpm
from mpc_iris_tpu_torch.constants import BITS_BYTES
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import b1_packed as bp
from mpc_iris_tpu_torch.ops import packed_match as tpm
from tests.test_torch_b1_select import _crafted, _pad, _select, four_products

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 256       # entries a tile (csrc/b1_packed.cu kTile)
WARPS = 8        # consumer warps, 32 entries of a tile each
BIG_N = 132 * TILE + 1  # one entry past a full wave of 132 blocks
JAX_CHUNK = 512  # the JAX kernel's tile (SMALL_B_TILE_N): its chunks


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---- the mirror

def spectrum_mirror(prods: torch.Tensor, n_entries: int, grid: int,
                    shuffles=(4, 8, 16)) -> torch.Tensor:
    """pk_fractions_kernel's epilogue (SpectrumOut), step by step.

    prods: int [4, 32, n_entries], the four products popc(mq & md),
    popc(mq & pmd), popc(pmq & md), popc(pmq & pmd) of query row r (rotation
    r; row 31 the dummy) and entry e. Block b of ``grid`` takes tiles b, b +
    grid, ... of TILE entries; rows past n_entries are zeros, as the TMA
    loads them. ``shuffles``: the xor distances of the lane fold. Returns
    int16 [2, n_entries], n then d; asserts that every entry is written
    once."""
    tiles = -(-n_entries // TILE)
    d = torch.nn.functional.pad(prods.long(), (0, tiles * TILE - n_entries))
    # row 8 mt + g, entry t * TILE + 32 w + 4 nt + t4 -> [t, w, nt, t4, g, mt]
    d = d.view(4, 4, 8, tiles, WARPS, 8, 4).permute(0, 3, 4, 5, 6, 2, 1)
    num, den = d[1] + d[2] - 2 * d[3], d[0]
    shape = num.shape[:-1]
    row = 8 * torch.arange(4) + torch.arange(8).view(8, 1)  # [g, mt]
    # 1. entry_min: the lane's 4 m-tiles, the row as the index
    f = _pad(*shape)
    for mt in range(4):
        f = _select(f, (num[..., mt], den[..., mt], row[:, mt].expand(shape)))
    # 2. the 8 lanes 4 g + t4 of an entry: xor shuffle s flips bit s / 4 of g
    for s in shuffles:
        f = _select(f, tuple(x[..., torch.arange(8) ^ (s // 4)] for x in f))
    # 3. lane 4 g + t4 keeps nt == g: [t, w, nt, t4, g] -> [t, w, g, t4] ->
    # [t, w, lane], the warp's entry `lane`
    kept = [x.diagonal(dim1=2, dim2=4).permute(0, 1, 3, 2).reshape(tiles, WARPS, 32)
            for x in f[:2]]
    # 4. the persistent walk: block b's k-th tile is b + k * grid; each lane
    # writes entry t * TILE + 32 w + lane if it is below n_entries
    out = torch.full((2, n_entries), -1, dtype=torch.int64)
    writes = torch.zeros(n_entries, dtype=torch.int64)
    for k in range(-(-tiles // grid)):
        for t in range(k * grid, min((k + 1) * grid, tiles)):
            e = t * TILE + torch.arange(TILE)
            ok = e < n_entries
            for p in range(2):
                out[p, e[ok]] = kept[p][t].reshape(-1)[ok]
            writes[e[ok]] += 1
    assert bool((writes == 1).all()), "an entry written other than once"
    return out.to(torch.int16)


# ---- cases

@functools.cache
def _case(kind: str, n: int):
    """(pat, msk uint8 [n, 1600], qpat, qmsk uint8 [1, 1600]). "random": the
    query a noisy copy of entry a, an exact duplicate of a at a tile or wave
    edge, an all-masked entry 0 and an all-set entry 3 where n allows;
    "planted": planted_packed_case's sparse masks (rotation ties), the
    duplicates at 129 and 257 of query 0's self-match and the all-invalid
    entry 7."""
    rng = np.random.default_rng(n + 11)
    if kind == "planted":
        return tpm.planted_packed_case(rng, n=n, b=1)
    pat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    a, b = (n - 2, n - 1) if n == BIG_N else (255, 256)
    if n > 4:
        msk[0] = 0
        pat[3] = msk[3] = 255
    if b < n:
        pat[b], msk[b] = pat[a], msk[a]
    src = min(a, n - 1)
    qpat = pat[src:src + 1] ^ (rng.integers(0, 256, (1, BITS_BYTES), dtype=np.uint8) & 0x11)
    return pat, msk, qpat, msk[src:src + 1].copy()


def _planes(qpat, qmsk):
    return teng.prepare_query_planes(torch.from_numpy(qpat), torch.from_numpy(qmsk))


@functools.cache
def _want(kind: str, n: int) -> np.ndarray:
    """fractions_packed_small_b_reference at B = 1 over [1, n, 1600],
    int16 [2, n]; for n of a few 512-entry chunks also checked against the
    JAX package's fractions_packed_small_b in interpret mode (the DB padded
    with all-zero entries to its chunks: they report (0, 0))."""
    pat, msk, qpat, qmsk = _case(kind, n)
    want = tpm.fractions_packed_small_b_reference(
        *_planes(qpat, qmsk), torch.from_numpy(pat).view(1, n, BITS_BYTES),
        torch.from_numpy(msk).view(1, n, BITS_BYTES))[:, 0].numpy()
    if n <= 4 * JAX_CHUNK:
        pat_c, _ = jeng._pad_chunks(pat, JAX_CHUNK)
        msk_c, _ = jeng._pad_chunks(msk, JAX_CHUNK)
        got = np.asarray(jpm.fractions_packed_small_b(
            *jeng.prepare_query_planes(qpat, qmsk), jnp.asarray(pat_c), jnp.asarray(msk_c),
            interpret=True))[:, 0]
        np.testing.assert_array_equal(got[:, :n], want.astype(np.uint16))
        assert not got[:, n:].any()
    return want


@functools.cache
def _products(kind: str, n: int) -> torch.Tensor:
    pat, msk, qpat, qmsk = _case(kind, n)
    return four_products(tpm._one_query_operand(*_planes(qpat, qmsk)), torch.from_numpy(pat),
                         torch.from_numpy(msk))


CASES = [("random", 1), ("random", 255), ("random", 256), ("random", 257), ("planted", 700),
         ("random", BIG_N)]


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("kind,n", CASES)
def test_spectrum_mirror_equals_reference_and_jax(kind, n, grid):
    want = _want(kind, n)
    got = spectrum_mirror(_products(kind, n), n, grid)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "random" and n > 4:
        assert got[:, 0].tolist() == [0, 0]                 # all masked: (0, 0)
        assert got[1, 3] > 0
    if kind == "random" and n > 256:
        a, b = (n - 2, n - 1) if n == BIG_N else (255, 256)
        assert got[:, a].tolist() == got[:, b].tolist() and got[1, a] > 0


def test_planted_traps():
    """planted_packed_case at B = 1: its sparse entries hold the rotation
    ties (the minimum fraction at two rotations as different pairs) and the
    spectrum keeps the earliest rotation's pair there; the self-match at 129
    and its duplicate at 257 report (0, d); the all-invalid entry 7 (0, 0)."""
    prods = _products("planted", 700).long()
    got = spectrum_mirror(prods, 700, 132)
    np.testing.assert_array_equal(got.numpy(), _want("planted", 700))
    num, den = (prods[1] + prods[2] - 2 * prods[3]).numpy(), prods[0].numpy()
    n_e, d_e = got.numpy().astype(np.int64)
    ties = 0
    for e in range(700):
        rows = np.flatnonzero((den[:, e] > 0) & (num[:, e] * d_e[e] == n_e[e] * den[:, e]))
        if rows.size == 0:
            assert (n_e[e], d_e[e]) == (0, 0), e
            continue
        assert (n_e[e], d_e[e]) == (num[rows[0], e], den[rows[0], e]), e
        ties += len({(num[r, e], den[r, e]) for r in rows}) > 1
    assert ties > 0, "no rotation tie as different pairs among the planted entries"
    assert got[0, 129] == 0 and got[0, 257] == 0 and got[1, 129] > 0
    assert got[:, 7].tolist() == [0, 0]


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("early,late,want", [
    (1, 2, (1, 2)), (5, 9, (2, 4)), (3, 8, (2, 4)), (6, 17, (2, 4)), (12, 30, (1, 2))])
def test_spectrum_mirror_rotation_tie(grid, early, late, want):
    """Entry 2 (and entry 33,790 past a wave): two rotations hold the same
    fraction as different pairs, 1/2 and 2/4, every other place more: the
    earliest rotation's pair. The rows sit in other m-tiles and other lanes
    of the entry (row 8 mt + g), so every xor step and the m-tile fold decide
    one of them; an entry with no valid row reports (0, 0)."""
    n = BIG_N
    d = _crafted(n, 4)
    for e in (2, n - 3):
        for row, (num, den) in ((early, want), (late, (3 - want[0], 6 - want[1]))):
            d[1, row, e], d[0, row, e] = num, den
    d[:, :, 5] = 0
    got = spectrum_mirror(d, n, grid)
    assert got[:, 2].tolist() == list(want) and got[:, n - 3].tolist() == list(want)
    assert got[:, 5].tolist() == [0, 0]


@pytest.mark.parametrize("dropped", [4, 8, 16])
def test_mirror_without_a_shuffle_step_misses_a_tie(dropped):
    """The tie cases hold the lane fold to all three xor steps. Entries 0-2
    are kept by lane g = 0 (n-tile 0); entry k has 1/2 at row 2^k (g = 2^k,
    reached only by the xor 4 * 2^k step) and 2/4 at row 8 (g = 0): a mirror
    that drops that step keeps the later rotation's 2/4."""
    d = _crafted(300, 4)
    for k in range(3):
        d[1, 1 << k, k], d[0, 1 << k, k] = 1, 2
        d[1, 8, k], d[0, 8, k] = 2, 4
    full = spectrum_mirror(d, 300, 3)
    cut = spectrum_mirror(d, 300, 3, tuple(s for s in (4, 8, 16) if s != dropped))
    k = (4, 8, 16).index(dropped)
    assert full[:, :3].T.tolist() == [[1, 2]] * 3
    assert cut[:, k].tolist() == [2, 4]


# ---- the audit route

def _route(q_enc, q_mask, pat_c, msk_c):
    """fractions_packed_small_b's launch plan on the CPU: a group of one
    query through its operand, the query check and the mirror of
    pk_fractions_kernel over the [C * c, 1600] view of the chunks (grid
    132), the check read back after the launches; the other groups through
    the plain version."""
    flat = tuple(x.reshape(-1, BITS_BYTES) for x in (pat_c, msk_c))
    n = flat[0].shape[0]
    out = torch.empty((2, q_enc.shape[0], n), dtype=torch.int16)
    checks = []
    for q0, nq, qg in tpm._launch_plan(q_enc.shape[0]):
        qe, qm = q_enc[q0:q0 + nq], q_mask[q0:q0 + nq]
        if qg == 1:
            q = tpm._one_query_operand(qe, qm)
            checks.append(bp.start_query_check(qe, qm))
            out[:, q0] = spectrum_mirror(four_products(q, *flat), n, 132)
        else:
            out[:, q0:q0 + nq] = tpm.fractions_packed_small_b_reference(qe, qm, pat_c, msk_c)
    for check in checks:
        bp.require_bit_valued("fractions_packed_small_b", check)
    return out


def _route_case(b: int, kind: str):
    """700 entries in chunks of 256 (a zero-padded tail of 68 entries);
    planted: query 0 the self-match at 129 (its duplicate at 257), query 2
    all-masked; "random": the last query a copy of entry 255, duplicated at
    256, past a chunk edge."""
    rng = np.random.default_rng(b + 20)
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=700, b=b)
    if kind == "random":
        pat[256], msk[256] = pat[255], msk[255]
        qpat[-1], qmsk[-1] = pat[255], msk[255]
    pat_c, _ = jeng._pad_chunks(pat, 256)
    msk_c, _ = jeng._pad_chunks(msk, 256)
    return pat_c, msk_c, qpat, qmsk


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("kind", ["planted", "random"])
def test_fractions_packed_small_b_equals_jax_scan(b, kind):
    """B = 1 and 5 (a group of 4 and one of 1): the wrapper on CPU tensors
    and its launch plan with the mirror for the group of one equal the JAX
    package's packed spectrum scan; the padded tail reports (0, 0)."""
    pat_c, msk_c, qpat, qmsk = _route_case(b, kind)
    want = np.asarray(jeng._fractions_scan_packed(*jeng.prepare_query_planes(qpat, qmsk),
                                                  jnp.asarray(pat_c), jnp.asarray(msk_c)))
    args = (*_planes(qpat, qmsk), torch.from_numpy(pat_c), torch.from_numpy(msk_c))
    got = tpm.fractions_packed_small_b(*args)
    assert got.dtype == torch.int16 and got.shape == (2, b, 768)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int16))
    np.testing.assert_array_equal(_route(*args).numpy(), want.astype(np.int16))
    assert not want[:, :, 700:].any() and not want[:, :, 7].any()
    if kind == "planted":
        assert want[0, 0, 129] == 0 and want[0, 0, 257] == 0 and want[1, 0, 129] > 0
        if b > 2:
            assert not want[:, 2].any()
    else:
        assert want[0, -1, 255] == 0 and want[0, -1, 256] == 0 and want[1, -1, 255] > 0


# ---- the bit-valued check

def test_route_refuses_other_queries():
    """The group of one checks its query as fractions_packed_small_b does on
    the card, after the launch: prepare_query_planes's queries pass; a mask
    of 2, an encoding of 1 where the mask is 0 or -2 are refused; a group of
    4 (B = 4) takes the int8 path and no check."""
    pat_c, msk_c, qpat, qmsk = _route_case(5, "random")
    q_enc, q_mask = _planes(qpat, qmsk)
    db = (torch.from_numpy(pat_c), torch.from_numpy(msk_c))
    q_off = q_enc.clone()
    q_off[4][q_mask[4] == 0] = 1
    for bad in ((q_enc, 2 * q_mask), (q_off, q_mask), (2 * q_enc, q_mask)):
        with pytest.raises(ValueError, match="bit-valued"):
            _route(*bad, *db)
    assert torch.equal(_route(2 * q_enc[:4], q_mask[:4], *db),
                       tpm.fractions_packed_small_b_reference(2 * q_enc[:4], q_mask[:4], *db))


def test_cpu_tensors_never_launch_the_fractions_kernel():
    pat_c, msk_c, qpat, qmsk = _route_case(1, "planted")
    args = (*_planes(qpat, qmsk), torch.from_numpy(pat_c), torch.from_numpy(msk_c))
    before = bp.launch_fractions.launches, tpm.fractions_packed_small_b.launches
    assert torch.equal(tpm.fractions_packed_small_b(*args),
                       tpm.fractions_packed_small_b_reference(*args))
    assert (bp.launch_fractions.launches, tpm.fractions_packed_small_b.launches) == before


def test_old_vs_new_route_planes():
    """scripts/probe_kernels_old_vs_new_torch.py times the old and the new
    B = 1 spectrum on prep_query's pair put back by its route_planes: that
    gives prepare_query_planes's planes, the wrapper's input."""
    spec = importlib.util.spec_from_file_location(
        "probe_kernels_old_vs_new_torch",
        os.path.join(REPO, "scripts", "probe_kernels_old_vs_new_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, _, qpat, qmsk = _case("random", 257)
    qp, qm = torch.from_numpy(qpat), torch.from_numpy(qmsk)
    got = mod.route_planes(*bp.prep_query(qp, qm))
    want = teng.prepare_query_planes(qp, qm)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
