"""The B = 1 select kernel (``pk_select_kernel``, csrc/b1_packed.cu) on the
CPU: a torch mirror of its epilogue, fed the four AND-popcount products in
the kernel's lane layout (the in-thread fold of the 4 m-tiles, the xor 4 /
8 / 16 fold of the 8 lanes of an entry, each thread's fold over the
persistent tiles blockIdx + k * grid, the consumer warps' block fold and the
fold of the block partials), against ``pk_select_reference`` and the JAX
probe's ``make_pk_select`` in interpret mode, over grid sizes and entry
counts at the tile and block edges; the planted rotation and index ties;
the operand that ``match_packed_small_b`` builds for a group of one query
against ``pk_dot_operand``; ``match_packed_small_b`` at B = 1 and 5 (the
wrapper on CPU tensors, and its launch plan with the mirror for the group of
one) against the JAX package's packed scan; and the bit-valued check that
refuses another query. Every comparison is exact (tolerance 0). The kernel
itself runs in tests/test_torch_gpu.py on a card.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu_torch.constants import BITS_BYTES
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import b1_packed as bp
from mpc_iris_tpu_torch.ops import packed_match as tpm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 256       # entries a tile (csrc/b1_packed.cu kTile)
WARPS = 8        # consumer warps, 32 entries of a tile each
FOLD = 256       # fold_parts_kernel's threads (frac.cuh kFoldThreads)
INT_MAX = 2**31 - 1
BIG_N = 132 * TILE + 1  # one entry past a full wave of 132 blocks


@pytest.fixture(autouse=True)
def one_torch_thread():
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


# ---- the mirror

def _pad(*shape):
    """frac_pad() over a shape: (0, 0, INT_MAX)."""
    return (torch.zeros(shape, dtype=torch.int64), torch.zeros(shape, dtype=torch.int64),
            torch.full(shape, INT_MAX, dtype=torch.int64))


def _select(a, b):
    """frac.cuh's frac_select on tensors of (n, d, i): the smaller fraction
    by exact cross products, d = 0 never smaller than a valid one, ties to
    the lower index."""
    (an, ad, ai), (bn, bd, bi) = a, b
    v1, v2 = ad > 0, bd > 0
    less = (v1 & ~v2) | (v1 & v2 & (an * bd < bn * ad))
    greater = (v2 & ~v1) | (v1 & v2 & (bn * ad < an * bd))
    take = less | (~greater & (ai <= bi))
    return tuple(torch.where(take, x, y) for x, y in zip(a, b))


def _warp_select(f):
    """frac.cuh's warp_select over the last axis (32 lanes): shfl_down 16,
    8, 4, 2, 1 (a lane past 31 reads its own value); lane 0's result."""
    lane = torch.arange(32)
    for s in (16, 8, 4, 2, 1):
        src = torch.where(lane + s < 32, lane + s, lane)
        f = _select(f, tuple(x[..., src] for x in f))
    return tuple(x[..., 0] for x in f)


def epilogue_mirror(prods: torch.Tensor, n_entries: int, grid: int) -> torch.Tensor:
    """pk_select_kernel's epilogue and fold_parts_kernel, step by step.

    prods: int [4, 32, n_entries], the four products popc(mq & md),
    popc(mq & pmd), popc(pmq & md), popc(pmq & pmd) of query row r (rotation
    r; row 31 the dummy) and entry e. Block b of ``grid`` takes tiles b, b +
    grid, ... of TILE entries; rows past n_entries are zeros, as the TMA
    loads them. Returns int32 [3, 1]."""
    tiles = -(-n_entries // TILE)
    d = torch.nn.functional.pad(prods.long(), (0, tiles * TILE - n_entries))
    # row 8 mt + g, entry t * TILE + 32 w + 4 nt + t4 -> [t, w, nt, t4, g, mt]
    d = d.view(4, 4, 8, tiles, WARPS, 8, 4).permute(0, 3, 4, 5, 6, 2, 1)
    num, den = d[1] + d[2] - 2 * d[3], d[0]
    shape = num.shape[:-1]
    row = 8 * torch.arange(4) + torch.arange(8).view(8, 1)  # [g, mt]
    # 1. the lane's 4 m-tiles, the row as the index
    f = _pad(*shape)
    for mt in range(4):
        f = _select(f, (num[..., mt], den[..., mt], row[:, mt].expand(shape)))
    # 2. the 8 lanes 4 g + t4 of an entry: xor shuffles 4, 8, 16 flip g's bits
    for s in (1, 2, 4):
        f = _select(f, tuple(x[..., torch.arange(8) ^ s] for x in f))
    # 3, 4. each thread's running winner over its block's tiles, n-tile by
    # n-tile, with the global entry index, entries past n_entries skipped
    e = (TILE * torch.arange(tiles).view(-1, 1, 1, 1) + 32 * torch.arange(WARPS).view(-1, 1, 1)
         + 4 * torch.arange(8).view(-1, 1) + torch.arange(4)).unsqueeze(-1).expand(shape)
    best = _pad(grid, WARPS, 4, 8)                            # block, w, t4, g
    for k in range(-(-tiles // grid)):
        t = torch.arange(grid) + k * grid
        has = t < tiles
        t = t.clamp(max=tiles - 1)
        for nt in range(8):
            cand = (f[0][t, :, nt], f[1][t, :, nt], e[t, :, nt])
            ok = has.view(-1, 1, 1, 1) & (cand[2] < n_entries)
            best = tuple(torch.where(ok, x, y) for x, y in zip(_select(best, cand), best))
    # 5, 6. the consumer warps (lane 4 g + t4), then thread 0 over the 8
    # warps: one partial a block
    warp_best = _warp_select(tuple(x.transpose(2, 3).reshape(grid, WARPS, 32) for x in best))
    part = _pad(grid)
    for w in range(WARPS):
        part = _select(part, tuple(x[:, w] for x in warp_best))
    # 7. fold_parts_kernel: thread k takes parts k, k + 256, ...; then
    # block_select<256>: each warp, then warp 0 over the 8 warps' winners
    thread = _pad(FOLD)
    for k0 in range(0, grid, FOLD):
        got = tuple(x[k0:k0 + FOLD] for x in part)
        m = got[0].shape[0]
        head = _select(tuple(x[:m] for x in thread), got)
        thread = tuple(torch.cat([h, x[m:]]) for h, x in zip(head, thread))
    per_warp = _warp_select(tuple(x.view(FOLD // 32, 32) for x in thread))
    lanes = tuple(torch.cat([x, p[FOLD // 32:]]) for x, p in zip(per_warp, _pad(32)))
    n, dd, i = _warp_select(lanes)
    return torch.stack([n, dd, i]).to(torch.int32).view(3, 1)


# ---- the products, as the kernel's mma.sync accumulates them

def _bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [R, 1600] -> int8 0/1 [R, 12,800] (any fixed bit order serves,
    the same on both sides of a product)."""
    shifts = torch.arange(8, dtype=torch.uint8)
    return ((packed.unsqueeze(-1) >> shifts) & 1).reshape(packed.shape[0], -1).to(torch.int8)


def four_products(q: torch.Tensor, pat: torch.Tensor, msk: torch.Tensor) -> torch.Tensor:
    """q uint8 [64, Q_ROW] (rows 0-31 mask bits mq, 32-63 pattern-and-mask
    bits pmq) against the DB's mask bits md and pmd = p & m -> int32 [4, 32,
    N], exact 0/1 int8 products in pieces of entries."""
    a = _bits(q[:, :BITS_BYTES])
    out = []
    for e0 in range(0, pat.shape[0], 4096):
        p, m = pat[e0:e0 + 4096], msk[e0:e0 + 4096]
        d = torch._int_mm(a, torch.cat([_bits(m), _bits(p & m)]).T)  # [64, 2n]
        n = p.shape[0]
        out.append(torch.stack([d[:32, :n], d[:32, n:], d[32:, :n], d[32:, n:]]))
    return torch.cat(out, dim=2)


def _operand(qe, qm):
    """pk_select's operand: prep_query's rows put back in rotation order."""
    rev = torch.as_tensor(bp.ROT_BITREV)
    return bp.pk_dot_operand(qe[rev], qm[rev])


# ---- cases

@functools.cache
def _case(kind: str, n: int):
    """(pat, msk uint8 [n, 1600], qpat, qmsk uint8 [1, 1600]). "random": the
    query a noisy copy of entry a (a nonzero distance), entry b an exact
    duplicate of a past a tile edge (b = 256, or the next block's tile at
    BIG_N), an all-masked entry 0 and an all-set last entry where n allows;
    "planted": planted_packed_case's rotation ties, duplicates at 129 and
    257 and all-invalid entry 7 against its query 0."""
    rng = np.random.default_rng(n)
    if kind == "planted":
        pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=n, b=1)
        return pat, msk, qpat, qmsk
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


def _torch_case(kind, n):
    pat, msk, qpat, qmsk = _case(kind, n)
    qe, qm = bp.prep_query(torch.from_numpy(qpat), torch.from_numpy(qmsk))
    return qe, qm, torch.from_numpy(pat), torch.from_numpy(msk)


@functools.cache
def _want(kind: str, n: int) -> np.ndarray:
    """pk_select_reference, checked once against the JAX probe's
    make_pk_select in interpret mode (the DB padded with all-zero entries to
    its 512-entry tile: mask 0, never valid)."""
    args = _torch_case(kind, n)
    want = bp.pk_select_reference(*args).numpy()
    pat, msk, qpat, qmsk = _case(kind, n)
    npad = -(-n // 512) * 512
    pat, msk = (np.pad(x, ((0, npad - n), (0, 0))) for x in (pat, msk))
    jax_out = _probe().make_pk_select(npad, 512, interpret=True)(
        *_probe().prep_query(qpat, qmsk), jnp.asarray(pat), jnp.asarray(msk))
    np.testing.assert_array_equal(np.asarray(jax_out), want)
    return want


@functools.cache
def _products(kind: str, n: int) -> torch.Tensor:
    qe, qm, pat, msk = _torch_case(kind, n)
    return four_products(_operand(qe, qm), pat, msk)


CASES = [("random", 1), ("random", 255), ("random", 256), ("random", 257), ("planted", 700),
         ("random", BIG_N)]


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("kind,n", CASES)
def test_epilogue_mirror_equals_reference_and_jax_probe(kind, n, grid):
    want = _want(kind, n)
    got = epilogue_mirror(_products(kind, n), n, grid)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "random" and n > 256:
        a = n - 2 if n == BIG_N else 255
        assert int(got[2, 0]) == a and int(got[0, 0]) > 0  # the lower of the duplicates
    if kind == "planted":
        assert int(got[2, 0]) == 129 and int(got[0, 0]) == 0


def _crafted(n: int, seed: int) -> torch.Tensor:
    """Four products [4, 32, n] with every fraction above 3/4 (d1 = num,
    d2 = d3 = 0, d0 = den) and row 31 (the dummy) zero."""
    den = torch.from_numpy(np.random.default_rng(seed).integers(100, 12_801, (32, n)))
    num = (den * 3 + 3) // 4
    den[31] = num[31] = 0
    return torch.stack([den, num, torch.zeros_like(den), torch.zeros_like(den)])


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("early,late,want", [
    (1, 2, (1, 2)), (5, 9, (2, 4)), (3, 8, (2, 4)), (6, 17, (2, 4)), (12, 30, (1, 2))])
def test_epilogue_mirror_rotation_tie(grid, early, late, want):
    """Entry 2: two rotations hold the same fraction as different pairs,
    1/2 and 2/4, every other place more: the earliest rotation's pair. (1,
    2): pk_dot's position-order epilogue gives (2, 4) there. The rows sit in
    other m-tiles and other lanes of the entry (row 8 mt + g), so every xor
    step and the m-tile fold decide one of them."""
    d = _crafted(300, 4)
    for row, (n, den) in ((early, want), (late, (3 - want[0], 6 - want[1]))):
        d[1, row, 2], d[0, row, 2] = n, den
    assert epilogue_mirror(d, 300, grid).ravel().tolist() == [*want, 2]


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("pair", [(255, 256), (128, 384), (BIG_N - 2, BIG_N - 1)])
def test_epilogue_mirror_index_ties(grid, pair):
    """Equal fractions as different pairs at two entries across a tile, a
    block or a persistent wave's edge (rows congruent mod 128 too): the
    lower index with its own pair; all invalid: entry 0 with (0, 0)."""
    n = BIG_N
    d = _crafted(n, 6)
    lo, hi = pair
    d[1, 20, hi], d[0, 20, hi] = 1, 3
    d[1, 4, lo], d[0, 4, lo] = 2, 6
    assert epilogue_mirror(d, n, grid).ravel().tolist() == [2, 6, lo]
    assert epilogue_mirror(torch.zeros_like(d), n, grid).ravel().tolist() == [0, 0, 0]


# ---- the match route

def _route_operand_case(seed: int):
    rng = np.random.default_rng(seed)
    qpat = rng.integers(0, 256, (1, BITS_BYTES), dtype=np.uint8)
    qmsk = rng.integers(0, 256, (1, BITS_BYTES), dtype=np.uint8)
    qmsk[0, :100] = 0  # masked bytes
    qmsk[0, 1500:] = 255
    return torch.from_numpy(qpat), torch.from_numpy(qmsk)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_route_operand_equals_pk_dot_operand(seed):
    """match_packed_small_b's operand of a group of one, built from
    prepare_query_planes in the natural K order, is pk_select's: rows in
    rotation order, 31 and 63 zero, 32 zero bytes past each row's 1,600."""
    qp, qm = _route_operand_case(seed)
    got = tpm._one_query_operand(*teng.prepare_query_planes(qp, qm))
    want = _operand(*bp.prep_query(qp, qm))
    assert got.dtype == torch.uint8 and got.shape == (64, bp.Q_ROW)
    assert torch.equal(got, want)
    assert not got[[31, 63]].any() and not got[:, BITS_BYTES:].any()


def _route(q_enc, q_mask, pat_c, msk_c):
    """match_packed_small_b's launch plan on the CPU: a group of one query
    through the mirror of pk_select_kernel on _one_query_operand over the
    [C * c, 1600] view of the chunks (grid 132), the other groups through
    the plain version."""
    flat = tuple(x.reshape(-1, BITS_BYTES) for x in (pat_c, msk_c))
    out = torch.empty((3, q_enc.shape[0]), dtype=torch.int32)
    for q0, nq, qg in tpm._launch_plan(q_enc.shape[0]):
        qe, qm = q_enc[q0:q0 + nq], q_mask[q0:q0 + nq]
        if qg == 1:
            prods = four_products(tpm._one_query_operand(qe, qm), *flat)
            out[:, q0:q0 + 1] = epilogue_mirror(prods, flat[0].shape[0], 132)
        else:
            out[:, q0:q0 + nq] = tpm.match_packed_small_b_reference(qe, qm, pat_c, msk_c)
    return out


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("kind", ["planted", "random"])
def test_match_packed_small_b_equals_jax_scan(b, kind):
    """B = 1 and 5 (a group of 4 and one of 1): the wrapper on CPU tensors
    and its launch plan with the mirror for the group of one equal the JAX
    package's packed scan, on 700 entries in chunks of 256 (a zero-padded
    tail); planted: query 0 the self-match at 129 (its duplicate at 257),
    query 2 all-masked (0, 0, 0); "random": the last query a copy of entry
    255, duplicated at 256, past a chunk edge (sparse entries past 257 tie
    it at 0.0 with a higher index)."""
    rng = np.random.default_rng(b)
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=700, b=b)
    if kind == "random":
        pat[256], msk[256] = pat[255], msk[255]
        qpat[-1], qmsk[-1] = pat[255], msk[255]
    pat_c, _ = jeng._pad_chunks(pat, 256)
    msk_c, _ = jeng._pad_chunks(msk, 256)
    want = np.asarray(jeng._match_scan_packed(*jeng.prepare_query_planes(qpat, qmsk),
                                              jnp.asarray(pat_c), jnp.asarray(msk_c),
                                              fused=False))
    args = (*teng.prepare_query_planes(torch.from_numpy(qpat), torch.from_numpy(qmsk)),
            torch.from_numpy(pat_c), torch.from_numpy(msk_c))
    np.testing.assert_array_equal(tpm.match_packed_small_b(*args).numpy(), want)
    np.testing.assert_array_equal(tpm.match_packed_int8_pairs(*args).numpy(), want)
    np.testing.assert_array_equal(_route(*args).numpy(), want)
    if kind == "planted":
        assert want[2, 0] == 129 and want[0, 0] == 0
        if b > 2:
            assert want[:, 2].tolist() == [0, 0, 0]
    else:
        assert want[2, -1] == 255 and want[0, -1] == 0


# ---- the bit-valued check

def test_query_check_refuses_other_queries():
    """start_query_check / require_bit_valued, the check both wrappers read
    back after their launch, on CPU tensors: prep_query's and
    prepare_query_planes's queries pass; a mask of 2, a negative mask, an
    encoding of 1 where the mask is 0, or -2 are refused."""
    qp, qm = _route_operand_case(4)
    q_enc, q_mask = teng.prepare_query_planes(qp, qm)
    for good in (bp.prep_query(qp, qm), (q_enc, q_mask)):
        bp.require_bit_valued("ok", bp.start_query_check(*good))
    q_off = q_enc.clone()
    q_off[(q_mask == 0)] = 1
    for bad in ((q_enc, 2 * q_mask), (-q_mask, -q_mask), (q_off, q_mask),
                (2 * q_enc, q_mask)):
        with pytest.raises(ValueError, match="bit-valued"):
            bp.require_bit_valued("match_packed_small_b", bp.start_query_check(*bad))


def test_cpu_tensors_never_launch_the_select_kernel():
    qe, qm, pat, msk = _torch_case("random", 257)
    before = bp.pk_select.launches, tpm.match_packed_small_b.launches
    assert torch.equal(bp.pk_select(qe, qm, pat, msk), bp.pk_select_reference(qe, qm, pat, msk))
    q_enc, q_mask = teng.prepare_query_planes(*(torch.from_numpy(x) for x in _case("random",
                                                                                   257)[2:]))
    tpm.match_packed_small_b(q_enc, q_mask, pat.view(1, 257, BITS_BYTES),
                             msk.view(1, 257, BITS_BYTES))
    assert (bp.pk_select.launches, tpm.match_packed_small_b.launches) == before
