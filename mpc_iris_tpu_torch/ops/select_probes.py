"""The select compare-arithmetic probe kernels (counterpart of the kernel
functions of ``scripts/select_variants.py`` and ``scripts/select_i16_probe.py``).

:func:`select_variant` launches ``csrc/select_probes.cu`` with one of three
compares, and :func:`select_lanes` with one of two carry types, for CUDA
tensors; for CPU tensors each takes its plain version (``*_reference``),
which mirrors the probe's halving loops slice for slice.

Both probes are kernel (a) (``select_chunk``) before its index-aware fix.
Every step keeps its FIRST operand unless the second is strictly smaller, so
the pairing decides which index wins an exact tie, and ``tile_n`` is part of
the function, not a tuning knob: per query and tile of ``tile_n`` columns,
num = (den - dot) >> 1, the rotation tree (r, r + half) for half = 16 .. 1
(the rows in the order given), the column tree (c, c + half) down to one
column (s1) or to 128 lanes (s2), then the tiles folded in tile order. The
compares:

- ``i32`` (``sel_i32``): the exact int32 cross products;
- ``f32`` (``sel_f32``): float32 cross products, INEXACT past 2^24:
  12,799/12,800 against 12,798/12,799 are 163,814,401 and 163,814,400,
  both 163,814,400 in float32, so ``f32`` keeps the first and ``i32`` takes
  the second; only the probe's pairings and fold order give its answer;
- ``f32_exact`` (``sel_f32_exact``): float32 with d split as 128 hi + lo,
  exact for n, d < 2^14.

``select_lanes``'s ``i16_tree`` carries n and d in int16 (``num = (den - dot)
>> 1`` wraps where den - dot > 32,767; the int32 tree does not) and returns the
128 lane winners [B, 384], widened to int32.
"""

from __future__ import annotations

import torch

from mpc_iris_tpu_torch.ops._build import check_launch, library

N_ROT_PAD = 32
LANES = 128
TILE_N = 2048     # the tile of select_i16_probe.py, and select_variant's default
TILE_B = 8        # the probes' queries a grid step: B must be a multiple
COMPARES = ("i32", "f32", "f32_exact")
TREES = ("i32", "i16")


def sel_i32(n1, d1, n2, d2, *extras):
    """Keep-first selection by the int32 cross products (the probe's
    ``sel_i32``); ``extras`` are (a1, a2, ...) pairs selected alongside."""
    return _pick(n2 * d1 < n1 * d2, n1, d1, n2, d2, extras)


def sel_f32(n1, d1, n2, d2, *extras):
    """Keep-first selection by float32 cross products, inexact past 2^24 (the
    probe's ``sel_f32``)."""
    f = torch.float32
    return _pick(n2.to(f) * d1.to(f) < n1.to(f) * d2.to(f), n1, d1, n2, d2, extras)


def sel_f32_exact(n1, d1, n2, d2, *extras):
    """Keep-first selection by float32 products of d split as 128 hi + lo,
    every partial product exact (the probe's ``sel_f32_exact``)."""
    f = torch.float32
    n1f, n2f, d1f, d2f = n1.to(f), n2.to(f), d1.to(f), d2.to(f)
    d1hi = torch.floor(d1f * (1.0 / 128.0))
    d2hi = torch.floor(d2f * (1.0 / 128.0))
    d1lo = d1f - d1hi * 128.0
    d2lo = d2f - d2hi * 128.0
    hi = n2f * d1hi - n1f * d2hi
    lo = n2f * d1lo - n1f * d2lo
    return _pick(hi * 128.0 + lo < 0, n1, d1, n2, d2, extras)


def _pick(smaller, n1, d1, n2, d2, extras):
    v1 = d1 > 0
    v2 = d2 > 0
    greater = (v2 & ~v1) | (v1 & v2 & smaller)
    out = (torch.where(greater, n2, n1), torch.where(greater, d2, d1))
    for a1, a2 in zip(extras[::2], extras[1::2]):
        out += (torch.where(greater, a2, a1),)
    return out


def _sel_i16(n1, d1, n2, d2, *extras):
    """select_i16_probe.py's int16-tree compare: products of the values
    widened to int32, the carried values kept int16."""
    return _pick(n2.int() * d1.int() < n1.int() * d2.int(), n1, d1, n2, d2, extras)


_SELECTS = {"i32": sel_i32, "f32": sel_f32, "f32_exact": sel_f32_exact}


def _tile_trees(dot, den, off: int, tile_n: int, stop: int, sel):
    """The per-tile part of both probes on [b*32, n] inputs: per query and
    tile the rotation tree, then the column tree down to ``stop`` columns.
    Returns (n, d, col) [b, n / tile_n, stop]."""
    b, n_cols = dot.shape[0] // N_ROT_PAD, dot.shape[1]
    t = n_cols // tile_n
    dot = dot.reshape(b, N_ROT_PAD, t, tile_n)
    den = den.reshape(b, N_ROT_PAD, t, tile_n)
    n, d = (den - dot) >> 1, den
    k = N_ROT_PAD
    while k > 1:
        half = k // 2
        n, d = sel(n[:, :half], d[:, :half], n[:, half:], d[:, half:])
        k = half
    n, d = n[:, 0], d[:, 0]
    col = (torch.arange(tile_n, dtype=torch.int32, device=dot.device) + off
           + tile_n * torch.arange(t, dtype=torch.int32, device=dot.device)[:, None])
    col = col.expand(b, t, tile_n)
    tn = tile_n
    while tn > stop:
        half = tn // 2
        n, d, col = sel(n[..., :half], d[..., :half], n[..., half:], d[..., half:],
                        col[..., :half], col[..., half:])
        tn = half
    return n, d, col


def _fold_tiles(n, d, col, sel):
    """The probes' fold across tiles, keep-first in tile order from tile 0:
    [b, T, L] -> [b, L] x3."""
    state = n[:, 0], d[:, 0], col[:, 0]
    for j in range(1, n.shape[1]):
        state = sel(state[0], state[1], n[:, j], d[:, j], state[2], col[:, j])
    return state


def _check_shape(name, dot, den, tile_n: int, dtype):
    if dot.dim() != 2 or dot.shape != den.shape or dot.dtype != dtype or den.dtype != dtype:
        raise ValueError(f"{name}: dot/den must be {dtype} [B*32, N] of one shape")
    b, n_cols = dot.shape[0] // N_ROT_PAD, dot.shape[1]
    if dot.shape[0] % (N_ROT_PAD * TILE_B) or b > 65535:
        raise ValueError(f"{name}: {dot.shape[0]} rows must be {N_ROT_PAD} for each of B "
                         f"queries, B a multiple of {TILE_B} (the probe's tile_b) up to 65,535")
    if not (128 <= tile_n <= TILE_N and tile_n & (tile_n - 1) == 0):
        raise ValueError(f"{name}: tile_n={tile_n} must be a power of two in [128, {TILE_N}]")
    if n_cols == 0 or n_cols % tile_n or n_cols >= 2**31:
        raise ValueError(f"{name}: N={n_cols} must be a positive multiple of tile_n={tile_n}")
    if dot.device != den.device:
        raise ValueError(f"{name}: dot and den on different devices")
    if dot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dot.device}")
    return b, n_cols


def select_variant_reference(dot, den, off: int = 0, compare: str = "i32",
                             tile_n: int = TILE_N):
    """Plain version of :func:`select_variant`: the probe's loops on tensors."""
    sel = _SELECTS[compare]
    return _fold_tiles(*_tile_trees(dot, den, off, tile_n, 1, sel), sel)


def select_variant(dot: torch.Tensor, den: torch.Tensor, off: int = 0, compare: str = "i32",
                   tile_n: int = TILE_N):
    """select_variants.py's ``make_select(sel)`` kernel: int32 dot, den
    [b*32, n] and a column offset -> (n, d, idx) int32 [b, 1] each, the
    keep-first selection by ``compare`` (one of :data:`COMPARES`). One
    launch (and its fold) for CUDA tensors. b % 8 == 0; ``tile_n`` a power
    of two in [128, 2048] dividing n."""
    if compare not in COMPARES:
        raise ValueError(f"select_variant: compare must be one of {COMPARES}")
    b, n_cols = _check_shape("select_variant", dot, den, tile_n, torch.int32)
    if dot.device.type == "cpu":
        return select_variant_reference(dot, den, off, compare, tile_n)
    if not (dot.is_contiguous() and den.is_contiguous()):
        raise ValueError("select_variant: dot/den must be contiguous")
    lib = library()
    part = torch.empty(3 * b * (n_cols // tile_n), dtype=torch.int32, device=dot.device)
    out = torch.empty((b, 3), dtype=torch.int32, device=dot.device)
    with torch.cuda.device(dot.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch("select_variant", lib.select_variant_launch(
            COMPARES.index(compare), dot.data_ptr(), den.data_ptr(), b, n_cols, tile_n,
            int(off), part.data_ptr(), out.data_ptr(), stream))
    select_variant.launches[compare] += 1
    return out[:, 0:1], out[:, 1:2], out[:, 2:3]


select_variant.launches = dict.fromkeys(COMPARES, 0)


def select_lanes_reference(dot, den, i16_tree: bool = False) -> torch.Tensor:
    """Plain version of :func:`select_lanes`: the probe's loops on tensors."""
    if i16_tree:
        sel = _sel_i16
    else:
        sel, dot, den = sel_i32, dot.int(), den.int()
    n, d, col = _tile_trees(dot, den, 0, TILE_N, LANES, sel)
    return torch.cat([v.int() for v in _fold_tiles(n, d, col, sel)], dim=1)


def select_lanes(dot: torch.Tensor, den: torch.Tensor, i16_tree: bool = False) -> torch.Tensor:
    """select_i16_probe.py's ``make(i16_tree)`` kernel: int16 dot, den
    [B*32, N] -> int32 [B, 384], per query the 128 lane winners (n lanes, d
    lanes, column lanes), carried in int16 (``i16_tree``) or int32. One launch
    (and its fold) for CUDA tensors. B % 8 == 0, N % 2048 == 0."""
    b, n_cols = _check_shape("select_lanes", dot, den, TILE_N, torch.int16)
    if dot.device.type == "cpu":
        return select_lanes_reference(dot, den, i16_tree)
    if not (dot.is_contiguous() and den.is_contiguous()):
        raise ValueError("select_lanes: dot/den must be contiguous")
    lib = library()
    part = torch.empty(3 * LANES * b * (n_cols // TILE_N), dtype=torch.int32, device=dot.device)
    out = torch.empty((b, 3 * LANES), dtype=torch.int32, device=dot.device)
    with torch.cuda.device(dot.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch("select_lanes", lib.select_lanes_launch(
            int(bool(i16_tree)), dot.data_ptr(), den.data_ptr(), b, n_cols, part.data_ptr(),
            out.data_ptr(), stream))
    select_lanes.launches["i16" if i16_tree else "i32"] += 1
    return out


select_lanes.launches = dict.fromkeys(TREES, 0)
