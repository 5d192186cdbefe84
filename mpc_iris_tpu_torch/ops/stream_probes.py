"""The streaming, morph and bisect probe kernels (counterpart of the kernel
functions of ``scripts/dma_probe.py``, ``scripts/morph_probe.py`` and
``scripts/select_bisect.py``).

Each probe streams two int32 [B, N] inputs through (tb, tn) blocks and cuts
kernel (a)'s selection off at another stage. For CUDA tensors each function
launches ``csrc/stream_probes.cu`` (a kernel, then the fold of its per-tile
records); for CPU tensors it takes its plain version (``*_reference``), which
mirrors the probe's halving loops slice for slice. Every oddity of the probes
is kept:

- :func:`dma_variant` (``dma_probe.py::variant``): per (tb, tn) block the
  (8, 128) corner ``dot[i tb + 0..7, j tn + 0..127]`` (+ den's), written per
  block to [8 B/tb, 128 N/tn], or with ``revisit`` summed over j into
  [8 B/tb, 128]. The probe's ``prefetch`` and ``dimsem`` change no value and
  are not arguments.
- :func:`morph_stage` (``morph_probe.py::make(stage)``), blocks (256, 2,048):
  stages 0-2 the corner dot + den summed over j (one output, then three equal
  ones); stage 3 v = the sum over a query's 32 rows of num + den at lanes
  0-127, num = (den - dot) >> 1, and n = d = idx = v; stage 4 the rotation
  tree at lanes 0-127, idx = n; stage 5 the rotation tree, then the column
  tree to 128 lanes, idx the column j 2,048 + c. Stages 3-5 fold keep-first
  across tiles in tile order; in stage 3 the compare v2 v1 < v1 v2 is never
  true, so a later tile wins only when the kept v <= 0 < its v.
- :func:`morph2` (``make2``): [B/32, out_lanes], out_lanes 128 or 384 of
  n | d | idx; without ``compute`` the values are (a, a, a), a the corner;
  with 3 scratch the tiles are summed (no compute) or folded keep-first;
  without scratch only j = 0 writes, so it holds tile 0's values.
- :func:`morph3` (``make3`` in ``main3``): make2's "= select" (3 scratch,
  compute, 384 lanes); ``lane_tree`` then selects over the 128 lanes by the
  index-aware ``decode._frac_select`` tree and gives the winner to each lane.
- :func:`bisect` (``select_bisect.py::make(mode, tile_b, tile_n)``): three
  int32 [b, 1]. Every column tile overwrites the outputs, so each mode
  returns the last tile's values, though the kernel does every tile's work as
  the probe does. ``dma``: dot + den at rows 0 .. tile_b - 1 of each block
  (not a row per query), the tile's first column, d = idx = 0; ``reshape``:
  (num, den) at row 32q, the first column; ``rot``: the keep-first rotation
  tree at the first column; ``col``: the column tree over row 32q, idx = off
  + (J - 1) tile_n + c; ``full``: both trees, select_variant's ``i32`` on
  the last tile.

The keep-first steps and trees are ``ops/select_probes.py``'s (s1's
``sel_i32`` pairing). Shapes come from the arguments, where the probes read
module constants; the kernels take tiles of 2,048, 4,096 or 8,192 columns
(a bulk copy moves 2,048) and blocks of whole 32-row queries.
"""

from __future__ import annotations

from functools import partial

import torch

from mpc_iris_tpu_torch.ops._build import check_launch, library
from mpc_iris_tpu_torch.ops.decode import _frac_select
from mpc_iris_tpu_torch.ops.select_probes import (
    LANES,
    N_ROT_PAD,
    _fold_tiles,
    _tile_trees,
    sel_i32,
)

TB, TN = 256, 2048     # morph_probe.py's block, and dma_variant's default tiles
CORNER = 8             # rows of the TPU's (8, 128) tile
TILE_NS = (2048, 4096, 8192)
MODES = ("dma", "reshape", "rot", "col", "full")
STAGES = tuple(range(6))

# csrc/stream_probes.cu's stream kinds and folds
_CORNER, _DMA, _RESHAPE, _ROT, _COL, _ROW_SUM, _ROT_LANES = range(7)
_SUM, _FIRST, _LAST, _KEEP_FIRST, _LANE_TREE = range(5)
_MODE_KIND = {"dma": _DMA, "reshape": _RESHAPE, "rot": _ROT, "col": _COL}


def _wrapped_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The int32 sum along ``dim``, wrapping as the probes' int32 adds."""
    s = x.long().sum(dim)
    return ((s + 2**31) % 2**32 - 2**31).int()


def _corner(dot, den, tb: int, tn: int) -> torch.Tensor:
    """Each (tb, tn) block's (8, 128) corner, dot + den (or dot alone):
    [B/tb * 8, N/tn, 128], row 8i + r of block row i."""
    g0, g1 = dot.shape[0] // tb, dot.shape[1] // tn
    c = dot.reshape(g0, tb, g1, tn)[:, :CORNER, :, :LANES]
    if den is not None:
        c = c + den.reshape(g0, tb, g1, tn)[:, :CORNER, :, :LANES]
    return c.reshape(g0 * CORNER, g1, LANES)


def _check(name: str, dot, den, tb: int, tn: int) -> None:
    """The inputs' contract, the same on every device: int32 [B, N] of one
    shape and device, B a multiple of tb (whole 32-row queries), N of tn."""
    if dot.dim() != 2 or dot.dtype != torch.int32:
        raise ValueError(f"{name}: dot must be int32 [B, N]")
    if not (isinstance(den, torch.Tensor) and den.shape == dot.shape
            and den.dtype == torch.int32 and den.device == dot.device):
        raise ValueError(f"{name}: den must be int32 of dot's shape, on its device")
    if dot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dot.device}")
    rows, cols = dot.shape
    if tb < N_ROT_PAD or tb % N_ROT_PAD or rows == 0 or rows % tb or rows // N_ROT_PAD > 65535:
        raise ValueError(f"{name}: {rows} rows must be a multiple of the block's {tb} rows, "
                         f"which must be whole queries of {N_ROT_PAD} (at most 65,535 queries)")
    if tn not in TILE_NS or cols == 0 or cols % tn or cols >= 2**31:
        raise ValueError(f"{name}: the tile's {tn} columns must be one of {TILE_NS} and "
                         f"divide N={cols}")
    if dot.device.type == "cuda":
        for x in (dot, den):
            if not x.is_contiguous() or x.data_ptr() % 16:
                raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")


def _stream(kind: int, dot, den, block_rows: int, tile_n: int, off: int, out) -> None:
    lib = library()
    with torch.cuda.device(dot.device):
        check_launch("stream_probe", lib.stream_probe_launch(
            kind, dot.data_ptr(), None if den is None else den.data_ptr(), dot.shape[0],
            dot.shape[1], block_rows, tile_n, int(off), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream))


def _trees(lanes: int, dot, den, tile_n: int, off: int, part) -> None:
    lib = library()
    with torch.cuda.device(dot.device):
        check_launch("probe_trees", lib.probe_trees_launch(
            lanes, dot.data_ptr(), den.data_ptr(), dot.shape[0] // N_ROT_PAD, dot.shape[1],
            tile_n, int(off), part.data_ptr(), torch.cuda.current_stream().cuda_stream))


def _fold(fold: int, part, n_tiles: int, planes: int, lanes: int, out, out_planes: int,
          s_g: int, s_k: int) -> None:
    """Fold part [groups, n_tiles, planes, lanes] into out[g s_g + k s_k + l]."""
    lib = library()
    groups = part.numel() // (n_tiles * planes * lanes)
    with torch.cuda.device(part.device):
        check_launch("probe_fold", lib.probe_fold_launch(
            fold, part.data_ptr(), groups, n_tiles, planes, lanes, out_planes, s_g, s_k,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream))


def _empty(shape, like) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=like.device)


def dma_variant_reference(dot, den=None, revisit: bool = False, tiles=(TB, TN)):
    """Plain version of :func:`dma_variant`."""
    c = _corner(dot, den, *tiles)
    return _wrapped_sum(c, 1) if revisit else c.reshape(c.shape[0], -1)


def dma_variant(dot: torch.Tensor, den: torch.Tensor | None = None, *, revisit: bool = False,
                tiles=(TB, TN)) -> torch.Tensor:
    """dma_probe.py's ``variant``: the (8, 128) corner of every (tb, tn)
    block of int32 dot [B, N], plus den's (``den`` None: the probe's
    ``two_inputs=False``) -> int32 [8 B/tb, 128 N/tn], or with ``revisit``
    summed over the column blocks, [8 B/tb, 128]. For CUDA tensors one
    launch streams every block through shared memory."""
    tb, tn = tiles
    _check("dma_variant", dot, dot if den is None else den, tb, tn)
    if dot.device.type == "cpu":
        return dma_variant_reference(dot, den, revisit, tiles)
    rows, t = dot.shape[0] // tb * CORNER, dot.shape[1] // tn
    corners = _empty((rows, t * LANES), dot)
    _stream(_CORNER, dot, den, tb, tn, 0, corners)
    out = corners
    if revisit:
        out = _empty((rows, LANES), dot)
        _fold(_SUM, corners, t, 1, LANES, out, 1, LANES, 0)
    dma_variant.launches += 1
    return out


dma_variant.launches = 0


def _morph_trees(dot, den, stage: int):
    """Stages 3-5's per-tile (n, d, idx) [B/32, N/2048, 128]."""
    if stage == 3:
        b, t = dot.shape[0] // N_ROT_PAD, dot.shape[1] // TN
        d4 = den.reshape(b, N_ROT_PAD, t, TN)
        v = _wrapped_sum(((d4 - dot.reshape(d4.shape)) >> 1) + d4, 1)[..., :LANES]
        return v, v, v
    if stage == 4:
        n, d, _ = _tile_trees(dot, den, 0, TN, TN, sel_i32)
        return n[..., :LANES], d[..., :LANES], n[..., :LANES]
    return _tile_trees(dot, den, 0, TN, LANES, sel_i32)


def morph_stage_reference(dot, den, stage: int):
    """Plain version of :func:`morph_stage`."""
    if stage <= 2:
        acc = _wrapped_sum(_corner(dot, den, TB, TN), 1)
        return acc if stage == 0 else (acc, acc.clone(), acc.clone())
    return _fold_tiles(*_morph_trees(dot, den, stage), sel_i32)


def morph_stage(dot: torch.Tensor, den: torch.Tensor, stage: int):
    """morph_probe.py's ``make(stage)`` kernel on int32 dot, den [B, N]
    (blocks of 256 x 2,048): stage 0 one int32 [B/32, 128], stages 1-5
    three (n, d, idx). For CUDA tensors one kernel launch and its fold."""
    if stage not in STAGES:
        raise ValueError(f"morph_stage: stage must be one of {STAGES}")
    _check("morph_stage", dot, den, TB, TN)
    if dot.device.type == "cpu":
        return morph_stage_reference(dot, den, stage)
    q, t = dot.shape[0] // N_ROT_PAD, dot.shape[1] // TN
    n_out = 1 if stage == 0 else 3
    out = _empty((n_out, q, LANES), dot)
    if stage <= 2:
        part = _empty((q, t * LANES), dot)
        _stream(_CORNER, dot, den, TB, TN, 0, part)
        _fold(_SUM, part, t, 1, LANES, out, n_out, LANES, q * LANES)
    else:
        part = _empty((q, t, 3, LANES), dot)
        if stage == 5:
            _trees(LANES, dot, den, TN, 0, part)
        else:
            _stream(_ROW_SUM if stage == 3 else _ROT_LANES, dot, den, N_ROT_PAD, TN, 0, part)
        _fold(_KEEP_FIRST, part, t, 3, LANES, out, 3, LANES, q * LANES)
    morph_stage.launches += 1
    return out[0] if stage == 0 else (out[0], out[1], out[2])


morph_stage.launches = 0


def _check_morph2(scratch: int, out_lanes: int) -> None:
    if scratch not in (0, 3) or out_lanes not in (LANES, 3 * LANES):
        raise ValueError("morph2: scratch must be 0 or 3, out_lanes 128 or 384")


def morph2_reference(dot, den, scratch: int = 0, compute: bool = False,
                     out_lanes: int = LANES) -> torch.Tensor:
    """Plain version of :func:`morph2`."""
    if compute:
        vals = _tile_trees(dot, den, 0, TN, LANES, sel_i32)
    else:
        a = _corner(dot, den, TB, TN)
        vals = (a, a, a)
    if not scratch:
        vals = tuple(v[:, 0] for v in vals)  # only j == 0 writes
    elif compute:
        vals = _fold_tiles(*vals, sel_i32)
    else:
        vals = tuple(_wrapped_sum(v, 1) for v in vals)
    return torch.cat(vals, dim=1)[:, :out_lanes]


def morph2(dot: torch.Tensor, den: torch.Tensor, *, scratch: int = 0, compute: bool = False,
           out_lanes: int = LANES) -> torch.Tensor:
    """morph_probe.py's ``make2`` kernel on int32 dot, den [B, N] -> int32
    [B/32, out_lanes]: ``scratch`` 0 or 3, ``out_lanes`` 128 or 384. For
    CUDA tensors one kernel launch and its fold. (The probe's ``prefetch``
    changes no value and is not an argument.)"""
    _check_morph2(scratch, out_lanes)
    _check("morph2", dot, den, TB, TN)
    if dot.device.type == "cpu":
        return morph2_reference(dot, den, scratch, compute, out_lanes)
    q, t = dot.shape[0] // N_ROT_PAD, dot.shape[1] // TN
    if compute:
        planes, fold = 3, (_KEEP_FIRST if scratch else _FIRST)
        part = _empty((q, t, 3, LANES), dot)
        _trees(LANES, dot, den, TN, 0, part)
    else:
        planes, fold = 1, (_SUM if scratch else _FIRST)
        part = _empty((q, t * LANES), dot)
        _stream(_CORNER, dot, den, TB, TN, 0, part)
    out = _empty((q, out_lanes), dot)
    _fold(fold, part, t, planes, LANES, out, out_lanes // LANES, out_lanes, LANES)
    morph2.launches += 1
    return out


morph2.launches = 0


def morph3_reference(dot, den, lane_tree: bool = False) -> torch.Tensor:
    """Plain version of :func:`morph3`."""
    n, d, i = _fold_tiles(*_tile_trees(dot, den, 0, TN, LANES, sel_i32), sel_i32)
    if lane_tree:
        w = LANES
        while w > 1:
            half = w // 2
            n, d, i = _frac_select(n[:, :half], d[:, :half], i[:, :half],
                                   n[:, half:], d[:, half:], i[:, half:])
            w = half
        n, d, i = (v.expand(-1, LANES) for v in (n, d, i))
    return torch.cat([n, d, i], dim=1)


def morph3(dot: torch.Tensor, den: torch.Tensor, lane_tree: bool = False) -> torch.Tensor:
    """morph_probe.py's ``make3`` kernel (``main3``) on int32 dot, den [B, N]
    -> int32 [B/32, 384], n | d | idx. For CUDA tensors one kernel launch and
    its fold."""
    _check("morph3", dot, den, TB, TN)
    if dot.device.type == "cpu":
        return morph3_reference(dot, den, lane_tree)
    q, t = dot.shape[0] // N_ROT_PAD, dot.shape[1] // TN
    part = _empty((q, t, 3, LANES), dot)
    _trees(LANES, dot, den, TN, 0, part)
    out = _empty((q, 3 * LANES), dot)
    _fold(_LANE_TREE if lane_tree else _KEEP_FIRST, part, t, 3, LANES, out, 3, 3 * LANES, LANES)
    morph3.launches += 1
    return out


morph3.launches = 0


def _check_bisect(mode: str, tile_b: int, b: int) -> None:
    if mode not in MODES:
        raise ValueError(f"bisect: mode must be one of {MODES}")
    if not (1 <= tile_b <= N_ROT_PAD) or b % tile_b:
        raise ValueError(f"bisect: tile_b={tile_b} must be in [1, {N_ROT_PAD}] and divide "
                         f"B={b}")


def bisect_reference(dot, den, off: int = 0, mode: str = "full", tile_b: int = 8,
                     tile_n: int = TN):
    """Plain version of :func:`bisect`: the last column tile's values (every
    tile overwrites the one before)."""
    b = dot.shape[0] // N_ROT_PAD
    j = dot.shape[1] // tile_n - 1
    last = slice(j * tile_n, (j + 1) * tile_n)
    zero = torch.zeros((b, 1), dtype=torch.int32, device=dot.device)
    if mode == "dma":
        v = dot[:, j * tile_n] + den[:, j * tile_n]
        return v.reshape(b // tile_b, tile_b * N_ROT_PAD)[:, :tile_b].reshape(b, 1), zero, zero
    if mode == "full":
        n, d, i = _tile_trees(dot[:, last], den[:, last], off + j * tile_n, tile_n, 1, sel_i32)
        return n.reshape(b, 1), d.reshape(b, 1), i.reshape(b, 1)
    dot3 = dot[:, last].reshape(b, N_ROT_PAD, tile_n)
    den3 = den[:, last].reshape(b, N_ROT_PAD, tile_n)
    num = (den3 - dot3) >> 1
    if mode == "reshape":
        return num[:, 0, 0:1], den3[:, 0, 0:1], zero
    if mode == "rot":
        n, d = num[..., 0], den3[..., 0]
        k = N_ROT_PAD
        while k > 1:
            half = k // 2
            n, d = sel_i32(n[:, :half], d[:, :half], n[:, half:], d[:, half:])
            k = half
        return n, d, zero
    n, d = num[:, 0], den3[:, 0]  # col: rotation row 0 alone
    col = (torch.arange(tile_n, dtype=torch.int32, device=dot.device) + off + j * tile_n
           ).expand(b, tile_n)
    tn = tile_n
    while tn > 1:
        half = tn // 2
        n, d, col = sel_i32(n[:, :half], d[:, :half], n[:, half:], d[:, half:],
                            col[:, :half], col[:, half:])
        tn = half
    return n, d, col


def bisect(dot: torch.Tensor, den: torch.Tensor, off: int = 0, mode: str = "full",
           tile_b: int = 8, tile_n: int = TN):
    """select_bisect.py's ``make(mode, tile_b, tile_n)`` kernel on int32 dot,
    den [b*32, n] and a column offset -> (n, d, idx) int32 [b, 1] each. For
    CUDA tensors one kernel launch over every tile and the pick of the last."""
    b = dot.shape[0] // N_ROT_PAD if dot.dim() == 2 else 0
    _check_bisect(mode, tile_b, b)
    _check("bisect", dot, den, tile_b * N_ROT_PAD, tile_n)
    if dot.device.type == "cpu":
        return bisect_reference(dot, den, off, mode, tile_b, tile_n)
    t = dot.shape[1] // tile_n
    part = _empty((b, t, 3), dot)
    if mode == "full":
        _trees(1, dot, den, tile_n, off, part)
    else:
        _stream(_MODE_KIND[mode], dot, den, tile_b * N_ROT_PAD, tile_n, off, part)
    out = _empty((b, 3), dot)
    _fold(_LAST, part, t, 3, 1, out, 3, 3, 1)
    bisect.launches += 1
    return out[:, 0:1], out[:, 1:2], out[:, 2:3]


bisect.launches = 0


# The variants the probes' mains run, as the probes list them: dma_probe.py's
# main (label, reads den, keywords; its first variant is printed "1in plain"
# though it reads both inputs, and prefetch and dimsem change no value),
# morph_probe.py's main (the stages), main2 and main3, select_bisect.py's
# main (every mode at two tile shapes).
DMA_MAIN = (
    ("2in plain", True, {}), ("1in plain", False, {}), ("2in revisit", True, {"revisit": True}),
    ("2in prefetch", True, {}), ("2in pre+revis", True, {"revisit": True}),
    ("2in dimsem par", True, {}), ("2in arb+arb", True, {}),
    ("2in tile 512x4k", True, {"tiles": (512, 4096)}),
    ("2in tile 1024x2k", True, {"tiles": (1024, 2048)}),
)
STAGE_NAMES = ("1 out, revisit", "3 outs, revisit", "3 outs + 3 scratch",
               "+ reshape/rot-sum", "+ rotation select tree", "+ column tree (full)")
_SELECT_LIKE = {"scratch": 3, "compute": True, "out_lanes": 3 * LANES}
MORPH2_MAIN = (
    ("1out trivial", {}), ("1out +3scratch", {"scratch": 3}),
    ("1out +3scratch +compute", {"scratch": 3, "compute": True}),
    ("1out(384) +3scr +compute", _SELECT_LIKE), ("+ prefetch (=select)", _SELECT_LIKE),
)
MORPH3_MAIN = (("replica, no lane tree", False), ("replica, with lane tree", True))
BISECT_TILES = ((8, 2048), (4, 8192))
PROBES = ("dma_variant", "morph_stage", "morph2", "morph3", "bisect")


def main_variants(probe: str, dot, den, off: int = 0) -> list:
    """The variants of ``probe``'s main (one of :data:`PROBES`) on these
    inputs: [(label, call of the function, call of its plain version)]."""
    if probe == "dma_variant":
        runs = [(label, (dot, den if two else None), kw) for label, two, kw in DMA_MAIN]
        fns = dma_variant, dma_variant_reference
    elif probe == "morph_stage":
        runs = [(f"stage {k} {STAGE_NAMES[k]}", (dot, den, k), {}) for k in STAGES]
        fns = morph_stage, morph_stage_reference
    elif probe == "morph2":
        runs = [(label, (dot, den), kw) for label, kw in MORPH2_MAIN]
        fns = morph2, morph2_reference
    elif probe == "morph3":
        runs = [(label, (dot, den, tree), {}) for label, tree in MORPH3_MAIN]
        fns = morph3, morph3_reference
    elif probe == "bisect":
        runs = [(f"{mode} {tiles}", (dot, den, off, mode, *tiles), {})
                for mode in MODES for tiles in BISECT_TILES]
        fns = bisect, bisect_reference
    else:
        raise ValueError(f"main_variants: probe must be one of {PROBES}")
    return [(label, partial(fns[0], *a, **kw), partial(fns[1], *a, **kw))
            for label, a, kw in runs]
