"""Plaintext min-distance search over a device-resident template DB
(counterpart of ``mpc_iris_tpu/models/engines.py``, plaintext slice).

The request path of ``PlaintextEngine.match``:

1. ``prepare_query_planes``: unpack, ring-encode and rotation-expand the
   queries to int8 [B, 31, K].
2. Packed storage, :func:`match_scan_packed_auto`: B in 1..8 goes to the
   packed small-batch kernel (ops/packed_match.py); any other B to
   ``_match_scan_packed``, which per chunk unpacks and encodes the DB, takes
   the two int8 products (numerator dot and denominator) and selects the
   chunk winner with the selection kernel (ops/select.py). Dense storage,
   :func:`match_scan_auto`, skips the unpack.
3. The host turns each winning integer pair into an f64.

The threshold audit, ``PlaintextEngine.min_fractions`` and ``find_under``:

1. The fraction spectrum, per (query, entry) the min-over-rotations exact
   (n, d), int16 [2, B, N_padded] on the device: packed storage through
   :func:`fractions_scan_packed_auto` (B in 1..8 -> the packed audit-spectrum
   kernel, any other B -> ``_fractions_scan_packed``), dense through
   ``_fractions_scan``.
2. :func:`_compact_under_device` keeps the entries under a conservative f32
   bound of the threshold, at most k per query, on the device.
3. The host settles them exactly (:func:`settle_compacted_under`), or, when a
   query has more than k candidates, decodes the whole spectrum
   (:func:`find_under_from_fractions`).

``prepare_query_planes``, ``_unpack_encode_chunk``, ``_match_scan_packed`` and
the spectrum scans live in ops/scan.py, below the packed kernels' plain
versions, and are re-exported here. The DB is [C, c, ...] on the device and
padded rows are all zero (mask 0 -> den 0 -> never a valid distance). On the
card every selection goes through a CUDA kernel; on the CPU the kernel
wrappers run their plain versions.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from mpc_iris_tpu.constants import BITS, N_ROTATIONS
from mpc_iris_tpu_torch.ops.decode import (
    decode_distance_batch_np,
    fraction_to_f64,
    fractions_to_f64_np,
    under_threshold_mask_np,
)
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.packed_match import (
    fractions_packed_small_b,
    match_packed_small_b,
    small_b_ok,
)
from mpc_iris_tpu_torch.ops.scan import (
    _fractions_scan,
    _fractions_scan_packed,
    _fused_rows,
    _match_scan_packed,
    _plain_select,
    _scan,
    _unpack_encode_chunk,
    prepare_query_planes,
)
from mpc_iris_tpu_torch.ops.select import select_chunk
from mpc_iris_tpu_torch.ops.self_test import kernel_self_test

# DB entries per scan step. Untuned. Chosen so that one step's transients stay
# a few GB at B <= 1024 (the two int32 products are 8 * B * 32 * chunk bytes,
# 4.3 GB at B = 1024; the unpacked int8 planes about 5 * 12,800 * chunk bytes)
# while a 1M-entry DB takes 64 steps, few enough that per-step launches stay
# small next to the products.
DEFAULT_CHUNK = 16384


def _pad_chunks(arr: np.ndarray, chunk: int, pad_value=0):
    """Host-side: pad the leading axis to a multiple of ``chunk`` and reshape
    to [num_chunks, chunk, ...]. Returns (reshaped, true_count). Copy of
    ``mpc_iris_tpu.models.engines._pad_chunks`` (that module imports jax)."""
    n = arr.shape[0]
    num_chunks = max(1, -(-n // chunk))
    padded = num_chunks * chunk
    if padded != n:
        pad_width = [(0, padded - n)] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad_width, constant_values=pad_value)
    return arr.reshape(num_chunks, chunk, *arr.shape[1:]), n


# --------------------------------------------------------------------- dense scans


def _match_scan(q_enc, q_mask, db_enc, db_mask) -> torch.Tensor:
    """Plain min-distance search over a dense DB: int8 [C, c, K] encodings
    and masks. Returns int32 [3, B] (numerator, denominator, index)."""
    b = q_enc.shape[0]
    return _scan(b, q_enc.reshape(b * N_ROTATIONS, BITS),
                 q_mask.reshape(b * N_ROTATIONS, BITS),
                 db_enc.shape[0], db_enc.shape[1],
                 lambda c: (db_enc[c], db_mask[c]), _plain_select)


def _match_scan_fused(q_enc, q_mask, db_enc, db_mask) -> torch.Tensor:
    """:func:`_match_scan` with each chunk's selection in ``select_chunk``;
    identical results."""
    return _scan(q_enc.shape[0], _fused_rows(q_enc), _fused_rows(q_mask),
                 db_enc.shape[0], db_enc.shape[1],
                 lambda c: (db_enc[c], db_mask[c]), select_chunk)


def match_scan_auto(q_enc, q_mask, db_enc, db_mask) -> torch.Tensor:
    """Dense dispatch: every batch goes through ``select_chunk`` (the kernel
    on the card, its plain version on the CPU)."""
    return _match_scan_fused(q_enc, q_mask, db_enc, db_mask)


# --------------------------------------------------------------------- packed scans


def match_scan_packed_auto(q_enc, q_mask, db_pat, db_msk) -> torch.Tensor:
    """Packed dispatch: B in 1..8 -> the packed small-batch kernel; any
    other B -> the packed scan through ``select_chunk``. Each wrapper runs
    its kernel on the card and its plain version on the CPU; all paths give
    identical results."""
    if small_b_ok(q_enc.shape[0]):
        return match_packed_small_b(q_enc, q_mask, db_pat, db_msk)
    return _match_scan_packed(q_enc, q_mask, db_pat, db_msk, fused=True)


def _plaintext_chunk_fractions(q_enc, q_mask, enc_c, mask_c):
    """Per-entry per-rotation (num, den) for one chunk: int32 [B, c, 31] each."""
    b = q_enc.shape[0]
    chunk = enc_c.shape[0]
    dot = dot_bits_batch(q_enc.reshape(b * N_ROTATIONS, BITS), enc_c)
    den = dot_bits_batch(q_mask.reshape(b * N_ROTATIONS, BITS), mask_c)
    dot = dot.reshape(b, N_ROTATIONS, chunk).transpose(1, 2)
    den = den.reshape(b, N_ROTATIONS, chunk).transpose(1, 2)
    return (den - dot) >> 1, den


# --------------------------------------------------------------------- audit spectrum


def fractions_scan_packed_auto(q_enc, q_mask, db_pat, db_msk) -> torch.Tensor:
    """Audit-spectrum dispatch for packed storage (mirrors
    ``engines.fractions_scan_packed_auto``): B in 1..8 -> the packed
    audit-spectrum kernel; any other B -> the packed spectrum scan. Identical
    int16 [2, B, N_padded] values either way."""
    if small_b_ok(q_enc.shape[0]):
        return fractions_packed_small_b(q_enc, q_mask, db_pat, db_msk)
    return _fractions_scan_packed(q_enc, q_mask, db_pat, db_msk)


def _compact_under_device(nd: torch.Tensor, t_hi, k: int):
    """Device-side audit compaction: keep only the CANDIDATE entries.

    The contract of ``engines._compact_under_device``. nd: int16 [2, B, Np]
    spectrum on the device; t_hi: an f32 value, a conservative upper bound of
    the threshold, so the f32 prefilter ``n < t_hi * d`` is a superset of the
    exact ``n/d < t`` (n, d <= 12,800 are exact in f32; the one rounding is
    the multiply) and d == 0 never qualifies. Returns

    - meta int32 [B, k+1]: column 0 the candidate count (may exceed k: the
      caller then takes the full spectrum), columns 1.. the first k
      candidates' DB indices, ascending, padded with -1;
    - nd_out int16 [2, B, k]: their (n, d), zero-padded.

    On the GPU this is the straightforward form, a cumsum of the mask and a
    scatter of the first k candidates (``nonzero`` lists them in order); the
    reference's two-level block compaction works around serial scatter on
    the TPU and is not carried over, so the count is never forced past k.
    """
    b = nd.shape[1]
    t = torch.tensor(float(np.float32(t_hi)), dtype=torch.float32, device=nd.device)
    mask = nd[0].float() < t * nd[1].float()
    counts = mask.sum(dim=1, dtype=torch.int32)
    slot = mask.cumsum(dim=1, dtype=torch.int32) - 1
    q, e = (mask & (slot < k)).nonzero(as_tuple=True)
    slot = slot[q, e]
    idx = torch.full((b, k), -1, dtype=torch.int32, device=nd.device)
    idx[q, slot] = e.to(torch.int32)
    nd_out = nd.new_zeros((2, b, k))
    nd_out[:, q, slot] = nd[:, q, e]
    return torch.cat([counts[:, None], idx], dim=1), nd_out


# --------------------------------------------------------------------- results


@dataclass
class MatchResult:
    """Winner of a min-distance search for one query (copy of
    ``mpc_iris_tpu.models.engines.MatchResult``)."""

    index: int
    distance: float  # reference-exact f64 of numerator/denominator
    numerator: int
    denominator: int


def _results_from_triples(n, d, i) -> list[MatchResult]:
    """Copy of ``mpc_iris_tpu.models.engines._results_from_triples``."""
    n, d, i = np.asarray(n), np.asarray(d), np.asarray(i)
    return [
        MatchResult(int(ii), fraction_to_f64(int(nn), int(dd)), int(nn), int(dd))
        for nn, dd, ii in zip(n, d, i)
    ]


class AuditLimitExceeded(RuntimeError):
    """An under-threshold audit produced more matches than the caller's
    limit allows (copy of ``mpc_iris_tpu.models.engines.AuditLimitExceeded``:
    a client choosing a huge threshold must not force an O(N) match list)."""


def hits_under_from_fractions(nums, dens, threshold: float,
                              limit: int | None = None, indices=None):
    """Host epilogue of every threshold-audit path (copy of
    ``mpc_iris_tpu.models.engines.hits_under_from_fractions``): per-entry
    minimal (numerator, denominator) int arrays [N] -> (idx, dist, n, d)
    arrays of the entries exactly under the threshold, ascending by f64
    distance, index-ordered within equal-f64 ties. Raises
    :class:`AuditLimitExceeded` before building any per-hit objects when
    more than ``limit`` entries match. ``indices``: the global DB indices of
    the rows (compacted candidates); default 0..N-1."""
    sel = np.nonzero(under_threshold_mask_np(nums, dens, threshold))[0]
    idx = sel if indices is None else np.asarray(indices)[sel]
    if limit is not None and idx.size > limit:
        raise AuditLimitExceeded(
            f"{idx.size} entries under threshold {threshold} exceeds the "
            f"configured match limit {limit}")
    n_b = np.asarray(nums)[sel].astype(np.int64)
    d_b = np.asarray(dens)[sel].astype(np.int64)
    dist = fractions_to_f64_np(n_b, d_b)
    order = np.lexsort((idx, dist))
    return idx[order], dist[order], n_b[order], d_b[order]


def _match_list(idx, dist, n_b, d_b) -> list[MatchResult]:
    return [MatchResult(int(i), float(v), int(nn), int(dd))
            for i, v, nn, dd in zip(idx, dist, n_b, d_b)]


def settle_compacted_under(meta, nd_c, k: int, count: int, threshold: float,
                           limit: int | None = None) -> list[list[MatchResult]] | None:
    """Host epilogue of the device compaction (copy of
    ``mpc_iris_tpu.models.engines.settle_compacted_under``): the exact
    settle of each query's candidates -> its match list, or None when any
    query's candidates overflowed the k slots (the caller then takes the
    full spectrum). ``meta``, ``nd_c``: host arrays of
    :func:`_compact_under_device`."""
    meta = np.asarray(meta)
    counts = meta[:, 0]
    if (counts > k).any():
        return None
    nd_c = np.asarray(nd_c)
    results = []
    for q in range(meta.shape[0]):
        c = int(counts[q])
        idx_g = meta[q, 1:1 + c]
        keep = idx_g < count  # defensive: padded rows (d == 0) are never candidates
        results.append(_match_list(*hits_under_from_fractions(
            nd_c[0, q, :c][keep].astype(np.int64),
            nd_c[1, q, :c][keep].astype(np.int64),
            threshold, limit=limit, indices=idx_g[keep])))
    return results


def orchestrate_find_under(count: int, b: int, threshold: float, limit, compact_k,
                           full_nd_fn, compact_fn) -> list[list[MatchResult]]:
    """The audit policy (copy of
    ``mpc_iris_tpu.models.engines.orchestrate_find_under``): threshold
    classes, the compact buffer size k, the conservative f32 bound, the
    compacted attempt with its exact settle, and the overflow fallback.

    full_nd_fn() -> host uint16 [2, B, count] spectrum (the exact path);
    compact_fn(t_hi, k) -> host (meta, nd_c) of :func:`_compact_under_device`.

    The bound t_hi = f32(t * (1 + 1e-4)) is a guaranteed superset only while
    it is a normal finite f32: a subnormal t_hi (t below about 1.2e-38) may
    be flushed to zero, turning ``n < t_hi * d`` into ``0 < 0`` and dropping
    exact duplicates (n = 0), and an overflowed one is inf. Such thresholds
    take the exact full path."""
    t = float(threshold)
    if math.isnan(t) or t <= 0.0:
        return [[] for _ in range(b)]
    k = compact_k if compact_k is not None else max(65536, 2 * limit if limit else 0)
    k = min(k, count)
    with np.errstate(over="ignore"):  # overflow handled by the isfinite guard
        t_hi = np.float32(t * (1.0 + 1e-4))
    if (math.isinf(t) or k == count
            or not np.isfinite(t_hi) or t_hi < np.finfo(np.float32).tiny):
        return find_under_from_fractions(full_nd_fn(), t, limit=limit)
    meta, nd_c = compact_fn(t_hi, k)
    compacted = settle_compacted_under(meta, nd_c, k, count, t, limit=limit)
    if compacted is None:
        # candidates overflowed the compact buffer: identical results via
        # the full spectrum
        return find_under_from_fractions(full_nd_fn(), t, limit=limit)
    return compacted


def find_under_from_fractions(nd: np.ndarray, threshold: float,
                              limit: int | None = None) -> list[list[MatchResult]]:
    """Host half of the audit (copy of
    ``mpc_iris_tpu.models.engines.find_under_from_fractions``): [2, B, N]
    per-entry minimal (numerator, denominator) pairs -> per query every
    entry exactly under the threshold, ascending by f64 distance
    (index-ordered within equal-f64 ties)."""
    return [_match_list(*hits_under_from_fractions(nd[0, q], nd[1, q], threshold,
                                                   limit=limit))
            for q in range(nd.shape[1])]


# --------------------------------------------------------------------- engine


class PlaintextEngine:
    """Plaintext min-distance search over a device-resident template DB."""

    def __init__(self, patterns_packed: np.ndarray, masks_packed: np.ndarray, *,
                 device, chunk: int = DEFAULT_CHUNK, storage: str = "auto"):
        """Args:
        patterns_packed, masks_packed: uint8 [N, 1600] packed planes (host).
        device: where the DB lives and the search runs; there is no default,
          and a CUDA device without a card raises.
        chunk: DB entries per scan step (rounded up to a multiple of 8 on the
          card, where the int8 product needs it; the padded rows never win).
        storage: "packed" keeps the raw bit planes (3.2 KB per entry) and
          unpacks per chunk; "dense" keeps int8 encodings and masks (25.6 KB
          per entry); "auto" is packed, as in the reference.
        """
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PlaintextEngine: device is CUDA but no CUDA card "
                               "is available")
        if storage == "auto":
            storage = "packed"
        if storage not in ("packed", "dense"):
            raise ValueError(f"unknown storage {storage!r}")
        kernel_self_test(self.device)
        n = patterns_packed.shape[0]
        chunk = min(chunk, max(128, n))
        if self.device.type == "cuda":
            chunk = -(-chunk // 8) * 8
        self.storage = storage
        self.chunk = chunk
        pat_c, self.count = _pad_chunks(
            np.ascontiguousarray(patterns_packed, dtype=np.uint8), chunk)
        msk_c, _ = _pad_chunks(np.ascontiguousarray(masks_packed, dtype=np.uint8), chunk)
        db_pat = torch.from_numpy(np.require(pat_c, requirements="CW")).to(self.device)
        db_msk = torch.from_numpy(np.require(msk_c, requirements="CW")).to(self.device)
        self.db_pat = self.db_msk = self.db_enc = self.db_mask = None
        if storage == "packed":
            self.db_pat, self.db_msk = db_pat, db_msk
        else:
            # unpack on the device, one chunk at a time
            shape = (db_pat.shape[0], chunk, BITS)
            self.db_enc = torch.empty(shape, dtype=torch.int8, device=self.device)
            self.db_mask = torch.empty(shape, dtype=torch.int8, device=self.device)
            for c in range(shape[0]):
                self.db_enc[c], self.db_mask[c] = _unpack_encode_chunk(db_pat[c], db_msk[c])

    def _queries(self, patterns_packed, masks_packed):
        def put(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device, torch.uint8)
            return torch.from_numpy(np.array(x, dtype=np.uint8)).to(self.device)

        return prepare_query_planes(put(patterns_packed), put(masks_packed))

    def match(self, patterns_packed, masks_packed) -> list[MatchResult]:
        """Min-distance entry per query. uint8 [B, 1600] packed query planes."""
        q_enc, q_mask = self._queries(patterns_packed, masks_packed)
        n, d, i = self.match_arrays(q_enc, q_mask).cpu().numpy()
        return _results_from_triples(n, d, i)

    def match_arrays(self, q_enc, q_mask) -> torch.Tensor:
        """Prepared query planes -> int32 [3, B] stacked (numerator,
        denominator, DB index) on the engine's device."""
        if self.storage == "packed":
            return match_scan_packed_auto(q_enc, q_mask, self.db_pat, self.db_msk)
        return match_scan_auto(q_enc, q_mask, self.db_enc, self.db_mask)

    def distances(self, patterns_packed, masks_packed) -> np.ndarray:
        """Full f64 distance matrix [B, N] (for tests and small DBs),
        bit-identical to the scalar oracle ``Template.distance`` per pair."""
        q_enc, q_mask = self._queries(patterns_packed, masks_packed)
        packed = self.storage == "packed"
        n_chunks = (self.db_pat if packed else self.db_enc).shape[0]
        out = []
        for c in range(n_chunks):
            if packed:
                enc_c, mask_c = _unpack_encode_chunk(self.db_pat[c], self.db_msk[c])
            else:
                enc_c, mask_c = self.db_enc[c], self.db_mask[c]
            num, den = _plaintext_chunk_fractions(q_enc, q_mask, enc_c, mask_c)
            num, den = num.cpu().numpy(), den.cpu().numpy()
            vals = decode_distance_batch_np(
                # decode takes u16 "dots": dot = den - 2*num (exact ints)
                (den - 2 * num).astype(np.int64) & 0xFFFF,
                den,
            ).reshape(num.shape[0], -1)
            out.append(vals)
        return np.concatenate(out, axis=1)[:, : self.count]

    def _guard_spectrum(self, b: int) -> None:
        """The spectrum costs 4 bytes per (query, padded entry) on the
        device, on both the full and the compacted path (mirrors
        ``PlaintextEngine._guard_spectrum``)."""
        db = self.db_pat if self.storage == "packed" else self.db_enc
        out_bytes = 4 * b * db.shape[0] * db.shape[1]
        if out_bytes > 4 * (1 << 30):
            raise ValueError(f"min_fractions output would be {out_bytes / 2**30:.1f} GiB "
                             f"on device (B={b}); split the query batch")

    def _spectrum(self, q_enc, q_mask) -> torch.Tensor:
        """Prepared query planes -> the int16 [2, B, N_padded] fraction
        spectrum on the engine's device. Followed by
        :func:`_compact_under_device` it stands for the reference's fused
        ``_fractions_under_compact``, ``_fractions_under_compact_packed``,
        ``_fractions_under_compact_packed_smallb`` and
        ``fractions_under_compact_packed_auto``: without ``jit`` each is
        these two calls."""
        if self.storage == "packed":
            return fractions_scan_packed_auto(q_enc, q_mask, self.db_pat, self.db_msk)
        return _fractions_scan(q_enc, q_mask, self.db_enc, self.db_mask)

    def _host_spectrum(self, nd: torch.Tensor) -> np.ndarray:
        return nd[:, :, : self.count].cpu().numpy().astype(np.uint16)

    def min_fractions(self, patterns_packed, masks_packed) -> np.ndarray:
        """Per-entry minimal exact fractions: uint16 [2, B, N], the
        min-over-31-rotations (numerator, denominator) per (query, entry),
        the full distance spectrum (``fractions_to_f64_np`` decodes it
        exactly as ``Template.distance``). Costs 4 * B bytes of device memory
        per entry, so it is meant for audit-sized batches."""
        q_enc, q_mask = self._queries(patterns_packed, masks_packed)
        self._guard_spectrum(q_enc.shape[0])
        return self._host_spectrum(self._spectrum(q_enc, q_mask))

    def find_under(self, patterns_packed, masks_packed, threshold: float,
                   limit: int | None = None,
                   compact_k: int | None = None) -> list[list[MatchResult]]:
        """Every DB entry with distance strictly under ``threshold``, per
        query, ascending by distance (index-ordered within ties): the
        dedup-audit complement of :meth:`match`. The compare is exact in the
        rational order, so a threshold exactly on a distance excludes it.

        The device computes the spectrum once and compacts a conservative
        candidate superset (at most ``compact_k`` per query; default
        max(65,536, 2 * limit), capped at the DB size); only those
        candidates cross to the host, O(k), where the exact compare settles
        them. When a query has more candidates, the whole spectrum crosses
        instead (the same device spectrum, not a second pass), so results
        are identical in every case.

        ``limit``: raise :class:`AuditLimitExceeded` when a query matches
        more than this many entries.
        """
        q_enc, q_mask = self._queries(patterns_packed, masks_packed)
        self._guard_spectrum(q_enc.shape[0])
        spectrum = functools.cache(lambda: self._spectrum(q_enc, q_mask))

        def compact(t_hi, k):
            meta, nd_c = _compact_under_device(spectrum(), t_hi, k)
            return meta.cpu().numpy(), nd_c.cpu().numpy()

        return orchestrate_find_under(
            self.count, q_enc.shape[0], threshold, limit, compact_k,
            lambda: self._host_spectrum(spectrum()), compact)
