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

The MPC engines, below the plaintext engine:

- :class:`ShareEngine`: a participant's dot shares of the rotated encoded
  queries against its u16 share DB, per chunk two int8 products and the
  ``128 * rowsum`` correction mod 2^16 (ops/dot.py). Chunks that fit the
  device budget stay resident as int8 lo/hi planes; the rest stream from the
  host u16 array (or memmap) per query batch, one chunk prefetched ahead.
- :class:`KeyedShareEngine`: a participant whose share is pure ChaCha20
  output regenerates its DB on the device from the 32-byte key, through the
  CUDA kernel ``csrc/chacha_planes.cu`` (ops/chacha.py): a resident head made
  once at construction, the tail per query batch.
- :class:`MasksEngine`: the coordinator's denominators against the public
  masks DB, packed or dense.

No parameters are converted: every engine's state is made from the same host
numpy arrays the JAX engines take (the 32-byte key, u16 share matrices,
packed uint8 masks), so both packages compute the same thing from the same
inputs. Each per-chunk function returns the wire block [B, c, 31] as int16
holding the u16 values' bit patterns (half the bytes of int32 to the host);
the host edge views it as ``np.uint16``. There is no ``jit``: the reference's
``lax.scan`` is a Python loop, and torch's asynchronous launches keep
``pipelined_stream``'s dispatches in flight.

Each stage of a request runs in a span of ``utils/profiling.py``, which
costs a flag check unless a ``torch.profiler`` capture runs: roots
``iris.match`` and ``iris.find_under``; ``iris.query_prep``,
``iris.launch``, ``iris.wait`` (wherever the host blocks on the card),
``iris.compact``, ``iris.settle``, and a stream's ``iris.dispatch``; at
set-up ``iris.setup.db_load``. ``iris.audit.overflows`` counts the audits
that took the full spectrum.
"""

from __future__ import annotations

import functools
import math
import os
import sys
import threading
import warnings
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS, N_ROTATIONS
from mpc_iris_tpu_torch.ops.chacha import (
    check_stream_id,
    k_permutation,
    key_tensor,
    share_planes_kernel,
)
from mpc_iris_tpu_torch.ops.decode import (
    decode_distance_batch_np,
    fraction_to_f64,
    fractions_to_f64_np,
    under_threshold_mask_np,
)
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch, dot_share_batch, shares_to_planes
from mpc_iris_tpu_torch.ops.encode import unpack_bits
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
from mpc_iris_tpu_torch.utils.profiling import annotate
from mpc_iris_tpu_torch.utils.profiling import count as count_event

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
    with annotate("iris.launch"):
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
    with annotate("iris.launch"):
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
    with annotate("iris.compact"):
        b = nd.shape[1]
        with annotate("iris.wait"):  # a pageable upload waits for the card's queue
            t = torch.tensor(float(np.float32(t_hi)), dtype=torch.float32, device=nd.device)
        mask = nd[0].float() < t * nd[1].float()
        counts = mask.sum(dim=1, dtype=torch.int32)
        slot = mask.cumsum(dim=1, dtype=torch.int32) - 1
        kept = mask & (slot < k)
        with annotate("iris.wait"):  # nonzero waits for the card to size its output
            q, e = kept.nonzero(as_tuple=True)
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
    with annotate("iris.settle"):
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
    with annotate("iris.settle"):
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
    count_event("iris.audit.overflows", int(compacted is None))
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
    with annotate("iris.settle"):
        return [_match_list(*hits_under_from_fractions(nd[0, q], nd[1, q], threshold,
                                                       limit=limit))
                for q in range(nd.shape[1])]


# --------------------------------------------------------------------- engine


def _engine_device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device is CUDA but no CUDA card is available")
    return device


def _engine_chunk(chunk: int, n: int, device: torch.device) -> int:
    """The reference's chunk clamp, min(chunk, max(128, n)), rounded up to a
    multiple of 8 on the card, where the int8 product needs it; the padded
    rows are trimmed from every output."""
    chunk = min(chunk, max(128, n))
    if device.type == "cuda":
        chunk = -(-chunk // 8) * 8
    return chunk


def _put_u8(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.uint8)
    return torch.from_numpy(np.array(x, dtype=np.uint8)).to(device)


class PlaintextEngine:
    """Plaintext min-distance search over a device-resident template DB."""

    def __init__(self, patterns_packed: np.ndarray, masks_packed: np.ndarray, *,
                 device="cuda", chunk: int = DEFAULT_CHUNK, storage: str = "auto"):
        """Args:
        patterns_packed, masks_packed: uint8 [N, 1600] packed planes (host).
        device: where the DB lives and the search runs; the card by
          default, and a CUDA device without a card raises.
        chunk: DB entries per scan step (rounded up to a multiple of 8 on the
          card, where the int8 product needs it; the padded rows never win).
        storage: "packed" keeps the raw bit planes (3.2 KB per entry) and
          unpacks per chunk; "dense" keeps int8 encodings and masks (25.6 KB
          per entry); "auto" is packed, as in the reference.
        """
        self.device = _engine_device(device, "PlaintextEngine")
        if storage == "auto":
            storage = "packed"
        if storage not in ("packed", "dense"):
            raise ValueError(f"unknown storage {storage!r}")
        kernel_self_test(self.device)
        n = patterns_packed.shape[0]
        chunk = _engine_chunk(chunk, n, self.device)
        self.storage = storage
        self.chunk = chunk
        self.db_pat = self.db_msk = self.db_enc = self.db_mask = None
        with annotate("iris.setup.db_load"):
            pat_c, self.count = _pad_chunks(
                np.ascontiguousarray(patterns_packed, dtype=np.uint8), chunk)
            msk_c, _ = _pad_chunks(np.ascontiguousarray(masks_packed, dtype=np.uint8), chunk)
            db_pat = torch.from_numpy(np.require(pat_c, requirements="CW")).to(self.device)
            db_msk = torch.from_numpy(np.require(msk_c, requirements="CW")).to(self.device)
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
        with annotate("iris.query_prep"):
            return prepare_query_planes(_put_u8(patterns_packed, self.device),
                                        _put_u8(masks_packed, self.device))

    def match(self, patterns_packed, masks_packed) -> list[MatchResult]:
        """Min-distance entry per query. uint8 [B, 1600] packed query planes."""
        with annotate("iris.match", request=True):
            q_enc, q_mask = self._queries(patterns_packed, masks_packed)
            out = self.match_arrays(q_enc, q_mask)
            with annotate("iris.wait"):
                n, d, i = out.cpu().numpy()
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
        with annotate("iris.wait"):
            nd = nd[:, :, : self.count].cpu()
        return nd.numpy().astype(np.uint16)

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
        with annotate("iris.find_under", request=True):
            q_enc, q_mask = self._queries(patterns_packed, masks_packed)
            self._guard_spectrum(q_enc.shape[0])
            spectrum = functools.cache(lambda: self._spectrum(q_enc, q_mask))

            def compact(t_hi, k):
                meta, nd_c = _compact_under_device(spectrum(), t_hi, k)
                with annotate("iris.wait"):
                    return meta.cpu().numpy(), nd_c.cpu().numpy()

            return orchestrate_find_under(
                self.count, q_enc.shape[0], threshold, limit, compact_k,
                lambda: self._host_spectrum(spectrum()), compact)


# --------------------------------------------------------------------- share path: per chunk


def _wire_block(dots: torch.Tensor, b: int, chunk: int) -> torch.Tensor:
    """int32 [B*31, c] products -> the wire block int16 [B, c, 31]
    (entry-major within a query, rotations -15..15 innermost; reference
    src/main.rs:428-434), one conversion pass; values >= 2^15 wrap to their
    u16 bit patterns."""
    out = torch.empty((b, chunk, N_ROTATIONS), dtype=torch.int16, device=dots.device)
    return out.copy_(dots.reshape(b, N_ROTATIONS, chunk).transpose(1, 2))


def _share_dots_chunk(q_enc, db_lo, db_hi) -> torch.Tensor:
    """Dot shares for one chunk: int16 [B, c, 31] u16 bit patterns in wire
    order."""
    b = q_enc.shape[0]
    dots = dot_share_batch(q_enc.reshape(b * N_ROTATIONS, BITS), db_lo, db_hi)
    return _wire_block(dots, b, db_lo.shape[0])


def _shares_reformat(chunk_u16: torch.Tensor) -> torch.Tensor:
    """Raw u16 share chunk [c, K] -> stacked int8 [2, c, K] (lo, hi) planes,
    split on the device."""
    return torch.stack(shares_to_planes(chunk_u16))


def _share_dots_chunk_u16(q_enc, chunk_u16) -> torch.Tensor:
    """Dot shares straight from a raw u16 chunk (the streamed out-of-core
    path): the lo/hi split, then the products."""
    return _share_dots_chunk(q_enc, *shares_to_planes(chunk_u16))


def _keyed_planes_chunk(kw, stream_id, row0, n_rows) -> torch.Tensor:
    """Regenerate one chunk's rows as stacked int8 [2, n, K] lo/hi planes in
    NATURAL K order (the keyed engine's resident head; pair with
    :func:`_queries_to_natural_k`)."""
    return torch.stack(share_planes_kernel(kw, stream_id, row0, n_rows))


def _queries_to_natural_k(q_enc) -> torch.Tensor:
    """[B, 31, K] file-order query planes -> the keystream planes' natural K
    order (``ops.chacha.k_permutation``): the share dot is invariant under
    one permutation of both operands' K axis, and permuting the small query
    side once per batch spares the keystream side a serialization pass."""
    return q_enc[..., torch.from_numpy(k_permutation()).to(q_enc.device)]


def _share_dots_chunk_keyed(q_nat, kw, stream_id, row0, n_rows) -> torch.Tensor:
    """Dot shares against rows REGENERATED on the device from the share key:
    the ChaCha20 planes, then the products, no DB I/O. ``q_nat`` must be in
    natural K order (:func:`_queries_to_natural_k`)."""
    lo, hi = share_planes_kernel(kw, stream_id, row0, n_rows)
    return _share_dots_chunk(q_nat, lo, hi)


def _to_entry_major(block: torch.Tensor) -> torch.Tensor:
    """[B, c, 31] -> [c, B, 31] on the device (the batched wire's byte
    order), contiguous, so the host copy is one block."""
    return block.transpose(0, 1).contiguous()


def _mask_dots_chunk(q_mask, db_mask) -> torch.Tensor:
    """Denominators for one chunk: int16 [B, c, 31] in wire order (exact:
    den <= 12,800)."""
    b = q_mask.shape[0]
    dots = dot_bits_batch(q_mask.reshape(b * N_ROTATIONS, BITS), db_mask)
    return _wire_block(dots, b, db_mask.shape[0])


def _mask_dots_chunk_packed(q_mask, db_mask_packed) -> torch.Tensor:
    """:func:`_mask_dots_chunk` over a bit-packed uint8 [c, 1600] mask chunk
    (1.6 KB per entry on the device; unpacked per chunk)."""
    return _mask_dots_chunk(q_mask, unpack_bits(db_mask_packed).to(torch.int8))


def _host_u16(block: torch.Tensor) -> np.ndarray:
    """The host edge: an int16 block of u16 bit patterns -> np.uint16."""
    return block.contiguous().cpu().numpy().view(np.uint16)


# --------------------------------------------------------------------- streaming


def _fetch(block: torch.Tensor):
    """Start copying a device block to the host: (host tensor, CUDA event
    that marks the copy done, or None on the CPU). The copy goes into pinned
    memory right behind the block's own launches, so waiting for it waits
    for this chunk only, not for the chunks queued after it."""
    if block.device.type == "cpu":
        return block, None
    host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
    host.copy_(block, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(block.device))
    return host, done


def pipelined_stream(dispatch, num_chunks: int, count: int, chunk_entries: int,
                     depth: int = 4, entry_axis: int = 1):
    """Yield host np.uint16 arrays from per-chunk device dispatches, ``depth``
    in flight (mirrors ``engines.pipelined_stream``).

    ``dispatch(c)`` returns chunk c's int16 block (u16 bit patterns) with DB
    entries on ``entry_axis`` ([B, n, 31] query-major or [n, B, 31]
    entry-major). Launches are asynchronous, so up to ``depth`` chunks are
    queued on the device while the host takes the oldest. The final chunk is
    trimmed to ``count`` total entries.
    """
    def launch(c):
        with annotate("iris.dispatch"):
            return c, _fetch(dispatch(c))

    pending = deque(launch(c) for c in range(min(depth, num_chunks)))
    nxt = depth
    while pending:
        c, (host, done) = pending.popleft()
        if nxt < num_chunks:
            pending.append(launch(nxt))
            nxt += 1
        with annotate("iris.wait"):  # the host takes chunk c's block
            if done is not None:
                done.synchronize()
            host = host.contiguous().numpy().view(np.uint16)
        start = c * chunk_entries
        end = min(count, start + chunk_entries)
        if entry_axis == 0:
            yield host[: end - start]
        else:
            yield host[:, : end - start]


# --------------------------------------------------------------------- MPC engines


def default_hbm_budget(device) -> int:
    """Device bytes a share engine may pin resident (lo/hi planes).

    ``MPC_IRIS_HBM_BUDGET`` (bytes) overrides, as in the reference. Otherwise
    9/10 of the card's free memory at construction (the tenth covers the
    allocator's rounding and the CUDA context; each engine reserves its own
    per-chunk transients on top, see ``_max_resident`` and
    ``KeyedShareEngine``), or on the CPU half of the host's available
    memory."""
    env = os.environ.get("MPC_IRIS_HBM_BUDGET")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * 0.9)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2


_OOC_POOL = None
_OOC_POOL_LOCK = threading.Lock()


def _ooc_prefetch_pool():
    """Process-wide single-worker executor for out-of-core chunk prefetch
    (mirrors ``engines._ooc_prefetch_pool``): one 'ooc-prefetch' thread for
    every engine, created lazily under a lock; one worker keeps page-ins
    serialized, the right shape for one host disk feeding one device."""
    global _OOC_POOL
    with _OOC_POOL_LOCK:
        if _OOC_POOL is None:
            import concurrent.futures

            _OOC_POOL = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="ooc-prefetch")
    return _OOC_POOL


class ShareEngine:
    """Participant-side engine: dot shares of queries against a u16 share DB
    (mirrors ``engines.ShareEngine``; the reference's ``DistanceEngine``,
    src/lib.rs:28-52).

    Shares are full-entropy u16, 25.6 KB per entry with no packed form.
    Chunks that fit ``hbm_budget`` stay resident as int8 lo/hi planes; the
    rest are served out of core: raw u16 chunks go from the host source
    (array or memmap) to the device per query batch and are split there, the
    next one prefetched on a worker thread while the current one computes.
    Peak host memory is one chunk; peak extra device memory one streamed
    chunk and its planes."""

    def __init__(self, shares_u16: np.ndarray, *, device="cuda", chunk: int = DEFAULT_CHUNK,
                 hbm_budget: int | None = None, batch_hint: int = 512):
        """shares_u16: uint16 [N, 12800] share matrix (host, e.g. np.memmap).

        device: where the resident planes live and the products run; the
        card by default, and a CUDA device without a card raises.
        batch_hint: largest query batch this engine will serve. Out of core,
        every streamed chunk adds a device transient on top of the resident
        head, so the default budget carves that headroom out of the resident
        planes. Ignored when an explicit hbm_budget is given, and moot when
        the whole DB fits resident."""
        self.device = _engine_device(device, "ShareEngine")
        kernel_self_test(self.device)
        n = shares_u16.shape[0]
        self._chunk_req = chunk  # pre-clamp request, for refresh() warnings
        chunk = _engine_chunk(chunk, n, self.device)
        num_chunks = max(1, -(-n // chunk))
        self._explicit_budget = hbm_budget is not None
        if hbm_budget is None:
            hbm_budget = default_hbm_budget(self.device)
        self._hbm_budget = hbm_budget
        self._batch_hint = batch_hint
        self._num_chunks = num_chunks
        self._n_resident = min(num_chunks, self._max_resident(num_chunks, chunk))
        self._source = shares_u16
        self.count = n
        self.chunk = chunk
        # Out-of-core prefetch: chunk -> (epoch, future) under a lock, so
        # concurrent scans mutate it safely and refresh() bumps the epoch so
        # that a pre-growth future never serves a post-growth scan. Only under
        # the DEFAULT budget, which reserves the second raw-chunk transient.
        self._prefetch: dict[int, tuple[int, object]] = {}
        self._prefetch_lock = threading.Lock()
        self._prefetch_epoch = 0
        with annotate("iris.setup.db_load"):
            self._resident = [_shares_reformat(self._put(self._chunk_u16(c)))
                              for c in range(self._n_resident)]
        if self._n_resident < num_chunks:
            print(
                f"ShareEngine: {self._n_resident}/{num_chunks} chunks resident "
                f"({self._n_resident * chunk} of {n} entries); the rest stream "
                "host->device per query batch (out-of-core)", file=sys.stderr,
            )

    def _put(self, chunk_u16: np.ndarray) -> torch.Tensor:
        """Host u16 chunk -> int16 tensor (the same bits) on the device. A
        read-only memmap is only read, so its not-writable warning is
        silenced rather than paid for with a host copy."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(chunk_u16.view(np.int16)).to(self.device)

    def _max_resident(self, num_chunks: int, chunk: int) -> int:
        """Resident-chunk cap under the budget policy (the reference's rule):
        int8 lo + hi planes cost 2*BITS bytes per resident entry. When the
        default budget cannot hold every chunk, reserve one streamed chunk's
        device transients at ``batch_hint`` queries: two raw int16 chunks (the
        computing one and the prefetched next, 4 * BITS * c bytes), the lo/hi
        split's two int32 temporaries and its int8 planes (10 * BITS * c), and
        the two int32 products with the int16 reply block and its
        entry-major copy (12 * 31 * B * c), as KeyedShareEngine reserves."""
        max_resident = max(0, int(self._hbm_budget // (2 * BITS * chunk)))
        if not self._explicit_budget and max_resident < num_chunks:
            stream_ws = (14 * BITS + 12 * N_ROTATIONS * self._batch_hint) * chunk
            max_resident = max(
                0, int((self._hbm_budget - stream_ws) // (2 * BITS * chunk)))
        return max_resident

    def refresh(self, shares_u16: np.ndarray) -> int:
        """Adopt a grown (append-only) share source; returns entries added.

        Full resident chunks are reused as they are; a previously padded tail
        chunk is transferred again, and residency is re-fit to the budget.
        Safe to call while serving: the resident list is replaced, never
        mutated, and a stream trims to the count it captured at its start."""
        n_new = shares_u16.shape[0]
        if shares_u16.ndim != 2 or shares_u16.shape[1] != BITS:
            raise ValueError(f"share source must be [N, {BITS}] u16")
        if n_new < self.count:
            raise ValueError(
                f"refresh is append-only: new count {n_new} < current "
                f"{self.count} (rebuild the engine for a shrunk/rewritten DB)"
            )
        added = n_new - self.count
        full_before = self.count // self.chunk  # chunks that had no padding
        # Invalidate prefetches atomically with the source/count swap: a
        # prefetched pre-growth padded tail would feed zeros where appended
        # rows now exist.
        with self._prefetch_lock:
            self._prefetch_epoch += 1
            while self._prefetch:
                self._prefetch.popitem()[1][1].cancel()
            self._source = shares_u16
            self.count = n_new
        self._num_chunks = max(1, -(-n_new // self.chunk))
        self._warn_frozen_layout(n_new)
        n_res = min(self._num_chunks, self._max_resident(self._num_chunks, self.chunk))
        keep = min(len(self._resident), full_before, n_res)
        resident = self._resident[:keep]
        for c in range(keep, n_res):
            resident.append(_shares_reformat(self._put(self._chunk_u16(c))))
        self._resident = resident  # atomic swap under the GIL
        self._n_resident = n_res
        return added

    def _warn_frozen_layout(self, n_new: int) -> None:
        """Growth keeps the construction-time chunk; warn when a fresh build
        on the grown DB would pick a much larger one (fewer, larger
        launches)."""
        fresh = min(self._chunk_req, max(128, n_new))
        if fresh >= 4 * self.chunk:
            print(
                f"{type(self).__name__}: DB grew to {n_new} but the engine "
                f"keeps its construction-time chunk {self.chunk} (a fresh "
                f"build would pick {fresh}); rebuild for fewer, larger "
                "launches", file=sys.stderr,
            )

    def _chunk_u16(self, c: int, src=None, count=None) -> np.ndarray:
        """Host u16 [chunk, K] view of chunk c, zero-padded at the tail. Full
        chunks are direct views (a memmap slice goes to the device without a
        host copy). ``src``/``count`` pin a snapshot (the prefetch worker's
        epoch); default the engine's current source."""
        src = self._source if src is None else src
        count = self.count if count is None else count
        start = c * self.chunk
        end = min(count, start + self.chunk)
        s = src[start:end]
        if (isinstance(s, np.ndarray) and s.dtype == np.uint16
                and s.flags.c_contiguous and end - start == self.chunk):
            return s
        s = np.ascontiguousarray(s, dtype=np.uint16)
        if end - start < self.chunk:
            s = np.pad(s, [(0, self.chunk - (end - start)), (0, 0)])
        return s

    def num_chunks(self) -> int:
        return self._num_chunks

    @property
    def resident_entries(self) -> int:
        return min(self.count, self._n_resident * self.chunk)

    def _prefetch_submit(self, c: int) -> None:
        """Queue the page-in and device transfer of streamed chunk c on the
        worker thread (no-op for resident or out-of-range chunks, or under an
        explicit budget)."""
        if self._explicit_budget or c >= self._num_chunks or c < len(self._resident):
            return
        with self._prefetch_lock:
            if c in self._prefetch:
                return
            epoch = self._prefetch_epoch
            src, cnt = self._source, self.count
            self._prefetch[c] = (epoch, _ooc_prefetch_pool().submit(
                lambda: self._put(self._chunk_u16(c, src, cnt))))

    def dots_chunk(self, q_enc, chunk_index: int) -> torch.Tensor:
        """int16 [B, chunk, 31] for one DB chunk (on the device, launched
        asynchronously). Resident chunks go straight to the products;
        out-of-core chunks take the prefetched transfer when it is this
        chunk's and current, else transfer now. Concurrent scans at
        different positions evict each other's prefetch and fall back to the
        synchronous transfer, never to wrong bytes."""
        res = self._resident  # snapshot: refresh() swaps the list, never mutates
        if chunk_index < len(res):
            planes = res[chunk_index]
            if chunk_index + 1 == len(res):
                self._prefetch_submit(chunk_index + 1)  # warm the streamed tail
            return _share_dots_chunk(q_enc, planes[0], planes[1])
        with self._prefetch_lock:
            hit = self._prefetch.pop(chunk_index, None)
            for k in [k for k in self._prefetch if k != chunk_index + 1]:
                self._prefetch.pop(k)[1].cancel()
            epoch_now = self._prefetch_epoch
        self._prefetch_submit(chunk_index + 1)
        fut = None
        if hit is not None:
            epoch, f = hit
            if epoch == epoch_now:
                fut = f
            else:
                f.cancel()  # pre-refresh future: bytes may be stale-padded
        raw = fut.result() if fut is not None else self._put(self._chunk_u16(chunk_index))
        return _share_dots_chunk_u16(q_enc, raw)

    # KeyedShareEngine's DB lives in natural K order; it transforms the query
    # planes once per batch here.
    def _q_transform(self, q_enc):
        return q_enc

    def _queries(self, patterns_packed, masks_packed) -> torch.Tensor:
        with annotate("iris.query_prep"):
            q_enc, _ = prepare_query_planes(_put_u8(patterns_packed, self.device),
                                            _put_u8(masks_packed, self.device))
            return self._q_transform(q_enc)

    def dots(self, patterns_packed, masks_packed) -> np.ndarray:
        """Full reply tensor uint16 [B, N, 31] in reference wire order."""
        q_enc = self._queries(patterns_packed, masks_packed)
        parts = [_host_u16(self.dots_chunk(q_enc, c)) for c in range(self.num_chunks())]
        return np.concatenate(parts, axis=1)[:, : self.count]

    def stream(self, patterns_packed, masks_packed, entry_major: bool = False):
        """Yield per-chunk host uint16 arrays, device compute pipelined with
        the host transfer (the participant's chunked reply stream,
        src/main.rs:423-445); the final chunk trimmed to the DB size.

        entry_major: yield [chunk, B, 31] (the batched wire's byte order,
        transposed on the device) instead of [B, chunk, 31]."""
        q_enc = self._queries(patterns_packed, masks_packed)
        if entry_major:
            dispatch = lambda c: _to_entry_major(self.dots_chunk(q_enc, c))
        else:
            dispatch = lambda c: self.dots_chunk(q_enc, c)
        yield from pipelined_stream(dispatch, self.num_chunks(), self.count, self.chunk,
                                    entry_axis=0 if entry_major else 1)


class KeyedShareEngine:
    """Participant engine for a party whose share is pure ChaCha20 output:
    the DB is REGENERATED on the device from the 32-byte share key instead of
    stored (mirrors ``engines.KeyedShareEngine``).

    ``prepare`` derives every share s < n-1 of row R as the keystream
    addressed by (key, s, R) (docs/SPEC.md section 4.1; the last share
    carries the data and cannot be keyed). Each chunk's rows come from the
    CUDA kernel ``csrc/chacha_planes.cu`` as int8 lo/hi planes in natural K
    order, bit-identical to serving the share file, with no share I/O.

    Valid only for the ORIGINAL prepare output (a ``rerandomize``d share is
    no longer a pure keystream), and holding the key is exactly as sensitive
    as holding the share file.
    """

    def __init__(self, key: bytes, stream_id: int, count: int, *, device="cuda",
                 chunk: int = DEFAULT_CHUNK, hbm_budget: int | None = None,
                 batch_hint: int = 512):
        """hbm_budget: device bytes for a RESIDENT head of regenerated lo/hi
        planes, made once at construction; only the tail regenerates per
        query batch. The default is :func:`default_hbm_budget` less the
        pass's transients at ``batch_hint`` queries: one chunk's regenerated
        planes (2 * 12,800 * c bytes), the two int32 products (8 * 31 * B * c)
        and the int16 reply block with its entry-major copy (4 * 31 * B * c).
        Ignored when an explicit hbm_budget is given."""
        self.device = _engine_device(device, "KeyedShareEngine")
        kernel_self_test(self.device)
        self._sid = check_stream_id(stream_id)
        self._kw = key_tensor(key, self.device)
        self.count = int(count)
        self._chunk_req = chunk  # pre-clamp request, for refresh() warnings
        self.chunk = _engine_chunk(chunk, self.count, self.device)
        if hbm_budget is None:
            workspace = (2 * BITS + 12 * N_ROTATIONS * batch_hint) * self.chunk
            hbm_budget = max(0, default_hbm_budget(self.device) - workspace)
        self._max_resident = max(0, int(hbm_budget // (2 * BITS * self.chunk)))
        self._n_resident = min(self.num_chunks(), self._max_resident)
        with annotate("iris.setup.db_load"):
            self._resident = [self._regenerate(c) for c in range(self._n_resident)]

    def _regenerate(self, c: int) -> torch.Tensor:
        return _keyed_planes_chunk(self._kw, self._sid, c * self.chunk, self.chunk)

    def refresh(self, count: int) -> int:
        """Adopt a grown logical DB size; returns entries added. A keyed
        party's DB sync is learning the new row count: resident planes are
        whole keystream chunks and stay valid, and the head grows while the
        budget has room. The resident list is replaced, not mutated."""
        count = int(count)
        if count < self.count:
            raise ValueError(
                f"refresh is append-only: new count {count} < current "
                f"{self.count} (rebuild the engine for a shrunk DB)"
            )
        added = count - self.count
        self.count = count
        ShareEngine._warn_frozen_layout(self, count)
        n_res = min(self.num_chunks(), self._max_resident)
        resident = self._resident[:]
        for c in range(len(resident), n_res):
            resident.append(self._regenerate(c))
        self._resident = resident  # atomic swap under the GIL
        self._n_resident = n_res
        return added

    def num_chunks(self) -> int:
        return max(1, -(-self.count // self.chunk))

    @property
    def resident_entries(self) -> int:
        return min(self.count, self._n_resident * self.chunk)

    def _q_transform(self, q_enc):
        # All keyed planes (resident and regenerated) are in natural K order.
        return _queries_to_natural_k(q_enc)

    def dots_chunk(self, q_nat, chunk_index: int) -> torch.Tensor:
        """int16 [B, chunk, 31] for one DB chunk: resident head planes go
        straight to the products; tail chunks regenerate first. ``q_nat``:
        the ``_q_transform``ed query planes."""
        res = self._resident  # snapshot: refresh() swaps the list, never mutates
        if chunk_index < len(res):
            planes = res[chunk_index]
            return _share_dots_chunk(q_nat, planes[0], planes[1])
        return _share_dots_chunk_keyed(q_nat, self._kw, self._sid,
                                       chunk_index * self.chunk, self.chunk)

    # The same serving surface as ShareEngine (participant compatible).
    _queries = ShareEngine._queries
    dots = ShareEngine.dots
    stream = ShareEngine.stream

    def fold_pass_fn(self, segments: int = 1):
        """Build a whole-DB checksum pass (bench and self-test): returns
        ``run(q_enc) -> np.uint32``, the uint32 sum of every dot share of the
        file-order query planes ``q_enc``, the same value as summing
        :meth:`dots`. Nothing crosses to the host per chunk; the protocol
        path streams per-chunk outputs instead (its egress IS the product
        there).

        ``segments`` > 1 splits the chunk range into that many contiguous
        sub-passes, all launched before any result is fetched, whose sums add
        mod 2^32 to the same value. The reference needs segments for a
        deadline of its remote device; here they only split the pass."""
        if self.num_chunks() * self.chunk != self.count:
            raise ValueError(
                f"fold_pass_fn folds whole chunks: count={self.count} is not "
                f"a multiple of chunk={self.chunk} (the checksum would "
                "include phantom padding rows); use dots()/stream() for "
                "ragged row counts"
            )
        total = self.num_chunks()
        segments = max(1, min(int(segments), total))
        bounds = [round(s * total / segments) for s in range(segments + 1)]
        fns = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            tail_start = max(lo, self._n_resident)
            fns.append(functools.partial(
                _keyed_fold_pass, kw=self._kw, sid=self._sid,
                resident=tuple(self._resident[lo:min(hi, self._n_resident)]),
                chunk=self.chunk, n_tail=max(0, hi - tail_start), tail_start=tail_start,
            ))

        def run(q_enc):
            pending = [fn(q_enc) for fn in fns]  # all launched before any fetch
            acc = 0
            for p in pending:
                acc = (acc + int(p)) & 0xFFFFFFFF
            return np.uint32(acc)

        return run


def _keyed_fold_pass(q_enc, *, kw, sid, resident, chunk: int, n_tail: int,
                     tail_start: int) -> torch.Tensor:
    """One keyed checksum (sub-)pass on the device: the resident head chunks
    (a tuple of [2, chunk, K] planes), then ``n_tail`` regenerated chunks from
    chunk index ``tail_start``. Returns an int64 scalar tensor, the sum mod
    2^32 (see KeyedShareEngine.fold_pass_fn)."""
    q_nat = _queries_to_natural_k(q_enc)
    acc = torch.zeros((), dtype=torch.int64, device=q_enc.device)

    def add(block):
        acc.add_((block.to(torch.int64) & 0xFFFF).sum())

    for planes in resident:
        add(_share_dots_chunk(q_nat, planes[0], planes[1]))
    for t in range(n_tail):
        add(_share_dots_chunk_keyed(q_nat, kw, sid, (tail_start + t) * chunk, chunk))
    return acc & 0xFFFFFFFF


class MasksEngine:
    """Coordinator-side denominator engine over the plaintext masks DB
    (mirrors ``engines.MasksEngine``; the reference's ``MasksEngine``,
    src/lib.rs:55-80)."""

    def __init__(self, masks_packed: np.ndarray, *, device="cuda", chunk: int = DEFAULT_CHUNK,
                 storage: str = "auto"):
        """masks_packed: uint8 [N, 1600] packed mask planes (host, e.g. np.memmap).

        storage: "dense" = unpacked int8 planes on the device (12.8 KB per
        entry); "packed" = the raw bit planes (1.6 KB per entry) unpacked per
        chunk; "auto" picks packed past 400,000 entries, the reference's
        boundary, so both packages store alike.

        The DB is a list of per-chunk device blocks, so :meth:`refresh`
        transfers only appended chunks (O(added)) and the list swap keeps
        concurrent streams valid.
        """
        self.device = _engine_device(device, "MasksEngine")
        kernel_self_test(self.device)
        n = masks_packed.shape[0]
        chunk = _engine_chunk(chunk, n, self.device)
        if storage == "auto":
            storage = "packed" if n > 400_000 else "dense"
        if storage not in ("packed", "dense"):
            raise ValueError(f"unknown storage {storage!r}")
        self.storage = storage
        self._source = masks_packed
        self.count = n
        self.chunk = chunk
        num_chunks = max(1, -(-n // chunk))
        self._blocks = [self._put_chunk(c) for c in range(num_chunks)]

    def _put_chunk(self, c: int) -> torch.Tensor:
        """Host chunk c, zero-padded at the tail, on the device: packed uint8
        [c, 1600], or unpacked there to int8 [c, 12800] for dense storage."""
        start = c * self.chunk
        end = min(self.count, start + self.chunk)
        rows = np.ascontiguousarray(self._source[start:end], dtype=np.uint8)
        if end - start < self.chunk:
            rows = np.pad(rows, [(0, self.chunk - (end - start)), (0, 0)])
        # a read-only memmap slice (the CLI's masks file) is only read: its
        # not-writable warning is silenced, as in ShareEngine._put
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            block = torch.from_numpy(rows).to(self.device)
        if self.storage == "packed":
            return block
        return unpack_bits(block).to(torch.int8)

    def refresh(self, masks_packed: np.ndarray) -> int:
        """Adopt a grown (append-only) masks source; returns entries added.
        O(added): full device chunks are reused; only a previously padded
        tail chunk is transferred again, and new chunks appended. Safe while
        serving: the block list is replaced, never mutated."""
        n_new = masks_packed.shape[0]
        if n_new < self.count:
            raise ValueError(
                f"refresh is append-only: new count {n_new} < current "
                f"{self.count} (rebuild the engine for a shrunk/rewritten DB)"
            )
        added = n_new - self.count
        if added == 0:
            return 0
        full_before = self.count // self.chunk  # chunks that had no padding
        self._source = masks_packed
        self.count = n_new
        num_chunks = max(1, -(-n_new // self.chunk))
        blocks = self._blocks[:full_before]
        for c in range(full_before, num_chunks):
            blocks.append(self._put_chunk(c))
        self._blocks = blocks  # atomic swap under the GIL
        return added

    def num_chunks(self) -> int:
        return len(self._blocks)

    def dots_chunk(self, q_mask, chunk_index: int) -> torch.Tensor:
        blocks = self._blocks  # snapshot: refresh() swaps, never mutates
        if self.storage == "packed":
            return _mask_dots_chunk_packed(q_mask, blocks[chunk_index])
        return _mask_dots_chunk(q_mask, blocks[chunk_index])

    def _queries(self, masks_packed) -> torch.Tensor:
        q = _put_u8(masks_packed, self.device)
        return prepare_query_planes(torch.zeros_like(q), q)[1]

    def dots(self, masks_packed) -> np.ndarray:
        """Full denominator tensor uint16 [B, N, 31] in wire order."""
        q_mask = self._queries(masks_packed)
        parts = [_host_u16(self.dots_chunk(q_mask, c)) for c in range(self.num_chunks())]
        return np.concatenate(parts, axis=1)[:, : self.count]

    def stream(self, masks_packed, entry_major: bool = False):
        """Yield per-chunk host uint16 arrays (trimmed at the end); see
        ShareEngine.stream for the entry_major layout."""
        q_mask = self._queries(masks_packed)
        if entry_major:
            dispatch = lambda c: _to_entry_major(self.dots_chunk(q_mask, c))
        else:
            dispatch = lambda c: self.dots_chunk(q_mask, c)
        yield from pipelined_stream(dispatch, self.num_chunks(), self.count, self.chunk,
                                    entry_axis=0 if entry_major else 1)
