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

``prepare_query_planes``, ``_unpack_encode_chunk`` and ``_match_scan_packed``
live in ops/scan.py, below the packed kernel's plain version, and are
re-exported here. The DB is [C, c, ...] on the device and padded rows are all
zero (mask 0 -> den 0 -> never a valid distance). On the card every
selection goes through a CUDA kernel; on the CPU the kernel wrappers run
their plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mpc_iris_tpu.constants import BITS, N_ROTATIONS
from mpc_iris_tpu_torch.ops.decode import decode_distance_batch_np, fraction_to_f64
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.packed_match import match_packed_small_b, small_b_ok
from mpc_iris_tpu_torch.ops.scan import (
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
