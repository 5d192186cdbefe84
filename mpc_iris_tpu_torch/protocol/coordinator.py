"""Coordinator/resolver role: query fan-out, share aggregation, distance decode
(counterpart of ``mpc_iris_tpu/protocol/coordinator.py``; reference
src/main.rs:453-644).

Per query: connect to every participant, send the query, then per read round
(20,000 records, byte-budgeted down for large batches: wire.py
``records_per_read``) (a) read each party's dot-share stream, (b) pull locally
computed denominators (and the coordinator's own share, if it holds one) from
the engines in worker threads, (c) stage the round's blocks in pinned host
memory, upload them asynchronously and launch one device decode step. The
wire, the rounds, the deadlines, the alignment to the shortest stream and the
serving front are the reference's, byte for byte.

The device steps: per received round, the wrapping sum of the P parties' dot
shares, the distance decode against the denominators, the rotation min and,
for the match, the entry argmin. Share reconstruction is a sum mod 2^16
(reference src/main.rs:597-612) and the numerator ``((den - dot) mod 2^16)
>> 1`` (the wrapping sub of reference src/lib.rs:104). Selection is the
exact rational order with d == 0 as +inf, ties to the earliest rotation and
then the lowest index (ops/decode.py). Inputs are integer tensors holding u16
values: int16 blocks of u16 bit patterns, or int32 values; all arithmetic is
int32 with ``& 0xFFFF`` (torch has no uint16 arithmetic on the CPU). Each
step's small result is fetched only after the stream drains, and the winners
fold exactly on the host, so decode overlaps the next round's reads.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import logging
import math
import struct
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import N_ROTATIONS, TEMPLATE_BYTES
from mpc_iris_tpu_torch.models.engines import (
    AuditLimitExceeded,
    _engine_device,
    hits_under_from_fractions,
)
from mpc_iris_tpu_torch.ops.decode import fraction_argmin, fraction_min_rotations, fraction_to_f64
from mpc_iris_tpu_torch.protocol.drain import ConnectionTracker, drain_server
from mpc_iris_tpu_torch.protocol.pump import StreamPump
from mpc_iris_tpu_torch.protocol.wire import (
    batched_query_bytes,
    chain_query_bytes,
    read_batched_records,
    read_records,
    records_per_read,
)
from mpc_iris_tpu_torch.types import Template

log = logging.getLogger("mpc_iris_tpu_torch.coordinator")


class StalledPartyError(ConnectionError):
    """A connected participant produced no complete read round within the
    coordinator's per-round deadline.

    Policy (docs/SPEC.md section 5): the query is ABORTED loudly, naming the
    stalled part(ies), never silently truncated: a uniqueness check over a
    truncated scan could falsely report "unique" while the unseen tail holds
    a match. The reference has no deadline at all (src/main.rs:538-555)."""


class TruncatedScanError(ConnectionError):
    """The reply streams ended before the full masks DB was scanned
    (strict-scan mode).

    The reference tolerates early EOF by truncating to the shortest common
    prefix (src/main.rs:538-569); a participant that crashes mid-stream looks
    exactly like a clean early EOF, so ``strict_scan=True`` turns that
    silent truncation into this loud failure. It stays opt-in because DB
    growth makes transiently unequal counts legitimate (SPEC section 6.2)."""


class _Stalled:
    """Sentinel read result marking the party whose round timed out."""

    __slots__ = ("party",)

    def __init__(self, party: str):
        self.party = party


def _decode(shares, dens):
    """(num, den) int32 from P share blocks and the denominators."""
    dots = shares[0].to(torch.int32)
    for s in shares[1:]:
        dots = dots + s.to(torch.int32)
    den = dens.to(torch.int32) & 0xFFFF
    return ((den - dots) & 0xFFFF) >> 1, den


def _sum_decode_argmin_device_batch(shares, dens) -> torch.Tensor:
    """Batched round: tuple of P [n, B, 31] ENTRY-major dot-share blocks and
    the denominators -> int32 [3, B] winners (numerator, denominator,
    round-local index)."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=2)  # [n, B]
    return torch.stack(fraction_argmin(n_r, d_r, axis=0))  # over entries -> [B]


def _sum_decode_argmin_device(shares, dens) -> torch.Tensor:
    """One query's round: tuple of P [n, 31] dot-share blocks and the
    denominators -> int32 [3] winner (numerator, denominator, round-local
    index)."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)
    return torch.stack(fraction_argmin(n_r, d_r, axis=0))


def _sum_decode_minfrac_device_batch(shares, dens) -> torch.Tensor:
    """Batched threshold-audit round: tuple of P [n, B, 31] ENTRY-major
    blocks and the denominators -> int32 [2, n, B], per entry the minimal
    (numerator, denominator)."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=2)
    return torch.stack([n_r, d_r])


def _sum_decode_minfrac_device(shares, dens) -> torch.Tensor:
    """One query's audit round: tuple of P [n, 31] blocks and the
    denominators -> int32 [2, n] per-entry minimal (numerator, denominator);
    the entry axis is kept so the host can list every entry under a
    threshold."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)
    return torch.stack([n_r, d_r])


def _frac_less_host(n1: int, d1: int, n2: int, d2: int) -> bool:
    """Exact n1/d1 < n2/d2 on Python ints, d == 0 as +inf (copy of
    ``mpc_iris_tpu.protocol.coordinator._frac_less_host``)."""
    if d1 == 0:
        return False
    if d2 == 0:
        return True
    return n1 * d2 < n2 * d1


class _Uploads:
    """One connection round's uploads. Each read round's ``blocks`` are host
    u16 arrays of one shape (the P share blocks, then the denominators),
    read-only views of the wire's bytes among them. They are copied into
    ONE staging tensor as int16 (the u16 bit patterns), pinned on the
    card's host side, and its copy to the device is queued without waiting.
    Each staging tensor is kept until its copy event has passed, then
    released, so pinned host memory stays bounded by the copies still
    queued, not by the DB size.

    With ``times`` (a list), :meth:`report` appends each round's (staging
    ms, host wall; upload ms, decode-step ms, CUDA events) once the stream
    has drained; the device times are None on the CPU."""

    def __init__(self, device: torch.device, times: list | None = None):
        self.device = device
        self._held = deque()
        self._times = times
        self._rounds = []  # per round when timed: [staging ms, upload start, end, step end]

    def __call__(self, blocks) -> torch.Tensor:
        """The round's blocks as one device tensor [P+1, ...] (on the CPU the
        staging tensor itself)."""
        t0 = time.perf_counter()
        pin = self.device.type == "cuda"
        stage = torch.empty((len(blocks), *blocks[0].shape), dtype=torch.int16, pin_memory=pin)
        host = stage.numpy()
        for k, b in enumerate(blocks):
            host[k] = b.view(np.int16)
        timed = self._times is not None
        staged = [(time.perf_counter() - t0) * 1e3]
        if not pin:
            if timed:
                self._rounds.append(staged)
            return stage
        stream = torch.cuda.current_stream(self.device)
        start, done = (torch.cuda.Event(enable_timing=timed) for _ in range(2))
        start.record(stream)
        dev = stage.to(self.device, non_blocking=True)
        done.record(stream)
        if timed:
            self._rounds.append(staged + [start, done])
        self._held.append((stage, done))
        while self._held and self._held[0][1].query():
            self._held.popleft()
        return dev

    def stepped(self) -> None:
        """Mark the end of the decode step launched on the latest upload."""
        if self._times is not None and self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self._rounds[-1].append(end)

    def report(self) -> None:
        """After the stream drained: append each round's times to ``times``."""
        if self._times is None:
            return
        for staged, *marks in self._rounds:
            if not marks:
                self._times.append((staged, None, None))
                continue
            start, done, end = marks
            end.synchronize()
            self._times.append((staged, start.elapsed_time(done), done.elapsed_time(end)))


async def _close_all(conns, pumps):
    """Release worker pumps (they may be blocked on full queues) and sockets."""
    for p in pumps:
        if p is not None:
            p.close()
    for _, w in conns:
        w.close()
    await asyncio.gather(
        *[w.wait_closed() for _, w in conns], return_exceptions=True
    )


@dataclass
class QueryOutcome:
    index: int
    distance: float
    total: int  # entries compared


@dataclass
class MatchAt:
    """One under-threshold hit from a dedup audit."""

    index: int
    distance: float  # reference-exact f64 decode of the winning fraction


@dataclass
class UnderThresholdOutcome:
    """Result of `Coordinator.query_under`: every DB entry whose distance is
    strictly under the threshold (ascending distance, index within ties).

    ``limit_exceeded``: the audit found MORE matches than the caller's
    ``limit`` allowed; ``matches`` is empty and must not be treated as "no
    duplicates" (the serving front closes such clients without a reply)."""

    matches: list[MatchAt]
    total: int  # entries compared
    limit_exceeded: bool = False


def _rechunk(stream, size: int, squeeze: bool = True, entry_axis: int = 1):
    """Re-buffer a stream of u16 arrays into exactly-``size``-entry batches
    along the entry axis (the final batch may be short). With ``squeeze`` the
    leading B=1 axis is dropped (reference-wire [1, n, 31] layout); batched
    entry-major streams pass squeeze=False, entry_axis=0 ([n, B, 31])."""
    buf = []
    have = 0

    def view(chunk):
        return chunk[0] if squeeze else chunk

    ax = 0 if squeeze else entry_axis
    for chunk in stream:
        arr = view(chunk)
        buf.append(arr)
        have += arr.shape[ax]
        while have >= size:
            cat = np.concatenate(buf, axis=ax) if len(buf) > 1 else buf[0]
            head, rest = np.split(cat, [size], axis=ax)
            yield head
            buf = [rest] if rest.shape[ax] else []
            have = rest.shape[ax]
    if have:
        yield np.concatenate(buf, axis=ax) if len(buf) > 1 else buf[0]


class Coordinator:
    def __init__(self, masks_engine, participants: list[tuple[str, int]],
                 local_engine=None, batch_records: int | None = None,
                 ssl_context=None, round_timeout: float | None = None,
                 strict_scan: bool = False, chain: bool = False, *,
                 device="cuda"):
        """masks_engine: MasksEngine/ShardedMasksEngine over the public masks DB.
        participants: (host, port) of each share-holding party.
        local_engine: optional ShareEngine if this process also holds a share.
        batch_records: optional override of entry-groups per read round; by
        default sized per batch from the wire's byte budget
        (:func:`records_per_read`) so per-round memory stays bounded for any B.
        ssl_context: optional `ssl.SSLContext` (tlsutil.client_context) used
        for every participant connection; the wire inside is unchanged.
        round_timeout: per-read-round deadline in seconds for each remote
        party's byte stream; on expiry the query is aborted with
        :class:`StalledPartyError` naming the silent part(ies). None waits
        forever, as the reference does (src/main.rs:538-555).
        strict_scan: when True, a query whose aligned streams end before the
        masks DB is fully scanned raises :class:`TruncatedScanError` instead
        of returning a verdict over the prefix.
        chain: chained reply aggregation (SPEC section 5.4): the coordinator
        contacts ONLY the last participant (the chain head), which pulls,
        sums and forwards the rest of the chain's dot shares. Requires
        ``local_engine``, so that every partial sum a party sees misses at
        least one share. Participants must run ``wire="chain"``.
        device: where the rounds are uploaded and decoded; the card by
        default, and a CUDA device without a card raises.
        """
        if not participants and local_engine is None:
            raise ValueError(
                "coordinator needs at least one participant or a local share "
                "engine — masks alone cannot answer queries"
            )
        if chain and local_engine is None:
            raise ValueError(
                "chain mode requires the coordinator to hold a share "
                "(local_engine / --share): without it the chain head would "
                "reconstruct the full dot sums — plaintext distances — "
                "which only the coordinator may see"
            )
        if chain and not participants:
            raise ValueError("chain mode needs at least one participant")
        self.device = _engine_device(device, "Coordinator")
        self.masks_engine = masks_engine
        self.participants = participants
        self.local_engine = local_engine
        self.batch_records = batch_records
        self.ssl_context = ssl_context
        self.round_timeout = round_timeout
        self.strict_scan = strict_scan
        self.chain = chain
        # set to a list to time every read round: each appends (pinned
        # staging ms, host wall; upload ms and decode-step ms, CUDA events on
        # this thread's stream of ``device``, which other threads' work
        # queued there between them also fills; None on the CPU)
        self.round_times = None

    async def _read_round(self, coro, party: str):
        """Run one party's read-round coroutine under the deadline; a timeout
        yields a ``(_Stalled, False)`` marker instead of raising so the
        concurrent gather finishes and ALL stalled parties get named."""
        if not self.round_timeout:
            return await coro
        try:
            return await asyncio.wait_for(coro, self.round_timeout)
        except asyncio.TimeoutError:
            return _Stalled(party), False

    def _check_stalled(self, read_results) -> None:
        stalled = [r.party for r, _eof in read_results
                   if isinstance(r, _Stalled)]
        if stalled:
            raise StalledPartyError(
                f"participant(s) {', '.join(stalled)} produced no complete "
                f"read round within {self.round_timeout}s — aborting the "
                "query (connected-but-silent party; see SPEC section 5)"
            )

    async def _connect_all(self):
        """Open one connection per participant with a clear error on failure.
        Connections that did succeed are closed before raising: a single
        rejected TLS handshake must not leak the other parties' sockets."""
        results = await asyncio.gather(
            *[asyncio.open_connection(h, p, ssl=self.ssl_context)
              for h, p in self._endpoints()],
            return_exceptions=True,
        )
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            for r in results:
                if not isinstance(r, BaseException):
                    r[1].close()
                    try:
                        await r[1].wait_closed()
                    except (OSError, asyncio.TimeoutError):
                        pass
            raise ConnectionError(
                f"cannot reach all participants {self._endpoints()}: {errs[0]}"
            ) from errs[0]
        return results

    async def _stream_rounds(self, templates: list[Template], batched: bool):
        """Async generator over aligned read rounds for one connection round:
        yields ``(offset, blocks)`` per round, ``blocks`` the uint16 share
        blocks of the remote parties (and of the local engine, if any) and
        then the denominators, all of one shape: [n, 31] on the reference
        wire (one template), entry-major [n, B, 31] on the batched and chain
        wires.

        Owns the protocol round trip: the fan-out, the local denominator and
        share pumps (device compute in worker threads overlapping network
        reads, the reference's `join!`, src/main.rs:560), the per-round
        deadlines, the shortest-prefix alignment (src/main.rs:565-569),
        connection and pump teardown, and the dead-party and strict-scan
        checks."""
        b = len(templates)
        qpat = np.stack([t.pattern.data for t in templates])
        qmsk = np.stack([t.mask.data for t in templates])
        if batched:
            # byte-budgeted read rounds: one round buffers <= READ_BYTE_BUDGET
            # per party regardless of B
            records = self.batch_records or records_per_read(b)
            read = functools.partial(read_batched_records, b=b, max_records=records)
            local_stream = functools.partial(_rechunk, size=records, squeeze=False, entry_axis=0)
            empty = (0, b, N_ROTATIONS)
            if self.chain:
                # one connection to the chain head; its request names the
                # rest of the chain, which self-assembles (SPEC 5.4)
                payload = chain_query_bytes(
                    qpat, qmsk, [f"{h}:{p}" for h, p in self.participants[:-1]])
            else:
                payload = batched_query_bytes(qpat, qmsk)
        else:
            records = self.batch_records or records_per_read(1)
            read = functools.partial(read_records, max_records=records)
            local_stream = functools.partial(_rechunk, size=records)
            empty = (0, N_ROTATIONS)
            payload = templates[0].to_bytes()

        conns = await self._connect_all()
        for _, writer in conns:
            writer.write(payload)
        await asyncio.gather(*[w.drain() for _, w in conns])

        loop = asyncio.get_running_loop()
        denom_pump = StreamPump(
            local_stream(self.masks_engine.stream(qmsk, entry_major=batched)), loop)
        local_pump = (
            StreamPump(local_stream(
                self.local_engine.stream(qpat, qmsk, entry_major=batched)), loop)
            if self.local_engine is not None else None
        )

        processed = 0
        party_records = [0] * len(conns)
        try:
            while True:
                reads = [self._read_round(read(r), f"{h}:{p}")
                         for (r, _w), (h, p) in zip(conns, self._endpoints())]
                gathered = await asyncio.gather(
                    denom_pump.next_item(),
                    *([local_pump.next_item()] if local_pump is not None else []),
                    *reads,
                )
                denom = gathered[0]
                off = 1 if local_pump is None else 2
                self._check_stalled(gathered[off:])
                blocks = [arr for arr, _eof in gathered[off:]]
                for k, arr in enumerate(blocks):
                    party_records[k] += arr.shape[0]
                if local_pump is not None:
                    local = gathered[1]
                    blocks.append(np.zeros(empty, np.uint16) if local is None else local)
                blocks.append(np.zeros(empty, np.uint16) if denom is None else denom)

                # align to the shortest prefix (main.rs:565-569)
                n = min(blk.shape[0] for blk in blocks)
                if n == 0:
                    break
                yield processed, [blk[:n].astype(np.uint16, copy=False) for blk in blocks]
                processed += n
                if n < records:
                    break
        finally:
            await _close_all(conns, [denom_pump, local_pump])

        self._check_dead_parties(processed, party_records)
        self._check_truncated(processed, party_records)

    async def _decoded_rounds(self, templates: list[Template], batched: bool, step, join):
        """Run one connection round: each read round's blocks are uploaded
        through pinned staging and decoded by one device ``step``, launched
        without waiting. After the stream drains, the steps' results are
        joined on the device (``join``) and fetched once (``_Uploads`` holds
        each staging buffer until its copy has passed). Returns ([(offset,
        entries)] per round, host array of the joined results, or None
        without rounds)."""
        b = len(templates)
        if not 0 < b <= 65536:
            raise ValueError(f"batch size {b} outside the wire's 1..65536 range")
        upload = _Uploads(self.device, self.round_times)
        spans, results = [], []
        async for offset, blocks in self._stream_rounds(templates, batched):
            dev = upload(blocks)
            results.append(step(tuple(dev[:-1]), dev[-1]))
            upload.stepped()
            spans.append((offset, blocks[0].shape[0]))
        out = join(results).cpu().numpy() if results else None
        upload.report()
        return spans, out

    async def query(self, template: Template) -> QueryOutcome:
        if self.chain:
            # chain replies are entry-major batched streams; at B=1 the bytes
            # coincide with the reference record stream
            return (await self.query_batch([template]))[0]
        return (await self._query_argmin([template], False))[0]

    async def query_batch(self, templates: list[Template]) -> list[QueryOutcome]:
        """Batched uniqueness check over the batched wire extension: one
        connection round carries B queries; each round's device step is the
        batched sibling of `query`'s (share reconstruction + decode +
        rotation-min + per-query entry-argmin)."""
        return await self._query_argmin(templates, True)

    async def _query_argmin(self, templates, batched: bool) -> list[QueryOutcome]:
        step = _sum_decode_argmin_device_batch if batched else _sum_decode_argmin_device
        spans, triples = await self._decoded_rounds(templates, batched, step, torch.stack)
        b = len(templates)
        best = [(0, 0, -1)] * b  # (num, den, index); den == 0 means +inf
        processed = 0
        for (offset, n), arr in zip(spans, [] if triples is None else triples.reshape(-1, 3, b)):
            processed = offset + n
            for q in range(b):
                nb, db_, jb = int(arr[0, q]), int(arr[1, q]), int(arr[2, q])
                # strict <: an equal fraction in a later round never replaces
                # the earlier (lower-index) winner
                if _frac_less_host(nb, db_, best[q][0], best[q][1]):
                    best[q] = (nb, db_, offset + jb)
        return [QueryOutcome(i, fraction_to_f64(nn, dd), processed) for nn, dd, i in best]

    def _check_audit_size(self, b: int) -> None:
        """The audit keeps every round's [2, n(, B)] int32 min-fraction block
        on the device until the stream drains (threshold-independent): guard
        the blow-up like PlaintextEngine.min_fractions does."""
        expected = getattr(self.masks_engine, "count", None)
        if expected is not None and 8 * expected * b > 4 * (1 << 30):
            raise ValueError(
                f"audit spectrum would be {8 * expected * b / 2**30:.1f} GiB "
                f"of device blocks (B={b}, {expected} entries); split the "
                "query batch"
            )

    async def query_under(self, template: Template, threshold: float,
                          limit: int | None = None) -> UnderThresholdOutcome:
        """ALL DB entries with distance strictly under ``threshold``: the MPC
        dedup audit (plaintext sibling: PlaintextEngine.find_under).

        Same protocol rounds and wire bytes as :meth:`query`; the per-round
        device step keeps every entry's minimal exact fraction instead of
        folding to the argmin, and the threshold comparison is exact in the
        rational order (engines.hits_under_from_fractions). ``limit``: more
        matches than this returns ``limit_exceeded=True`` with no list."""
        if self.chain:
            return (await self.query_batch_under([template], [threshold], limit=limit))[0]
        return (await self._query_minfrac([template], [float(threshold)], limit, False))[0]

    async def query_batch_under(self, templates: list[Template], threshold,
                                limit: int | None = None
                                ) -> list[UnderThresholdOutcome]:
        """Batched MPC dedup audit over the batched wire: per query EVERY
        entry with distance strictly under the threshold.

        ``threshold``: one float for the whole batch, or a per-query sequence
        (the device pass is threshold-independent, so micro-batched audit
        clients may each bring their own). ``limit`` applies per query."""
        b = len(templates)
        thresholds = (list(threshold) if isinstance(threshold, (list, tuple))
                      else [float(threshold)] * b)
        if len(thresholds) != b:
            raise ValueError(f"{len(thresholds)} thresholds for {b} templates")
        return await self._query_minfrac(templates, thresholds, limit, True)

    async def _query_minfrac(self, templates, thresholds, limit,
                             batched: bool) -> list[UnderThresholdOutcome]:
        b = len(templates)
        self._check_audit_size(b)
        step = _sum_decode_minfrac_device_batch if batched else _sum_decode_minfrac_device
        # contiguous offset-ordered rounds: the concatenated position IS the
        # global DB index
        spans, nd = await self._decoded_rounds(templates, batched, step,
                                               lambda r: torch.cat(r, dim=1))
        processed = spans[-1][0] + spans[-1][1] if spans else 0
        nd = np.zeros((2, 0, b), np.int32) if nd is None else nd.reshape(2, -1, b)
        outcomes = []
        for q, t in enumerate(thresholds):
            try:
                idx, dist, _n, _d = hits_under_from_fractions(nd[0, :, q], nd[1, :, q], t,
                                                              limit=limit)
            except AuditLimitExceeded:
                outcomes.append(UnderThresholdOutcome([], processed, limit_exceeded=True))
                continue
            outcomes.append(UnderThresholdOutcome(
                [MatchAt(int(i), float(v)) for i, v in zip(idx, dist)], processed))
        return outcomes

    def _endpoints(self) -> list[tuple[str, int]]:
        """The participants this coordinator actually connects to: all of
        them, or only the chain head in chain mode."""
        return [self.participants[-1]] if self.chain else self.participants

    def _check_truncated(self, processed: int, party_records: list[int]):
        """strict_scan: the aligned streams must have covered the WHOLE masks
        DB (its count at round end), else the verdict is unsafe: raise with
        per-party record counts so the short party is identifiable."""
        if not self.strict_scan:
            return
        expected = getattr(self.masks_engine, "count", None)
        if expected is None or processed >= expected:
            return
        per_party = ", ".join(
            f"{h}:{p} sent {c}"
            for (h, p), c in zip(self._endpoints(), party_records)
        ) or "local share only"
        raise TruncatedScanError(
            f"scan truncated at {processed}/{expected} entries — a verdict "
            f"over a prefix is unsafe (strict_scan; SPEC section 5). "
            f"Reply records: {per_party}"
        )

    def _check_dead_parties(self, processed: int, party_records: list[int]):
        """A remote party that produced ZERO reply records is a failed
        connection (TLS handshake rejection, wire-mode mismatch, crashed
        server), not the reference's partial-batch truncation: fail loudly
        instead of returning an empty result."""
        if processed == 0 and any(c == 0 for c in party_records):
            dead = [
                f"{h}:{p}"
                for (h, p), c in zip(self._endpoints(), party_records)
                if c == 0
            ]
            raise ConnectionError(
                f"no reply records from participant(s) {', '.join(dead)} — "
                "connection, TLS, or wire-mode failure"
                + (" (chain mode: a failed upstream aborts through the "
                   "chain head)" if self.chain else "")
            )


# ------------------------------------------------------------- serving front

# Reply record of the query-serving wire (SPEC section 5.2): little-endian
# i64 winning index, f64 distance (bit-identical to the reference decode),
# u64 entries compared. The request is the raw 3,200-byte template.
SERVE_REPLY = struct.Struct("<qdQ")

# Audit-serving wire (SPEC section 5.3): request = the raw 3,200-byte
# template ‖ one little-endian f64 threshold; reply = <u64 match count> <u64
# entries compared> header, then count 16-byte <i64 index> <f64 distance>
# records ascending by distance. A short read of the header is the client's
# failure signal (never a fabricated outcome).
AUDIT_THRESHOLD = struct.Struct("<d")
AUDIT_HEAD = struct.Struct("<QQ")
AUDIT_REC = struct.Struct("<qd")

# Persistent query wire (SPEC 5.5): a client opening with these 8 bytes keeps
# the connection for MANY query/reply records (same per-record formats as the
# one-shot wire), amortizing the TCP/TLS handshake.
PERSIST_MAGIC = b"MPCIRSQ1"


class QueryServer:
    """Network front for the uniqueness service: accepts one raw 3,200-byte
    query template per connection and replies with the 24-byte outcome
    record; a client opening with the 8-byte PERSIST_MAGIC instead keeps the
    connection for many query/reply records (SPEC 5.5).

    Each inbound query runs one full MPC round over the wrapped
    :class:`Coordinator`; concurrent connections are served concurrently,
    or micro-batched into shared batched rounds (``max_batch`` > 1).
    """

    def __init__(self, coordinator: Coordinator, host: str = "127.0.0.1",
                 port: int = 8080, ssl_context=None,
                 read_timeout: float | None = None, refresh=None,
                 max_batch: int = 1, batch_window: float = 0.005,
                 audit: bool = False, max_matches: int = 65536,
                 max_inflight: int = 32, rounds_inflight: int = 1):
        """coordinator: the configured Coordinator to run rounds on.
        ssl_context: optional server-side TLS for the client-facing socket.
        read_timeout: deadline for receiving a request after a client
        connects (None = wait forever).
        refresh: optional zero-arg callable run before each query,
        serialized server-wide.

        max_batch > 1 enables MICRO-BATCHING: concurrent client queries are
        aggregated (up to max_batch, waiting at most batch_window seconds
        after the first) into ONE MPC round over the batched wire (the
        participants must run ``wire="batched"``); each client still sees
        the single-query serving wire, and outcomes equal solo rounds.

        audit=True serves the AUDIT wire instead (SPEC section 5.3): each
        request carries a template ‖ f64 threshold, and the reply lists EVERY
        DB entry under that threshold. max_matches guards it: a client whose
        threshold matches more entries is closed WITHOUT a reply.

        max_inflight bounds CONCURRENT solo-mode MPC rounds; excess clients
        queue on the semaphore (0 disables the gate). rounds_inflight
        (micro-batched mode only) allows up to K batched rounds in flight at
        once, overlapping each round's wire reads with the others' device
        steps. Outcomes are per-client futures, so completion order never
        matters."""
        self.audit = audit
        self.max_matches = max_matches
        # nullcontext supports `async with` (3.10+): max_inflight=0 disables
        self._round_gate = (
            asyncio.Semaphore(max_inflight) if max_inflight
            else contextlib.nullcontext()
        )
        self.coordinator = coordinator
        # serving stats: monotonic counters + a bounded latency window,
        # logged every `stats_every` completed queries and readable via stats()
        self.served = 0
        self.failed = 0
        self.stats_every = 100
        self._lat_window: deque[float] = deque(maxlen=512)
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self.read_timeout = read_timeout
        self.refresh = refresh
        self.max_batch = max_batch
        self.batch_window = batch_window
        self.rounds_inflight = max(1, rounds_inflight)
        self._refresh_lock = asyncio.Lock()
        self._server: asyncio.AbstractServer | None = None
        self._queue: asyncio.Queue | None = None
        self._dispatcher: asyncio.Task | None = None
        self._round_tasks: set[asyncio.Task] = set()
        self._tracker = ConnectionTracker()
        # persistent sessions parked between records (SPEC 5.5): drained
        # immediately at shutdown, nothing is in flight on them
        self._idle_persistent: set[asyncio.StreamWriter] = set()
        self._draining = False

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.wrap(self._handle), self.host, self.port,
            ssl=self.ssl_context,
        )
        if self.max_batch > 1:
            self._queue = asyncio.Queue()
            self._dispatcher = asyncio.get_running_loop().create_task(
                self._dispatch_loop()
            )
        sock = self._server.sockets[0].getsockname()
        log.info("query server listening on %s:%s", sock[0], sock[1])
        self.port = sock[1]
        return sock[0], sock[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def drain(self, grace: float | None = None) -> bool:
        """Graceful shutdown: stop accepting new clients, wait up to `grace`
        seconds for every in-flight query (queued micro-batch members
        included) to be answered; persistent sessions parked BETWEEN records
        are ended immediately. Returns False if the deadline expired with
        queries still running: call :meth:`abort_connections`, then
        :meth:`close`."""
        self._draining = True
        if self._server is not None:
            self._server.close()  # stop accepting before ending idle sessions
        for w in list(self._idle_persistent):
            w.close()  # graceful FIN: the parked record read ends cleanly
        return await drain_server(self._server, grace, tracker=self._tracker)

    def abort_connections(self) -> int:
        """Hard-close every live client connection (post-grace force path)."""
        return self._tracker.abort_all()

    async def close(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            try:
                await self._dispatcher
            except asyncio.CancelledError:
                pass
            self._dispatcher = None
        for task in list(self._round_tasks):
            task.cancel()
        for task in list(self._round_tasks):
            try:
                await task
            except asyncio.CancelledError:
                pass
        # queries enqueued but never collected into a round: cancel their
        # futures so the waiting handlers unwind instead of hanging
        while self._queue is not None and not self._queue.empty():
            _t, _th, fut = self._queue.get_nowait()
            if not fut.done():
                fut.cancel()
        # persistent sessions parked between records would keep their handler
        # alive forever, and wait_closed() on >=3.12.1 waits for every handler
        self._draining = True
        for w in list(self._idle_persistent):
            w.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _dispatch_loop(self):
        """Collect queued (template, threshold, future) triples into batched
        MPC rounds (threshold is None in argmin mode); run up to
        ``rounds_inflight`` rounds concurrently."""
        loop = asyncio.get_running_loop()
        gate = asyncio.Semaphore(self.rounds_inflight)
        while True:
            batch = [await self._queue.get()]
            try:
                deadline = loop.time() + self.batch_window
                while len(batch) < self.max_batch:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(
                            await asyncio.wait_for(self._queue.get(), remaining)
                        )
                    except asyncio.TimeoutError:
                        break
                # acquire BEFORE spawning so the dispatcher back-pressures at
                # rounds_inflight; the task releases when its round finishes
                await gate.acquire()
            except asyncio.CancelledError:
                # cancelled mid-collection (or parked on the gate): the
                # collected triples' handlers await these futures
                for _t, _th, fut in batch:
                    if not fut.done():
                        fut.cancel()
                raise
            task = loop.create_task(self._run_round(batch, gate))
            self._round_tasks.add(task)
            task.add_done_callback(self._round_tasks.discard)

    async def _run_round(self, batch, gate: asyncio.Semaphore):
        """One batched MPC round; resolves each client's future."""
        try:
            try:
                if self.audit:
                    outcomes = await self.coordinator.query_batch_under(
                        [t for t, _th, _f in batch],
                        [th for _t, th, _f in batch],
                        limit=self.max_matches,
                    )
                else:
                    outcomes = await self.coordinator.query_batch(
                        [t for t, _th, _f in batch]
                    )
            except asyncio.CancelledError:
                for _t, _th, fut in batch:
                    if not fut.done():
                        fut.cancel()
                raise
            except Exception as e:
                for _t, _th, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError(f"batched MPC round failed: {e}")
                        )
            else:
                for (_t, _th, fut), outcome in zip(batch, outcomes):
                    if not fut.done():
                        fut.set_result(outcome)
        finally:
            gate.release()

    def stats(self) -> dict:
        """Serving counters + latency quantiles over the recent window."""
        lat = sorted(self._lat_window)
        q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0
        return {
            "served": self.served,
            "failed": self.failed,
            "p50_s": q(0.50),
            "p95_s": q(0.95),
            "window": len(lat),
        }

    def _count_query(self, dt: float) -> None:
        self.served += 1
        self._lat_window.append(dt)
        if self.stats_every and self.served % self.stats_every == 0:
            s = self.stats()
            log.info(
                "served %d queries (%d failed) — p50 %.3fs p95 %.3fs "
                "over the last %d",
                s["served"], s["failed"], s["p50_s"], s["p95_s"], s["window"],
            )

    async def _serve_one(self, raw: bytes, threshold, peer, writer) -> bool:
        """Run one query round and write its reply. Returns False when the
        connection must close WITHOUT a reply (invalid threshold or
        max_matches exceeded): the client's failure signal is the short
        read, never a fabricated outcome."""
        if self.audit and not math.isfinite(threshold):
            # NaN would read as "no duplicates", +inf matches the whole DB
            self.failed += 1
            log.error("audit from %s sent invalid threshold %r — "
                      "closing without a reply", peer, threshold)
            return False
        if self.refresh is not None:
            async with self._refresh_lock:
                await asyncio.to_thread(self.refresh)
        template = Template.from_bytes(raw)
        t0 = time.monotonic()
        try:
            if self._queue is not None:
                fut = asyncio.get_running_loop().create_future()
                await self._queue.put((template, threshold, fut))
                outcome = await fut
            elif self.audit:
                async with self._round_gate:
                    outcome = await self.coordinator.query_under(
                        template, threshold, limit=self.max_matches
                    )
            else:
                async with self._round_gate:
                    outcome = await self.coordinator.query(template)
        except (asyncio.IncompleteReadError, ConnectionResetError) as e:
            # a PARTICIPANT stream breaking mid-round counts as a failed
            # query, not as the client dropping
            raise ConnectionError(f"participant stream failed: {e}") from e
        if getattr(outcome, "limit_exceeded", False):
            self.failed += 1
            log.error(
                "audit from %s exceeded max_matches=%d (threshold %r) — "
                "closing without a reply", peer, self.max_matches,
                threshold,
            )
            return False
        self._count_query(time.monotonic() - t0)
        if self.audit:
            writer.write(AUDIT_HEAD.pack(len(outcome.matches), outcome.total))
            writer.write(b"".join(AUDIT_REC.pack(m.index, m.distance)
                                  for m in outcome.matches))
        else:
            writer.write(SERVE_REPLY.pack(outcome.index, outcome.distance, outcome.total))
        await writer.drain()
        return True

    async def _handle(self, reader, writer):
        peer = writer.get_extra_info("peername")
        try:
            def timed(coro):
                return (asyncio.wait_for(coro, self.read_timeout)
                        if self.read_timeout else coro)

            async def read_first():
                """First request under ONE deadline (a slow-loris client
                must not get a fresh budget per partial read): the 8-byte
                persistent magic, or a complete one-shot request."""
                head = await reader.readexactly(len(PERSIST_MAGIC))
                if head == PERSIST_MAGIC:
                    return None
                raw = head + await reader.readexactly(TEMPLATE_BYTES - len(head))
                if not self.audit:
                    return raw, None
                t_raw = await reader.readexactly(AUDIT_THRESHOLD.size)
                return raw, AUDIT_THRESHOLD.unpack(t_raw)[0]

            async def read_record():
                """One persistent record under one deadline. None on a clean
                end-of-session (EOF at the record boundary); EOF anywhere
                INSIDE the record raises (torn record)."""
                try:
                    raw = await reader.readexactly(TEMPLATE_BYTES)
                except asyncio.IncompleteReadError as e:
                    if e.partial:
                        raise
                    return None
                if not self.audit:
                    return raw, None
                t_raw = await reader.readexactly(AUDIT_THRESHOLD.size)
                return raw, AUDIT_THRESHOLD.unpack(t_raw)[0]

            first = await timed(read_first())
            if first is not None:
                await self._serve_one(first[0], first[1], peer, writer)
                return
            # persistent wire (SPEC 5.5): many queries per connection;
            # read_timeout applies per record, and a session parked between
            # records registers as IDLE so a drain can end it at once
            while True:
                self._idle_persistent.add(writer)
                if self._draining:
                    self._idle_persistent.discard(writer)
                    break
                try:
                    rec = await timed(read_record())
                finally:
                    self._idle_persistent.discard(writer)
                if rec is None:
                    break
                if not await self._serve_one(rec[0], rec[1], peer, writer):
                    return  # close-without-reply policy ends the session
        except asyncio.TimeoutError:
            log.warning("client %s sent no complete query within %.1fs — "
                        "closing", peer, self.read_timeout)
        except (asyncio.IncompleteReadError, ConnectionResetError) as e:
            log.warning("client %s dropped: %s", peer, e)
        except (ConnectionError, OSError) as e:
            # participant-side failure: a closed connection with no reply
            # record, loudly in the server log
            self.failed += 1
            log.error("query from %s failed: %s", peer, e)
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass


async def query_remote_under(host: str, port: int, template: Template,
                             threshold: float,
                             ssl_context=None,
                             max_matches: int = 65536) -> UnderThresholdOutcome:
    """Client half of the AUDIT serving wire (SPEC section 5.3): send one
    template ‖ f64 threshold, read the (count, total) header + match records.
    ``max_matches`` bounds the server-claimed match count before the body is
    read."""
    reader, writer = await asyncio.open_connection(host, port, ssl=ssl_context)
    try:
        writer.write(template.to_bytes())
        writer.write(AUDIT_THRESHOLD.pack(float(threshold)))
        await writer.drain()
        head = await reader.readexactly(AUDIT_HEAD.size)
        count, total = AUDIT_HEAD.unpack(head)
        if count > max_matches:
            raise ConnectionError(
                f"audit server claims {count} matches > client cap "
                f"{max_matches} — refusing to read the body"
            )
        body = await reader.readexactly(count * AUDIT_REC.size)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
    matches = [
        MatchAt(*AUDIT_REC.unpack_from(body, k * AUDIT_REC.size))
        for k in range(count)
    ]
    return UnderThresholdOutcome(matches, total)


async def query_remote(host: str, port: int, template: Template,
                       ssl_context=None) -> QueryOutcome:
    """Client half of the serving wire: send one template, read the 24-byte
    outcome record."""
    reader, writer = await asyncio.open_connection(host, port, ssl=ssl_context)
    try:
        writer.write(template.to_bytes())
        await writer.drain()
        raw = await reader.readexactly(SERVE_REPLY.size)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
    index, distance, total = SERVE_REPLY.unpack(raw)
    return QueryOutcome(index, distance, total)


class PersistentQueryClient:
    """Client for the persistent serving wire (SPEC 5.5): ONE connection
    carrying many query/reply records::

        client = await PersistentQueryClient.connect(host, port)
        try:
            for t in templates:
                outcome = await client.query(t)
        finally:
            await client.close()

    For an audit service construct with ``audit=True`` and call
    :meth:`query_under`. Queries are strictly sequential per connection."""

    def __init__(self, reader, writer, audit: bool = False,
                 max_matches: int = 65536):
        self._reader = reader
        self._writer = writer
        self.audit = audit
        self.max_matches = max_matches

    @classmethod
    async def connect(cls, host: str, port: int, ssl_context=None,
                      audit: bool = False, max_matches: int = 65536):
        reader, writer = await asyncio.open_connection(host, port, ssl=ssl_context)
        writer.write(PERSIST_MAGIC)
        # flush now so a transport failure surfaces here, not on the first query
        await writer.drain()
        return cls(reader, writer, audit=audit, max_matches=max_matches)

    async def query(self, template: Template) -> QueryOutcome:
        if self.audit:
            raise ValueError("audit client: use query_under")
        self._writer.write(template.to_bytes())
        await self._writer.drain()
        raw = await self._reader.readexactly(SERVE_REPLY.size)
        return QueryOutcome(*SERVE_REPLY.unpack(raw))

    async def query_under(self, template: Template,
                          threshold: float) -> UnderThresholdOutcome:
        if not self.audit:
            raise ValueError("argmin client: use query")
        self._writer.write(template.to_bytes())
        self._writer.write(AUDIT_THRESHOLD.pack(float(threshold)))
        await self._writer.drain()
        head = await self._reader.readexactly(AUDIT_HEAD.size)
        count, total = AUDIT_HEAD.unpack(head)
        if count > self.max_matches:
            raise ConnectionError(
                f"audit server claims {count} matches > client cap "
                f"{self.max_matches} — refusing to read the body"
            )
        body = await self._reader.readexactly(count * AUDIT_REC.size)
        matches = [
            MatchAt(*AUDIT_REC.unpack_from(body, k * AUDIT_REC.size))
            for k in range(count)
        ]
        return UnderThresholdOutcome(matches, total)

    async def close(self) -> None:
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
