"""Sharded match engines (counterpart of
``mpc_iris_tpu/parallel/sharded.py``): the single-card engines of
``models/engines.py`` run per shard over the devices of a
:class:`~.mesh.Mesh`.

Data distribution (strided-by-chunk), as in the reference: the padded DB of
G = C_local * D chunks (chunk = c entries) is laid out as [C_local, D, c, K]
with the second axis over the ``"db"`` mesh axis, so shard i holds the
global chunks {j*D + i}:

- the global entry index of (local chunk j, shard i, position p) is
  (j*D + i)*c + p;
- one block step at local chunk j computes the D *consecutive* global chunks
  j*D .. j*D+D-1, so reply streams come out in DB order while every shard
  works.

Each shard's body is the port's single-card function on its own
[C_local, c, ...] slab: its ``PlainDB``'s ``match_scan_packed_auto``
(kernel (b) at B <= 8, the scan through kernel (a) above) and
``fractions_scan_packed_auto`` (kernel (c) at B <= 8); ``_share_dots_chunk``
and, for a keyed party, ``_share_dots_chunk_keyed`` (kernel (d)). Every
launch goes to the shard's own device, and torch launches are asynchronous
per device, so shards on distinct cards overlap; shards on one repeated
device run one after another. Queries split over ``"batch"`` for the
plaintext engine (B must divide by the batch axis); the global winner is
combined with :func:`~.collectives.fraction_allmin` over the shards. The MPC
engines take the whole batch on each shard's first device, as the reference
replicates their queries over ``"batch"``.

In a party of several processes, each process loads the DB rows its own
devices sit on (a contiguous range of the ``"db"`` axis; a row may span
processes, as a (2, 2) mesh of four one-card ranks does). The plaintext
engine computes every mesh entry (db row i, batch column j) on the process
that owns its device; the MPC engines compute shard i on the owner of its
home device ``devices[i, 0]`` only. Every result is joined over the party's
process group with each piece taken from its one owner, so no shard counts
twice: winners fold with :func:`~.collectives.fraction_allmin`, spectra and
reply blocks are gathered slot by slot (``_ShardedBase._gather_slots``), and
checksums add.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from mpc_iris_tpu_torch.constants import N_ROTATIONS
from mpc_iris_tpu_torch.models.engines import (
    _MASK_FORMATS,
    _MASKS_PACKED_PAST,
    DEFAULT_CHUNK,
    MasksEngine,
    PlainDB,
    _masks_storage,
    _PlaintextRequests,
    _queries_to_natural_k,
    _share_dots_chunk,
    _share_dots_chunk_keyed,
    _shares_reformat,
    _to_entry_major,
    pipelined_stream,
)
from mpc_iris_tpu_torch.ops.chacha import check_stream_id, key_tensor
from mpc_iris_tpu_torch.ops.decode import INDEX_PAD
from mpc_iris_tpu_torch.ops.self_test import kernel_self_test
from mpc_iris_tpu_torch.parallel.collectives import all_gather_cat, fraction_allmin
from mpc_iris_tpu_torch.utils.profiling import annotate
from mpc_iris_tpu_torch.utils.profiling import count as count_event

_M32 = 0xFFFFFFFF


def effective_chunk(chunk: int, total_rows: int, n_shards: int,
                    device_type: str = "cpu") -> int:
    """The chunk size the sharded engines ACTUALLY use: the reference's clamp
    min(chunk, max(128, ceil(N / D))), so tiny DBs do not pad a shard block
    to a huge chunk, rounded up to a multiple of 8 on the card, where the
    int8 product needs it (as the single-card engines round). Every layout
    consumer (the engines and ``multihost.local_entry_spans``) applies this
    same clamp, or a process's prefetch offsets would silently diverge from
    the rows the engine reads."""
    chunk = min(chunk, max(128, -(-total_rows // n_shards)))
    if device_type == "cuda":
        chunk = -(-chunk // 8) * 8
    return chunk


def local_db_span(mesh) -> tuple[int, int]:
    """Contiguous [lo, hi) range of the mesh's ``"db"`` axis on which this
    process owns a device (the reference's rule). Each process loads ONLY
    the DB rows its own devices serve, which needs the ``"db"`` axis grouped
    by process (as ``make_mesh`` builds it); raises otherwise, since a
    process-interleaved axis has no contiguous local slab. A row may span
    processes (4 ranks of one card on a (2, 2) mesh): each of its ranks
    loads it."""
    mine = [i for i in range(mesh.ranks.shape[0])
            if (mesh.ranks[i] == mesh.process_index).any()]
    if not mine:
        raise ValueError("this process owns no devices on the 'db' axis")
    lo, hi = mine[0], mine[-1] + 1
    if mine != list(range(lo, hi)):
        raise ValueError("mesh 'db' axis interleaves processes; list each "
                         "rank's devices together so its shards are contiguous")
    return lo, hi


def _local_chunk_iter(n: int, chunk: int, d: int, lo: int, hi: int):
    """Yield (block j, local row li, src start, src end) for every DB chunk
    this process loads under the strided-by-chunk layout (global chunk of
    (j, li) = j*D + lo + li; tail chunks may be empty or short)."""
    g_blocks = max(1, -(-n // (chunk * d)))
    for j in range(g_blocks):
        for li in range(hi - lo):
            start = (j * d + lo + li) * chunk
            end = min(n, start + chunk)
            yield j, li, start, max(start, end)


class _ShardedBase:
    def __init__(self, mesh, chunk: int):
        self.mesh = mesh
        self.n_shards = mesh.shape["db"]
        self.chunk = chunk
        self.db_span = local_db_span(mesh)
        # the party's group when it has several processes, else no collective
        self._group = dist.group.WORLD if mesh.process_count > 1 else None
        lo, hi = self.db_span
        pid = mesh.process_index
        # the mesh entries (db row, batch column) on this process's devices
        self._entries = [(i, j) for i in range(lo, hi) for j in range(mesh.shape["batch"])
                         if mesh.ranks[i, j] == pid]
        # the shards whose home device (first of the row) is this process's:
        # the MPC engines compute these, and only these
        self._shards = [i for i in range(lo, hi) if mesh.ranks[i, 0] == pid]
        self.device = mesh.devices[self._entries[0]]  # where results are gathered
        for dev in dict.fromkeys(mesh.devices[e] for e in self._entries):
            kernel_self_test(dev)

    def _home(self, i: int) -> torch.device:
        """Shard i's device for the MPC engines (the first of its mesh row)."""
        return self.mesh.devices[i, 0]

    def _spread(self, t: torch.Tensor, devices=None) -> dict:
        """``t`` on each of ``devices`` (default: the local shards' homes),
        every copy queued before any shard's work. A copy between cards runs
        on the source card's stream, behind all work queued there: queued
        after shard 0's launches, it would hold the other cards until shard
        0 is done."""
        if devices is None:
            devices = (self._home(i) for i in self._shards)
        with annotate("iris.query_prep"):
            return {dev: t.to(dev) for dev in dict.fromkeys(devices)}

    def _block_rows(self, j: int, src, n: int) -> np.ndarray:
        """Block j's rows of this process's (MPC) shards: ONE contiguous
        source slice (a shared memmap never pages in other processes' rows),
        zero-padded, as [hi-lo, chunk, W] from the first shard lo."""
        lo, hi = self._shards[0], self._shards[-1] + 1
        span_rows = (hi - lo) * self.chunk
        start = (j * self.n_shards + lo) * self.chunk
        end = min(n, start + span_rows)
        rows = np.ascontiguousarray(src[max(0, min(start, end)):end])
        if rows.shape[0] < span_rows:
            rows = np.pad(rows, [(0, span_rows - rows.shape[0]), (0, 0)])
        return rows.reshape(hi - lo, self.chunk, rows.shape[1])

    def _gather_slots(self, pieces: dict, owners: dict, shape, dtype) -> dict:
        """Every slot of a result, whole on THIS process (a reply block leaves
        the party through one process's socket, so it must see the whole
        block). ``owners`` maps each slot to the ONE rank that computes it;
        ``pieces`` holds this process's slots, tensors of ``shape`` and
        ``dtype``. Single process: ``pieces``. Several: each rank sends its
        own slots, padded to the most any rank owns, in one all-gather, and
        every slot is taken from its owner only, so no shard counts twice."""
        if self._group is None:
            return pieces
        by_rank = {}
        for slot, r in owners.items():
            by_rank.setdefault(int(r), []).append(slot)
        width = max(map(len, by_rank.values()))
        buf = torch.zeros((width, *shape), dtype=dtype, device=self.device)
        for k, slot in enumerate(by_rank.get(self.mesh.process_index, [])):
            buf[k] = pieces[slot]
        g = all_gather_cat(buf, 0, self._group)
        return {slot: g[r * width + k] for r, slots in by_rank.items()
                for k, slot in enumerate(slots)}

    def _q_transform(self, q_enc):
        """Hook: engines with a transformed DB K order override (keyed)."""
        return q_enc

    _queries = _PlaintextRequests._queries


class ShardedPlaintextEngine(_PlaintextRequests, _ShardedBase):
    """Exact plaintext min-distance search over a DB sharded across devices:
    the single-card engine's requests over one ``PlainDB`` a (shard,
    device)."""

    _find_under_spectrum = "find_under spectrum"

    def __init__(self, patterns_packed, masks_packed, mesh,
                 chunk: int = DEFAULT_CHUNK, storage: str = "auto"):
        """storage: as in ``models.PlaintextEngine``: "packed" (the "auto"
        choice) keeps raw bit planes per shard (3.2 KB per entry) and unpacks
        per chunk on the device; "dense" keeps int8 encodings and masks.
        Each of this process's devices on mesh row i holds shard i's chunks,
        once per distinct device, uploaded chunk by chunk from the host
        arrays (:meth:`_upload_local`)."""
        n = patterns_packed.shape[0]
        chunk = effective_chunk(chunk, n, mesh.shape["db"], mesh.device_type)
        super().__init__(mesh, chunk)
        self.storage = PlainDB.resolve(storage)
        self.count = n
        self.g_blocks = max(1, -(-n // (chunk * self.n_shards)))
        self._n_padded = self.g_blocks * self.n_shards * chunk
        # global shard i -> {device: PlainDB}, this process's devices of row i
        self._db = {}
        with annotate("iris.setup.db_load"):
            pat_s = self._upload_local(patterns_packed)
            msk_s = self._upload_local(masks_packed)
            for i, per_dev in pat_s.items():
                self._db[i] = {dev: PlainDB(pat, msk_s[i][dev], self.storage)
                               for dev, pat in per_dev.items()}

    def _upload_local(self, src) -> dict:
        """This process's shards' slabs of one packed plane: global shard i
        -> {device: uint8 [G, chunk, 1600]}, on each of this process's
        distinct devices of row i, zero-padded. Each chunk's rows go from
        ``src`` (read only at this process's rows) to every device of its
        shard, through one reusable staging buffer, never a host copy of the
        whole local DB: on the card a ring of pinned slots, each refilled
        once the upload out of it is done, so that the host fills one slot
        while the cards take the others."""
        lo, hi = self.db_span
        n, width = src.shape
        slabs = {}
        for i, j in self._entries:
            dev = self.mesh.devices[i, j]
            per_dev = slabs.setdefault(i, {})
            if dev not in per_dev:
                per_dev[dev] = torch.zeros((self.g_blocks, self.chunk, width), dtype=torch.uint8,
                                           device=dev)
        pinned = self.mesh.device_type == "cuda"
        slots = 4 if pinned else 1
        stage = torch.empty((slots, self.chunk, width), dtype=torch.uint8, pin_memory=pinned)
        stage_np = stage.numpy()
        done = [[] for _ in range(slots)]
        k = 0
        for j, li, s, e in _local_chunk_iter(n, self.chunk, self.n_shards, lo, hi):
            if e <= s:
                continue
            slot = k % slots
            k += 1
            for event in done[slot]:
                event.synchronize()
            np.copyto(stage_np[slot, : e - s], src[s:e], casting="unsafe")
            done[slot] = []
            for dev, slab in slabs[lo + li].items():
                slab[j, : e - s].copy_(stage[slot, : e - s], non_blocking=pinned)
                if pinned:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                    done[slot].append(event)
        for events in done:
            for event in events:
                event.synchronize()
        return slabs

    def _columns(self, b: int):
        """The query rows of each ``"batch"`` column: (column, slice)."""
        nb = self.mesh.shape["batch"]
        if b % nb:
            raise ValueError(f"query batch {b} does not divide by the mesh's "
                             f"batch axis {nb}")
        bl = b // nb
        return [(j, slice(j * bl, (j + 1) * bl)) for j in range(nb)]

    def _per_shard(self, q_enc, q_mask, fn):
        """Run ``fn(db, q_enc, q_mask)`` (``PlainDB.match`` or
        ``PlainDB.spectrum``) for every mesh entry (shard i, column j) of
        this process on its device, with the shard's DB there and the
        column's queries; yields (column, rows, shard, result). Every
        column's queries reach every device first (``_spread``)."""
        rows_of = dict(self._columns(q_enc.shape[0]))
        qs = {}
        for j, rows in rows_of.items():
            devs = [self.mesh.devices[i, jj] for i, jj in self._entries if jj == j]
            qs[j] = (self._spread(q_enc[rows], devs), self._spread(q_mask[rows], devs))
        for i, j in self._entries:
            dev = self.mesh.devices[i, j]
            out = fn(self._db[i][dev], qs[j][0][dev], qs[j][1][dev])
            count_event("iris.shard.bodies")
            yield j, rows_of[j], i, out

    def match_arrays(self, q_enc, q_mask) -> torch.Tensor:
        """Prepared query planes -> int32 [3, B] (numerator, denominator,
        global DB index) on the engine's first device: every shard's body is
        launched first; then each column's winners fold over this process's
        shards, and in a party of several processes over the ranks (a
        column a rank does not compute is the invalid candidate there)."""
        c, d = self.chunk, self.n_shards
        bodies = list(self._per_shard(q_enc, q_mask, PlainDB.match))
        with annotate("iris.fold"):
            cols = {}
            for j, rows, i, (n_, d_, l) in bodies:
                # local l = jc*c + p  ->  global (jc*D + i)*c + p, int32
                g = (l // c) * (d * c) + i * c + l % c
                cols.setdefault(j, (rows, []))[1].append((n_, d_, g))
            folded = {j: (rows, torch.stack(fraction_allmin(*zip(*triples), self.device)))
                      for j, (rows, triples) in cols.items()}
            if self._group is None:  # every column is computed here
                return torch.cat([folded[j][1] for j in sorted(folded)], dim=1)
            win = torch.zeros((3, q_enc.shape[0]), dtype=torch.int32, device=self.device)
            win[2] = INDEX_PAD
            for rows, w in folded.values():
                win[:, rows] = w
            return torch.stack(fraction_allmin([win[0]], [win[1]], [win[2]], self.device,
                                               self._group))

    def _spectrum(self, q_enc, q_mask) -> torch.Tensor:
        """The fraction spectrum int16 [2, B, G*D*c] in GLOBAL entry order on
        the first device: each mesh entry's [2, B_col, G*c] is written into
        [2, B, G, D, c] at its (column rows, shard) slot (one strided copy),
        taken from the rank that computed it."""
        b, g, c, d = q_enc.shape[0], self.g_blocks, self.chunk, self.n_shards
        cols = self._columns(b)
        pieces = {(j, i): nd.reshape(2, -1, g, c).to(self.device, torch.int16)
                  for j, _, i, nd in self._per_shard(q_enc, q_mask, PlainDB.spectrum)}
        owners = {(j, i): self.mesh.ranks[i, j] for j, _ in cols for i in range(d)}
        pieces = self._gather_slots(pieces, owners, (2, b // len(cols), g, c), torch.int16)
        out = torch.empty((2, b, g, d, c), dtype=torch.int16, device=self.device)
        for j, rows in cols:
            for i in range(d):
                out[:, rows, :, i] = pieces[j, i]
        return out.reshape(2, b, -1)

    def find_under(self, patterns_packed, masks_packed, threshold: float,
                   limit: int | None = None, compact_k: int | None = None):
        """``models.PlaintextEngine.find_under`` over the sharded DB, but a
        NaN or non-positive threshold returns empty lists at once, before
        any work and outside the request's span, as the reference's
        sharded engine does."""
        b = np.asarray(patterns_packed).shape[0]
        t = float(threshold)
        if math.isnan(t) or t <= 0.0:
            return [[] for _ in range(b)]
        return super().find_under(patterns_packed, masks_packed, threshold, limit, compact_k)


class _BlockListEngine(_ShardedBase):
    """Reply streaming shared by the MPC engines. Block step j is the D
    shards' replies for global chunks j*D .. j*D+D-1, joined along the entry
    axis in DB order. ``_blocks`` holds one element per step (the local
    shards' device slabs, or the step's index for a keyed engine); refresh()
    replaces the list, never mutates it, so a running stream keeps its
    snapshot. Subclasses give ``_shard_dots(qs, blk, li, i)``: shard i's
    reply to step element ``blk`` for the queries ``qs`` (one copy a
    device)."""

    def num_blocks(self) -> int:
        return len(self._blocks)

    def _block(self, qs: dict, blk, b: int) -> torch.Tensor:
        """The D shards' replies [B, D*chunk, 31]: this process's shards
        computed here, the others' taken from the owners of their home
        devices."""
        pieces = {i: self._shard_dots(qs, blk, li, i).to(self.device)
                  for li, i in enumerate(self._shards)}
        owners = {i: self.mesh.ranks[i, 0] for i in range(self.n_shards)}
        parts = self._gather_slots(pieces, owners, (b, self.chunk, N_ROTATIONS), torch.int16)
        return torch.cat([parts[i] for i in range(self.n_shards)], dim=1)

    def block(self, q_enc, j: int) -> torch.Tensor:
        """Global chunks j*D .. j*D+D-1 for prepared query planes: int16
        [B, D*chunk, 31] (u16 bit patterns) in DB order on the first
        device."""
        return self._block(self._spread(q_enc), self._blocks[j], q_enc.shape[0])

    def _stream(self, qs: dict, b: int, entry_major: bool):
        """Host uint16 blocks in DB order, trimmed ([B, n, 31] or
        entry-major [n, B, 31])."""
        blocks = self._blocks  # snapshot: refresh() swaps, never mutates
        step = self.chunk * self.n_shards
        if entry_major:
            dispatch = lambda j: _to_entry_major(self._block(qs, blocks[j], b))
        else:
            dispatch = lambda j: self._block(qs, blocks[j], b)
        # the block count and the count are taken with the snapshot, so a
        # refresh racing this generator cannot index past it
        yield from pipelined_stream(dispatch, len(blocks), min(self.count, len(blocks) * step),
                                    step, entry_axis=0 if entry_major else 1)

    def _growth_note(self, n_new: int) -> str | None:
        """Hook: a warning to print when the DB grows to ``n_new``."""
        return None

    def refresh(self, src) -> int:
        """Adopt a grown (append-only) host source; returns entries added.

        O(added): complete blocks are reused, a previously padded tail block
        is loaded again and new blocks appended, each process reading only
        its own slice. In a party every process calls refresh() with its own
        source before the next query."""
        n_new = src.shape[0]
        if n_new < self.count:
            raise ValueError(
                f"refresh is append-only: new count {n_new} < current "
                f"{self.count} (rebuild the engine for a shrunk/rewritten DB)")
        added = n_new - self.count
        if added == 0:
            return 0
        note = self._growth_note(n_new)
        if note:
            print(f"{type(self).__name__}: {note}", file=sys.stderr)
        step = self.chunk * self.n_shards
        blocks = self._blocks[: self.count // step]  # blocks with no padded rows, reused
        for j in range(len(blocks), max(1, -(-n_new // step))):
            blocks.append(self._load_block(j, src, n_new))
        self._blocks = blocks  # atomic swap under the GIL
        self.count = n_new
        return added


class ShardedShareEngine(_BlockListEngine):
    """Participant dot-share engine over a share DB sharded across devices."""

    def __init__(self, shares_u16, mesh, chunk: int = DEFAULT_CHUNK):
        """shares_u16: uint16 [N, 12800] (host, e.g. np.memmap).

        Loading is process-local: each process reads one contiguous source
        slice per block (its own shards' rows), moves the raw u16 rows to each
        shard's device and splits them into int8 lo/hi planes there. The
        devices must hold the whole shard (25.6 KB per entry per shard); for
        a DB past the mesh's memory use the single-card ShareEngine's
        out-of-core mode per party, or a bigger mesh."""
        n = shares_u16.shape[0]
        self._chunk_req = chunk  # pre-clamp request, for refresh() warnings
        chunk = effective_chunk(chunk, n, mesh.shape["db"], mesh.device_type)
        super().__init__(mesh, chunk)
        self.count = n
        g_blocks = max(1, -(-n // (chunk * self.n_shards)))
        # per block: per local shard int8 [2, chunk, K] planes on its device
        self._blocks = [self._load_block(j, shares_u16, n) for j in range(g_blocks)]

    def _load_block(self, j: int, src, n: int) -> list[torch.Tensor]:
        if not self._shards:
            return []
        local = self._block_rows(j, src, n).astype(np.uint16, copy=False)
        lo = self._shards[0]
        return [_shares_reformat(torch.from_numpy(local[i - lo].view(np.int16)).to(self._home(i)))
                for i in self._shards]

    def _growth_note(self, n_new: int) -> str | None:
        fresh = effective_chunk(self._chunk_req, n_new, self.n_shards, self.mesh.device_type)
        if fresh >= 4 * self.chunk:
            return (f"DB grew to {n_new} but keeps its construction-time chunk "
                    f"{self.chunk} (a fresh build would pick {fresh}); rebuild for "
                    "fewer, larger launches")
        return None

    def _shard_dots(self, qs: dict, blk, li: int, i: int) -> torch.Tensor:
        planes = blk[li]
        return _share_dots_chunk(qs[planes.device], planes[0], planes[1])

    def stream(self, patterns_packed, masks_packed, entry_major: bool = False):
        """Yield host uint16 blocks in DB order, trimmed ([B, n, 31] or
        entry-major [n, B, 31])."""
        q_enc = self._queries(patterns_packed, masks_packed)[0]
        yield from self._stream(self._spread(self._q_transform(q_enc)), q_enc.shape[0],
                                entry_major)

    def dots(self, patterns_packed, masks_packed) -> np.ndarray:
        return np.concatenate(list(self.stream(patterns_packed, masks_packed)), axis=1)


class ShardedKeyedShareEngine(_BlockListEngine):
    """Participant for a PRF-backed share (s < n-1) over several devices:
    every shard REGENERATES its own rows on its device from the 32-byte key
    (kernel (d)), so no share data moves at all. Replies stream in DB order
    like ShardedShareEngine's; ``block`` takes query planes already in
    natural K order (``_queries_to_natural_k``), as the reference's does."""

    def __init__(self, key: bytes, stream_id: int, count: int, mesh,
                 chunk: int = DEFAULT_CHUNK):
        self._sid = check_stream_id(stream_id)
        n = int(count)
        chunk = effective_chunk(chunk, n, mesh.shape["db"], mesh.device_type)
        super().__init__(mesh, chunk)
        self.count = n
        self._blocks = range(max(1, -(-n // (chunk * self.n_shards))))  # step j is j
        self._kw = {dev: key_tensor(key, dev)
                    for dev in dict.fromkeys(self._home(i) for i in self._shards)}

    def refresh(self, count: int) -> int:
        """Adopt a grown logical DB size; returns entries added. Every row
        regenerates from the key, so a sync is the new count."""
        count = int(count)
        if count < self.count:
            raise ValueError(
                f"refresh is append-only: new count {count} < current "
                f"{self.count} (rebuild the engine for a shrunk DB)")
        added = count - self.count
        self._blocks = range(max(1, -(-count // (self.chunk * self.n_shards))))
        self.count = count
        return added

    def _shard_dots(self, qs: dict, j: int, li: int, i: int) -> torch.Tensor:
        dev = self._home(i)
        return _share_dots_chunk_keyed(qs[dev], self._kw[dev], self._sid,
                                       (j * self.n_shards + i) * self.chunk, self.chunk)

    def fold_pass_fn(self):
        """Whole-DB checksum pass over the shards (the sharded analogue of
        ``KeyedShareEngine.fold_pass_fn``): returns ``run(q_enc) ->
        np.uint32``, the uint32 sum of every dot share of the file-order
        query planes. Each shard folds its own regenerated chunks on its
        device; the partial sums add mod 2^32 in int64 with a mask, across
        shards and across the party's processes."""
        d, chunk, g_blocks = self.n_shards, self.chunk, len(self._blocks)
        if g_blocks * d * chunk != self.count:
            raise ValueError(
                f"fold_pass_fn folds whole per-shard chunks: count="
                f"{self.count} != {g_blocks}x{d}x{chunk} (the checksum would "
                "include phantom padding rows); use a chunk*n_shards-aligned "
                "count or the streaming path")

        def run(q_enc):
            qs = self._spread(_queries_to_natural_k(q_enc))
            parts = []
            for li, i in enumerate(self._shards):  # all launched before any fetch
                acc = torch.zeros((), dtype=torch.int64, device=self._home(i))
                for j in range(g_blocks):
                    acc.add_((self._shard_dots(qs, j, li, i).to(torch.int64) & 0xFFFF).sum())
                parts.append(acc & _M32)
            total = sum((p.to(self.device) for p in parts),
                        torch.zeros((), dtype=torch.int64, device=self.device)) & _M32
            if self._group is not None:
                total = all_gather_cat(total[None], 0, self._group).sum() & _M32
            return np.uint32(int(total))

        return run

    def _q_transform(self, q_enc):
        return _queries_to_natural_k(q_enc)

    # the query side is the data-holding engine's, as in the reference
    stream = ShardedShareEngine.stream
    dots = ShardedShareEngine.dots


class ShardedMasksEngine(_BlockListEngine):
    """Coordinator denominator engine over a masks DB sharded across devices."""

    def __init__(self, masks_packed, mesh, chunk: int = DEFAULT_CHUNK,
                 storage: str = "auto"):
        """The masks DB lives as per-block shard lists (like
        ShardedShareEngine's), so :meth:`refresh` moves only appended blocks,
        O(added). storage "auto" is packed past 400,000 entries per shard,
        the reference's boundary; it stays as built (``refresh`` warns when
        growth crosses the boundary)."""
        n = masks_packed.shape[0]
        chunk = effective_chunk(chunk, n, mesh.shape["db"], mesh.device_type)
        super().__init__(mesh, chunk)
        self.storage = _masks_storage(storage, n // self.n_shards)
        self._stored, self._dots = _MASK_FORMATS[self.storage]
        self.count = n
        g_blocks = max(1, -(-n // (chunk * self.n_shards)))
        self._blocks = [self._load_block(j, masks_packed, n) for j in range(g_blocks)]

    def _load_block(self, j: int, src, n: int) -> list[torch.Tensor]:
        """Block j's local shards on their devices: packed uint8 [c, 1600],
        or unpacked there to int8 [c, 12800]."""
        if not self._shards:
            return []
        local = self._block_rows(j, src, n).astype(np.uint8, copy=False)
        lo = self._shards[0]
        return [self._stored(torch.from_numpy(local[i - lo]).to(self._home(i)))
                for i in self._shards]

    def _growth_note(self, n_new: int) -> str | None:
        if self.storage == "dense" and n_new // self.n_shards > _MASKS_PACKED_PAST:
            return (f"DB grew to {n_new} with dense storage (12.8 KB/entry/shard); a "
                    "fresh build would pick packed (1.6 KB); rebuild to save device memory")
        return None

    def _shard_dots(self, qs: dict, blk, li: int, i: int) -> torch.Tensor:
        m = blk[li]
        return self._dots(qs[m.device], m)

    # the query side is the single-card engine's
    _queries = MasksEngine._queries

    def stream(self, masks_packed, entry_major: bool = False):
        q_mask = self._queries(masks_packed)
        yield from self._stream(self._spread(q_mask), q_mask.shape[0], entry_major)

    def dots(self, masks_packed) -> np.ndarray:
        return np.concatenate(list(self.stream(masks_packed)), axis=1)
