"""Wire-format helpers shared by coordinator and participant (copy of
``mpc_iris_tpu/protocol/wire.py``; the bytes are the same).

Three wire modes:

- **reference** (default): one raw 3,200-byte template per connection; reply is
  a stream of `[u16; 31]` little-endian records in DB order — byte-compatible
  with the reference (src/main.rs:417-445).
- **batched** (extension; the reference has none, its engine API is
  batch-shaped but its protocol is one-query-at-a-time): the client sends a
  u32-LE query count B (1..65536) followed by B raw templates; the reply is a
  flat stream of ENTRY-major groups — per DB entry, B consecutive `[u16; 31]`
  records — in DB order. Amortizes connection, rotation-expansion, and dispatch
  overheads over the whole batch. Selected explicitly per endpoint
  (``--wire batched``), never sniffed — a raw template could begin with any
  bytes.
- **chain** (extension, SPEC section 5.4): like batched, but the request also
  carries an upstream party list; the participant adds its own dot shares to
  its upstream chain's aggregated stream and forwards ONE summed stream
  downstream. The coordinator's reply ingress stops scaling with the party
  count; every partial sum stays uniformly random to its holder because the
  coordinator's own share is never in the chain.
"""

from __future__ import annotations

import asyncio
import struct

import numpy as np

from mpc_iris_tpu_torch.constants import N_ROTATIONS, REPLY_RECORD_BYTES, TEMPLATE_BYTES

# Records per network batch (reference BATCH_SIZE, src/main.rs:473).
BATCH_RECORDS = 20_000

# Per-party byte budget for one read round. The batched wire buffers
# B × 62 bytes per entry-group, so a fixed group count would scale per-round
# memory linearly with B (20,000 groups × B=65,536 ≈ 81 GB). Budgeting in
# bytes keeps coordinator memory bounded for any B.
READ_BYTE_BUDGET = 32 << 20


def records_per_read(b: int, budget: int | None = None) -> int:
    """Entry-groups per read round for batch size ``b``: the reference's
    20,000-record batches, capped so one round buffers at most ``budget``
    bytes (default ``READ_BYTE_BUDGET``) per party (b == 1 keeps the
    reference's exact batching)."""
    if budget is None:
        budget = READ_BYTE_BUDGET
    return max(1, min(BATCH_RECORDS, budget // (b * REPLY_RECORD_BYTES)))


async def read_records(
    reader: asyncio.StreamReader, max_records: int
) -> tuple[np.ndarray, bool]:
    """Read up to ``max_records`` 62-byte reply records; tolerate EOF.

    Returns (records u16 [n, 31], eof). Partial trailing records are dropped with the
    same whole-record truncation as the reference (src/main.rs:538-555).
    """
    want = max_records * REPLY_RECORD_BYTES
    chunks = []
    got = 0
    eof = False
    while got < want:
        data = await reader.read(want - got)
        if not data:
            eof = True
            break
        chunks.append(data)
        got += len(data)
    raw = b"".join(chunks)
    n = len(raw) // REPLY_RECORD_BYTES
    if len(raw) % REPLY_RECORD_BYTES:
        # partial record at EOF — reference warns and truncates
        raw = raw[: n * REPLY_RECORD_BYTES]
    arr = np.frombuffer(raw, dtype="<u2").reshape(n, N_ROTATIONS)
    return arr, eof


async def read_template_bytes(reader: asyncio.StreamReader) -> bytes:
    """Read the fixed 3,200-byte query (src/main.rs:417-420)."""
    return await reader.readexactly(TEMPLATE_BYTES)


def records_to_bytes(records: np.ndarray) -> bytes:
    """u16 [n, 31] -> wire bytes (little-endian, row-major)."""
    return np.ascontiguousarray(records).astype("<u2").tobytes()


# ------------------------------------------------------------- batched wire


# Magic prefix for the batched wire: a reference-wire client hitting a batched
# server fails fast with a clear error instead of computing garbage. (The
# reference wire has no framing by design — a raw template may begin with any
# bytes — so only the extension can afford a magic, and the opposite mismatch,
# a batched client on a reference server, remains undetectable: configure both
# ends consistently.)
BATCHED_MAGIC = b"IRB1"


def _query_body_bytes(patterns: np.ndarray, masks: np.ndarray,
                      wire: str) -> bytes:
    """Shared framing body of the batched and chain wires:
    u32 count + B raw templates."""
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    masks = np.ascontiguousarray(masks, dtype=np.uint8)
    b = patterns.shape[0]
    if not 0 < b <= 65536:
        raise ValueError(f"{wire} wire supports 1..65536 queries, got {b}")
    # One contiguous copy: per template, pattern plane then mask plane.
    return struct.pack("<I", b) + np.hstack([patterns, masks]).tobytes()


async def _read_query_body(reader: asyncio.StreamReader, wire: str):
    """Shared server-side body read: (patterns u8 [B,1600], masks u8 [B,1600])."""
    (b,) = struct.unpack("<I", await reader.readexactly(4))
    if not 0 < b <= 65536:
        raise ValueError(f"bad {wire} query count {b}")
    raw = await reader.readexactly(b * TEMPLATE_BYTES)
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(b, TEMPLATE_BYTES)
    half = TEMPLATE_BYTES // 2
    return arr[:, :half].copy(), arr[:, half:].copy()


def batched_query_bytes(patterns: np.ndarray, masks: np.ndarray) -> bytes:
    """[B, 1600] uint8 plane pairs -> magic + u32 count + B raw templates."""
    return BATCHED_MAGIC + _query_body_bytes(patterns, masks, "batched")


async def read_batched_query(reader: asyncio.StreamReader):
    """Server side: (patterns u8 [B, 1600], masks u8 [B, 1600])."""
    magic = await reader.readexactly(4)
    if magic != BATCHED_MAGIC:
        raise ValueError(
            f"not a batched-wire query (magic {magic!r}); is the client running "
            "--wire batched?"
        )
    return await _read_query_body(reader, "batched")


def batched_records_to_bytes(block_entry_major: np.ndarray) -> bytes:
    """u16 [n, B, 31] (entry-major) -> wire bytes: per DB entry, B consecutive
    [u16; 31] records. Entry-major keeps the stream a flat sequence of
    fixed-size per-entry groups, so blocks of any size concatenate seamlessly
    and EOF truncation stays entry-granular (like the reference stream).
    Engines produce this layout on device (`stream(..., entry_major=True)`),
    so no host transpose happens anywhere on the batched path."""
    return np.ascontiguousarray(block_entry_major).astype("<u2", copy=False).tobytes()


# --------------------------------------------------------------- chain wire

# Chained reply aggregation (SPEC section 5.4): a chain participant computes
# its own dot shares AND adds the aggregated stream of its upstream chain,
# forwarding one summed entry-major stream downstream. The coordinator
# contacts only the chain head and receives ONE stream carrying
# sum_{i in chain} dot_i mod 2^16 — its ingress no longer scales with the
# party count. The request carries the upstream address list so the chain
# self-assembles recursively.
CHAIN_MAGIC = b"IRC1"


def chain_query_bytes(patterns: np.ndarray, masks: np.ndarray,
                      upstream: list[str]) -> bytes:
    """[B, 1600] uint8 plane pairs + upstream "host:port" list ->
    magic + u32 B + B raw templates + u16 n + n length-prefixed addresses."""
    if len(upstream) > 65535:
        raise ValueError("chain wire supports at most 65535 upstream parties")
    parts = [CHAIN_MAGIC, _query_body_bytes(patterns, masks, "chain"),
             struct.pack("<H", len(upstream))]
    for addr in upstream:
        raw = addr.encode()
        if len(raw) > 65535:
            raise ValueError(f"upstream address too long: {addr!r}")
        parts.append(struct.pack("<H", len(raw)) + raw)
    return b"".join(parts)


async def read_chain_query(reader: asyncio.StreamReader):
    """Server side: (patterns u8 [B, 1600], masks u8 [B, 1600],
    upstream ["host:port", ...])."""
    magic = await reader.readexactly(4)
    if magic != CHAIN_MAGIC:
        raise ValueError(
            f"not a chain-wire query (magic {magic!r}); is the client running "
            "--wire chain?"
        )
    patterns, masks = await _read_query_body(reader, "chain")
    (n_up,) = struct.unpack("<H", await reader.readexactly(2))
    upstream = []
    for _ in range(n_up):
        (ln,) = struct.unpack("<H", await reader.readexactly(2))
        upstream.append((await reader.readexactly(ln)).decode())
    return patterns, masks, upstream


async def read_batched_records(
    reader: asyncio.StreamReader, b: int, max_records: int
) -> tuple[np.ndarray, bool]:
    """Read up to ``max_records`` entry-groups of a batched reply; EOF-tolerant.

    Returns (u16 [n, B, 31] entry-major, eof); partial trailing entry-groups
    are dropped (the batched analogue of the reference's whole-record
    truncation).
    """
    group = b * REPLY_RECORD_BYTES  # bytes per DB entry across the whole batch
    want = max_records * group
    chunks = []
    got = 0
    eof = False
    while got < want:
        data = await reader.read(want - got)
        if not data:
            eof = True
            break
        chunks.append(data)
        got += len(data)
    raw = b"".join(chunks)
    n = len(raw) // group
    raw = raw[: n * group]
    arr = np.frombuffer(raw, dtype="<u2").reshape(n, b, N_ROTATIONS)
    return arr, eof
