"""tests/test_property.py's hypothesis properties through the port.

The same strategies, sizes and ``max_examples`` on the port's copies:
``types.Bits`` and ``EncodedBits`` (rotations, codecs, share algebra),
``protocol.wire`` (record and batched-record framing under any
fragmentation), ``io.json_stream.iter_json_array``, the C++ template parser
of ``native`` and the persistent serving wire of ``protocol.coordinator``.
Every property is checked against its own invariant, not against the JAX
package.
"""

import asyncio
import io
import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES, REPLY_RECORD_BYTES
from mpc_iris_tpu_torch.io.json_stream import iter_json_array
from mpc_iris_tpu_torch.types import Bits, EncodedBits
from test_property import _JSON_VALUES, FAST, _feed_in_splits


# ------------------------------------------------------------------- rotations


@FAST
@given(seed=st.integers(0, 2**32 - 1), r=st.integers(-15, 15))
def test_bits_rotation_roundtrip(seed, r):
    """rotate(r) then rotate(-r) is the identity for every r in [-15, 15]
    (reference bits.rs:234-247, randomized there too but only via thread_rng)."""
    rng = np.random.default_rng(seed)
    b = Bits.random(rng)
    assert b.rotated(r).rotated(-r) == b


@FAST
@given(seed=st.integers(0, 2**32 - 1), r=st.integers(-15, 15))
def test_packed_and_encoded_rotation_agree(seed, r):
    """Bits (byte-packed) rotation and EncodedBits (u16-grid) rotation encode
    the same column permutation (reference encoded_bits.rs:221-236)."""
    rng = np.random.default_rng(seed)
    b = Bits.random(rng)
    lifted = EncodedBits(b.grid().astype(np.uint16).reshape(BITS))
    rot_then_lift = b.rotated(r).grid().astype(np.uint16).reshape(BITS)
    lift_then_rot = lifted.rotated(r).data
    np.testing.assert_array_equal(rot_then_lift, lift_then_rot)


@FAST
@given(
    seed=st.integers(0, 2**32 - 1),
    a=st.integers(-7, 7),
    b=st.integers(-8, 8),
)
def test_rotation_composes_additively(seed, a, b):
    rng = np.random.default_rng(seed)
    x = Bits.random(rng)
    assert x.rotated(a).rotated(b) == x.rotated(a + b)


# ---------------------------------------------------------------------- codecs


@FAST
@given(seed=st.integers(0, 2**32 - 1))
def test_bits_hex_and_bytes_roundtrip(seed):
    rng = np.random.default_rng(seed)
    b = Bits.random(rng)
    assert Bits.from_hex(b.to_hex()) == b
    assert Bits.from_bytes(b.to_bytes()) == b
    assert len(b.to_bytes()) == BITS_BYTES


@FAST
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(1, 6))
def test_share_reconstruct_roundtrip(seed, n):
    """n additive shares wrapping-sum back to the encoding for any n >= 1
    (reference encoded_bits.rs:22-38)."""
    rng = np.random.default_rng(seed)
    v = EncodedBits(rng.integers(0, 1 << 16, BITS, dtype=np.uint16))
    shares = v.share(n, rng)
    assert len(shares) == n
    assert EncodedBits.reconstruct(shares) == v


# ---------------------------------------------------------- wire stream framing


@FAST
@given(
    seed=st.integers(0, 2**32 - 1),
    n=st.integers(0, 9),
    torn=st.integers(0, REPLY_RECORD_BYTES - 1),
    per_read=st.integers(1, 6),
    cuts=st.lists(st.integers(0, 700), max_size=8),
)
def test_read_records_arbitrary_splits_and_torn_tail(seed, n, torn, per_read, cuts):
    """read_records reassembles the record stream exactly for ANY packet
    fragmentation, and drops a torn trailing record (the reference's
    whole-record truncation, src/main.rs:538-555)."""
    from mpc_iris_tpu_torch.protocol.wire import read_records, records_to_bytes

    rng = np.random.default_rng(seed)
    records = rng.integers(0, 1 << 16, (n, 31), dtype=np.uint16)
    raw = records_to_bytes(records) + bytes(torn)

    async def go():
        reader = _feed_in_splits(raw, cuts)
        got = []
        while True:
            arr, eof = await read_records(reader, per_read)
            got.append(arr)
            if eof or arr.shape[0] < per_read:
                break
        return np.concatenate(got, axis=0) if got else np.zeros((0, 31), np.uint16)

    out = asyncio.run(go())
    np.testing.assert_array_equal(out, records)


@FAST
@given(
    seed=st.integers(0, 2**32 - 1),
    n=st.integers(0, 5),
    b=st.integers(1, 4),
    torn=st.integers(0, 61),
    cuts=st.lists(st.integers(0, 1500), max_size=6),
)
def test_read_batched_records_arbitrary_splits(seed, n, b, torn, cuts):
    """The batched wire's entry-group framing survives arbitrary
    fragmentation; partial trailing groups are dropped whole."""
    from mpc_iris_tpu_torch.protocol.wire import (
        batched_records_to_bytes,
        read_batched_records,
    )

    rng = np.random.default_rng(seed)
    block = rng.integers(0, 1 << 16, (n, b, 31), dtype=np.uint16)
    raw = batched_records_to_bytes(block) + bytes(min(torn, b * 62 - 1))

    async def go():
        reader = _feed_in_splits(raw, cuts)
        got = []
        while True:
            arr, eof = await read_batched_records(reader, b, 3)
            got.append(arr)
            if eof or arr.shape[0] < 3:
                break
        return (np.concatenate(got, axis=0) if got
                else np.zeros((0, b, 31), np.uint16))

    out = asyncio.run(go())
    np.testing.assert_array_equal(out, block)


# ------------------------------------------------------------- streaming JSON


@FAST
@given(
    elements=st.lists(_JSON_VALUES, max_size=6),
    chunk_size=st.integers(1, 7),
    spaces=st.integers(0, 2),
)
def test_iter_json_array_boundary_adversarial(elements, chunk_size, spaces):
    """A valid array parses identically for ANY buffer chunk size (1-byte
    refills cut tokens, strings, and escapes at every possible boundary)."""
    pad = " " * spaces + "\n" * (spaces % 2)
    raw = ("[" + ("," + pad).join(json.dumps(e) for e in elements) + pad + "]").encode()
    got = list(iter_json_array(io.BytesIO(raw), chunk_size=chunk_size))
    assert got == elements


@FAST
@given(data=st.binary(max_size=40), chunk_size=st.integers(1, 5))
def test_iter_json_array_malformed_never_crashes(data, chunk_size):
    """Arbitrary bytes either parse as a JSON array or raise ValueError
    (JsonStreamError or json.JSONDecodeError) — never any other exception,
    never a hang (mirrors the reference's error contract,
    src/json_stream.rs:15-17)."""
    try:
        list(iter_json_array(io.BytesIO(data), chunk_size=chunk_size))
    except ValueError:
        pass  # JsonStreamError subclasses ValueError, as does JSONDecodeError


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    seed=st.integers(0, 2**32 - 1),
    chunk_size=st.integers(32, 256),
    field_order=st.booleans(),
    ws=st.integers(0, 3),
)
def test_native_parser_chunk_boundaries_match_python(seed, chunk_size,
                                                     field_order, ws):
    """The restartable C++ template parser yields byte-identical planes for
    any refill boundary, field order, and whitespace (a template is ~6.4 KB,
    so small chunk_size tears every hex string across refills)."""
    native = pytest.importorskip("mpc_iris_tpu_torch.native")
    if not native.available():
        pytest.skip("native library not built")

    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
    msks = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
    pad = " \n\t"[: ws % 3] * ws
    items = []
    for p, m in zip(pats, msks):
        ph, mh = bytes(p).hex(), bytes(m).hex()
        if field_order:
            items.append(f'{{{pad}"pattern":{pad}"{ph}", "mask": "{mh}"{pad}}}')
        else:
            items.append(f'{{"mask":{pad}"{mh}",{pad}"pattern": "{ph}"}}')
    raw = ("[" + ",".join(items) + "]").encode()

    got = list(native.parse_templates_stream(
        io.BytesIO(raw), batch=1, chunk_size=chunk_size
    ))  # (patterns u8 [1, 1600], masks u8 [1, 1600]) per batch
    assert len(got) == 2
    for (gp, gm), p, m in zip(got, pats, msks):
        np.testing.assert_array_equal(gp[0], p)
        np.testing.assert_array_equal(gm[0], m)


@FAST
@given(
    seed=st.integers(0, 2**32 - 1),
    n=st.integers(0, 3),
    torn=st.integers(0, 3199),
    cuts=st.lists(st.integers(0, 13000), max_size=8),
)
def test_persistent_wire_record_framing(seed, n, torn, cuts):
    """The persistent serving wire (SPEC 5.5) under ANY fragmentation: a
    session of n whole records yields exactly n replies; a torn trailing
    record (1..3199 bytes) never yields an extra reply and never crashes
    the handler. Uses a stub coordinator so each example costs no MPC."""
    from mpc_iris_tpu_torch.protocol.coordinator import (
        PERSIST_MAGIC,
        SERVE_REPLY,
        QueryOutcome,
        QueryServer,
    )

    class StubCoord:
        async def query(self, template):
            return QueryOutcome(7, 0.25, 99)

    class SinkWriter:
        def __init__(self):
            self.buf = bytearray()

        def write(self, b):
            self.buf += b

        async def drain(self):
            pass

        def close(self):
            pass

        async def wait_closed(self):
            pass

        def get_extra_info(self, key):
            return ("stub", 0)

    rng = np.random.default_rng(seed)
    records = rng.integers(0, 256, (n, 3200), dtype=np.uint8).tobytes()
    raw = PERSIST_MAGIC + records + bytes(torn)
    server = QueryServer(StubCoord(), "127.0.0.1", 0)
    writer = SinkWriter()

    async def go():
        reader = _feed_in_splits(raw, cuts)
        await server._handle(reader, writer)

    asyncio.run(go())
    assert len(writer.buf) == n * SERVE_REPLY.size
    for k in range(n):
        idx, dist, total = SERVE_REPLY.unpack_from(writer.buf,
                                                   k * SERVE_REPLY.size)
        assert (idx, dist, total) == (7, 0.25, 99)
    assert server.served == n
    # torn tails are dropped-client events, clean tails are clean sessions
    assert server.failed == 0
