"""tests/test_interop.py's byte-interop vectors through the port.

The reference's byte semantics are pinned in test_interop three ways: its
``_spec_*`` helpers (plain Python ints written against the reference's lines,
importing nothing of either package), the fixture bytes built from
closed-form formulas, and frozen literals. Here the same helpers, fixtures
and literals are held against ``mpc_iris_tpu_torch``: types, ``io.formats``,
``native``, ``ShareEngine`` and ``MasksEngine`` (on the CPU),
``ParticipantServer`` and ``Coordinator``, the batched, chain and persistent
wires, the keyed-stream KATs and the CLI's ``rekey`` epochs. No JAX function
is the oracle. ``TestFrozenVectors`` (the spec helpers against their own
literals) touches neither package and is not repeated.

One case changes its subject: ``test_keyed_row_xla_path`` becomes
``test_keyed_row_device_path``, through the port's ``share_rows`` and
``share_planes_natural`` (the plain version of kernel (d)).
"""

import asyncio
import os
import struct

import numpy as np
import pytest
import torch

from mpc_iris_tpu_torch import native
from mpc_iris_tpu_torch.cli import main as cli_main
from mpc_iris_tpu_torch.io.formats import open_masks, open_share, write_masks, write_share
from mpc_iris_tpu_torch.models import MasksEngine, ShareEngine
from mpc_iris_tpu_torch.ops.chacha import (
    k_permutation,
    key_tensor,
    share_planes_natural,
    share_rows,
)
from mpc_iris_tpu_torch.ops.dot import planes_to_shares
from mpc_iris_tpu_torch.ops.encode import encode_template
from mpc_iris_tpu_torch.protocol import Coordinator, ParticipantServer, QueryServer
from mpc_iris_tpu_torch.protocol.wire import batched_query_bytes, chain_query_bytes
from mpc_iris_tpu_torch.types import Bits, EncodedBits, Template
from test_interop import (  # noqa: F401  (spec_world is a fixture)
    BITS,
    FROZEN_DISTANCES,
    FROZEN_DIST_RECORD_E1,
    FROZEN_EPOCH2_DATA_ROW2_PREFIX,
    FROZEN_EPOCH2_KEYED_ROW2_PREFIX,
    FROZEN_KEYED_ROWS,
    FROZEN_PERSIST_REPLY_Q1,
    FROZEN_PERSIST_REPLY_Q2,
    FROZEN_REKEYED_DATA_ROW2_PREFIX,
    KEY_A,
    KEY_B,
    KEY_C,
    N_ENTRIES,
    QUERY_MASK,
    QUERY_PATTERN,
    _hand_batched_query,
    _hand_chain_query,
    _spec_bit,
    _spec_chacha_block,
    _spec_dot_u16,
    _spec_encode,
    _spec_keyed_row_u16,
    _spec_rotate_bits,
    _spec_rotate_encoded,
    _u16s_to_le_bytes,
    fx_mask,
    fx_pattern,
    spec_world,
)

CPU = "cpu"


def _shares(world, key):
    return np.array([e[key] for e in world], dtype=np.uint16)


def _masks(world):
    return np.stack([np.frombuffer(e["mask"], np.uint8) for e in world])


def _query():
    return (np.frombuffer(QUERY_PATTERN, np.uint8)[None],
            np.frombuffer(QUERY_MASK, np.uint8)[None])


def _share_engine(db):
    return ShareEngine(db, device=CPU, chunk=4)


async def _raw_exchange(host, port, request: bytes) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(request)
    await writer.drain()
    data = await reader.read(-1)
    writer.close()
    await writer.wait_closed()
    return data


class TestTypesAgainstSpec:
    def test_bits_indexing_and_rotation(self):
        raw = fx_pattern(2)
        b = Bits.from_bytes(raw)
        assert b.to_bytes() == raw
        for i in (0, 1, 7, 8, 63, 64, 199, 200, 12_799):
            assert int(b[i]) == _spec_bit(raw, i)
        for r in (-15, -8, -1, 0, 1, 7, 8, 15):
            assert b.rotated(r).to_bytes() == _spec_rotate_bits(raw, r)

    def test_encoded_rotation_and_encode(self):
        pat, msk = fx_pattern(0), fx_mask(0)
        enc = encode_template(Template.from_bytes(pat + msk))
        assert enc.data.tolist() == _spec_encode(pat, msk)
        eb = EncodedBits.from_bytes(_u16s_to_le_bytes(enc.data))
        for r in (-15, -3, 0, 4, 15):
            assert eb.rotated(r).data.tolist() == _spec_rotate_encoded(
                _spec_encode(pat, msk), r)

    def test_template_wire_bytes(self):
        """Wire query = raw pattern||mask (src/main.rs:417-420)."""
        raw = QUERY_PATTERN + QUERY_MASK
        t = Template.from_bytes(raw)
        assert t.to_bytes() == raw
        assert t.pattern.to_bytes() == QUERY_PATTERN
        assert t.mask.to_bytes() == QUERY_MASK


class TestFilesAgainstSpec:
    def test_masks_file(self, spec_world, tmp_path):
        path = tmp_path / "mpc.masks"
        path.write_bytes(b"".join(e["mask"] for e in spec_world))
        masks = open_masks(path)
        assert masks.shape == (N_ENTRIES, 1600)
        for e, row in zip(spec_world, masks):
            assert row.tobytes() == e["mask"]
        out = tmp_path / "rt.masks"
        write_masks(out, np.asarray(masks))
        assert out.read_bytes() == path.read_bytes()

    def test_share_files_reconstruct(self, spec_world, tmp_path):
        p0, p1 = tmp_path / "mpc.share-0", tmp_path / "mpc.share-1"
        p0.write_bytes(b"".join(_u16s_to_le_bytes(e["s0"]) for e in spec_world))
        p1.write_bytes(b"".join(_u16s_to_le_bytes(e["s1"]) for e in spec_world))
        s0, s1 = open_share(p0), open_share(p1)
        assert s0.shape == s1.shape == (N_ENTRIES, BITS)
        total = native.share_sum([np.asarray(s0), np.asarray(s1)])
        for e, row in zip(spec_world, total):
            assert row.tolist() == e["enc"]
        out = tmp_path / "rt.share-0"
        write_share(out, np.asarray(s0))
        assert out.read_bytes() == p0.read_bytes()


class TestEnginesAgainstSpec:
    def test_share_engine_records(self, spec_world):
        """Both parties' dot records summed mod 2^16 equal the spec's
        distance records (src/main.rs:597-612)."""
        qpat, qmsk = _query()
        d0 = _share_engine(_shares(spec_world, "s0")).dots(qpat, qmsk)[0]
        d1 = _share_engine(_shares(spec_world, "s1")).dots(qpat, qmsk)[0]
        total = (d0.astype(np.uint32) + d1) % 65536
        for e, rec in zip(spec_world, total):
            assert rec.tolist() == e["dists"]
        assert total[1].tolist() == FROZEN_DIST_RECORD_E1

    def test_masks_engine_records(self, spec_world):
        dens = MasksEngine(_masks(spec_world), device=CPU, chunk=4).dots(_query()[1])[0]
        for e, rec in zip(spec_world, dens):
            assert rec.tolist() == e["dens"]


class TestProtocolAgainstSpec:
    def test_raw_wire_reply_bytes(self, spec_world):
        """A port participant driven by hand-built query bytes: the raw
        reply stream equals the spec records byte for byte."""
        async def go():
            server = ParticipantServer(_share_engine(_shares(spec_world, "s0")),
                                       "127.0.0.1", 0)
            host, port = await server.start()
            try:
                return await _raw_exchange(host, port, QUERY_PATTERN + QUERY_MASK)
            finally:
                await server.close()

        data = asyncio.run(go())
        assert len(data) == N_ENTRIES * 62
        recs = np.frombuffer(data, "<u2").reshape(N_ENTRIES, 31)
        q_enc = _spec_encode(QUERY_PATTERN, QUERY_MASK)
        for e, rec in zip(spec_world, recs):
            assert rec.tolist() == [_spec_dot_u16(_spec_rotate_encoded(q_enc, r), e["s0"])
                                    for r in range(-15, 16)]

    def test_end_to_end_distance(self, spec_world):
        """The 2-party protocol over the hand-built world through the port's
        roles: the decoded winner equals the frozen spec distances."""
        async def go():
            servers = [ParticipantServer(_share_engine(_shares(spec_world, k)),
                                         "127.0.0.1", 0) for k in ("s0", "s1")]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(MasksEngine(_masks(spec_world), device=CPU, chunk=4), addrs,
                                device=CPU)
            try:
                return await coord.query(Template.from_bytes(QUERY_PATTERN + QUERY_MASK))
            finally:
                for s in servers:
                    await s.close()

        outcome = asyncio.run(go())
        assert outcome.total == N_ENTRIES
        assert outcome.index == int(np.argmin(FROZEN_DISTANCES))
        assert outcome.distance == min(FROZEN_DISTANCES)


def _write_keyed_store(base: str, key: bytes) -> list:
    """share-0 = keystream(key, stream 0), share-1 = enc - share-0 over the
    hand-built fixture; returns the spec encodings."""
    rows = range(N_ENTRIES)
    encs = [_spec_encode(fx_pattern(e), fx_mask(e)) for e in rows]
    ks = [_spec_keyed_row_u16(key, 0, r, BITS) for r in rows]
    with open(f"{base}.share-0", "wb") as f:
        for r in rows:
            f.write(_u16s_to_le_bytes(ks[r]))
    with open(f"{base}.share-1", "wb") as f:
        for r in rows:
            f.write(_u16s_to_le_bytes([(e - k) % 65536 for e, k in zip(encs[r], ks[r])]))
    return encs


def _rekey(monkeypatch, base: str, old: bytes, new: bytes, new_key_path: str) -> None:
    """The port CLI's ``rekey`` from ``old`` to ``new`` (os.urandom pinned)."""
    monkeypatch.setattr(os, "urandom", lambda n, k=new: k[:n] if n == 32 else b"\0" * n)
    with open(f"{base}.oldkey", "w") as f:
        f.write(old.hex())  # key files carry 64 hex digits
    rc = cli_main(["rekey", base, "--count", "2", "--old-key", f"{base}.oldkey",
                   "--new-key-out", new_key_path, "--device", CPU])
    assert rc == 0
    with open(new_key_path) as kf:
        assert bytes.fromhex(kf.read().strip()) == new


def _check_keyed_store(base: str, key: bytes, encs: list):
    got0 = np.fromfile(f"{base}.share-0", "<u2").reshape(N_ENTRIES, BITS)
    got1 = np.fromfile(f"{base}.share-1", "<u2").reshape(N_ENTRIES, BITS)
    for r in range(N_ENTRIES):
        ks = _spec_keyed_row_u16(key, 0, r, BITS)
        assert got0[r].tolist() == ks  # the keyed file rewritten to the new key
        assert got1[r].tolist() == [(e - k) % 65536 for e, k in zip(encs[r], ks)]
        assert ((got0[r].astype(np.int64) + got1[r]) % 65536).tolist() == encs[r]
    return got0, got1


class TestKeyedStreamKATs:
    def test_rfc8439_block_through_port(self):
        """RFC 8439 section 2.3.2's block from the port's ChaCha20 (the
        spec's own block is the JAX-side case)."""
        nw = tuple(int.from_bytes(bytes.fromhex(h), "little")
                   for h in ("00000009", "0000004a", "00000000"))
        want = _spec_chacha_block(KEY_A, 1, nw)
        assert want[:16].hex() == "10f1e7e4d13b5915500fdd1fa32071c4"
        nonce = b"".join(w.to_bytes(4, "little") for w in nw)
        got = np.asarray(native.chacha20_stream(KEY_A, 1, nonce, 64)).tobytes()
        assert got == want

    @pytest.mark.parametrize("sid,row", sorted(FROZEN_KEYED_ROWS))
    def test_keyed_row_addressing_three_way(self, sid, row):
        """spec == frozen == the port's native for every stream-id/row class."""
        spec4 = _spec_keyed_row_u16(KEY_A, sid, row, 4)
        assert spec4 == FROZEN_KEYED_ROWS[(sid, row)]
        nonce = (sid & 0xFFFFFFFF).to_bytes(4, "little") + \
            (row & (2**64 - 1)).to_bytes(8, "little")
        got = np.asarray(native.chacha20_stream(KEY_A, 0, nonce, 8)).view("<u2").tolist()
        assert got == spec4

    def test_keyed_row_device_path(self):
        """The port's device regeneration (``share_rows``, and
        ``share_planes_natural``, the plain version of kernel (d), rebuilt
        into file order) equals the spec for a full 12,800-u16 row."""
        sid, row = 5, 1000
        want = _spec_keyed_row_u16(KEY_A, sid, row, BITS)
        kw = key_tensor(KEY_A, CPU)
        assert share_rows(kw, sid, row, 1)[0].tolist() == want
        natural = planes_to_shares(*share_planes_natural(kw, sid, row, 1))[0]
        inv = torch.from_numpy(np.argsort(k_permutation()))
        assert natural[inv].tolist() == want

    def test_rekey_epoch_frozen(self, tmp_path, monkeypatch):
        """SPEC 4.3 key rotation through the port CLI over a hand-built keyed
        store: the rewritten data share equals enc - keystream(new key)."""
        base = str(tmp_path / "kat")
        encs = _write_keyed_store(base, KEY_A)
        _rekey(monkeypatch, base, KEY_A, KEY_B, f"{base}.newkey")
        _, got1 = _check_keyed_store(base, KEY_B, encs)
        assert got1[2][:8].tolist() == FROZEN_REKEYED_DATA_ROW2_PREFIX


class TestBatchedWireAgainstSpec:
    def test_request_framing_bytes(self):
        pats = np.stack([np.frombuffer(fx_pattern(e), np.uint8) for e in (9, 3)])
        msks = np.stack([np.frombuffer(fx_mask(e), np.uint8) for e in (9, 3)])
        hand = _hand_batched_query([fx_pattern(9) + fx_mask(9), fx_pattern(3) + fx_mask(3)])
        assert batched_query_bytes(pats, msks) == hand

    def test_reply_stream_bytes(self, spec_world):
        """A port batched-wire participant driven by hand-built bytes: per
        DB entry, B consecutive [u16; 31] records equal to the spec's."""
        q1 = QUERY_PATTERN + QUERY_MASK
        q2 = fx_pattern(3) + fx_mask(3)

        async def go():
            server = ParticipantServer(_share_engine(_shares(spec_world, "s0")),
                                       "127.0.0.1", 0, wire="batched")
            host, port = await server.start()
            try:
                return await _raw_exchange(host, port, _hand_batched_query([q1, q2]))
            finally:
                await server.close()

        data = asyncio.run(go())
        assert len(data) == N_ENTRIES * 2 * 62
        recs = np.frombuffer(data, "<u2").reshape(N_ENTRIES, 2, 31)
        for (qp, qm), q in (((QUERY_PATTERN, QUERY_MASK), 0), ((fx_pattern(3), fx_mask(3)), 1)):
            q_enc = _spec_encode(qp, qm)
            for e, ent in zip(spec_world, recs):
                assert ent[q].tolist() == [
                    _spec_dot_u16(_spec_rotate_encoded(q_enc, r), e["s0"])
                    for r in range(-15, 16)]


class TestChainWireAgainstSpec:
    def test_request_framing_bytes(self):
        pats, msks = _query()
        ups = ["127.0.0.1:4441", "10.0.0.7:9"]
        hand = _hand_chain_query([QUERY_PATTERN + QUERY_MASK], ups)
        assert chain_query_bytes(pats, msks, ups) == hand

    def test_aggregated_stream_reconstructs_full_records(self, spec_world):
        """A 2-party port chain driven by hand-built bytes: the head adds its
        dot shares to its upstream's, so the reply is the full spec records."""
        async def go():
            up = ParticipantServer(_share_engine(_shares(spec_world, "s0")),
                                   "127.0.0.1", 0, wire="chain")
            uh, upp = await up.start()
            head = ParticipantServer(_share_engine(_shares(spec_world, "s1")),
                                     "127.0.0.1", 0, wire="chain")
            hh, hp = await head.start()
            try:
                return await _raw_exchange(hh, hp, _hand_chain_query(
                    [QUERY_PATTERN + QUERY_MASK], [f"{uh}:{upp}"]))
            finally:
                await head.close()
                await up.close()

        data = asyncio.run(go())
        assert len(data) == N_ENTRIES * 62
        recs = np.frombuffer(data, "<u2").reshape(N_ENTRIES, 31)
        for e, rec in zip(spec_world, recs):
            assert rec.tolist() == e["dists"]
        assert recs[1].tolist() == FROZEN_DIST_RECORD_E1


class TestPersistentWireAgainstSpec:
    def test_transcript_bytes(self, spec_world):
        """The persistent serving wire (SPEC 5.5) on the port's QueryServer as
        raw bytes: two records on one connection, each reply equal to its
        frozen literal."""
        async def go():
            part = ParticipantServer(_share_engine(_shares(spec_world, "s1")), "127.0.0.1", 0)
            addr = await part.start()
            coord = Coordinator(MasksEngine(_masks(spec_world), device=CPU, chunk=4), [addr],
                                local_engine=_share_engine(_shares(spec_world, "s0")),
                                device=CPU)
            front = QueryServer(coord, "127.0.0.1", 0)
            host, port = await front.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(b"MPCIRSQ1")
                replies = []
                for q in (QUERY_PATTERN + QUERY_MASK, fx_pattern(3) + fx_mask(3)):
                    writer.write(q)
                    await writer.drain()
                    replies.append(await reader.readexactly(24))
                writer.close()
                await writer.wait_closed()
                return replies
            finally:
                await front.close()
                await part.close()

        r1, r2 = asyncio.run(go())
        assert r1.hex() == FROZEN_PERSIST_REPLY_Q1
        assert r2.hex() == FROZEN_PERSIST_REPLY_Q2
        idx, dist, total = struct.unpack("<qdQ", r1)
        assert (idx, total) == (int(np.argmin(FROZEN_DISTANCES)), N_ENTRIES)
        assert dist == min(FROZEN_DISTANCES)
        assert struct.unpack("<qdQ", r2)[:2] == (3, 0.0)


class TestTwoEpochRekey:
    def test_two_epoch_sequence_frozen(self, tmp_path, monkeypatch):
        """SPEC 4.3 key rotation twice (KEY_A -> KEY_B -> KEY_C) through the
        port CLI: after it the keyed share is keystream(KEY_C), the
        reconstruction holds, and row 2 equals the frozen epoch-2 prefixes."""
        base = str(tmp_path / "kat")
        encs = _write_keyed_store(base, KEY_A)
        _rekey(monkeypatch, base, KEY_A, KEY_B, f"{base}.key-b")
        _rekey(monkeypatch, base, KEY_B, KEY_C, f"{base}.key-c")
        got0, got1 = _check_keyed_store(base, KEY_C, encs)
        assert got0[2][:8].tolist() == FROZEN_EPOCH2_KEYED_ROW2_PREFIX
        assert got1[2][:8].tolist() == FROZEN_EPOCH2_DATA_ROW2_PREFIX
