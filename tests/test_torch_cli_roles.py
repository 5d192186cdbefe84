"""The port's serving roles behind its CLI, on the CPU: the cases of
test_enroll.py (uniqueness check and insert over the MPC protocol) and
test_refresh.py (append-only DB sync of every engine, the CLI's watchers,
and participants and coordinators that adopt growth between queries), run
against the port's engines, roles and ``mpc_iris_tpu_torch.cli``; and
``python -m mpc_iris_tpu_torch --help``, whose subcommands are the JAX
CLI's."""

import asyncio
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_iris_tpu_torch import native
from mpc_iris_tpu_torch.cli import (
    main as port_main,
    make_keyed_count_watcher,
    make_keyed_masks_follower,
    make_masks_watcher,
    make_share_watcher,
)
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES
from mpc_iris_tpu_torch.io.formats import (
    open_masks,
    open_share,
    write_masks,
    write_share,
)
from mpc_iris_tpu_torch.models import KeyedShareEngine, MasksEngine, ShareEngine
from mpc_iris_tpu_torch.parallel import (
    ShardedKeyedShareEngine,
    ShardedMasksEngine,
    ShardedShareEngine,
    make_mesh,
)
from mpc_iris_tpu_torch.protocol import Coordinator, ParticipantServer
from mpc_iris_tpu_torch.protocol.keyagree import read_key32
from mpc_iris_tpu_torch.protocol.wire import read_records
from mpc_iris_tpu_torch.types import EncodedBits, Template

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent


def main(argv):
    return port_main([*argv, "--device", "cpu"])


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _shares(rng, n):
    return rng.integers(0, 1 << 16, size=(n, BITS), dtype=np.uint16)


def _queries(rng, b=2):
    return (rng.integers(0, 256, (b, BITS_BYTES), dtype=np.uint8),
            rng.integers(0, 256, (b, BITS_BYTES), dtype=np.uint8))


def _mesh4():
    return make_mesh(db=4, batch=1, devices=[CPU] * 4)


# ------------------------------------------------------------------ the CLI's names


def test_help_lists_the_jax_clis_subcommands():
    from mpc_iris_tpu.cli import build_parser

    out = subprocess.run([sys.executable, "-m", "mpc_iris_tpu_torch", "--help"],
                         capture_output=True, text=True, check=True, cwd=ROOT).stdout
    names = re.search(r"\{([a-z,-]+)\}", out)[1].split(",")
    ref = build_parser()._subparsers._group_actions[0].choices
    assert len(names) == 17 and names == list(ref)
    assert "--device" in out


# ------------------------------------------------------------------ enroll (test_enroll.py)


def _start_participant_thread(engine, refresh, wire="reference"):
    """A ParticipantServer on its own event loop in a daemon thread, so
    cli.main() (which owns the main thread's asyncio.run) can query it."""
    holder = {}
    ready = threading.Event()

    def run():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        server = ParticipantServer(engine, "127.0.0.1", 0, wire=wire, refresh=refresh)
        _, holder["port"] = loop.run_until_complete(server.start())
        holder["loop"] = loop
        ready.set()
        loop.run_forever()
        loop.run_until_complete(server.close())
        loop.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(120), "participant server failed to start"
    holder["thread"] = th
    return holder


def _stop_participant_thread(holder):
    holder["loop"].call_soon_threadsafe(holder["loop"].stop)
    holder["thread"].join(60)


def test_enroll_end_to_end(workdir, capsys):
    """2-party deployment: party 0 KEYED (follows mpc.count), this process
    holds the data share. A duplicate of an entry, a fresh template, and a
    rotation of it (caught only if appends are adopted between queries)."""
    assert main(["generate", "db.json", "10", "--seed", "41"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "7",
                 "--save-key", "mpc.key"]) == 0

    objs = json.loads((workdir / "db.json").read_bytes())
    fresh = Template.random(np.random.default_rng(77))
    cands = [objs[4], fresh.to_json_obj(), fresh.rotated(3).to_json_obj()]
    (workdir / "cands.json").write_text(json.dumps(cands))

    key = read_key32(str(workdir / "mpc.key"))
    eng = KeyedShareEngine(key, 0, count=10, chunk=4, device=CPU)
    holder = _start_participant_thread(
        eng, make_keyed_count_watcher(str(workdir / "mpc.count"), eng))
    try:
        rc = main(["enroll", "cands.json", "mpc", f"127.0.0.1:{holder['port']}",
                   "--count", "2", "--key", "mpc.key", "--threshold", "0.2",
                   "--share", "mpc.share-1", "--chunk", "4"])
    finally:
        _stop_participant_thread(holder)
    assert rc == 0

    out = capsys.readouterr().out.splitlines()
    verdicts = [l for l in out if l.startswith("candidate ")]
    assert len(verdicts) == 3
    assert "DUPLICATE of entry 4 at distance 0.0" in verdicts[0]
    assert "enrolled at index 10" in verdicts[1]
    assert "DUPLICATE of entry 10 at distance 0.0" in verdicts[2]

    assert open_masks("mpc.masks").shape[0] == 11
    assert open_share("mpc.share-0").shape[0] == 11
    assert open_share("mpc.share-1").shape[0] == 11
    assert (workdir / "mpc.count").read_text().strip() == "11"

    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "--output", "dec.json"]) == 0
    dec = json.loads((workdir / "dec.json").read_bytes())
    assert len(dec) == 11
    got = Template.from_json_obj(dec[10])
    assert got.mask.data.tobytes() == fresh.mask.data.tobytes()
    assert np.array_equal(got.pattern.data & got.mask.data,
                          fresh.pattern.data & fresh.mask.data)
    assert main(["decrypt", "keyed:0:11:mpc.key", "mpc.share-1",
                 "--output", "dec2.json"]) == 0
    assert (workdir / "dec.json").read_bytes() == (workdir / "dec2.json").read_bytes()


def test_enroll_batched_matches_sequential_semantics(workdir, capsys):
    assert main(["generate", "db.json", "8", "--seed", "45"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "3",
                 "--save-key", "mpc.key"]) == 0

    objs = json.loads((workdir / "db.json").read_bytes())
    f1 = Template.random(np.random.default_rng(91))
    f2 = Template.random(np.random.default_rng(92))
    cands = [objs[2], f1.to_json_obj(), f1.rotated(-7).to_json_obj(), f2.to_json_obj()]
    (workdir / "cands.json").write_text(json.dumps(cands))

    key = read_key32(str(workdir / "mpc.key"))
    eng = KeyedShareEngine(key, 0, count=8, chunk=4, device=CPU)
    holder = _start_participant_thread(
        eng, make_keyed_count_watcher(str(workdir / "mpc.count"), eng), wire="batched")
    try:
        rc = main(["enroll", "cands.json", "mpc", f"127.0.0.1:{holder['port']}",
                   "--count", "2", "--key", "mpc.key", "--threshold", "0.2",
                   "--share", "mpc.share-1", "--chunk", "4", "--wire", "batched",
                   "--round", "4"])
    finally:
        _stop_participant_thread(holder)
    assert rc == 0

    out = capsys.readouterr().out.splitlines()
    verdicts = [l for l in out if l.startswith("candidate ")]
    assert len(verdicts) == 4
    assert "DUPLICATE of entry 2 at distance 0.0" in verdicts[0]
    assert "enrolled at index 8" in verdicts[1]
    assert "DUPLICATE of entry 8 at distance 0.0" in verdicts[2]
    assert "enrolled at index 9" in verdicts[3]
    assert open_masks("mpc.masks").shape[0] == 10
    assert (workdir / "mpc.count").read_text().strip() == "10"


def test_enroll_validation(workdir):
    assert main(["generate", "db.json", "4", "--seed", "42"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "7",
                 "--save-key", "mpc.key"]) == 0
    assert main(["enroll", "db.json", "nope", "--count", "2",
                 "--key", "mpc.key", "--threshold", "0.3"]) == 1
    assert main(["generate", "db3.json", "4", "--seed", "43"]) == 0
    assert main(["prepare", "db3.json", "3", "mpc3", "--insecure-seed", "7",
                 "--save-key", "mpc3.key"]) == 0
    assert main(["enroll", "db.json", "mpc3", "--count", "2",
                 "--key", "mpc3.key", "--threshold", "0.3"]) == 1
    assert main(["enroll", "db.json", "mpc", "--count", "2",
                 "--key", "nope.key", "--threshold", "0.3"]) == 1
    assert main(["enroll", "db.json", "mpc", "--count", "2",
                 "--key", "mpc.key", "--threshold", "0.3"]) == 1


# ------------------------------------------------------------------ refresh (test_refresh.py)


class TestShareEngineRefresh:
    def test_grow_partial_tail_chunk(self, rng):
        full = _shares(rng, 13)
        qp, qm = _queries(rng)
        eng = ShareEngine(full[:6], chunk=4, device=CPU)
        added = eng.refresh(full)
        assert added == 7 and eng.count == 13
        fresh = ShareEngine(full, chunk=4, device=CPU)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_grow_aligned(self, rng):
        full = _shares(rng, 12)
        qp, qm = _queries(rng)
        eng = ShareEngine(full[:8], chunk=4, device=CPU)
        assert eng.refresh(full) == 4
        fresh = ShareEngine(full, chunk=4, device=CPU)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_grow_past_residency_budget(self, rng):
        full = _shares(rng, 14)
        qp, qm = _queries(rng)
        budget = 2 * BITS * 4 * 2  # exactly 2 resident chunks of 4 rows
        eng = ShareEngine(full[:8], chunk=4, hbm_budget=budget, device=CPU)
        assert eng._n_resident == 2
        eng.refresh(full)
        assert eng._n_resident == 2
        assert eng.num_chunks() == 4
        fresh = ShareEngine(full, chunk=4, hbm_budget=budget, device=CPU)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_noop_and_shrink(self, rng):
        full = _shares(rng, 8)
        eng = ShareEngine(full, chunk=4, device=CPU)
        assert eng.refresh(full) == 0
        with pytest.raises(ValueError, match="append-only"):
            eng.refresh(full[:4])

    def test_refresh_mid_stream_serves_engine_state_at_start(self, rng):
        full = _shares(rng, 24)
        qp, qm = _queries(rng)
        eng = ShareEngine(full[:10], chunk=2, device=CPU)
        gen = eng.stream(qp, qm)
        parts = [next(gen)]
        assert eng.refresh(full) == 14
        parts.extend(gen)
        got = np.concatenate(parts, axis=1)
        np.testing.assert_array_equal(got, ShareEngine(full[:10], chunk=2,
                                                       device=CPU).dots(qp, qm))
        grown = np.concatenate(list(eng.stream(qp, qm)), axis=1)
        np.testing.assert_array_equal(grown, ShareEngine(full, chunk=2,
                                                         device=CPU).dots(qp, qm))

    def test_memmap_file_growth(self, rng, tmp_path):
        full = _shares(rng, 10)
        path = tmp_path / "mpc.share-0"
        write_share(path, full[:6])
        eng = ShareEngine(open_share(path), chunk=4, device=CPU)
        write_share(path, full[6:])
        assert eng.refresh(open_share(path)) == 4
        qp, qm = _queries(rng)
        np.testing.assert_array_equal(eng.dots(qp, qm),
                                      ShareEngine(full, chunk=4, device=CPU).dots(qp, qm))


class TestWatcherTornRecords:
    def test_share_watcher_ignores_partial_trailing_record(self, rng, tmp_path):
        full = _shares(rng, 9)
        path = tmp_path / "mpc.share-0"
        write_share(path, full[:7])
        eng = ShareEngine(open_share(path), chunk=4, device=CPU)
        watch = make_share_watcher(str(path), eng)

        tail = np.ascontiguousarray(full[7:]).astype("<u2").tobytes()
        with open(path, "ab") as f:
            f.write(tail[:1000])
        assert watch() == 0 and eng.count == 7
        with open(path, "ab") as f:
            f.write(tail[1000:])
        assert watch() == 2 and eng.count == 9
        path.rename(tmp_path / "moved-away")
        assert watch() == 0 and eng.count == 9
        (tmp_path / "moved-away").rename(path)
        qp, qm = _queries(rng)
        np.testing.assert_array_equal(
            eng.dots(qp, qm), ShareEngine(full, chunk=4, device=CPU).dots(qp, qm))

    def test_masks_watcher_ignores_partial_trailing_record(self, rng, tmp_path):
        masks = rng.integers(0, 256, (6, BITS_BYTES), dtype=np.uint8)
        path = tmp_path / "mpc.masks"
        write_masks(path, masks[:4])
        eng = MasksEngine(open_masks(path), chunk=4, device=CPU)
        watch = make_masks_watcher(str(path), eng)
        with open(path, "ab") as f:
            f.write(masks[4:].tobytes()[:700])
        assert watch() == 0 and eng.count == 4
        with open(path, "ab") as f:
            f.write(masks[4:].tobytes()[700:])
        assert watch() == 2 and eng.count == 6


class TestKeyedRefresh:
    def test_grow_count(self, rng):
        key = native.derive_insecure_key(7)
        qp, qm = _queries(rng)
        eng = KeyedShareEngine(key, 0, count=9, chunk=4, device=CPU)
        assert eng.refresh(17) == 8
        fresh = KeyedShareEngine(key, 0, count=17, chunk=4, device=CPU)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))
        with pytest.raises(ValueError, match="append-only"):
            eng.refresh(3)

    def test_grow_extends_resident_head(self, rng):
        key = native.derive_insecure_key(8)
        qp, qm = _queries(rng)
        budget = 2 * BITS * 4 * 3
        eng = KeyedShareEngine(key, 1, count=6, chunk=4, hbm_budget=budget, device=CPU)
        assert eng._n_resident == 2
        eng.refresh(20)
        assert eng._n_resident == 3
        fresh = KeyedShareEngine(key, 1, count=20, chunk=4, hbm_budget=budget, device=CPU)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))


class TestKeyedCountWatcher:
    def test_grow_torn_and_shrink(self, rng, tmp_path):
        key = native.derive_insecure_key(5)
        eng = KeyedShareEngine(key, 0, count=6, chunk=4, device=CPU)
        cf = tmp_path / "mpc.count"
        watch = make_keyed_count_watcher(str(cf), eng)
        assert watch() == 0
        cf.write_text("")
        assert watch() == 0
        cf.write_text("not-a-number")
        assert watch() == 0
        cf.write_text("13\n")
        assert watch() == 7 and eng.count == 13
        qp, qm = _queries(rng)
        fresh = KeyedShareEngine(key, 0, count=13, chunk=4, device=CPU)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))
        cf.write_text("4\n")
        assert watch() == 0 and eng.count == 13

    def test_masks_follower(self, rng):
        key = native.derive_insecure_key(6)
        eng = KeyedShareEngine(key, 0, count=5, chunk=4, device=CPU)
        masks = rng.integers(0, 256, (9, BITS_BYTES), dtype=np.uint8)
        me = MasksEngine(masks[:5], chunk=4, device=CPU)
        follow = make_keyed_masks_follower(eng, me)
        assert follow() == 0
        me.refresh(masks)
        assert follow() == 4 and eng.count == 9


class TestMasksRefresh:
    @pytest.mark.parametrize("storage", ["dense", "packed"])
    def test_grow(self, rng, storage):
        masks = rng.integers(0, 256, (11, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
        eng = MasksEngine(masks[:5], chunk=4, storage=storage, device=CPU)
        assert eng.refresh(masks) == 6
        fresh = MasksEngine(masks, chunk=4, storage=storage, device=CPU)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))
        with pytest.raises(ValueError, match="append-only"):
            eng.refresh(masks[:2])

    @pytest.mark.parametrize("storage", ["dense", "packed"])
    def test_refresh_cost_is_o_added(self, rng, storage):
        masks = rng.integers(0, 256, (72, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
        eng = MasksEngine(masks[:64], chunk=4, storage=storage, device=CPU)
        kept = list(eng._blocks)
        put, orig = [], eng._put_chunk
        eng._put_chunk = lambda c: (put.append(c), orig(c))[1]
        assert eng.refresh(masks) == 8
        assert put == [16, 17]
        assert all(a is b for a, b in zip(eng._blocks, kept))

        eng2 = MasksEngine(masks[:62], chunk=4, storage=storage, device=CPU)
        put2, orig2 = [], eng2._put_chunk
        eng2._put_chunk = lambda c: (put2.append(c), orig2(c))[1]
        assert eng2.refresh(masks) == 10
        assert put2 == [15, 16, 17]

        fresh = MasksEngine(masks, chunk=4, storage=storage, device=CPU)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))
        np.testing.assert_array_equal(eng2.dots(qm), fresh.dots(qm))


class TestShardedRefresh:
    def test_sharded_share(self, rng):
        full = _shares(rng, 26)
        qp, qm = _queries(rng)
        eng = ShardedShareEngine(full[:10], _mesh4(), chunk=2)
        assert eng.refresh(full) == 16
        fresh = ShardedShareEngine(full, _mesh4(), chunk=2)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_sharded_keyed(self, rng):
        key = native.derive_insecure_key(9)
        qp, qm = _queries(rng)
        eng = ShardedKeyedShareEngine(key, 0, 9, _mesh4(), chunk=2)
        assert eng.refresh(21) == 12
        fresh = ShardedKeyedShareEngine(key, 0, 21, _mesh4(), chunk=2)
        np.testing.assert_array_equal(eng.dots(qp, qm), fresh.dots(qp, qm))

    def test_sharded_masks(self, rng):
        masks = rng.integers(0, 256, (19, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
        eng = ShardedMasksEngine(masks[:7], _mesh4(), chunk=2)
        assert eng.refresh(masks) == 12
        fresh = ShardedMasksEngine(masks, _mesh4(), chunk=2)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))

    def test_sharded_masks_refresh_cost_is_o_added(self, rng):
        masks = rng.integers(0, 256, (40, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (2, BITS_BYTES), dtype=np.uint8)
        eng = ShardedMasksEngine(masks[:24], _mesh4(), chunk=2)
        kept = list(eng._blocks)
        loads, orig = [], eng._load_block
        eng._load_block = lambda j, src, n: (loads.append(j), orig(j, src, n))[1]
        assert eng.refresh(masks) == 16
        assert loads == [3, 4]
        assert all(a is b for a, b in zip(eng._blocks, kept))
        fresh = ShardedMasksEngine(masks, _mesh4(), chunk=2)
        np.testing.assert_array_equal(eng.dots(qm), fresh.dots(qm))


async def _ask(port, query):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(query.to_bytes())
    await writer.drain()
    recs, _eof = await read_records(reader, 1000)
    writer.close()
    await writer.wait_closed()
    return recs


class TestParticipantWatch:
    def test_server_syncs_appended_rows_between_queries(self, rng, tmp_path):
        full = _shares(rng, 11)
        path = tmp_path / "mpc.share-0"
        write_share(path, full[:7])
        eng = ShareEngine(open_share(path), chunk=4, device=CPU)
        query = Template.random(np.random.default_rng(3))

        async def go():
            server = ParticipantServer(eng, "127.0.0.1", 0,
                                       refresh=make_share_watcher(str(path), eng))
            _, port = await server.start()
            try:
                first = await _ask(port, query)
                write_share(path, full[7:])
                second = await _ask(port, query)
            finally:
                await server.close()
            return first, second

        first, second = asyncio.run(go())
        assert first.shape[0] == 7 and second.shape[0] == 11
        fresh = ShareEngine(full, chunk=4, device=CPU)
        np.testing.assert_array_equal(
            second, fresh.dots(query.pattern.data[None], query.mask.data[None])[0])


class TestKeyedParticipantWatch:
    def test_keyed_server_follows_count_file(self, rng, tmp_path):
        key = native.derive_insecure_key(11)
        eng = KeyedShareEngine(key, 0, count=7, chunk=4, device=CPU)
        cf = tmp_path / "mpc.count"
        cf.write_text("7\n")
        query = Template.random(np.random.default_rng(4))

        async def go():
            server = ParticipantServer(eng, "127.0.0.1", 0,
                                       refresh=make_keyed_count_watcher(str(cf), eng))
            _, port = await server.start()
            try:
                first = await _ask(port, query)
                cf.write_text("11\n")
                second = await _ask(port, query)
            finally:
                await server.close()
            return first, second

        first, second = asyncio.run(go())
        assert first.shape[0] == 7 and second.shape[0] == 11
        fresh = KeyedShareEngine(key, 0, count=11, chunk=4, device=CPU)
        np.testing.assert_array_equal(
            second, fresh.dots(query.pattern.data[None], query.mask.data[None])[0])
        np.testing.assert_array_equal(second[:7], first)


class TestCoordinatorWatch:
    def test_full_protocol_finds_winner_appended_between_rounds(self, rng, tmp_path):
        db = [Template.random(rng) for _ in range(19)]
        query = Template.random(rng)
        db[14] = query.rotated(-4)  # planted winner lives in the APPENDED rows
        head = 11
        pats = np.stack([t.pattern.data for t in db])
        masks = np.stack([t.mask.data for t in db])
        enc = native.encode_u16_native(pats, masks)
        mats = [np.zeros((19, BITS), dtype=np.uint16) for _ in range(2)]
        for i in range(19):
            for p, s in enumerate(EncodedBits(enc[i]).share(2, rng)):
                mats[p][i] = s.data
        mpath = tmp_path / "mpc.masks"
        spaths = [tmp_path / f"mpc.share-{p}" for p in range(2)]
        write_masks(mpath, masks[:head])
        for p in range(2):
            write_share(spaths[p], mats[p][:head])

        masks_engine = MasksEngine(open_masks(mpath), chunk=4, device=CPU)
        engines = [ShareEngine(open_share(sp), chunk=4, device=CPU) for sp in spaths]
        watch_masks = make_masks_watcher(str(mpath), masks_engine)

        async def go():
            servers = [ParticipantServer(eng, "127.0.0.1", 0,
                                         refresh=make_share_watcher(str(sp), eng))
                       for eng, sp in zip(engines, spaths)]
            addrs = [await s.start() for s in servers]
            coord = Coordinator(masks_engine, addrs, batch_records=5, device=CPU)
            try:
                first = await coord.query(query)
                write_masks(mpath, masks[head:])
                for p in range(2):
                    write_share(spaths[p], mats[p][head:])
                await asyncio.to_thread(watch_masks)
                second = await coord.query(query)
            finally:
                for s in servers:
                    await s.close()
            return first, second

        first, second = asyncio.run(go())
        oracle_head = np.array([query.distance(t) for t in db[:head]])
        assert first.total == head
        assert (first.index, first.distance) == (int(np.argmin(oracle_head)), oracle_head.min())
        assert second.total == 19
        assert (second.index, second.distance) == (14, 0.0)
