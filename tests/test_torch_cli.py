"""The port's CLI (mpc_iris_tpu_torch.cli) on the CPU: every case of
test_cli.py run through ``main([..., "--device", "cpu"])`` with the JAX
test's assertions, and a parity subset that runs both CLIs on the same seeds
and compares them: generate / prepare / rerandomize / rekey files
byte-equal, match winner lines and --all-under lists equal (also on four
CPU shards against the JAX CLI's 8 virtual devices), store-check verdicts
equal, and a store prepared by either CLI decrypts and serves under the
other."""

import asyncio
import contextlib
import io
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from mpc_iris_tpu.cli import main as ref_main
from mpc_iris_tpu_torch import native
from mpc_iris_tpu_torch.cli import main as port_main
from mpc_iris_tpu_torch.io.formats import open_masks, open_share

CPU = torch.device("cpu")


def main(argv):
    """The port's CLI on the CPU."""
    return port_main([*argv, "--device", "cpu"])


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _planes(path):
    pats, msks = [], []
    with open(path, "rb") as f:
        for p, m in native.parse_templates_stream(f):
            pats.append(p)
            msks.append(m)
    return np.concatenate(pats), np.concatenate(msks)


def _result_lines(out: str) -> list[str]:
    return [l for l in out.splitlines()
            if l.startswith("query ") or l.lstrip().startswith("entry ")]


def test_generate_prepare_decrypt_roundtrip(workdir):
    assert main(["generate", "db.json", "24", "--seed", "3"]) == 0
    objs = json.loads((workdir / "db.json").read_bytes())
    assert len(objs) == 24 and set(objs[0]) == {"pattern", "mask"}

    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "9"]) == 0
    masks = open_masks("mpc.masks")
    assert masks.shape == (24, 1600)
    s0, s1 = open_share("mpc.share-0"), open_share("mpc.share-1")
    assert s0.shape == s1.shape == (24, 12800)

    pats, msks_in = _planes("db.json")
    assert np.array_equal(np.asarray(masks), msks_in)
    enc = native.encode_u16_native(pats, msks_in)
    total = (np.asarray(s0, np.uint16) + np.asarray(s1, np.uint16)).astype(np.uint16)
    assert np.array_equal(total, enc)

    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "--output", "dec.json"]) == 0
    dp, dm = _planes("dec.json")
    assert np.array_equal(dm, msks_in)
    assert np.array_equal(dp & dm, pats & msks_in)
    assert not np.any(dp & ~dm)


def test_generate_refuses_overwrite(workdir):
    assert main(["generate", "db.json", "4"]) == 0
    assert main(["generate", "db.json", "4"]) == 1
    assert main(["generate", "db.json", "4", "--replace"]) == 0


def test_match_smoke(workdir, capsys):
    assert main(["generate", "db.json", "40", "--seed", "11"]) == 0
    assert main(["match", "db.json", "--batch", "4", "--seed", "2"]) == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("query ")]
    assert len(lines) == 4
    assert all("at distance 0.0" in l for l in lines)


def test_match_all_under_lists_duplicates(workdir, capsys):
    assert main(["generate", "db.json", "40", "--seed", "11"]) == 0
    assert main(["match", "db.json", "--batch", "4", "--seed", "2",
                 "--all-under", "1e-6"]) == 0
    out = capsys.readouterr().out
    heads = [l for l in out.splitlines() if l.startswith("query ")]
    hits = [l for l in out.splitlines() if l.lstrip().startswith("entry ")]
    assert len(heads) == 4
    assert len(hits) >= 4
    assert all("at distance 0.0" in l for l in hits)
    assert main(["match", "db.json", "--batch", "4", "--seed", "2",
                 "--all-under", "0.0"]) == 0
    out = capsys.readouterr().out
    assert all(" 0 entries under " in l
               for l in out.splitlines() if l.startswith("query "))


def test_coordinator_queries_file_all_under(workdir, capsys):
    assert main(["generate", "db.json", "12", "--seed", "31"]) == 0
    assert main(["prepare", "db.json", "1", "mpc", "--insecure-seed", "8"]) == 0
    assert main(["coordinator", "--masks", "mpc.masks", "--share",
                 "mpc.share-0", "--queries-file", "db.json", "--queries", "3",
                 "--all-under", "1e-9", "--no-warmup"]) == 0
    out = capsys.readouterr().out
    heads = [l for l in out.splitlines() if l.startswith("query ")]
    hits = [l for l in out.splitlines() if l.lstrip().startswith("entry ")]
    assert len(heads) == 3
    assert [f"entry {i} at distance 0.0" in h for i, h in enumerate(hits)] \
        == [True, True, True]
    assert main(["coordinator", "--masks", "mpc.masks", "--share",
                 "mpc.share-0", "--queries-file", "db.json", "--queries", "2",
                 "--no-warmup"]) == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("query ")]
    assert len(lines) == 2
    assert all("at distance 0.0" in l for l in lines)
    for i, l in enumerate(lines):
        assert f"closest entry {i} " in l


def test_match_distances_out(workdir, capsys):
    assert main(["generate", "db.json", "24", "--seed", "13"]) == 0
    assert main(["match", "db.json", "--batch", "3", "--seed", "5",
                 "--distances-out", "d.npy"]) == 0
    dist = np.load(workdir / "d.npy")
    assert dist.shape == (3, 24) and dist.dtype == np.float64
    assert (dist.min(axis=1) == 0.0).all()
    capsys.readouterr()
    assert main(["match", "db.json", "--batch", "3", "--seed", "5"]) == 0
    out = capsys.readouterr().out
    for b, line in enumerate(l for l in out.splitlines() if l.startswith("query ")):
        assert f"closest entry {int(dist[b].argmin())} " in line


def test_store_check(workdir, capsys):
    assert main(["generate", "db.json", "10", "--seed", "41"]) == 0
    assert main(["prepare", "db.json", "3", "mpc", "--insecure-seed", "6",
                 "--save-key", "mpc.key"]) == 0
    ok = ["store-check", "mpc", "--count", "3", "--key", "mpc.key", "--deep"]
    assert main(ok) == 0

    with open(workdir / "mpc.share-1", "r+b") as f:
        f.seek(0)
        f.write(b"\xff" * 16)
    assert main(ok) == 1
    assert "PROBLEM" in capsys.readouterr().err
    for p in workdir.glob("mpc.*"):
        p.unlink()
    assert main(["prepare", "db.json", "3", "mpc", "--insecure-seed", "6",
                 "--save-key", "mpc.key"]) == 0

    assert main(["rerandomize", "mpc.share-0", "--index", "0",
                 "--pair", "1:777"]) == 0
    assert main(["rerandomize", "mpc.share-1", "--index", "1",
                 "--pair", "0:777"]) == 0
    assert main(["store-check", "mpc", "--deep"]) == 0
    assert main(["store-check", "mpc", "--key", "mpc.key"]) == 1
    capsys.readouterr()

    with open(workdir / "mpc.masks", "ab") as f:
        f.write(b"\x00" * 7)
    assert main(["store-check", "mpc"]) == 0
    assert "warning" in capsys.readouterr().err
    assert main(["store-check", "mpc", "--strict"]) == 1

    (workdir / "mpc.count").write_text("99\n")
    assert main(["store-check", "mpc"]) == 1
    capsys.readouterr()

    (workdir / "mpc.count").write_text("not-a-number\n")
    assert main(["store-check", "mpc"]) == 1
    assert "unparseable" in capsys.readouterr().err
    (workdir / "mpc.count").unlink()
    (workdir / "mpc.share-backup").write_bytes(b"junk")
    assert main(["store-check", "mpc"]) == 1
    assert "unrecognized share filename" in capsys.readouterr().err


def test_coordinator_serve_flag_validation(workdir):
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--audit"]) == 1
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--serve", "--queries-file", "x.json"]) == 1
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--serve", "--all-under", "0.3"]) == 1
    assert main(["coordinator", "127.0.0.1:1", "--masks", "nope.masks",
                 "--strict-scan", "--watch"]) == 1


def test_rerandomize_cli_roundtrip(workdir):
    assert main(["generate", "db.json", "8", "--seed", "4"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "6"]) == 0
    before0 = (workdir / "mpc.share-0").read_bytes()
    before1 = (workdir / "mpc.share-1").read_bytes()
    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "--output", "before.json"]) == 0
    assert main(["rerandomize", "mpc.share-0", "--index", "0", "--pair", "1:777"]) == 0
    assert main(["rerandomize", "mpc.share-1", "--index", "1", "--pair", "0:777"]) == 0
    assert (workdir / "mpc.share-0").read_bytes() != before0
    assert (workdir / "mpc.share-1").read_bytes() != before1
    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "--output", "after.json"]) == 0
    assert (workdir / "before.json").read_bytes() == (workdir / "after.json").read_bytes()


def test_prepare_append_extends_store_byte_identically(workdir):
    assert main(["generate", "db.json", "10", "--seed", "21"]) == 0
    objs = json.loads((workdir / "db.json").read_bytes())
    (workdir / "head.json").write_text(json.dumps(objs[:6]))
    (workdir / "tail.json").write_text(json.dumps(objs[6:]))

    assert main(["prepare", "db.json", "2", "ref", "--insecure-seed", "5"]) == 0
    assert main(["prepare", "head.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    assert main(["prepare", "tail.json", "2", "mpc", "--key", "mpc.key", "--append"]) == 0
    for name in ["masks", "share-0", "share-1"]:
        assert (workdir / f"mpc.{name}").read_bytes() == \
            (workdir / f"ref.{name}").read_bytes(), name


def test_prepare_writes_count_sidecar(workdir):
    assert main(["generate", "db.json", "6", "--seed", "23"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    assert (workdir / "mpc.count").read_text().strip() == "6"
    assert main(["prepare", "db.json", "2", "mpc", "--key", "mpc.key", "--append"]) == 0
    assert (workdir / "mpc.count").read_text().strip() == "12"


def test_participant_watch_flag_validation(workdir):
    assert main(["generate", "db.json", "4", "--seed", "24"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    assert main(["participant", "keyed:0:4:mpc.key", "127.0.0.1:0",
                 "--watch", "--no-warmup"]) == 1
    assert main(["participant", "mpc.share-0", "127.0.0.1:0", "--watch",
                 "--watch-count", "mpc.count", "--no-warmup"]) == 1
    assert main(["participant", "mpc.share-0", "127.0.0.1:0",
                 "--watch-count", "mpc.count", "--no-warmup"]) == 1


def test_prepare_append_validation(workdir):
    assert main(["generate", "db.json", "4", "--seed", "22"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--append"]) == 1
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--save-key", "mpc.key"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "5",
                 "--key", "mpc.key", "--append"]) == 1
    with open(workdir / "mpc.masks", "ab") as f:
        f.write(b"x" * 100)
    assert main(["prepare", "db.json", "2", "mpc", "--key", "mpc.key", "--append"]) == 1
    with open(workdir / "mpc.masks", "ab") as f:
        f.write(b"x" * 1500)
    assert main(["prepare", "db.json", "2", "mpc", "--key", "mpc.key", "--append"]) == 1
    assert main(["prepare", "db.json", "3", "mpc3", "--insecure-seed", "5",
                 "--save-key", "mpc3.key"]) == 0
    assert main(["prepare", "db.json", "2", "mpc3", "--key", "mpc3.key", "--append"]) == 1
    assert main(["prepare", "db.json", "3", "mpc3", "--key", "nope.key", "--append"]) == 1


def test_rekey_epoch_rotation(workdir):
    assert main(["generate", "db.json", "9", "--seed", "51"]) == 0
    assert main(["prepare", "db.json", "3", "mpc", "--insecure-seed", "4",
                 "--save-key", "mpc.key"]) == 0
    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "mpc.share-2",
                 "--output", "before.json"]) == 0
    olds = {i: (workdir / f"mpc.share-{i}").read_bytes() for i in range(3)}

    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key",
                 "--new-key-out", "mpc.key2", "--insecure-new-seed", "5",
                 "--batch", "4"]) == 0
    for i in range(3):
        assert (workdir / f"mpc.share-{i}").read_bytes() != olds[i], i

    assert main(["decrypt", "mpc.share-0", "mpc.share-1", "mpc.share-2",
                 "--output", "after.json"]) == 0
    assert (workdir / "before.json").read_bytes() == (workdir / "after.json").read_bytes()
    assert main(["decrypt", "keyed:0:9:mpc.key2", "keyed:1:9:mpc.key2",
                 "mpc.share-2", "--output", "after2.json"]) == 0
    assert (workdir / "after2.json").read_bytes() == (workdir / "after.json").read_bytes()
    assert main(["decrypt", "keyed:0:9:mpc.key", "mpc.share-1", "mpc.share-2",
                 "--output", "stale.json"]) == 0
    assert (workdir / "stale.json").read_bytes() != (workdir / "after.json").read_bytes()

    os.remove(workdir / "mpc.share-0")
    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key2",
                 "--new-key-out", "mpc.key3", "--insecure-new-seed", "6",
                 "--batch", "4"]) == 0
    assert main(["decrypt", "keyed:0:9:mpc.key3", "mpc.share-1",
                 "mpc.share-2", "--output", "after3.json"]) == 0
    assert (workdir / "after3.json").read_bytes() == (workdir / "after.json").read_bytes()

    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key3",
                 "--new-key-out", "mpc.key2"]) == 1
    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key3",
                 "--new-key-out", "k4", "--insecure-new-seed", "6"]) == 1
    assert main(["rekey", "mpc", "--count", "2", "--old-key", "mpc.key3",
                 "--new-key-out", "k4", "--insecure-new-seed", "7"]) == 1
    assert main(["rekey", "mpc", "--count", "3", "--old-key", "mpc.key2",
                 "--new-key-out", "k4", "--insecure-new-seed", "7"]) == 1


def test_rekey_refuses_rerandomized_store(workdir):
    assert main(["generate", "db.json", "5", "--seed", "52"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "4",
                 "--save-key", "mpc.key"]) == 0
    assert main(["rerandomize", "mpc.share-0", "--index", "0", "--pair", "1:99"]) == 0
    assert main(["rerandomize", "mpc.share-1", "--index", "1", "--pair", "0:99"]) == 0
    assert main(["rekey", "mpc", "--count", "2", "--old-key", "mpc.key",
                 "--new-key-out", "k2", "--insecure-new-seed", "8"]) == 1
    assert not os.path.exists(workdir / "k2")


def test_share_engine_from_spec_dispatch(workdir):
    """A file path opens a ShareEngine, a keyed:<s>:<count>:<keyfile> spec a
    keyed engine with identical dot streams, a device list of several a
    sharded engine with the same; malformed specs raise ValueError."""
    from mpc_iris_tpu_torch.cli import _share_engine_from_spec
    from mpc_iris_tpu_torch.models import KeyedShareEngine, ShareEngine
    from mpc_iris_tpu_torch.parallel import ShardedKeyedShareEngine, ShardedShareEngine

    assert main(["generate", "db.json", "16", "--seed", "5"]) == 0
    assert main(["prepare", "db.json", "2", "mpc", "--insecure-seed", "8",
                 "--save-key", "mpc.key"]) == 0

    engines = [_share_engine_from_spec("mpc.share-0", 8, device="cpu"),
               _share_engine_from_spec(f"keyed:0:16:{workdir}/mpc.key", 8, device="cpu"),
               _share_engine_from_spec("mpc.share-0", 2, device="cpu,cpu"),
               _share_engine_from_spec(f"keyed:0:16:{workdir}/mpc.key", 2, device="cpu,cpu")]
    assert [type(e) for e in engines] == [ShareEngine, KeyedShareEngine,
                                          ShardedShareEngine, ShardedKeyedShareEngine]
    rng = np.random.default_rng(2)
    pat = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    msk = np.full((2, 1600), 255, np.uint8)
    want = engines[0].dots(pat, msk)
    for e in engines[1:]:
        np.testing.assert_array_equal(np.asarray(e.dots(pat, msk)), want)

    with pytest.raises(ValueError):
        _share_engine_from_spec("keyed:0:16:/nonexistent-key", 8, device="cpu")


def test_query_client_cli(workdir, capsys):
    """`query` client against a live QueryServer of the port (SPEC 5.2)."""
    from mpc_iris_tpu_torch.models import MasksEngine, ShareEngine
    from mpc_iris_tpu_torch.protocol import Coordinator, QueryServer

    assert main(["generate", "db.json", "12", "--seed", "31"]) == 0
    assert main(["prepare", "db.json", "1", "mpc", "--insecure-seed", "2"]) == 0
    masks = open_masks("mpc.masks")
    share = open_share("mpc.share-0")

    loop = asyncio.new_event_loop()
    ready = threading.Event()
    state = {}

    async def serve():
        coord = Coordinator(
            MasksEngine(np.asarray(masks), chunk=8, device=CPU), [],
            local_engine=ShareEngine(np.asarray(share), chunk=8, device=CPU), device=CPU,
        )
        server = QueryServer(coord, "127.0.0.1", 0)
        await server.start()
        state["server"] = server
        state["port"] = server.port
        ready.set()
        await server.serve_forever()

    def run_loop():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(serve())
        except (asyncio.CancelledError, RuntimeError):
            pass
        finally:
            pending = asyncio.all_tasks(loop)
            for task in pending:
                task.cancel()
            if pending:
                loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()
            asyncio.set_event_loop(None)

    t = threading.Thread(target=run_loop, daemon=True)
    t.start()
    assert ready.wait(timeout=60)
    try:
        for extra in ([], ["--one-shot"]):
            rc = main(["query", f"127.0.0.1:{state['port']}", "db.json",
                       "--count", "3", "--threshold", "0.5"] + extra)
            assert rc == 0
            out = capsys.readouterr().out
            lines = [l for l in out.splitlines() if l.startswith("query ")]
            assert len(lines) == 3
            for i, l in enumerate(lines):
                assert f"closest entry {i} of 12" in l
                assert "at distance 0.0" in l and "DUPLICATE" in l
    finally:
        fut = asyncio.run_coroutine_threadsafe(state["server"].close(), loop)
        try:
            fut.result(timeout=10)
        except Exception:
            pass
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass
        t.join(timeout=10)


def test_serving_observability_signals(tmp_path, capsys):
    """SIGUSR1 dumps a one-line JSON stats snapshot (device memory None on
    the CPU); SIGUSR2 toggles a torch.profiler trace into --profile-dir
    (fresh subdir per capture, exported when stopped); without a profile
    dir SIGUSR2 logs a hint."""
    from mpc_iris_tpu_torch.cli import _attach_observability

    prof = tmp_path / "prof"
    prof.mkdir()

    async def go():
        loop = asyncio.get_running_loop()
        cleanup = _attach_observability(
            loop, "participant", stats_fn=lambda: {"served": 3, "failed": 0},
            profile_dir=str(prof), device=CPU)
        os.kill(os.getpid(), signal.SIGUSR1)
        await asyncio.sleep(0.05)
        os.kill(os.getpid(), signal.SIGUSR2)
        await asyncio.sleep(0.05)
        torch.ones(64).cumsum(0)  # something for the trace
        os.kill(os.getpid(), signal.SIGUSR2)
        await asyncio.sleep(0.05)
        cleanup()

        cleanup2 = _attach_observability(loop, "query server", stats_fn=None,
                                         profile_dir=None)
        os.kill(os.getpid(), signal.SIGUSR2)
        await asyncio.sleep(0.05)
        cleanup2()

    asyncio.run(go())
    err = capsys.readouterr().err
    assert '"served": 3' in err and '"trace_active": false' in err
    assert '"hbm": {"bytes_in_use": null' in err
    assert "device trace STARTED" in err and "device trace stopped" in err
    assert "SIGUSR2 ignored" in err
    subdirs = list(prof.iterdir())
    assert len(subdirs) == 1 and (subdirs[0] / "trace.json").stat().st_size > 0
    json.loads((subdirs[0] / "trace.json").read_text())


def test_serving_observability_trace_closed_at_shutdown(tmp_path, capsys):
    from mpc_iris_tpu_torch.cli import _attach_observability

    prof = tmp_path / "prof"
    prof.mkdir()

    async def go():
        loop = asyncio.get_running_loop()
        cleanup = _attach_observability(loop, "participant", stats_fn=None,
                                        profile_dir=str(prof))
        os.kill(os.getpid(), signal.SIGUSR2)
        await asyncio.sleep(0.05)
        cleanup()

    asyncio.run(go())
    err = capsys.readouterr().err
    assert "device trace STARTED" in err
    assert "closed at shutdown" in err
    assert (next(prof.iterdir()) / "trace.json").exists()


def test_device_defaults_to_the_card(workdir):
    """Roles run on the card unless --device says otherwise: without one the
    default raises, and so does naming it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot be shown")
    assert main(["generate", "db.json", "4", "--seed", "1"]) == 0
    for argv in (["match", "db.json"], ["--device", "cuda:0", "match", "db.json"],
                 ["prepare", "db.json", "2", "mpc", "--backend", "device"]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            port_main(argv)
    assert not os.path.exists(workdir / "mpc.masks")
    # the top-level form, and the subcommand's taking precedence over it
    assert port_main(["--device", "cpu", "match", "db.json", "--batch", "1"]) == 0
    assert port_main(["--device", "cuda", "match", "db.json", "--batch", "1",
                      "--device", "cpu"]) == 0


# ------------------------------------------------------------------ parity with the JAX CLI


def _both(tmp_path, monkeypatch, argv_list):
    """Run the same commands through both CLIs in two directories."""
    for name, run in (("ref", ref_main), ("port", main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        for argv in argv_list:
            assert run(argv) == 0, (name, argv)
    monkeypatch.chdir(tmp_path)
    return tmp_path / "ref", tmp_path / "port"


def test_parity_files_byte_equal(tmp_path, monkeypatch):
    ref, port = _both(tmp_path, monkeypatch, [
        ["generate", "db.json", "11", "--seed", "61"],
        ["prepare", "db.json", "3", "mpc", "--insecure-seed", "3", "--save-key",
         "mpc.key", "--batch", "4"],
        ["prepare", "db.json", "3", "mpc", "--key", "mpc.key", "--append"],
        ["decrypt", "mpc.share-0", "mpc.share-1", "mpc.share-2", "--output", "dec.json"],
        ["rerandomize", "mpc.share-0", "--index", "0", "--pair", "2:0x1234",
         "--output", "rr.share-0"],
        ["rekey", "mpc", "--count", "3", "--old-key", "mpc.key", "--new-key-out",
         "new.key", "--insecure-new-seed", "8", "--batch", "5"],
    ])
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in port.iterdir())
    assert {"db.json", "mpc.masks", "mpc.share-2", "rr.share-0", "new.key"} <= set(names)
    for n in names:
        assert (ref / n).read_bytes() == (port / n).read_bytes(), n
    # the device backend (the port's share split on the CPU) writes the same bytes
    monkeypatch.chdir(port)
    assert main(["prepare", "db.json", "3", "dev", "--key", "new.key",
                 "--backend", "device", "--batch", "4"]) == 0
    assert main(["prepare", "db.json", "3", "host", "--key", "new.key", "--batch", "4"]) == 0
    for n in ("masks", "share-0", "share-1", "share-2", "count"):
        assert (port / f"dev.{n}").read_bytes() == (port / f"host.{n}").read_bytes(), n


@pytest.fixture(scope="module")
def match_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("match")
    assert port_main(["generate", str(d / "db.json"), "40", "--seed", "11"]) == 0
    return d / "db.json"


_REF_MATCH = {}


def _ref_match(db, args):
    key = tuple(args)
    if key not in _REF_MATCH:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert ref_main(["match", str(db), *args]) == 0
        _REF_MATCH[key] = _result_lines(out.getvalue())
    return _REF_MATCH[key]


@pytest.mark.parametrize("device", ["cpu", "cpu,cpu,cpu,cpu"])
@pytest.mark.parametrize("args", [
    ["--batch", "4", "--seed", "2"],
    ["--batch", "9", "--seed", "3", "--storage", "dense"],
    ["--batch", "4", "--seed", "2", "--all-under", "0.47"],
    ["--batch", "9", "--seed", "4", "--all-under", "0.47"],
])
def test_parity_match_equal_to_jax_cli(match_db, device, args):
    """Winner lines and audit lists equal the JAX CLI's (8 virtual devices)."""
    want = _ref_match(match_db, args)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(["match", str(match_db), *args, "--device", device]) == 0
    got = _result_lines(out.getvalue())
    assert got == want
    assert sum(l.startswith("query ") for l in got) == int(args[1])


def test_parity_store_check_verdicts(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["generate", "db.json", "6", "--seed", "71"]) == 0
    assert main(["prepare", "db.json", "3", "mpc", "--insecure-seed", "2",
                 "--save-key", "mpc.key"]) == 0
    checks = [["store-check", "mpc", "--count", "3", "--key", "mpc.key", "--deep"],
              ["store-check", "mpc", "--strict"]]

    def verdicts(run):
        out = []
        for argv in checks:
            rc = run(argv)
            err = capsys.readouterr().err
            out.append((rc, [l for l in err.splitlines()
                             if l.startswith(("PROBLEM", "store-check", "warning", "mpc."))]))
        return out

    capsys.readouterr()
    clean = verdicts(main)
    assert clean == verdicts(ref_main) and all(rc == 0 for rc, _ in clean)
    with open(tmp_path / "mpc.share-2", "r+b") as f:
        f.seek(5 * 25600)
        f.write(b"\x01\x02" * 8)
    with open(tmp_path / "mpc.masks", "ab") as f:
        f.write(b"\x00" * 3)
    broken = verdicts(main)
    assert broken == verdicts(ref_main) and all(rc == 1 for rc, _ in broken)


def test_parity_store_serves_under_either_cli(tmp_path, monkeypatch, capsys):
    """A store prepared by the JAX CLI decrypts and serves under the port's,
    and one prepared by the port's under the JAX CLI, with equal results."""
    monkeypatch.chdir(tmp_path)
    assert main(["generate", "db.json", "12", "--seed", "81"]) == 0
    assert ref_main(["prepare", "db.json", "2", "jx", "--insecure-seed", "5",
                     "--save-key", "jx.key"]) == 0
    assert main(["prepare", "db.json", "2", "pt", "--insecure-seed", "6",
                 "--save-key", "pt.key"]) == 0
    for base, key in (("jx", "jx.key"), ("pt", "pt.key")):
        assert ref_main(["decrypt", f"keyed:0:12:{key}", f"{base}.share-1",
                         "--output", f"{base}.ref.json"]) == 0
        assert main(["decrypt", f"keyed:0:12:{key}", f"{base}.share-1",
                     "--output", f"{base}.port.json"]) == 0
        assert (tmp_path / f"{base}.ref.json").read_bytes() == \
            (tmp_path / f"{base}.port.json").read_bytes()
    capsys.readouterr()

    # each decrypted store re-prepared as a one-share store by the other CLI
    assert main(["prepare", "jx.port.json", "1", "jx1", "--insecure-seed", "1"]) == 0
    assert ref_main(["prepare", "pt.ref.json", "1", "pt1", "--insecure-seed", "1"]) == 0
    outs = {}
    for name, run, base in (("port on jx", main, "jx1"), ("jax on pt", ref_main, "pt1"),
                            ("jax on jx", ref_main, "jx1"), ("port on pt", main, "pt1")):
        assert run(["coordinator", "--masks", f"{base}.masks", "--share",
                    f"{base}.share-0", "--queries-file", "db.json", "--queries", "3",
                    "--all-under", "0.47", "--no-warmup"]) == 0
        outs[name] = [l.split(" (")[0] for l in _result_lines(capsys.readouterr().out)]
    assert outs["port on jx"] == outs["jax on jx"] == outs["jax on pt"] == outs["port on pt"]
    assert len([l for l in outs["port on jx"] if l.startswith("query ")]) == 3
