"""Participants in processes of their own, for the card check of the serving
path (``chip_smoke.py``) and its CPU rehearsal.

:func:`start_parties` starts one process per party (each runs this module
with its settings as one JSON argument). A process rebuilds its engine
deterministically: a keyed party (share stream 0 or 1) a ``KeyedShareEngine``
from the key and the DB size; the data party (the last share) a
``ShareEngine`` over the share ``share_split_device`` makes on its own
device from the DB of ``smoke_data.make_db``, so no share file crosses between
processes. It serves that engine on three ports, one ``ParticipantServer``
per wire mode, and prints them on one JSON line. Stopped by SIGTERM (to its
PID, :func:`stop_parties`), it closes its servers and prints its serving
stats and the ChaCha20 kernel's launches while it served on a last JSON
line.
"""

from __future__ import annotations

import asyncio
import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from mpc_iris_tpu_torch.smoke_data import db_rng, make_db

WIRES = ("reference", "batched", "chain")


def _engine(args):
    from mpc_iris_tpu_torch.models import KeyedShareEngine, ShareEngine
    from mpc_iris_tpu_torch.ops.encode import share_split_device

    dev = torch.device(args["device"])
    key = bytes.fromhex(args["key"])
    if args["stream"] < args["n_shares"] - 1:
        return KeyedShareEngine(key, args["stream"], args["n"], device=dev,
                                chunk=args["chunk"], hbm_budget=args["hbm_budget"])
    pat, msk = make_db(db_rng(args["seed"]), args["n"])[:2]
    share = share_split_device(pat, msk, args["n_shares"], key, device=dev,
                               shares=[args["stream"]])[0]
    del pat, msk
    return ShareEngine(share, device=dev, chunk=args["chunk"])


async def _serve(args) -> dict:
    from mpc_iris_tpu_torch.ops.chacha import share_planes_kernel
    from mpc_iris_tpu_torch.protocol.participant import ParticipantServer

    dev = torch.device(args["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    engine = _engine(args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    built_s = time.perf_counter() - t0
    stop = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
    servers = {w: ParticipantServer(engine, "127.0.0.1", 0, wire=w) for w in WIRES}
    ports = {w: (await s.start())[1] for w, s in servers.items()}
    share_planes_kernel.launches = 0  # count the serving only
    print(json.dumps({"ports": ports, "pid": os.getpid(), "built_s": built_s,
                      "resident": engine.resident_entries}), flush=True)
    await stop.wait()
    for s in servers.values():
        await s.close()
    return {"stats": {w: s.stats() for w, s in servers.items()},
            "share_planes_kernel": share_planes_kernel.launches}


def start_parties(n: int, seed: int, key: bytes, devices, *, chunk: int = 16384,
                  hbm_budget=None, timeout: float = 300.0) -> list:
    """Start one party a device: share stream s's on ``devices[s]``, of
    ``len(devices)`` shares (keyed below the last, ``hbm_budget`` theirs),
    and wait, up to ``timeout`` seconds in all, for each to print its
    ports. Returns one dict a party: ``proc`` (its Popen), ``ports`` (wire
    -> port), ``built_s``, ``resident``. On any failure every started
    process is killed and the error carries their stderr."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    parties = []
    deadline = time.monotonic() + timeout
    try:
        for s in range(len(devices)):
            settings = {"stream": s, "n_shares": len(devices), "n": n, "seed": seed,
                        "key": key.hex(), "device": str(devices[s]), "chunk": chunk,
                        "hbm_budget": hbm_budget}
            err = tempfile.TemporaryFile()
            proc = subprocess.Popen(
                [sys.executable, "-m", "mpc_iris_tpu_torch.protocol.party_proc",
                 json.dumps(settings)], stdout=subprocess.PIPE, stderr=err, env=env)
            parties.append({"proc": proc, "err": err, "stream": s})
        for p in parties:
            line = _read_line(p, deadline)
            p.update(json.loads(line))
    except BaseException:
        for p in parties:
            _kill(p["proc"])
            p["err"].close()
        raise
    return parties


def _read_line(party: dict, deadline: float) -> str:
    proc = party["proc"]
    while True:
        ready, _, _ = select.select([proc.stdout], [], [], max(0.0, deadline - time.monotonic()))
        if ready:
            line = proc.stdout.readline()
            if line:
                return line.decode()
        if not ready or proc.poll() is not None:
            raise RuntimeError(f"party {party['stream']} (pid {proc.pid}) did not start "
                               f"(exit {proc.poll()}):\n{_stderr(party)}")


def _stderr(party: dict) -> str:
    party["err"].seek(0)
    return party["err"].read().decode(errors="replace")[-4000:]


def _kill(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    if proc.stdout is not None:
        proc.stdout.close()


def stop_parties(parties: list, timeout: float = 60.0) -> list[dict]:
    """SIGTERM each party's process by its PID and wait, up to ``timeout``
    seconds in all, for its last JSON line; returns them in party order.
    Raises (after killing whatever still runs) with a party's stderr when it
    exits non-zero or prints no result."""
    for p in parties:
        if p["proc"].poll() is None:
            p["proc"].send_signal(signal.SIGTERM)
    deadline = time.monotonic() + timeout
    out, failed = [], []
    for p in parties:
        proc = p["proc"]
        try:
            rest = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            _kill(proc)
            rest = b""
        lines = rest.decode().strip().splitlines()
        if proc.returncode or not lines:
            failed.append(f"party {p['stream']} (pid {proc.pid}) exit {proc.returncode}:\n"
                          f"{_stderr(p)}")
        else:
            out.append(json.loads(lines[-1]))
        p["err"].close()
    for p in parties:
        _kill(p["proc"])
    if failed:
        raise RuntimeError("participant processes failed:\n" + "\n".join(failed))
    return out


if __name__ == "__main__":  # one party, started by start_parties
    print(json.dumps(asyncio.run(_serve(json.loads(sys.argv[1])))), flush=True)
