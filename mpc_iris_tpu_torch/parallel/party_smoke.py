"""Multi-process party check (counterpart of ``scripts/multihost_smoke.py``):
the ranks of one party form one ``torch.distributed`` process group and serve
the sharded match and share dots with process-local loading.

:func:`run_party` starts the ranks on localhost (each runs this module with
its settings as one JSON argument) and returns rank 0's result. Each rank
puts ``shards_per_rank`` devices into a mesh of ``mesh_batch`` columns (so
four one-card ranks with ``mesh_batch=2`` form a (2, 2) mesh whose "db" rows
span two ranks each) and poisons every DB row outside its own
``multihost.local_entry_spans``, so an engine that read another rank's row
would return wrong winners or dots. Rank 0 reports the
``ShardedPlaintextEngine.match`` winners of the queries
``smoke_data.query_rows`` picks (self-matches of DB rows); the sha256 of a
``min_fractions`` spectrum of the first ``mesh_batch`` queries, of the
``find_under`` lists at ``threshold`` (:func:`under_digest`) and of the
``ShardedShareEngine.dots`` bytes; and a ``ShardedKeyedShareEngine`` fold-pass checksum over ``n`` rows
of share stream 0 under :data:`KEY` (``n`` a multiple of the shards times
the chunk). A caller holds them against the single-card engines on the
clean data of ``smoke_data.make_data``.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from mpc_iris_tpu_torch.parallel import multihost
from mpc_iris_tpu_torch.parallel.mesh import make_mesh
from mpc_iris_tpu_torch.parallel.sharded import (
    ShardedKeyedShareEngine,
    ShardedPlaintextEngine,
    ShardedShareEngine,
)
from mpc_iris_tpu_torch.smoke_data import make_data, query_rows

KEY = bytes(range(32))  # the keyed party's share key


def dots_digest(dots: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(dots, dtype=np.uint16).tobytes()).hexdigest()


def under_digest(lists) -> str:
    """sha256 of ``find_under`` lists as (index, numerator, denominator)."""
    return hashlib.sha256(json.dumps([[[m.index, m.numerator, m.denominator] for m in row]
                                      for row in lists]).encode()).hexdigest()


def _device_of(rank: int, backend: str, device: str) -> torch.device:
    """NCCL ranks each take their own card; gloo ranks share ``device``."""
    return torch.device("cuda", rank) if backend == "nccl" else torch.device(device)


def _poison(src: np.ndarray, chunk: int, mesh, value) -> None:
    """Overwrite, in place, every row outside this rank's spans."""
    local = np.zeros(src.shape[0], dtype=bool)
    for s, e in multihost.local_entry_spans(src.shape[0], chunk, mesh):
        local[s:e] = True
    src[~local] = value


def worker(args) -> None:
    """One rank: ``args`` holds run_party's settings and this rank's
    ``rank`` and rendezvous ``port``."""
    dev = _device_of(args.rank, args.backend, args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.procs))
    multihost.init_party(f"127.0.0.1:{args.port}", args.procs, args.rank, args.backend)
    try:
        info = multihost.party_info()
        if info["process_count"] != args.procs:
            raise RuntimeError(f"party_info: {info}")
        mesh = make_mesh(db=args.procs * args.shards_per_rank // args.mesh_batch,
                         batch=args.mesh_batch, devices=[
            (r, _device_of(r, args.backend, args.device))
            for r in range(args.procs) for _ in range(args.shards_per_rank)])
        pat, msk, share = make_data(args.seed, args.n, args.n_share)
        q = query_rows(args.n, args.batch)
        qpat, qmsk = pat[q].copy(), msk[q].copy()
        _poison(pat, args.chunk, mesh, 0xEE)
        _poison(msk, args.chunk, mesh, 0xEE)
        _poison(share, args.chunk, mesh, 0xBEEF)
        eng = ShardedPlaintextEngine(pat, msk, mesh, chunk=args.chunk)
        results = eng.match(qpat, qmsk)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.match(qpat, qmsk)
            times.append((time.perf_counter() - t0) * 1e3)
        nb = args.mesh_batch  # the smallest batch the mesh's columns divide
        spectrum = eng.min_fractions(qpat[:nb], qmsk[:nb])
        under = eng.find_under(qpat, qmsk, args.threshold)
        del eng
        dots = ShardedShareEngine(share, mesh, chunk=args.chunk).dots(qpat, qmsk)
        keyed = ShardedKeyedShareEngine(KEY, 0, args.n, mesh, chunk=args.chunk)
        checksum = keyed.fold_pass_fn()(keyed._queries(qpat, qmsk)[0])
        if args.rank == 0:
            print(json.dumps({
                "backend": dist.get_backend(), "procs": args.procs,
                "shards": mesh.shape["db"], "mesh": list(mesh.devices.shape), "devices": [str(d) for d in mesh.devices.flat],
                "local_rows": int(sum(e - s for s, e in multihost.local_entry_spans(
                    args.n, args.chunk, mesh))),
                "winners": [[r.index, r.numerator, r.denominator] for r in results],
                "dots_sha256": dots_digest(dots), "spectrum_sha256": dots_digest(spectrum),
                "under_sha256": under_digest(under), "under_hits": sum(map(len, under)),
                "keyed_checksum": int(checksum), "match_ms": float(np.median(times))}))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_party(procs: int = 2, backend: str = "gloo", device: str = "cpu", n: int = 64,
              n_share: int = 64, chunk: int = 8, batch: int = 2, seed: int = 7,
              shards_per_rank: int = 2, mesh_batch: int = 1, threshold: float = 0.375,
              timeout: float = 120.0) -> dict:
    """Start ``procs`` rank processes on localhost and return rank 0's JSON.
    Raises with the ranks' errors if any rank fails; kills every rank on
    the timeout."""
    settings = dict(procs=procs, port=_free_port(), backend=backend, device=device, n=n,
                    n_share=n_share, chunk=chunk, batch=batch, seed=seed,
                    shards_per_rank=shards_per_rank, mesh_batch=mesh_batch,
                    threshold=threshold)
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    ranks = [subprocess.Popen([sys.executable, "-m", "mpc_iris_tpu_torch.parallel.party_smoke",
                               json.dumps({**settings, "rank": r})],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(procs)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in ranks:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exit {p.returncode}:\n{err[-3000:]}"
              for r, (p, (_, err)) in enumerate(zip(ranks, outs)) if p.returncode]
    if failed:
        raise RuntimeError("party_smoke failed:\n" + "\n".join(failed))
    return json.loads(outs[0][0].strip().splitlines()[-1])


if __name__ == "__main__":  # one rank, started by run_party
    worker(SimpleNamespace(**json.loads(sys.argv[1])))
