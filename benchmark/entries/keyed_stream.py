"""``KeyedShareEngine.stream(..., entry_major=True)``: a keyed MPC party's
reply to a batch of queries. The request ends when the port has handed the
host its last block (pinned host memory, 31 u16 an entry and query); the
caller takes the checked entries' rows out of each block before the next.

A participant would also write the 496 MB into its socket. That host copy is
left out of the request: alone it takes 62-90 ms a reply, varying by as much
between processes (host memory bandwidth on a shared host), where the port's
stream takes 34 ms within 2%; with it in, no bound could hold the cell.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from mpc_iris_tpu_torch.models import KeyedShareEngine

from benchmark import data
from benchmark.reference import keyed_share as ref


@dataclass
class Inputs:
    key: bytes
    pool: data.Pool
    rows: np.ndarray  # the entries whose replies are checked, ascending


def prepare(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """The key and the queries from the seed, and the checked entries: the
    first and the last, and ``check_rows`` drawn from the seed in every
    ``check_stride`` entries, so that a chunk of the engine left out shows."""
    rng = np.random.default_rng(data.sub_seed(seed, "check"))
    n, stride = int(config["entries"]), int(traffic["check_stride"])
    rows = {0, n - 1}
    for start in range(0, n, stride):
        end = min(n, start + stride)
        rows.update(rng.choice(np.arange(start, end), min(end - start, int(traffic["check_rows"])),
                               replace=False).tolist())
    return Inputs(data.share_key(seed), data.make_pool(traffic, seed, None),
                  np.array(sorted(rows), dtype=np.int64))


def build(config: dict, traffic: dict, inputs: Inputs, device):
    n, b = int(config["entries"]), int(traffic["batch"])
    chunk = {"chunk": int(config["chunk"])} if "chunk" in config else {}
    engine = KeyedShareEngine(inputs.key, int(config["share_stream"]), n, device=device, **chunk)
    rows = inputs.rows

    def serve(i):
        pos = 0
        got = np.empty((len(rows), b, 31), dtype=np.uint16)
        for block in engine.stream(*inputs.pool.request(i), entry_major=True):
            lo, hi = np.searchsorted(rows, [pos, pos + block.shape[0]])
            got[lo:hi] = block[rows[lo:hi] - pos]
            pos += block.shape[0]
        return pos, got

    return serve


def control(config: dict, traffic: dict, inputs: Inputs, device):
    """The reference in the program's place, with the share rows held at 8
    bits, the integer precision below the configuration's 16 (see the
    reference's docstring). It answers the checked entries only, the ones
    the judge reads."""
    answers = {}
    share = ref.quantized(ref.share_rows(inputs.key, int(config["share_stream"]), inputs.rows), 8)

    def serve(i):
        p = i % len(inputs.pool)
        if p not in answers:
            answers[p] = ref.reply(share, inputs.pool.pat[p], inputs.pool.msk[p], device)
        return int(config["entries"]), answers[p]

    return serve


def judge(config: dict, traffic: dict, inputs: Inputs, answers: dict, unanswered: int,
          seed: int, device) -> dict:
    """Every answered request's reply at the checked entries against the
    reference's, value for value; the limits are 0, since the configuration
    states the exact u16 dot shares."""
    n = int(config["entries"])
    share = ref.share_rows(inputs.key, int(config["share_stream"]), inputs.rows)
    want = {}
    missing = wrong = 0
    for i, (rows, got) in sorted(answers.items()):
        p = i % len(inputs.pool)
        if p not in want:
            want[p] = ref.reply(share, inputs.pool.pat[p], inputs.pool.msk[p], device)
        missing += abs(n - rows)
        wrong += int((np.asarray(got) != want[p]).sum()) if np.shape(got) == want[p].shape \
            else want[p].size
    return {"unanswered": {"value": unanswered, "limit": 0},
            "missing_rows": {"value": missing, "limit": 0},
            "wrong_values": {"value": wrong, "limit": 0}}
