"""``ShardedPlaintextEngine.match``: the winner of each query over a DB
sharded over the cards of the configuration's ``mesh`` ([db, batch]), the
cell's cards in order (on the CPU, every shard on the one device). The
inputs, the control and the judge are those of ``match``: the same seeded DB
and pool, the plain reference over the whole DB."""

from __future__ import annotations

import torch
from mpc_iris_tpu_torch.parallel import ShardedPlaintextEngine, make_mesh

from benchmark import harness
from benchmark import plaintext_db as db
from benchmark.entries import match

prepare = db.prepare
control = match.control
judge = match.judge


def build(config: dict, traffic: dict, inputs: db.Inputs, device):
    rows, cols = (int(x) for x in config["mesh"])
    cards = harness.cards(device, rows * cols)
    devices = cards if len(cards) == rows * cols else cards[:1] * (rows * cols)
    # The peak the run reports is the engine's and its requests': the
    # inputs are made a whole plane at a time on the first card, more than
    # the deployment holds there.
    for card in cards:
        if card.type == "cuda":
            torch.cuda.reset_peak_memory_stats(card)
    chunk = {"chunk": int(config["chunk"])} if "chunk" in config else {}
    engine = ShardedPlaintextEngine(inputs.db_pat, inputs.db_msk,
                                    make_mesh(rows, cols, devices=devices),
                                    storage=config["storage"], **chunk)
    return lambda i: engine.match(*inputs.pool.request(i))
