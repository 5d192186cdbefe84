"""``PlaintextEngine.match``: the winner of each query over the DB."""

from __future__ import annotations

from benchmark import plaintext_db as db
from benchmark.reference import plaintext as ref

prepare = db.prepare


def build(config: dict, traffic: dict, inputs: db.Inputs, device):
    engine = db.engine(config, inputs, device)
    return lambda i: engine.match(*inputs.pool.request(i))


def _reference(inputs: db.Inputs, pat, msk, device, dtype):
    return [[w] for w in ref.match(inputs.db_pat, inputs.db_msk, pat, msk, device, dtype=dtype)]


def control(config: dict, traffic: dict, inputs: db.Inputs, device):
    return db.control(traffic, inputs, device, _reference, lambda hits: hits[0])


def judge(config: dict, traffic: dict, inputs: db.Inputs, answers: dict, unanswered: int,
          seed: int, device) -> dict:
    return db.judge(traffic, inputs, answers, unanswered, seed, device, _reference,
                    lambda result: [result])
