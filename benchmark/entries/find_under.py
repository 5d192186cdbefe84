"""``PlaintextEngine.find_under``: every entry under the traffic's threshold,
per query, with the engine's default ``limit``, and its default
``compact_k`` unless the traffic states one."""

from __future__ import annotations

import functools

from benchmark import plaintext_db as db
from benchmark.reference import plaintext as ref

prepare = db.prepare


def build(config: dict, traffic: dict, inputs: db.Inputs, device):
    engine = db.engine(config, inputs, device)
    t, k = float(traffic["threshold"]), traffic.get("compact_k")
    return lambda i: engine.find_under(*inputs.pool.request(i), t, compact_k=k)


def _reference(threshold: float, inputs: db.Inputs, pat, msk, device, dtype):
    return ref.audit(inputs.db_pat, inputs.db_msk, pat, msk, threshold, device, dtype=dtype)


def control(config: dict, traffic: dict, inputs: db.Inputs, device):
    return db.control(traffic, inputs, device,
                      functools.partial(_reference, float(traffic["threshold"])), list)


def judge(config: dict, traffic: dict, inputs: db.Inputs, answers: dict, unanswered: int,
          seed: int, device) -> dict:
    return db.judge(traffic, inputs, answers, unanswered, seed, device,
                    functools.partial(_reference, float(traffic["threshold"])), list)
