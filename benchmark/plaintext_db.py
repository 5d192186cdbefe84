"""What the plaintext entries share: the enrolled DB and request pool from
the seed, the port's ``PlaintextEngine`` over it, the sample of answers that
is checked, and the comparison of an answer with the reference's."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from mpc_iris_tpu_torch.models import PlaintextEngine

from benchmark import data


@dataclass
class Inputs:
    db_pat: np.ndarray  # uint8 [N, 1600], host
    db_msk: np.ndarray
    pool: data.Pool
    clusters: data.Clusters


def prepare(config: dict, traffic: dict, seed: int, device) -> Inputs:
    n = int(config["entries"])
    clusters = data.plan_clusters(traffic, n, seed)
    db = data.make_db(n, seed, device, clusters, int(traffic.get("db_flip_bits", 0)))
    return Inputs(db[0], db[1], data.make_pool(traffic, seed, db, clusters), clusters)


def engine(config: dict, inputs: Inputs, device):
    """The system under test: the port's plaintext engine over the DB, at
    the port's own chunk unless the configuration states one."""
    chunk = {"chunk": int(config["chunk"])} if "chunk" in config else {}
    return PlaintextEngine(inputs.db_pat, inputs.db_msk, device=device,
                           storage=config["storage"], **chunk)


def _spread(rng, pairs: np.ndarray, k: int, seen: np.ndarray) -> np.ndarray:
    """``k`` of the (request, slot) ``pairs``, drawn from ``rng`` so that
    the slots of the batch are covered evenly: a slot seen less often (in
    ``seen``, counted on) goes first."""
    pairs = pairs[rng.permutation(len(pairs))]
    rank = np.empty(len(pairs), dtype=np.int64)
    count = seen.copy()
    for j, q in enumerate(pairs[:, 1]):
        rank[j] = count[q]
        count[q] += 1
    take = pairs[np.argsort(rank, kind="stable")[:k]]
    seen += np.bincount(take[:, 1], minlength=len(seen))
    return take


def sample(traffic: dict, inputs: Inputs, answered, seed: int) -> list[tuple[int, int]]:
    """The (request, query) answers that are checked: ``check_queries`` of
    all answered, drawn from the seed over every slot of the batch in turn,
    half of them (as far as there are) among the copies of enrolled
    entries, whose winners are the planted ones, the rest among the fresh
    templates; and one answer of the query that copies the largest planted
    cluster, where one was answered."""
    rng = np.random.default_rng(data.sub_seed(seed, "check"))
    pool, b = inputs.pool, int(traffic["batch"])
    pairs = np.array([(i, q) for i in sorted(answered) for q in range(b)], dtype=np.int64)
    if not len(pairs):
        return []
    src = pool.source[pairs[:, 0] % len(pool), pairs[:, 1]]
    dup = src >= 0
    want = int(traffic["check_queries"])
    n_dup = min(int(dup.sum()), want // 2)
    n_fresh = min(int((~dup).sum()), want - n_dup)
    seen = np.zeros(b, dtype=np.int64)
    pick = [_spread(rng, pairs[dup], n_dup, seen), _spread(rng, pairs[~dup], n_fresh, seen)]
    sizes = inputs.clusters.sizes
    if len(sizes):
        largest = src == inputs.clusters.sources[int(np.argmax(sizes))]
        pick.append(pairs[largest][:1])
    return sorted({tuple(map(int, p)) for p in np.concatenate(pick)})


def distinct_queries(inputs: Inputs, picks) -> tuple[list[tuple[int, int]], np.ndarray, np.ndarray]:
    """The distinct pool queries behind ``picks``, and their planes."""
    keys = sorted({(i % len(inputs.pool), q) for i, q in picks})
    pat = np.stack([inputs.pool.pat[p, q] for p, q in keys])
    msk = np.stack([inputs.pool.msk[p, q] for p, q in keys])
    return keys, pat, msk


def as_tuple(result) -> tuple[int, int, int, float]:
    """A ``MatchResult`` (or the control's :class:`Winner`) as (index, n, d,
    distance)."""
    return (int(result.index), int(result.numerator), int(result.denominator),
            float(result.distance))


@dataclass
class Winner:
    """The control's answer, in the fields of a ``MatchResult``."""

    index: int
    distance: float
    numerator: int
    denominator: int


def compare(got: list, want: list) -> tuple[bool, float]:
    """Lists of (index, n, d, distance): whether they differ, and the largest
    gap of distances at the places both have."""
    gap = max((abs(g[3] - w[3]) if g[3] != w[3] else 0.0 for g, w in zip(got, want)),
              default=0.0)
    return [g[:3] for g in got] != [w[:3] for w in want], gap


def control(traffic: dict, inputs: Inputs, device, reference, shape):
    """The reference in the program's place, its distances in float32:
    ``reference(inputs, pat, msk, device, dtype)`` gives per query a list of
    (index, n, d, distance), ``shape`` turns one into the program's answer
    for a query. It answers the pool's requests in passes over the DB of
    ``check_queries`` queries (at least one request) each, made when a
    request is first asked for."""
    answers = {}
    b = int(traffic["batch"])
    per_pass = max(1, int(traffic["check_queries"]) // b)

    def serve(i):
        p = i % len(inputs.pool)
        if p not in answers:
            todo = range(p, min(len(inputs.pool), p + per_pass))
            got = reference(inputs, inputs.pool.pat[todo].reshape(-1, data.BITS_BYTES),
                            inputs.pool.msk[todo].reshape(-1, data.BITS_BYTES), device,
                            np.float32)
            for k, pp in enumerate(todo):
                answers[pp] = [shape([Winner(h[0], h[3], h[1], h[2]) for h in hits])
                               for hits in got[k * b:(k + 1) * b]]
        return answers[p]

    return serve


def judge(traffic: dict, inputs: Inputs, answers: dict, unanswered: int, seed: int, device,
          reference, listed) -> dict:
    """Compare the sampled answers with the reference's. ``listed`` turns the
    program's answer for one query into a list of results. The numbers
    compared and their limits: every limit is 0, since the configuration
    states exact answers (see the reference's docstring)."""
    picks = sample(traffic, inputs, answers, seed)
    want = {}
    if picks:
        keys, pat, msk = distinct_queries(inputs, picks)
        want = dict(zip(keys, reference(inputs, pat, msk, device, np.float64)))
    wrong, gap = 0, 0.0
    for i, q in picks:
        got = answers[i]
        if q >= len(got):
            wrong += 1
            continue
        differs, g = compare([as_tuple(r) for r in listed(got[q])],
                             want[(i % len(inputs.pool), q)])
        wrong += differs
        gap = max(gap, g)
    return {"unanswered": {"value": unanswered, "limit": 0},
            "wrong_answers": {"value": wrong, "limit": 0},
            "distance_gap": {"value": gap, "limit": 0.0}}
