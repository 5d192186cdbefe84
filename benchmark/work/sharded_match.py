"""Work of one sharded ``match`` request, from the shapes alone: that of a
``match`` request over the whole DB (``work/match.py``), and for kernel (b)'s
int8 loop the least time of its launches on every card.

The DB is sharded over the mesh's ``db`` rows strided by chunk (global chunk
g on row g mod D, the port's 16,384 entries unless the configuration states
a chunk), and each card takes its column's B / batch queries. At B <= 8
each card launches the int8 loop of kernel (b) once for its queries in
groups of 4 and once for a remainder of 2 or 3 (a remainder of 1 runs the
binary kernel), each launch reading the card's DB and taking its queries'
products; its least time is the larger of those DB bytes at the memory peak
and its int8 operations (31 rows a query) at the int8 peak, the rule of
``packed_fractions_bound_s`` (``work/find_under.py``).
"""

from benchmark.peaks import HBM_BYTES_PER_S, INT8_OPS
from benchmark.work.find_under import int8_launches
from benchmark.work.match import BITS, ENTRY_BYTES, ROTATIONS
from benchmark.work.match import work as match_work

CHUNK = 16_384  # the port's DEFAULT_CHUNK


def shard_entries(n: int, shards: int, chunk: int) -> list[int]:
    """The DB entries on each of ``shards`` rows, strided by ``chunk``."""
    full, rest = divmod(n, chunk)
    out = [full // shards * chunk] * shards
    for g in range(full - full % shards, full):
        out[g % shards] += chunk
    out[full % shards] += rest
    return out


def work(config: dict, traffic: dict) -> dict:
    out = match_work(config, traffic)
    n, (rows, cols) = int(config["entries"]), (int(x) for x in config["mesh"])
    # the port's clamp of the chunk to a small DB (parallel/sharded.py::effective_chunk)
    chunk = min(int(config.get("chunk", CHUNK)), max(128, -(-n // rows)))
    per_card = int(traffic["batch"]) // cols
    out["packed_match_bound_s"] = cols * sum(
        max(e * ENTRY_BYTES / HBM_BYTES_PER_S, 2 * 2 * q * ROTATIONS * BITS * e / INT8_OPS)
        for e in shard_entries(n, rows, chunk) for q in int8_launches(per_card))
    return out
