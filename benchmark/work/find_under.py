"""Work of one ``find_under`` request, from the shapes alone: that of a
``match`` request (``work/match.py``), and for kernel (c) the least time of
each of its launches.

At B <= 8 the port launches kernel (c) once for the queries in groups of 4
and once for a remainder of 2 or 3 (a remainder of 1 runs the binary
kernel), each launch reading the DB and taking its queries' products; its
least time is the larger of the DB bytes at the memory peak and its queries'
int8 operations (31 rows a query) at the int8 peak.
"""

from benchmark.peaks import HBM_BYTES_PER_S, INT8_OPS
from benchmark.work.match import BITS, ROTATIONS
from benchmark.work.match import work as match_work


def int8_launches(b: int) -> list[int]:
    """Queries of each launch of the int8 loop of kernel (c) at batch b."""
    if not 1 <= b <= 8:
        return []
    launches = [b - b % 4] if b >= 4 else []
    if b % 4 >= 2:
        launches.append(b % 4)
    return launches


def work(config: dict, traffic: dict) -> dict:
    out = match_work(config, traffic)
    n = int(config["entries"])
    out["packed_fractions_bound_s"] = sum(
        max(out["db_bytes"] / HBM_BYTES_PER_S, 2 * 2 * q * ROTATIONS * BITS * n / INT8_OPS)
        for q in int8_launches(int(traffic["batch"])))
    return out
