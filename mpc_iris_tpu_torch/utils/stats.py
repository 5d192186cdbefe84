"""Criterion-grade timing statistics for the benchmark suites (copy of
``mpc_iris_tpu/utils/stats.py``).

The reference benches through criterion (Cargo.toml:41-46, src/arch/mod.rs:22-72),
which reports a distribution — sampling, outlier classification, dispersion —
not a single best time: robust summary statistics (median +/- MAD), Tukey-fence
outlier rejection, and round-over-round regression deltas against a history
ledger, so a +/-2% drift is visible instead of hiding inside best-of-3 noise.

The one difference from the JAX package: the port's ledger is a file of its
own, ``docs/BENCH_HISTORY_torch.jsonl``. ``docs/BENCH_HISTORY.jsonl`` holds the
JAX package's TPU numbers, and a delta between the two devices would mean
nothing.
"""

from __future__ import annotations

import json
import math
import os
import time


def summarize_timings(samples) -> dict:
    """Robust summary of raw timing samples (seconds).

    Returns median/MAD/min/max/mean over ALL samples plus a Tukey-fence
    (1.5 x IQR) outlier classification and the post-rejection median —
    criterion's methodology, sized for small N (N < 4 skips rejection;
    every sample is still reported).
    """
    ts = sorted(float(t) for t in samples)
    n = len(ts)
    if n == 0:
        raise ValueError("no samples")

    def _median(xs):
        m = len(xs)
        return xs[m // 2] if m % 2 else 0.5 * (xs[m // 2 - 1] + xs[m // 2])

    def _quantile(xs, q):
        # linear interpolation between closest ranks (criterion/Type-7)
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    med = _median(ts)
    mad = _median(sorted(abs(t - med) for t in ts))
    mean = sum(ts) / n
    out = {
        "n": n,
        "min": ts[0],
        "max": ts[-1],
        "mean": mean,
        "median": med,
        "mad": mad,
    }
    if n >= 4:
        q1 = _quantile(ts, 0.25)
        q3 = _quantile(ts, 0.75)
        iqr = q3 - q1
        lo_fence = q1 - 1.5 * iqr
        hi_fence = q3 + 1.5 * iqr
        kept = [t for t in ts if lo_fence <= t <= hi_fence]
        out["outliers_rejected"] = n - len(kept)
        out["median_clean"] = _median(kept)
    else:
        out["outliers_rejected"] = 0
        out["median_clean"] = med
    return out


def format_summary(s: dict, unit: str = "s", scale: float = 1.0) -> str:
    """One human line: ``median 4.851s +/- 0.002 (n=5, min 4.849, 0 outliers)``."""
    return (
        f"median {s['median'] * scale:.4g}{unit} +/- {s['mad'] * scale:.2g} "
        f"(n={s['n']}, min {s['min'] * scale:.4g}, "
        f"{s['outliers_rejected']} outliers)"
    )


# --------------------------------------------------------------- history ledger

HISTORY_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "docs", "BENCH_HISTORY_torch.jsonl")


def load_history(path: str | None = None) -> list[dict]:
    path = path or HISTORY_PATH
    entries = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    entries.append(json.loads(line))
    except FileNotFoundError:
        pass
    return entries


def append_history(entry: dict, path: str | None = None) -> dict | None:
    """Append one bench result to the regression ledger and return the most
    recent PRIOR entry with the same ``key`` (for a delta report), or None.

    Set ``MPC_IRIS_NO_BENCH_HISTORY=1`` to disable (e.g. experiments that
    should not pollute the round-over-round record)."""
    if os.environ.get("MPC_IRIS_NO_BENCH_HISTORY"):
        return None
    path = path or HISTORY_PATH
    prev = None
    for e in load_history(path):
        if e.get("key") == entry.get("key"):
            prev = e
    entry = dict(entry)
    entry.setdefault("ts", time.time())
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")
    except OSError:
        return prev
    return prev


def delta_line(entry: dict, prev: dict | None) -> str | None:
    """``vs last (2026-08-19): +1.3%`` — None when no prior entry exists."""
    if not prev or not prev.get("value"):
        return None
    delta = (entry["value"] - prev["value"]) / prev["value"] * 100.0
    when = prev.get("date") or time.strftime(
        "%Y-%m-%d", time.gmtime(prev.get("ts", 0)))
    return f"vs last recorded ({when}): {delta:+.1f}%"
