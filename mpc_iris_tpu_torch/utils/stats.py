"""Criterion-grade timing statistics for the benchmark suites (copy of
``mpc_iris_tpu/utils/stats.py``, without its history ledger, which nothing
of the port reads).

The reference benches through criterion (Cargo.toml:41-46, src/arch/mod.rs:22-72),
which reports a distribution — sampling, outlier classification, dispersion —
not a single best time: robust summary statistics (median +/- MAD) and
Tukey-fence outlier rejection, so a +/-2% drift is visible instead of hiding
inside best-of-3 noise.
"""

from __future__ import annotations

import math


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
