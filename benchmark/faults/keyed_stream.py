"""Faults under ``KeyedShareEngine.stream``, planted in each chunk's share
dots."""

from __future__ import annotations

from mpc_iris_tpu_torch.models import engines


def altered(monkeypatch) -> None:
    """An answer altered where it is produced: each chunk's first entry."""
    orig = engines._share_dots_chunk

    def dots(q, lo, hi):
        out = orig(q, lo, hi).clone()
        out[:, 0, :] += 1
        return out
    monkeypatch.setattr(engines, "_share_dots_chunk", dots)


def half_batch(monkeypatch) -> None:
    """Half of the batch left out: the second half's dots zero."""
    orig = engines._share_dots_chunk

    def dots(q, lo, hi):
        out = orig(q, lo, hi).clone()
        out[len(q) // 2:] = 0
        return out
    monkeypatch.setattr(engines, "_share_dots_chunk", dots)
