"""Faults under ``PlaintextEngine.find_under``: its spectrum and its
orchestration."""

from __future__ import annotations

from mpc_iris_tpu_torch.models import engines


def altered(monkeypatch) -> None:
    """An answer altered where it is produced: entry 5 at distance 0 for
    every query."""
    orig = engines.PlaintextEngine._spectrum

    def spectrum(self, q_enc, q_mask):
        nd = orig(self, q_enc, q_mask).clone()
        nd[0, :, 5], nd[1, :, 5] = 0, 1
        return nd
    monkeypatch.setattr(engines.PlaintextEngine, "_spectrum", spectrum)


def half_batch(monkeypatch) -> None:
    """Half of the batch left out."""
    orig = engines.orchestrate_find_under

    def orchestrate(count, b, *args):
        return orig(count, b, *args)[: b // 2]
    monkeypatch.setattr(engines, "orchestrate_find_under", orchestrate)
