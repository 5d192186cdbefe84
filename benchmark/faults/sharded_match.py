"""Faults under ``ShardedPlaintextEngine.match``, planted in
``match_arrays``."""

from __future__ import annotations

from mpc_iris_tpu_torch.parallel import sharded


def altered(monkeypatch) -> None:
    """An answer altered where it is produced: every winner's index."""
    orig = sharded.ShardedPlaintextEngine.match_arrays

    def match_arrays(self, q_enc, q_mask):
        out = orig(self, q_enc, q_mask).clone()
        out[2] += 1
        return out
    monkeypatch.setattr(sharded.ShardedPlaintextEngine, "match_arrays", match_arrays)


def half_batch(monkeypatch) -> None:
    """Half of the batch left out."""
    orig = sharded.ShardedPlaintextEngine.match_arrays
    monkeypatch.setattr(sharded.ShardedPlaintextEngine, "match_arrays",
                        lambda self, qe, qm: orig(self, qe[: len(qe) // 2], qm[: len(qm) // 2]))
