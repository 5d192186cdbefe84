"""Match engines on PyTorch (counterpart of ``mpc_iris_tpu/models``): the
plaintext engine over a packed or dense device-resident template DB, with
the min-distance match and the threshold audit; and the MPC engines: a
participant's ShareEngine (stored share) and KeyedShareEngine (share
regenerated from its key), and the coordinator's MasksEngine."""

from mpc_iris_tpu_torch.models.engines import (
    AuditLimitExceeded,
    KeyedShareEngine,
    MasksEngine,
    MatchResult,
    PlaintextEngine,
    ShareEngine,
    default_hbm_budget,
    prepare_query_planes,
)

__all__ = ["AuditLimitExceeded", "KeyedShareEngine", "MasksEngine", "MatchResult",
           "PlaintextEngine", "ShareEngine", "default_hbm_budget", "prepare_query_planes"]
