"""Cross-cutting utilities: progress reporting, SI-number parsing, a device
banner, profiling and timing statistics (counterpart of
``mpc_iris_tpu/utils``)."""

from mpc_iris_tpu_torch.utils.progress import Progress
from mpc_iris_tpu_torch.utils.config import parse_si, device_banner

__all__ = ["Progress", "parse_si", "device_banner"]
