"""``kernels_roofline`` in the cells of one query a request, which report the
``.b1`` latency and rate (their host work gives them a spread of their own)."""

from benchmark.manifest import metric_reader

read = metric_reader("kernels_roofline").read
