"""``query_prep_ms`` in the cells of one query a request, which report the
``.b1`` latency and rate."""

from benchmark.manifest import metric_reader

read = metric_reader("query_prep_ms").read
