"""Query prep (``iris.query_prep``): the engines' ``_queries`` (upload,
``prepare_query_planes``, the share engines' ``_q_transform``) and the
small-B kernels' query operands (``_one_query_operand``, ``_query_tiles``)
and bit-valued check (``start_query_check``); its self time a request, ms."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_request(ctx, "iris.query_prep")
