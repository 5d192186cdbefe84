"""Set-up's DB load into the engine (``iris.setup.db_load``): padding and
upload of the plaintext DB, the keyed party's resident head regenerated, s."""

from benchmark import spans


def read(ctx):
    return spans.seconds("iris.setup.db_load")
