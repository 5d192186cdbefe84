"""Set-up's ``kernel_self_test`` (``iris.setup.kernel_self_test``), less
an nvcc build of the kernels inside it, s."""

from benchmark import spans


def read(ctx):
    return spans.seconds("iris.setup.kernel_self_test")
