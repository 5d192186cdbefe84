"""The benchmark of the PyTorch and CUDA port (``mpc_iris_tpu_torch``); see
README.md."""
