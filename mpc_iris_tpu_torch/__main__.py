import sys

from mpc_iris_tpu_torch.cli import main

sys.exit(main())
