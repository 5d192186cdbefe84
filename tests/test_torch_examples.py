"""The port's examples are product surface: examples/api_demo_torch.py run
small on the CPU, as tests/test_examples.py runs the JAX package's demo.

The demo raises on every failed check (no bare assert), so running it is the
test; here at the smallest sizes the engines take (chunk floor 128), with
``--device cpu``. A second run in a fresh interpreter checks that the demo
loads nothing of jax or of the JAX package.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DEMO = ROOT / "examples" / "api_demo_torch.py"
QUICKSTART = ROOT / "examples" / "quickstart_torch.sh"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite's workers share the host's cores: torch's intra-op threads
    of several workers spin against each other on these small shapes (a
    25 ms match took 6 s with six workers), so these tests run torch on one
    thread and restore the setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_api_demo_torch_small():
    spec = importlib.util.spec_from_file_location("api_demo_torch", DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N_DB, mod.B, mod.CHUNK = 128, 2, 128
    ms = mod.main(["--device", "cpu"])
    assert {"match", "find_under", "MPC query", "keyed party"} <= set(ms)
    assert all(v >= 0.0 for v in ms.values())


def test_api_demo_torch_imports_no_jax():
    code = "\n".join([
        "import importlib.util, sys",
        f"spec = importlib.util.spec_from_file_location('api_demo_torch', {str(DEMO)!r})",
        "mod = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(mod)",
        "mod.N_DB, mod.B, mod.CHUNK = 128, 2, 128",
        "mod.main(['--device', 'cpu'])",
        "assert 'jax' not in sys.modules, 'jax imported'",
        "ref = sorted(m for m in sys.modules",
        "             if m == 'mpc_iris_tpu' or m.startswith('mpc_iris_tpu.'))",
        "assert not ref, f'JAX package modules imported: {ref}'",
    ])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # as one_torch_thread
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "api_demo_torch: all checks passed" in out.stdout


def test_quickstart_torch_uses_the_ports_cli():
    """The quickstart parses as bash, drives ``python -m mpc_iris_tpu_torch``
    only, and every subcommand it calls is one of the port CLI's."""
    from mpc_iris_tpu_torch.cli import build_parser

    src = QUICKSTART.read_text()
    subprocess.run(["bash", "-n", str(QUICKSTART)], check=True)
    assert 'CLI="python -m mpc_iris_tpu_torch --device ${DEVICE:-cuda}"' in src
    assert "python -m mpc_iris_tpu " not in src and 'mpc_iris_tpu"' not in src
    used = set(re.findall(r"\$CLI ([a-z][a-z-]*)", src))
    sub = next(a for a in build_parser()._actions if a.dest == "command")
    assert used and used <= set(sub.choices), used - set(sub.choices)
