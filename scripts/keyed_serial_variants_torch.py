"""Time shapes of the serial fused keyed kernel (``csrc/keyed_share_dot.cu``,
``keyed_share_dot_serial_kernel``) on one CUDA card, to see what bounds it.

A shape is (query rows a block, ChaCha blocks a thread a stage, query slab
buffers): ``ops/keyed_dot.py::serial_shape`` picks one for a batch, and the
others are built here, in one extra library compiled from a copy of the
source with more instantiations (under ``mpc_iris_tpu_torch/build/``).
Each runs one 16,384-row chunk at B = 1 (31 query rows) or B = 8 (248),
operands laid out once, CUDA events in turns with kernel (d) alone on the
same rows (mean of 20 calls after a warm-up, three rounds), and is checked
bit for bit against the plain version. ``--no-products`` builds the same
shapes with the products left out (timing only: it prints no check), to
show the regeneration's own time.

    python scripts/keyed_serial_variants_torch.py [--no-products]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.constants import BITS  # noqa: E402
from mpc_iris_tpu_torch.ops import _build  # noqa: E402
from mpc_iris_tpu_torch.ops.chacha import key_tensor, share_planes_kernel  # noqa: E402
from mpc_iris_tpu_torch.ops.keyed_dot import (  # noqa: E402
    keyed_share_dots_reference,
    query_slabs,
    serial_shape,
)

CHUNK = 16_384
KEY = bytes(range(0x80, 0xA0))
REPS = 20
# batch -> shapes (query rows, blocks a thread, query slab buffers)
SHAPES = {1: [(32, 1, 2), (32, 1, 1), (32, 2, 2), (32, 2, 1)],
          8: [(256, 2, 1), (256, 1, 1), (256, 1, 2)]}
SHAPE_NAMES = {str(s) for shapes in SHAPES.values() for s in shapes}
_PRODUCTS = ("      tile::wgmma_ss<QW>(acc, tile::slab_desc(planes + s * C::kSlab),\n"
             "                         tile::slab_desc(b_base + s * QW * 32));\n")


def build(no_products: bool) -> ctypes.CDLL:
    """The kernel source with every shape of SHAPES instantiated (and,
    ``no_products``, the products dropped), built into its own library."""
    src = (_build.CSRC / "keyed_share_dot.cu").read_text()
    lines = "".join(f"  SERIAL({q}, {b}, {k})\n" for shapes in SHAPES.values()
                    for q, b, k in shapes)
    assert "#undef SERIAL" in src and _PRODUCTS in src, "the source moved: update the patches"
    src = src.replace("#undef SERIAL", lines + "#undef SERIAL", 1)
    if no_products:
        src = src.replace(_PRODUCTS, "")
    key = hashlib.sha256(src.encode())
    for f in sorted(_build.CSRC.glob("*.cuh")):
        key.update(f.read_bytes())
    out = _build.BUILD_DIR / f"libkeyed_serial_variants_{key.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = out.with_suffix(".cu")
        cu.write_text(src)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_build._nvcc(), *flags, f"-I{_build.CSRC}", "-shared", "-o", str(out),
                        str(cu)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.keyed_share_dots_serial_launch.argtypes = [i, i, i, p, p, p, u, u, i, i, p, p]
    lib.keyed_share_dots_serial_launch.restype = i
    return lib


def cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-products", action="store_true",
                    help="timing only: the shapes with the products left out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    lib = build(args.no_products)
    kw = key_tensor(KEY, dev)
    rng = np.random.default_rng(2)
    ok = True
    for b, shapes in SHAPES.items():
        q = torch.from_numpy(rng.integers(-1, 2, (31 * b, BITS), dtype=np.int8)).to(dev)
        corr = 128 * q.sum(dim=1, dtype=torch.int32)
        out = torch.empty((q.shape[0], CHUNK), dtype=torch.int32, device=dev)
        want = None if args.no_products else keyed_share_dots_reference(q, kw, 0, 0, CHUNK)
        runs = {"kernel (d) alone": lambda: share_planes_kernel(kw, 0, 0, CHUNK)}
        for shape in shapes:
            qt = query_slabs(q, shape[0])

            def run(shape=shape, qt=qt):
                rc = lib.keyed_share_dots_serial_launch(
                    *shape, qt.data_ptr(), corr.data_ptr(), kw.data_ptr(), 0, 0, CHUNK,
                    q.shape[0], out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch {shape} failed: {rc}")
                return out
            if want is not None:
                equal = torch.equal(run(), want)
                ok &= equal
                print(f"B={b} shape {shape}: bit-equal to the plain version {equal}")
            runs[str(shape)] = run
        times = {name: [] for name in runs}
        for _ in range(3):  # in turns
            for name, fn in runs.items():
                times[name].append(cuda_ms(fn))
        chosen = str(serial_shape(31 * b).launch_args)
        for name, ts in times.items():
            mark = " (serial_shape's)" if name == chosen else ""
            if args.no_products and name in SHAPE_NAMES:
                mark += " without the products"
            print(f"B={b} {name}{mark}: " + " / ".join(f"{t:.4f}" for t in ts)
                  + f" ms [{card}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
