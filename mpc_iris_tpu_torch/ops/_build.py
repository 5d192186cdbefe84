"""Build and load the port's CUDA kernels.

All of ``mpc_iris_tpu_torch/csrc/*.cu`` (with the ``*.cuh`` headers they
include) is compiled with nvcc for sm_90a, one nvcc per source, all started
together, and linked into one shared library with a plain C interface, loaded
with ``ctypes``. The build runs at first use, into ``mpc_iris_tpu_torch/build/``
(ignored by git), under a file name keyed by a hash of the sources and flags,
so an edited source is never served by a stale library. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from mpc_iris_tpu_torch.utils.profiling import annotate

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
# Every exported C function: (argtypes, restype). Pointers and the stream are
# c_void_p so ctypes never truncates them to 32-bit ints.
_SIGNATURES = {
    "select_chunk_parts": ([ctypes.c_int], ctypes.c_int),
    "select_chunk_launch": (
        [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P],
        ctypes.c_int),
    "packed_tile_entries": ([ctypes.c_int], ctypes.c_int),
    "match_packed_small_b_launch": (
        [ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P,
         ctypes.c_int, _P],
        ctypes.c_int),
    "match_packed_g8_scratch": ([ctypes.c_longlong], ctypes.c_int),
    "match_packed_g8_launch": (
        [_P, _P, _P, ctypes.c_longlong, _P, _P, ctypes.c_int, _P], ctypes.c_int),
    "fractions_packed_small_b_launch": (
        [ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P,
         ctypes.c_longlong, _P],
        ctypes.c_int),
    "fractions_packed_g8_scratch": ([ctypes.c_longlong], ctypes.c_int),
    "fractions_packed_g8_launch": (
        [_P, _P, _P, ctypes.c_longlong, _P, _P, ctypes.c_longlong, _P], ctypes.c_int),
    "chacha_planes_launch": (
        [_P, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong, _P, _P, _P],
        ctypes.c_int),
    "packed_gemm_launch": (
        [ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P],
        ctypes.c_int),
    "int8_gemm_launch": (
        [ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P],
        ctypes.c_int),
    "keyed_share_dots_serial_launch": (
        [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_uint32, ctypes.c_uint32,
         ctypes.c_int, ctypes.c_int, _P, _P],
        ctypes.c_int),
    "keyed_share_dots_pipe_launch": (
        [ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_uint32, ctypes.c_uint32,
         ctypes.c_int, ctypes.c_int, _P, _P],
        ctypes.c_int),
    "pk_dot_launch": ([_P, _P, _P, ctypes.c_longlong, _P, _P], ctypes.c_int),
    "pk_tile_entries": ([], ctypes.c_int),
    "pk_select_launch": ([_P, _P, _P, ctypes.c_longlong, _P, _P, ctypes.c_int, _P], ctypes.c_int),
    "pk_fractions_launch": (
        [_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P], ctypes.c_int),
    "select_variant_launch": (
        [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
         _P],
        ctypes.c_int),
    "select_lanes_launch": (
        [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "stream_probe_launch": (
        [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P, _P],
        ctypes.c_int),
    "probe_trees_launch": (
        [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P],
        ctypes.c_int),
    "probe_fold_launch": (
        [ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, _P, _P],
        ctypes.c_int),
}


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an existing library for these sources was reused
    log: str        # nvcc / ptxas output (registers, shared memory, spills)


_lock = threading.Lock()
_built: Build | None = None
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build "
                           "the kernels in " + str(CSRC))
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Build:
    """Compile the kernels (or reuse the library already built from the same
    sources) and return where it is."""
    global _built
    with _lock:
        if _built is None:
            with annotate("iris.setup.kernel_build"):
                _built = _compile()
        return _built


def _compile() -> Build:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / f"libmpc_iris_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    t0 = time.perf_counter()
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources(), objs)])
        log += _run_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return Build(out, time.perf_counter() - t0, log)


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; returns their joined output, or raises
    with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{log}")
    return "".join(outs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    b = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(b.path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C launch function returned a nonzero ``cudaGetLastError``."""
    if code != 0:
        import torch

        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{torch.cuda.CudaError(code)}")
