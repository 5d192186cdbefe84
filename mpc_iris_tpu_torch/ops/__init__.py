"""Tensor ops and the hand-written CUDA kernels of the plaintext match,
audit and MPC paths (counterpart of ``mpc_iris_tpu/ops``).

- ``encode``, ``rotations``: query preparation (uint8 / int8 tensors), the
  u16 ring encoding, the device share split and the per-template host
  encoding (``encode_template``, ``decode_encoded``)
- ``decode``: exact fraction selection in int32, the host f64 decode
  (``decode_distance``, batched ``decode_distance_batch_np``) and the exact
  threshold compare
- ``dot``: int8 products (``torch._int_mm``) and the exact mod-2^16 share dots
- ``chacha``: ChaCha20 share-stream regeneration, kernel
  ``share_planes_kernel`` (csrc/chacha_planes.cu) and its plain version
- ``select``: kernel ``select_chunk`` (csrc/select_chunk.cu) and its plain version
- ``scan``: query planes, per-chunk unpack, the chunk scan and the fraction
  spectrum scans; with the plain selection the packed scan is the plain
  packed match, and the packed spectrum scan the plain packed spectrum
- ``packed_match``: kernels ``match_packed_small_b`` (csrc/packed_match.cu;
  a group of one query csrc/b1_packed.cu's ``pk_select_kernel``) and
  ``fractions_packed_small_b`` (csrc/packed_fractions.cu; a group of one
  query csrc/b1_packed.cu's ``pk_fractions_kernel``) and their plain
  versions
- ``gemm``, ``keyed_dot``: the fused-regen probe kernels ``int8_gemm``
  (csrc/int8_gemm.cu) and ``keyed_share_dots`` (csrc/keyed_share_dot.cu,
  ChaCha20 fused with the share products) and their plain versions; no
  engine calls them (scripts/fused_mm_regen_probe_torch.py measures them)
- ``b1_packed``, ``select_probes``: the B = 1 packed-dot probe kernels
  ``pk_dot`` and ``pk_select`` (csrc/b1_packed.cu; pk_select's kernel is
  the one match_packed_small_b launches at B = 1) and the select
  compare-arithmetic probe kernels ``select_variant`` and ``select_lanes``
  (csrc/select_probes.cu) and their plain versions; no engine calls the
  wrappers (scripts/b1_kernel_probe_torch.py, select_variants_torch.py and
  select_i16_probe_torch.py measure them)
- ``self_test``: the runtime canary of the int8 product, the share dot and
  the engines' kernels
- ``_build``: compiles csrc/*.cu with nvcc and loads it with ctypes

A kernel wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors. Nothing here builds or imports a kernel at import.
"""

from mpc_iris_tpu_torch.ops.decode import (
    decode_distance,
    decode_distance_batch_np,
    fraction_argmin,
    fraction_min_rotations,
    fraction_to_f64,
    fractions_to_f64_np,
    numerators,
    running_min,
    under_threshold_mask_np,
)
from mpc_iris_tpu_torch.ops.chacha import share_planes_kernel, share_planes_natural
from mpc_iris_tpu_torch.ops.dot import (
    dot_bits_batch,
    dot_share_batch,
    planes_to_shares,
    shares_to_planes,
)
from mpc_iris_tpu_torch.ops.encode import (
    encode_grid_i8,
    encode_grid_u16,
    encode_template,
    pack_bits,
    share_split_device,
    unpack_bits,
)
from mpc_iris_tpu_torch.ops.packed_match import (
    fractions_packed_small_b,
    fractions_packed_small_b_reference,
    match_packed_small_b,
    match_packed_small_b_reference,
    small_b_ok,
)
from mpc_iris_tpu_torch.ops.rotations import (
    expand_rotations,
    expand_rotations_flat,
    rotate_grid,
)
from mpc_iris_tpu_torch.ops.scan import prepare_query_planes
from mpc_iris_tpu_torch.ops.select import (
    fold_candidates,
    select_chunk,
    select_chunk_reference,
)
from mpc_iris_tpu_torch.ops.self_test import kernel_self_test

__all__ = [
    "decode_distance",
    "decode_distance_batch_np",
    "dot_bits_batch",
    "dot_share_batch",
    "encode_grid_i8",
    "encode_grid_u16",
    "encode_template",
    "expand_rotations",
    "expand_rotations_flat",
    "fold_candidates",
    "fraction_argmin",
    "fraction_min_rotations",
    "fraction_to_f64",
    "fractions_packed_small_b",
    "fractions_packed_small_b_reference",
    "fractions_to_f64_np",
    "kernel_self_test",
    "match_packed_small_b",
    "match_packed_small_b_reference",
    "numerators",
    "pack_bits",
    "planes_to_shares",
    "prepare_query_planes",
    "rotate_grid",
    "running_min",
    "select_chunk",
    "select_chunk_reference",
    "share_planes_kernel",
    "share_planes_natural",
    "share_split_device",
    "shares_to_planes",
    "small_b_ok",
    "under_threshold_mask_np",
    "unpack_bits",
]
