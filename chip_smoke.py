#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths (plaintext match, threshold audit,
MPC participants, sharded engines, the MPC serving roles) once on one
NVIDIA GPU, at full size, and check them.

- builds the CUDA kernels from mpc_iris_tpu_torch/csrc with nvcc (sm_90a);
- serves match requests through ``PlaintextEngine.match``: B = 1 and 8 on a
  1,048,576-entry packed DB (kernel match_packed_small_b), B = 13 and 128 on
  the same DB (kernels packed_gemm, both products of a packed chunk, and
  select_chunk) and B = 128 on a 262,144-entry dense DB (kernel
  select_chunk);
- holds every winner against the plain path on the card, bit for bit; the
  planted self-matches (rotated copies of DB entries) at distance 0.0, and a
  duplicated entry at its lower index; and ``distances()`` against the scalar
  oracle ``Template.distance`` for 2 queries x 256 sampled entries;
- serves audit requests on the same engines: ``min_fractions`` at B = 1 and 8
  (kernel fractions_packed_small_b; its groups of one query, B = 1, launch
  csrc/b1_packed.cu's pk_fractions_kernel, counted apart as
  ``pk_fractions``), bit-equal to the plain spectrum and, on
  sampled entries, to ``Template.distance``; ``find_under`` at threshold
  0.375 for packed B = 1, 8 (the kernel plus the device compaction) and 13
  (the spectrum scan) and dense B = 8, each list equal to the plain
  spectrum's; and one threshold with about 1,000 entries under it, past a
  256-entry compact buffer, equal to the full path, with a ``limit`` that
  must raise;
- drives a keyed MPC party at 1,048,576 entries (the reference's ``bench.py
  --mode share-keyed`` default): a ``KeyedShareEngine`` that keeps nothing
  resident, so every chunk regenerates through the ChaCha20 kernel
  share_planes_kernel; its ``fold_pass_fn`` checksum at B = 1 and 8 must
  equal the uint32 sum of the same engine's ``dots``. Beside it the kernel
  against its plain version bit for bit (a whole chunk, the three u64
  nonce-carry positions, stream id 0xFFFFFFFE, a high-bit key) and the
  RFC 8439 section 2.3.2 block from the kernel itself;
- drives the fused-regen probe kernels (``probe_phase``; the families of
  scripts/fused_mm_regen_probe_torch.py): ``int8_gemm`` (csrc/int8_gemm.cu)
  at the scan's B = 128 products of one chunk and the keyed B = 8 products,
  bit-equal to its plain version and to ``torch._int_mm``; both variants of
  ``keyed_share_dots`` (csrc/keyed_share_dot.cu, ChaCha20 fused with the
  share products) on a 16,384-row chunk at B = 1 and 8 and at the three u64
  carry positions, bit-equal to the plain version; then the keyed party's
  1,048,576-entry pass through each fused variant and through ``int8_gemm``
  at B = 1 and 8, each checksum equal to ``fold_pass_fn``'s; the times beside
  ``torch._int_mm`` and the unfused chunk (kernel (d), then the products);
- drives the B = 1 packed-dot probe kernels and the select compare probes
  (``b1_select_probe_phase``; scripts/b1_kernel_probe_torch.py,
  select_variants_torch.py, select_i16_probe_torch.py): ``pk_dot`` (with
  its epilogue) and ``pk_select`` (the exact selection fused in; the
  kernel match_packed_small_b launches for a group of one query), the two
  binary kernels of csrc/b1_packed.cu (four AND-popcount products on
  ``mma.sync`` b1, one tile loop), over the 1,048,576-entry packed DB at
  B = 1, pk_select's winner equal to its plain version, the unfused scan and
  the int8 kernel at a group of 2 with one query, pk_dot's of the same index
  and fraction, both outputs bit-equal to their plain versions over the
  whole DB; ``select_variant`` with the compares
  i32, f32 and f32_exact at [4,096, 32,768] int32 and ``select_lanes``
  with the int32 and int16 trees at [8,192, 32,768] int16
  (csrc/select_probes.cu), each bit-equal to its plain version there, on a
  tie-heavy block (tile_n 2,048 and 128) and an int16 wrap, f32 keeping the
  pair that int32 resolves; the times beside the int8 kernel at one query
  and (a);
- drives the streaming, morph and bisect probe kernels
  (``stream_probe_phase``; scripts/dma_probe_torch.py, morph_probe_torch.py,
  select_bisect_torch.py; csrc/stream_probes.cu): every variant of the
  probes' mains once at their shapes, int32 [4,096, 32,768] x2 in each
  probe's range: ``dma_variant`` x9, ``morph_stage`` stages 0-5, ``morph2``
  x5, ``morph3`` x2, ``bisect``'s five modes at tiles (8, 2,048) and (4,
  8,192); each output bit-equal to its plain version on the card, each time
  beside its bound and beside (a) and s1's i32 on the same inputs;
- serves one 3-party MPC query at 262,144 entries (``bench.py --mode share``'s
  default) on the dense DB's templates: parties 0 and 1 keyed (half their
  chunks resident, the rest regenerated per query), party 2 a
  ``ShareEngine`` over the data-carrying share that ``share_split_device``
  makes on the card, the coordinator a ``MasksEngine``; B = 8 queries, every
  party's ``stream(entry_major=True)``, then the coordinator's batched
  decode steps on the card. The winners must equal ``PlaintextEngine.match``
  on the same DB, the planted self-matches come back at 0.0 and the
  duplicate at its lower index, and the per-entry spectrum must equal
  ``PlaintextEngine.min_fractions``; party 2 again under the default budget
  policy with only part of it resident, the rest streamed host -> card
  through the prefetch worker, equal to the resident party before and after
  a ``refresh``;
- runs the sharded engines (``mpc_iris_tpu_torch.parallel``) on 4 shards
  over the card's devices, repeated up to 4 (one card runs them one after
  another, so the times are the sharded layer's overhead, not scaling):
  ``ShardedPlaintextEngine`` over the same 1,048,576-entry packed DB, match
  at B = 1, 8 (kernel (b) per shard) and 13 (the scan through kernel (a)),
  B = 8 on a (2, 2) mesh, ``min_fractions`` at B = 1 and ``find_under`` at
  B = 8 (kernel (c) per shard), each bit-equal to the single-card engine,
  with a duplicate pair across shards (the lower index on the higher shard)
  resolved to the lower index; a ``ShardedKeyedShareEngine`` fold pass at
  1,048,576 entries (one kernel (d) launch per chunk) equal to the
  single-card checksum at B = 1 and 8; the 3-party MPC query at 262,144
  entries over sharded parties and masks, winners equal to the single-card
  query's; and a party of several processes (``torch.distributed``: on one
  card 2 ranks of 2 shards over gloo, since NCCL refuses two ranks on one
  card; with several cards one rank a card over NCCL), every non-local row
  poisoned: its B = 8 match, B = 1 spectrum, share dots and keyed checksum
  equal to the single-card engines' on the clean data, and a party of 4
  ranks of one device on a (2, 2) mesh, whose "db" rows span two ranks
  each (its B = 2 spectrum and find_under lists checked too). Kernels (b)
  and (c) are held against their plain versions on every shard's own
  slab, at B = 1 and 8 on 4 shards and at B = 4 a column on the (2, 2)
  mesh. On a machine with several cards the same command spreads the
  shards over them;
- serves the 3-party MPC query with each participant in its own process
  (``mpc_iris_tpu_torch.protocol.party_proc``: two keyed parties and the
  data party, each rebuilt from the seed and the key on card p %
  device_count, serving the reference, batched and chain wires) behind a
  ``Coordinator`` and ``QueryServer`` in this process: 8 concurrent
  ``query_remote`` clients micro-batched into one B = 8 round, one B = 1
  query on the reference wire, ``query_remote_under`` at 0.375, a
  ``PersistentQueryClient`` with 3 records, a chain round (the coordinator
  holding the data share) and two rounds in flight; every winner equal to
  ``PlaintextEngine.match`` and the in-process MPC query, the audit list
  to ``find_under``; each keyed process must launch kernel (d); the
  processes are stopped by SIGTERM to their PIDs and killed at a deadline;
- drives the CLI (``mpc_iris_tpu_torch.cli``) as a deployment does, in a
  fresh directory under build/ (removed at the end): ``generate`` of a
  262,144-entry JSON DB (about 1.7 GB, the C++ codec), ``match --storage
  packed`` at B = 1, 8 (kernel (b)), 13 (kernel (a)) and ``--all-under
  0.375`` at B = 8 (kernel (c)) in this process, each equal to an
  in-process PlaintextEngine; ``prepare --backend device`` of a
  65,536-entry 3-party store (kernel (d); cut by disk: 25.6 KB an entry a
  share file) equal to the host path's bytes, ``store-check --key --deep``;
  then ``python -m mpc_iris_tpu_torch`` processes: two keyed participants
  and the data party on the batched wire (--watch), a coordinator whose
  winners equal ``match``, an ``enroll`` of 4 candidates (2 duplicates)
  and a query that finds the enrolled entries; a SIGUSR2 torch.profiler
  trace of a keyed participant that must name kernel (d), a SIGUSR1 stats
  line with the card's memory, every participant stopped by SIGTERM to its
  PID ("cli: participants [...]") and drained cleanly; ``bench-kernels``;
- holds the port to the repo's reference vectors on the card
  (``conformance_phase``): the golden set of tests/golden_distances.json
  through packed and dense ``distances``, ``match`` at B = 8 (kernel (b))
  and 17 (kernel (a)), ``min_fractions`` (kernel (c)) and the encoded path
  with a keyed party (kernel (d)); the interop fixture's frozen share and
  mask records, decoded distances and keystream rows (kernel (d)); every f64
  bit-equal; then examples/api_demo_torch.py at 262,144 entries, B = 8;
- counts the kernel launches of each path's run, and times each request and
  each kernel beside its plain version, labelled with the card's name and
  limit; the packed kernels (b) and (c) at B = 1, 8, 16, 32, 64 and 128,
  each bit-equal to its plain version, beside the scan the engine takes past
  the dispatch boundary, with their int8 op rate, their bound (bytes at
  3.35 TB/s or int8 ops at 1,979 TOPS) and share of it, the query bytes
  they read from L2, and the SM clock and power nvidia-smi samples while
  (b) runs; (c) at B = 1 (``pk_fractions``) as a call and as a kernel
  beside the int8 kernel at a group of 2;
- checks that no module of jax or of the JAX package ``mpc_iris_tpu`` was
  imported.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
card, the one before that the kernels as JSON (twenty kernels, each with
its bound).
Exits nonzero, printing no result, without a CUDA card or when any build,
launch or check fails.

    python3 chip_smoke.py [--seed S]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from mpc_iris_tpu_torch import BITS, BITS_BYTES, Bits, Template, native
from mpc_iris_tpu_torch.benchmarks import ALU_OPS, HBM_BYTES_PER_S, INT8_OPS, card_line, cuda_ms
from mpc_iris_tpu_torch.cli import main as cli_main
from mpc_iris_tpu_torch.io.formats import write_templates_json
from mpc_iris_tpu_torch.models.engines import (
    DEFAULT_CHUNK,
    AuditLimitExceeded,
    KeyedShareEngine,
    MasksEngine,
    PlaintextEngine,
    ShareEngine,
    _compact_under_device,
    _match_scan,
    _queries_to_natural_k,
    _share_dots_chunk,
    find_under_from_fractions,
    host_spectrum,
)
from mpc_iris_tpu_torch.ops import _build, stream_probes
from mpc_iris_tpu_torch.ops.b1_packed import (
    Q_ROW,
    launch_fractions,
    pk_dot,
    pk_dot_reference,
    pk_dot_winner,
    pk_select,
    pk_select_reference,
    prep_query,
)
from mpc_iris_tpu_torch.ops.chacha import (
    k_permutation,
    key_tensor,
    share_planes_kernel,
    share_planes_natural,
)
from mpc_iris_tpu_torch.ops.decode import (
    decode_distance,
    decode_distance_batch_np,
    fraction_to_f64,
    fractions_to_f64_np,
    under_threshold_mask_np,
)
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch, planes_to_shares
from mpc_iris_tpu_torch.ops.encode import encode_template, share_split_device
from mpc_iris_tpu_torch.ops.gemm import int8_gemm, int8_gemm_reference
from mpc_iris_tpu_torch.ops.packed_gemm import packed_gemm, packed_gemm_reference, packed_query
from mpc_iris_tpu_torch.ops.keyed_dot import (
    VARIANTS,
    keyed_pass_checksum,
    keyed_share_dots,
    keyed_share_dots_reference,
)
from mpc_iris_tpu_torch.ops.packed_match import (
    _launch_int8_fractions,
    _launch_int8_group,
    _launch_plan,
    _one_query_operand,
    fractions_packed_small_b,
    fractions_packed_small_b_reference,
    match_packed_int8_pairs,
    match_packed_small_b,
    match_packed_small_b_reference,
)
from mpc_iris_tpu_torch.ops.scan import (
    _fractions_scan,
    _fused_rows,
    _match_scan_packed,
    _unpack_encode_chunk,
    prepare_query_planes,
)
from mpc_iris_tpu_torch.ops.select import select_chunk, select_chunk_reference
from mpc_iris_tpu_torch.ops.select_probes import (
    COMPARES,
    TREES,
    select_lanes,
    select_lanes_reference,
    select_variant,
    select_variant_reference,
)
from mpc_iris_tpu_torch.parallel import (
    ShardedKeyedShareEngine,
    ShardedMasksEngine,
    ShardedPlaintextEngine,
    ShardedShareEngine,
    fraction_allmin,
    make_mesh,
)
from mpc_iris_tpu_torch.parallel.party_smoke import KEY, dots_digest, run_party, under_digest
from mpc_iris_tpu_torch.parallel.sharded import effective_chunk
from mpc_iris_tpu_torch.protocol import (
    Coordinator,
    PersistentQueryClient,
    QueryServer,
    query_remote,
    query_remote_under,
)
from mpc_iris_tpu_torch.protocol.coordinator import (
    _sum_decode_argmin_device_batch,
    _sum_decode_minfrac_device_batch,
)
from mpc_iris_tpu_torch.protocol.party_proc import start_parties, stop_parties
from mpc_iris_tpu_torch.protocol.wire import batched_query_bytes
from mpc_iris_tpu_torch.smoke_data import (
    BISECT_RANGES,
    N_PLANTED,
    STREAM_RANGES,
    db_rng,
    make_data,
    make_db,
    probe_inputs,
    query_rows,
    stream_inputs,
    tie_case,
)

# the select probes' shapes: select_variants.py's b x n int32 and
# select_i16_probe.py's B x N int16 (1.07 GB each); their tie-heavy block
S1_SHAPE = (128, 32_768)
S2_SHAPE = (256, 32_768)
LANES_OUT = 3 * 128  # select_lanes' int32 winners a query
TIE_SHAPE = (64, 8_192)
# the stream probes' inputs: dma_probe.py's and morph_probe.py's [B, N], and
# select_bisect.py's b x n (1.07 GB each pair); the variant whose time each
# function's entry of the kernels line carries; the TPU kernel each replaces
STREAM_SHAPE = (4_096, 32_768)
BISECT_SHAPE = (128, 32_768)
STREAM_ENTRY = {
    "dma_variant": ("2in plain", "scripts/dma_probe.py:27"),
    "morph_stage": ("stage 5 + column tree (full)", "scripts/morph_probe.py:28"),
    "morph2": ("1out(384) +3scr +compute", "scripts/morph_probe.py:170"),
    "morph3": ("replica, with lane tree", "scripts/morph_probe.py:305"),
    "bisect": ("full (8, 2048)", "scripts/select_bisect.py:24"),
}
# int32 operations a compare of the select probes (products, compares,
# validity, selects), and the subtract and shift of an element's numerator
COMPARE_OPS = {"i32": 10, "f32": 14, "f32_exact": 28}
NUMERATOR_OPS = 2
# int32 operations of one 64-byte ChaCha20 block: 20 rounds x 4 quarter
# rounds x 12 (4 add, 4 xor, 4 rotate), and the 16 adds of the input
CHACHA_OPS = 20 * 4 * 12 + 16
# batches of the packed kernels' sweep, both sides of the dispatch boundary
SWEEP = (1, 8, 16, 32, 64, 128)

# DB sizes: the packed and dense defaults of the reference's bench.py
PACKED_DB = 1_048_576
DENSE_DB = 262_144
# the audit: the reference bench.py's audit threshold; the overflow case's
# rank and compact buffer
AUDIT_THRESHOLD = 0.375
OVERFLOW_RANK = 1000
OVERFLOW_K = 256
# the MPC phases: the keyed party's DB (the reference bench.py share-keyed
# default), the share key (high bits set), and the RFC 8439 section 2.3.2
# block as (stream id, row, block 1's 64 bytes)
KEYED_DB = 1_048_576
# equals mpc_iris_tpu.native.derive_insecure_key(12345), the seed-derived test key
SHARE_KEY = hashlib.sha256(b"mpc-iris-tpu/insecure-seed/v1"
                           + (12345).to_bytes(8, "little")).digest()
RFC_ROW = (0x09000000, 0x4a000000, bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e"))
# the out-of-core data party's device budget at batch_hint 8: below its
# 6.7 GB of planes, so the streamed chunk's transients are reserved first,
# and about half its planes after them
OOC_BUDGET = 6 * 2**30
# the sharded phase: D shards over the card's devices, repeated up to D; the
# 2-process party's share DB and the time its ranks may take together
SHARDS = 4
PARTY_SHARE_DB = 65_536
PARTY_TIMEOUT = 300
# host-wall repetitions of each sharded request and of its single-card twin
SHARDED_REPS = 10
# the protocol phase: the seconds its participant processes may take to
# start (engines built) and to stop, the deadline of one read round, and the
# repetitions of each timed request
PARTIES_START_S = 240
PARTIES_STOP_S = 60
ROUND_TIMEOUT_S = 60
PROTOCOL_REPS = 3
# the CLI phase: match's JSON DB (about 1.7 GB of JSON), and the MPC store,
# cut to 65,536 entries by disk: prepare writes 25.6 KB an entry to each of
# its 3 share files (5.0 GB here, 20 GB at 262,144); the seconds a
# coordinator or enroll process may take
CLI_DB = 262_144
CLI_STORE = 65_536
CLI_ROLE_S = 300
# the conformance phase: the golden set (its seed and distances, computed by
# the pure-Python oracle of tests/oracles.py); the interop fixture of
# tests/test_interop.py (8 entries and a query built from closed-form bytes)
# with its frozen answers, computed there by a plain-int spec of the
# reference: entry 1's distance and denominator records, the 8 decoded
# distances, and keystream rows (stream id, row) -> first 4 u16 under the key
# bytes(range(32)), those whose row kernel (d) reaches from a 32-bit row
# offset; a key for the golden set's keyed party; the library walkthrough at
# the MPC query's size (bench.py --mode share's default), cut when the host
# cannot hold its shares
GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "golden_distances.json")
INTEROP_ENTRIES, INTEROP_QUERY = 8, 9
FROZEN_DIST_RECORD_E1 = [
    64, 20, 65522, 65500, 4, 30, 65432, 62662, 6, 50, 10, 16, 12, 65474, 58,
    2559, 66, 65472, 6, 65532, 65528, 48, 6, 64468, 65436, 66, 32, 30, 18,
    65506, 36,
]
FROZEN_DEN_RECORD_E1 = [12342] * 15 + [12571] + [12342] * 15
FROZEN_DISTANCES = [
    0.43550478042456653, 0.3982181210723093, 0.2532004537352131,
    0.4519926815686898, 0.4224569711319552, 0.49659698590179874,
    0.48152649489547883, 0.437773456490034,
]
FROZEN_KEYED_ROWS = {
    (0, 0): [64825, 32043, 50649, 27161],
    (1, 1): [27390, 27408, 23409, 47431],
    (5, 1000): [60086, 61944, 29730, 63774],
    (2147483648, 4294967296): [1764, 10301, 43630, 27855],
    (4294967295, 3): [20680, 25815, 31232, 15733],
}
GOLDEN_KEY = bytes(range(7, 39))
DEMO_DB, DEMO_DB_CUT, DEMO_BATCH = 262_144, 65_536, 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn`` (which returns host data, so ends
    synchronized) over ``reps`` calls after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound(n_bytes: int, ops: int, rate: float):
    """The least time the card could take, ms: the larger of the bytes over
    the memory rate and the operations over their peak rate, and which."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def packed_bound(b: int, n: int, out_bytes: int):
    """Bound of a packed small-batch kernel, B queries over n entries: reads
    the packed DB (3,200 bytes an entry) and the int8 query planes once; the
    two int8 products over the 31 rotations, 2 ops a MAC."""
    return bound(2 * BITS_BYTES * n + 2 * b * 31 * BITS + out_bytes,
                 2 * 2 * b * 31 * BITS * n, INT8_OPS)


def packed_rate(b: int, n: int, ms: float) -> str:
    ops = 2 * 2 * b * 31 * BITS * n
    return f"{ops / ms / 1e9:.0f} int8 TOPS ({ops / ms / 1e9 / (INT8_OPS / 1e12):.1%} of peak)"


def query_l2_bytes(lib, b: int, n: int) -> int:
    """Bytes of query the packed match kernels read from L2 for a batch of b:
    an int8 kernel's block reads its group's 400 slabs of 2 x (32 x group) x
    32 bytes; the group of 8's two blocks of a tile read one 256 x 12,800
    query plane each; the binary kernel of a group of one reads its 64 x
    1,632-byte operand once a block (one block an SM, at most one a tile)."""
    total = 0
    for _, nq, qg in _launch_plan(b):
        if qg == 1:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            total += min(-(-n // lib.pk_tile_entries()), sms) * 64 * Q_ROW
            continue
        if qg == 8:
            total += -(-n // lib.packed_tile_entries(qg)) * 2 * 32 * qg * BITS
            continue
        n_tiles = -(-n // lib.packed_tile_entries(qg))
        total += -(-nq // qg) * n_tiles * 400 * 2 * 32 * qg * 32
    return total


def clocks_under(fn, calls: int) -> str:
    """SM clock and power draw, sampled by one-shot nvidia-smi queries from a
    thread while ``calls`` queued calls of ``fn`` run on the card."""
    fn()
    torch.cuda.synchronize()
    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.splitlines()
            if out and out[0].count(",") == 1:
                samples.append(tuple(float(v) for v in out[0].split(",")))

    for _ in range(calls):
        fn()
    sampler = threading.Thread(target=sample)
    sampler.start()
    torch.cuda.synchronize()
    done.set()
    sampler.join()
    if len(samples) < 2:  # the last sample may postdate the work
        return "not measured (too few nvidia-smi samples)"
    sm = [c for c, _ in samples[:-1]]
    return (f"{len(sm)} samples, SM clock median {np.median(sm):.0f} MHz "
            f"(min {min(sm):.0f}), power max {max(w for _, w in samples[:-1]):.1f} W")


def planes(qp: np.ndarray, qm: np.ndarray, dev: torch.device):
    return prepare_query_planes(torch.from_numpy(qp).to(dev), torch.from_numpy(qm).to(dev))


def triples(results) -> torch.Tensor:
    return torch.tensor([[r.numerator for r in results], [r.denominator for r in results],
                         [r.index for r in results]], dtype=torch.int32)


def rows(lists):
    return [[(m.index, m.distance, m.numerator, m.denominator) for m in row] for row in lists]


def overflow_threshold(nd: np.ndarray):
    """From one query's uint16 [2, N] spectrum: the f64 distance t of the
    entry at rank OVERFLOW_RANK, or the first after it whose exact fraction
    is not under its own f64 value, so that strict < excludes it. Returns
    (t, entry, its rank); at most that many entries lie under t."""
    dist = fractions_to_f64_np(nd[0], nd[1])
    order = np.argsort(dist, kind="stable")
    for rank in range(OVERFLOW_RANK, order.size):
        e = int(order[rank])
        t = float(dist[e])
        if not under_threshold_mask_np(nd[0, e:e + 1], nd[1, e:e + 1], t)[0]:
            return t, e, rank
    raise RuntimeError("no overflow threshold found")


def check_share_planes_kernel(dev: torch.device, chunk: int) -> int:
    """Kernel (d) against its plain version, bit for bit: a whole chunk, the
    three u64 nonce-carry positions at stream id 0xFFFFFFFE, and the RFC 8439
    block from the kernel. Returns the largest absolute difference (0)."""
    kw = key_tensor(SHARE_KEY, dev)
    err = 0
    for sid, row0, n in ((0, 0, chunk), (0xFFFFFFFE, 0xFFFFFF80, 128),
                         (0xFFFFFFFE, 0xFFFFFFC0, 128), (0xFFFFFFFE, 0xFFFFFFF0, 128)):
        got = share_planes_kernel(kw, sid, row0, n)
        want = share_planes_natural(kw, sid, row0, n)
        e = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
        check(e == 0, f"share_planes_kernel sid={sid:#x} row0={row0:#x} n={n}: "
              "kernel equals plain version")
        err = max(err, e)
    sid, row, block1 = RFC_ROW
    u16 = planes_to_shares(*share_planes_kernel(key_tensor(bytes(range(32)), dev),
                                                sid, row, 1))[0].cpu().numpy()
    words = [int(u16[w * 400 + 1]) | int(u16[6400 + w * 400 + 1]) << 16 for w in range(16)]
    check(np.array(words, "<u4").tobytes() == block1,
          "share_planes_kernel: RFC 8439 2.3.2 block from the kernel")
    print(f"kernel share_planes_kernel: equals the plain version on a {chunk}-row "
          "chunk and at the three carry positions (stream id 0xFFFFFFFE, high-bit "
          "key); RFC 8439 2.3.2 block 1 from the kernel")
    return err


def keyed_phase(dev: torch.device, qpat, qmsk, n: int, card: str) -> int:
    """A keyed party with nothing resident: every chunk regenerates through
    kernel (d). Returns the kernel's launches in the counted pass (B = 1)."""
    t0 = time.perf_counter()
    keyed = KeyedShareEngine(SHARE_KEY, 0, n, device=dev, hbm_budget=0)
    torch.cuda.synchronize()
    print(f"keyed party: {n} entries, chunk {keyed.chunk}, {keyed.resident_entries} "
          f"resident, built in {time.perf_counter() - t0:.2f} s")
    q1 = planes(qpat[:1], qmsk[:1], dev)[0]
    share_planes_kernel.launches = 0
    checksum = keyed.fold_pass_fn()(q1)
    launches = share_planes_kernel.launches
    print(f"launches in the keyed pass: {json.dumps({'share_planes_kernel': launches})}")
    check(launches == keyed.num_chunks(), "every keyed chunk regenerated through the kernel")
    for bb in (1, 8):
        q = planes(qpat[:bb], qmsk[:bb], dev)[0]
        got = int(keyed.fold_pass_fn()(q))
        want = int(keyed.dots(qpat[:bb], qmsk[:bb]).sum(dtype=np.uint64)) & 0xFFFFFFFF
        check(got == want, f"keyed fold pass B={bb}: checksum equals the sum of dots")
        check(bb > 1 or got == int(checksum), "keyed fold pass: the counted pass agrees")
        ms = wall_ms(lambda: keyed.fold_pass_fn()(q), 3)
        print(f"keyed fold pass N={n} B={bb}: checksum {got:#010x} equals the uint32 sum "
              f"of dots; {ms:.3f} ms (median of 3, host wall) [{card}]")
    # where the pass's time goes: one chunk's kernel, plain version and products
    kw = key_tensor(SHARE_KEY, dev)
    c = keyed.chunk
    lo, hi = share_planes_kernel(kw, 0, 0, c)
    for bb in (1, 8):
        q_nat = _queries_to_natural_k(planes(qpat[:bb], qmsk[:bb], dev)[0])
        m_ms = cuda_ms(lambda: _share_dots_chunk(q_nat, lo, hi), 10)
        print(f"time share products + reply block, one {c}-entry chunk B={bb}: {m_ms:.4f} ms "
              f"(CUDA events) [{card}]")
    return launches


def probe_phase(dev: torch.device, packed, qpat, qmsk, card: str) -> list:
    """The fused-regen probe kernels (scripts/fused_mm_regen_probe_torch.py's
    families): ``int8_gemm`` at the products of the scan (B = 128, one
    chunk) and of the keyed pass (B = 1 and 8), bit-equal to its plain
    version and to ``torch._int_mm``, and both ``keyed_share_dots`` variants
    on a 16,384-row chunk at B = 1 and 8 and at the three u64 carry
    positions, each bit-equal to its plain version; then the keyed party's
    whole 1,048,576-entry pass through each fused variant and through
    ``int8_gemm`` (the counted run), its checksum equal to
    ``KeyedShareEngine.fold_pass_fn``'s; then the times, ``int8_gemm``
    beside ``torch._int_mm`` at the three shapes and the keyed kernels
    beside kernel (d) alone and the unfused chunk. Returns the three
    kernels' entries of the kernels line."""
    t_phase = time.perf_counter()
    kw = key_tensor(SHARE_KEY, dev)
    chunk = packed.chunk
    q_nat = {bb: _queries_to_natural_k(planes(qpat[:bb], qmsk[:bb], dev)[0]).reshape(
        31 * bb, BITS) for bb in (1, 8)}
    lo, _ = share_planes_kernel(kw, 0, 0, chunk)
    q_enc = planes(qpat[:128], qmsk[:128], dev)[0]
    enc0, _ = packed._db.encoded(0)
    products = {"keyed B=1": (q_nat[1], lo), "keyed B=8": (q_nat[8], lo),
                "scan B=128": (_fused_rows(q_enc), enc0.contiguous())}
    gemm_err = 0
    for what, (a, b) in products.items():
        got = int8_gemm(a, b)
        err = int((got - int8_gemm_reference(a, b)).abs().max())
        check(err == 0 and torch.equal(got, torch._int_mm(a, b.T)),
              f"int8_gemm {what} {list(a.shape)} x {list(b.shape)}: kernel equals plain "
              "version and torch._int_mm")
        gemm_err = max(gemm_err, err)
    fused_err = dict.fromkeys(VARIANTS, 0)
    cases = [(0, 0, chunk, 1), (0, 0, chunk, 8)] + [
        (0xFFFFFFFE, r0, 128, 8) for r0 in (0xFFFFFF80, 0xFFFFFFC0, 0xFFFFFFF0)]
    for sid, row0, n, bb in cases:
        want = keyed_share_dots_reference(q_nat[bb], kw, sid, row0, n)
        for v in VARIANTS:
            err = int((keyed_share_dots(q_nat[bb], kw, sid, row0, n, variant=v) - want)
                      .abs().max())
            check(err == 0, f"keyed_share_dots[{v}] sid={sid:#x} row0={row0:#x} n={n} "
                  f"B={bb}: kernel equals plain version")
            fused_err[v] = max(fused_err[v], err)
    print("kernels int8_gemm (the scan's B = 128 products, the keyed B = 1 and 8 products) and "
          "keyed_share_dots (serial, pipelined; a chunk at B = 1 and 8, the three carry "
          "positions at stream id 0xFFFFFFFE): equal to their plain versions")

    # ---- the main path of the probe: the keyed pass through each family, counted
    keyed = KeyedShareEngine(SHARE_KEY, 0, KEYED_DB, device=dev, hbm_budget=0)
    want = {bb: int(keyed.fold_pass_fn()(planes(qpat[:bb], qmsk[:bb], dev)[0]))
            for bb in (1, 8)}
    int8_gemm.launches = 0
    keyed_share_dots.launches = dict.fromkeys(VARIANTS, 0)
    families = ("fused-serial", "fused-pipe", "gemm")
    sums = {(f, bb): keyed_pass_checksum(f, q_nat[bb], kw, 0, KEYED_DB, keyed.chunk)
            for f in families for bb in (1, 8)}
    launches = {"int8_gemm": int8_gemm.launches,
                **{f"keyed_share_dots_{v}": keyed_share_dots.launches[v] for v in VARIANTS}}
    print(f"launches in the probe's keyed passes: {json.dumps(launches)}")
    check(dev.type == "cpu" or all(v > 0 for v in launches.values()),
          "every probe kernel launched on its path")
    for (f, bb), got in sums.items():
        check(got == want[bb], f"keyed pass {f} N={KEYED_DB} B={bb}: checksum {got:#010x} "
              f"equals fold_pass_fn's {want[bb]:#010x}")
    print(f"keyed pass N={KEYED_DB} through fused-serial, fused-pipe and gemm at B=1, 8: "
          f"checksums equal fold_pass_fn's ({want[1]:#010x}, {want[8]:#010x})")
    for bb in (1, 8):
        q = planes(qpat[:bb], qmsk[:bb], dev)[0]
        times = {"fold_pass_fn": wall_ms(lambda: keyed.fold_pass_fn()(q), 3)}
        times.update({f: wall_ms(lambda: keyed_pass_checksum(f, q_nat[bb], kw, 0, KEYED_DB,
                                                             keyed.chunk), 3)
                      for f in families})
        print(f"time keyed pass N={KEYED_DB} B={bb} (median of 3, host wall): "
              + ", ".join(f"{f} {ms:.3f} ms" for f, ms in times.items()) + f" [{card}]")
    del keyed

    # ---- times (CUDA events)
    rows = {}
    for what, (a, b) in products.items():
        k_ms = cuda_ms(lambda: int8_gemm(a, b), 20)
        l_ms = cuda_ms(lambda: torch._int_mm(a, b.T), 20)
        p_ms = cuda_ms(lambda: int8_gemm_reference(a, b), 2)
        (m, k), n = a.shape, b.shape[0]
        b_ms, b_by = bound(m * k + n * k + 4 * m * n, 2 * m * n * k, INT8_OPS)
        rows[what] = (k_ms, l_ms, p_ms, b_ms, b_by)
        print(f"time kernel int8_gemm {what} [{m}, {k}] x [{n}, {k}]: {k_ms:.4f} ms, "
              f"torch._int_mm {l_ms:.4f} ms, plain {p_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / k_ms:.1%} of it [{card}]")
    entries = []
    k_ms, l_ms, p_ms, b_ms, b_by = rows["scan B=128"]
    entries.append({"name": "int8_gemm", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/int8_gemm.cu",
                    "replaces": ("scripts/mm_probe.py:49, scripts/mm_ktile_probe.py:34, "
                                 "scripts/mm_ktile_probe.py:69"),
                    "launches": launches["int8_gemm"], "max_abs_err": gemm_err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": l_ms})
    fused = {}
    d_ms = cuda_ms(lambda: share_planes_kernel(kw, 0, 0, chunk), 20)
    print(f"time kernel (d) share_planes_kernel alone, one {chunk}-row chunk: {d_ms:.4f} ms "
          f"[{card}]")
    for bb in (1, 8):
        q = q_nat[bb]
        u_ms = cuda_ms(lambda: _share_dots_chunk(q.reshape(bb, 31, BITS),
                                                 *share_planes_kernel(kw, 0, 0, chunk)), 10)
        m = 31 * bb
        # reads the query once, writes the int32 dots; the two int8 products;
        # CHACHA_OPS int32 ALU operations per 64-byte block, 400 a row
        b_ms, b_by = max(bound(m * BITS + 4 * m * chunk + 32, 4 * m * chunk * BITS, INT8_OPS),
                         bound(0, chunk * 400 * CHACHA_OPS, ALU_OPS))
        for v in VARIANTS:
            fused[v, bb] = cuda_ms(lambda: keyed_share_dots(q, kw, 0, 0, chunk, variant=v), 20)
            print(f"time kernel keyed_share_dots[{v}] one {chunk}-row chunk B={bb}: "
                  f"{fused[v, bb]:.4f} ms; kernel (d) alone {d_ms:.4f} ms; unfused chunk "
                  f"(kernel (d), then the share products and reply block) {u_ms:.4f} ms; "
                  f"bound {b_ms:.4f} ms ({b_by}), "
                  f"{b_ms / fused[v, bb]:.1%} of it [{card}]")
    p_ms = cuda_ms(lambda: keyed_share_dots_reference(q_nat[8], kw, 0, 0, chunk), 2)
    for v in VARIANTS:
        entries.append({"name": f"keyed_share_dots_{v}", "route": "cuda",
                        "source": "mpc_iris_tpu_torch/csrc/keyed_share_dot.cu",
                        "replaces": ("scripts/fused_regen_probe.py:113" if v == "serial"
                                     else "scripts/fused_regen_probe.py:131"),
                        "launches": launches[f"keyed_share_dots_{v}"],
                        "max_abs_err": fused_err[v], "ms": fused[v, 8], "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    print(f"probe phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


def b1_select_probe_phase(dev: torch.device, packed, qpat, qmsk, seed: int, card: str) -> list:
    """The B = 1 packed-dot probe kernels (scripts/b1_kernel_probe_torch.py)
    and the select compare probes (scripts/select_variants_torch.py,
    select_i16_probe_torch.py). The counted run: ``pk_dot`` (+ its epilogue)
    and ``pk_select`` over the whole packed DB viewed as [N, 1600] at B = 1;
    ``select_variant`` with each compare at S1_SHAPE and ``select_lanes``
    with each tree at S2_SHAPE, their inputs made on the card from the seed.
    Then: pk_select's winner (the kernel match_packed_small_b now launches
    for a group of one query) equals three references, its plain version,
    the unfused scan and the int8 match kernel at a group of 2 with one query
    (``match_packed_int8_pairs``); pk_dot's has pk_select's index and exact
    fraction; both kernels' outputs of the counted run equal their plain
    versions over the whole DB (the plain versions unpack it in pieces);
    every select probe
    equals its plain version at its shape, on a tie-heavy block at tile_n
    2,048 and 128 (s1) and with an int16 wrap (s2), and f32 keeps the
    first of the pair that int32 resolves; then the times, p1 and p2 beside
    the int8 kernel at one query, s1 and s2 beside (a) on s1's inputs.
    Returns the seven kernels' entries of the kernels line."""
    t_phase = time.perf_counter()
    pat, msk = (p.reshape(-1, BITS_BYTES) for p in packed._db.planes)
    n = pat.shape[0]
    qp, qm = (torch.from_numpy(x[:1].copy()).to(dev) for x in (qpat, qmsk))
    qe, qmk = prep_query(qp, qm)
    q_enc, q_mask = prepare_query_planes(qp, qm)
    s1_dot, s1_den = probe_inputs(*S1_SHAPE, seed, dev)
    s2_dot, s2_den = probe_inputs(*S2_SHAPE, seed + 1, dev, torch.int16)

    # ---- the probes' paths, counted
    pk_dot.launches = pk_select.launches = 0
    select_variant.launches = dict.fromkeys(COMPARES, 0)
    select_lanes.launches = dict.fromkeys(TREES, 0)
    p1_packed = pk_dot(qe, qmk, pat, msk)
    p1 = pk_dot_winner(p1_packed)
    p2 = pk_select(qe, qmk, pat, msk)
    s1 = {c: torch.stack(select_variant(s1_dot, s1_den, 0, c)) for c in COMPARES}
    s2 = {t: select_lanes(s2_dot, s2_den, t == "i16") for t in TREES}
    launches = {"pk_dot": pk_dot.launches, "pk_select": pk_select.launches,
                **{f"select_variant_{c}": select_variant.launches[c] for c in COMPARES},
                **{f"select_lanes_{t}": select_lanes.launches[t] for t in TREES}}
    print(f"launches in the b1 and select probes' run: {json.dumps(launches)}")
    check(dev.type == "cpu" or all(v > 0 for v in launches.values()),
          "every b1 and select probe kernel launched on its path")

    # ---- correctness
    int8_one = match_packed_int8_pairs(q_enc, q_mask, *packed._db.planes)
    check(torch.equal(p2, int8_one), f"pk_select N={n}: winner {p2.ravel().tolist()} equals "
          f"the int8 kernel at qg=2, nq=1 {int8_one.ravel().tolist()}")
    check(torch.equal(p2, _match_scan_packed(q_enc, q_mask, *packed._db.planes, fused=False)),
          "pk_select: equals the unfused scan")
    (n1, d1, i1), (n2, d2, i2) = p1.ravel().tolist(), p2.ravel().tolist()
    check(i1 == i2 and n1 * d2 == n2 * d1 and d1 > 0,
          f"pk_dot N={n}: winner {p1.ravel().tolist()} has pk_select's index and fraction")
    print(f"pk_select N={n} B=1: winner {p2.ravel().tolist()} equals the int8 kernel at a "
          f"group of 2 with one query and the unfused scan; pk_dot's {p1.ravel().tolist()} "
          f"the same index and fraction "
          f"(pairs {'equal' if (n1, d1) == (n2, d2) else 'differ: a rotation tie'})")
    err = {}
    err["pk_dot"] = int((p1_packed.long() - pk_dot_reference(qe, qmk, pat, msk).long())
                        .abs().max())
    del p1_packed
    err["pk_select"] = int((p2 - pk_select_reference(qe, qmk, pat, msk)).abs().max())
    check(err["pk_dot"] == 0 and err["pk_select"] == 0,
          f"pk_dot, pk_select N={n}: the counted run's outputs equal their plain versions")
    print(f"pk_dot [32, {n}] and pk_select: the counted run's outputs equal their plain "
          "versions over the whole DB")
    t_dot, t_den = (torch.from_numpy(x).to(dev) for x in tie_case(*TIE_SHAPE))
    for c in COMPARES:
        err[f"select_variant_{c}"] = int((s1[c] - torch.stack(select_variant_reference(
            s1_dot, s1_den, 0, c))).abs().max())
        for tile_n in (2048, 128):
            got = torch.stack(select_variant(t_dot, t_den, 3, c, tile_n))
            e = int((got - torch.stack(select_variant_reference(t_dot, t_den, 3, c, tile_n)))
                    .abs().max())
            err[f"select_variant_{c}"] = max(err[f"select_variant_{c}"], e)
            check(got[:, 0, 0].tolist() == ([12799, 12800, 3] if c == "f32"
                                            else [12798, 12799, 1027]),
                  f"select_variant {c} tile_n={tile_n}: the f32 disagreement pair")
            check(got[:, 1, 0].tolist() == ([0, 2, 260] if tile_n == 2048 else [0, 4, 132]),
                  f"select_variant {c} tile_n={tile_n}: the congruent duplicates")
        check(err[f"select_variant_{c}"] == 0, f"select_variant {c}: kernel equals its plain "
              f"version at {list(s1_dot.shape)} and on the tie block")
    t_dot, t_den = (torch.from_numpy(x).to(dev) for x in tie_case(*TIE_SHAPE, dtype=np.int16))
    t_dot[5, 7] = -20_000  # den - dot = 32,800: wraps in the int16 tree
    for t in TREES:
        i16 = t == "i16"
        e = max(int((s2[t] - select_lanes_reference(s2_dot, s2_den, i16)).abs().max()),
                int((select_lanes(t_dot, t_den, i16)
                     - select_lanes_reference(t_dot, t_den, i16)).abs().max()))
        err[f"select_lanes_{t}"] = e
        check(e == 0, f"select_lanes {t}: kernel equals its plain version at "
              f"{list(s2_dot.shape)}, on the tie block and the int16 wrap")
    print("kernels select_variant (i32, f32, f32_exact) and select_lanes (i32, i16): equal "
          "to their plain versions at the probes' shapes, on the tie block and the wrap; "
          "f32 keeps 12,799/12,800 where i32 takes 12,798/12,799; the trees agree: "
          f"{torch.equal(s2['i32'], s2['i16'])}")

    # ---- times (CUDA events)
    b_ms = cuda_ms(lambda: match_packed_int8_pairs(q_enc, q_mask, *packed._db.planes), 10)
    w_ms = cuda_ms(lambda: pk_dot_winner(pk_dot(qe, qmk, pat, msk)), 5)
    rows = {"pk_dot": (lambda: pk_dot(qe, qmk, pat, msk),
                       lambda: pk_dot_reference(qe, qmk, pat, msk),
                       bound(2 * BITS_BYTES * n + 2 * 32 * BITS + 4 * 32 * n,
                             2 * 2 * 32 * BITS * n, INT8_OPS),
                       "scripts/b1_kernel_probe.py:97", "b1_packed.cu"),
            "pk_select": (lambda: pk_select(qe, qmk, pat, msk),
                          lambda: pk_select_reference(qe, qmk, pat, msk),
                          packed_bound(1, n, 12),
                          "scripts/b1_kernel_probe.py:144", "b1_packed.cu")}
    s1_bytes, s2_bytes = 8 * s1_dot.numel(), 4 * s2_dot.numel()
    for c in COMPARES:
        rows[f"select_variant_{c}"] = (
            lambda c=c: select_variant(s1_dot, s1_den, 0, c),
            lambda c=c: select_variant_reference(s1_dot, s1_den, 0, c),
            bound(s1_bytes + 12 * S1_SHAPE[0],
                  (NUMERATOR_OPS + COMPARE_OPS[c]) * s1_dot.numel(), ALU_OPS),
            "scripts/select_variants.py:66", "select_probes.cu")
    for t in TREES:
        rows[f"select_lanes_{t}"] = (
            lambda t=t: select_lanes(s2_dot, s2_den, t == "i16"),
            lambda t=t: select_lanes_reference(s2_dot, s2_den, t == "i16"),
            bound(s2_bytes + 4 * LANES_OUT * S2_SHAPE[0],
                  (NUMERATOR_OPS + COMPARE_OPS["i32"]) * s2_dot.numel(), ALU_OPS),
            "scripts/select_i16_probe.py:18", "select_probes.cu")
    a_ms = cuda_ms(lambda: select_chunk(s1_dot, s1_den, 0), 20)
    entries = []
    for name, (kernel, plain, (b_lo, b_by), replaces, src) in rows.items():
        k_ms = cuda_ms(kernel, 10)
        p_ms = cuda_ms(plain, 1)
        beside = (f"the int8 match kernel at qg=2, nq=1 {b_ms:.4f} ms" if name.startswith("pk_")
                  else f"kernel (a) select_chunk on the same inputs {a_ms:.4f} ms")
        print(f"time kernel {name}: {k_ms:.4f} ms, plain {p_ms:.3f} ms; bound {b_lo:.4f} ms "
              f"({b_by}), {b_lo / k_ms:.1%} of it; {beside} [{card}]")
        entries.append({"name": name, "route": "cuda",
                        "source": f"mpc_iris_tpu_torch/csrc/{src}", "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err[name], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_lo, "bound_by": b_by,
                        "library_ms": None})
    print(f"time pk_dot with its epilogue pk_dot_winner N={n}: {w_ms:.4f} ms [{card}]")
    print(f"pk_dot design: binary, {50 * n} mma.sync m16n8k256 b1 (4 AND-popcount products "
          f"of 12,800 bits for 32 positions, 50 an entry); its floor is the function's bound, "
          f"{rows['pk_dot'][2][0]:.4f} ms (the packed DB read once): NVIDIA gives no b1 rate, "
          "and at the one scripts/b1_packed_variants_torch.py measures the products take less")
    print(f"b1 and select probe phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


def stream_probe_phase(dev: torch.device, seed: int, card: str) -> list:
    """The streaming, morph and bisect probes (scripts/dma_probe_torch.py,
    morph_probe_torch.py, select_bisect_torch.py). The counted run: every
    variant of the probes' mains once, ``dma_variant`` x9, ``morph_stage`` x6
    (morph_probe.py's main), ``morph2`` x5 (main2), ``morph3`` x2 (main3) on
    STREAM_SHAPE int32 inputs in dma_probe.py's ranges, ``bisect`` x10 (five
    modes at tiles (8, 2,048) and (4, 8,192)) on BISECT_SHAPE in
    select_bisect.py's, made on the card from the seed. Then every output
    against its plain version on the card, bit for bit; then each variant's
    time and its bound (the inputs read once: 0.3205 ms, 0.160 for one
    input), beside kernel (a) and s1's ``select_variant("i32")`` on the same
    inputs. Returns the five functions' entries of the kernels line, each
    with the time of its STREAM_ENTRY variant and the largest error of all."""
    t_phase = time.perf_counter()
    m_dot, m_den = stream_inputs(*STREAM_SHAPE, seed, dev, STREAM_RANGES)
    b_dot, b_den = stream_inputs(BISECT_SHAPE[0] * 32, BISECT_SHAPE[1], seed + 1, dev,
                                 BISECT_RANGES)
    runs = {p: stream_probes.main_variants(p, m_dot, m_den) for p in stream_probes.PROBES[:4]}
    runs["bisect"] = stream_probes.main_variants("bisect", b_dot, b_den)
    fns = {p: getattr(stream_probes, p) for p in stream_probes.PROBES}

    # ---- the probes' mains, counted
    for fn in fns.values():
        fn.launches = 0
    outs = {p: [kernel() for _, kernel, _ in variants] for p, variants in runs.items()}
    launches = {p: fn.launches for p, fn in fns.items()}
    print(f"launches in the stream probes' run: {json.dumps(launches)}")
    check(dev.type == "cpu" or all(launches[p] == len(runs[p]) for p in runs),
          "every stream probe variant launched its kernel once")

    # ---- correctness
    err = {}
    for p, variants in runs.items():
        err[p] = 0
        for (label, _, plain), got in zip(variants, outs[p]):
            want = plain()
            got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
            check(len(got) == len(want) and all(g.shape == w.shape for g, w in zip(got, want)),
                  f"{p} {label}: shapes of its plain version")
            e = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            check(e == 0, f"{p} {label}: kernel equals its plain version")
            err[p] = max(err[p], e)
    print("kernels dma_variant (9 variants), morph_stage (stages 0-5), morph2 (5), morph3 (2), "
          "bisect (5 modes x 2 tiles): every output bit-equal to its plain version at "
          f"{list(STREAM_SHAPE)} and [{BISECT_SHAPE[0] * 32}, {BISECT_SHAPE[1]}]")

    # ---- times (CUDA events), beside (a) and s1 on the same inputs
    beside = {}
    for name, (dot, den) in (("dma_probe/morph_probe", (m_dot, m_den)),
                             ("select_bisect", (b_dot, b_den))):
        a_ms = cuda_ms(lambda: select_chunk(dot, den, 0), 20)
        s1_ms = cuda_ms(lambda: select_variant(dot, den, 0, "i32"), 20)
        beside[name] = f"(a) {a_ms:.4f} ms, s1 i32 {s1_ms:.4f} ms on the same inputs"
        print(f"time on the {name} inputs: kernel (a) select_chunk {a_ms:.4f} ms, "
              f"select_variant i32 {s1_ms:.4f} ms [{card}]")
    compute = {"morph_stage": ("stage 3", "stage 4", "stage 5"), "morph2": ("compute", "=select"),
               "morph3": ("replica",), "bisect": ("full",)}
    entries = []
    for p, variants in runs.items():
        dot = b_dot if p == "bisect" else m_dot
        where = "select_bisect" if p == "bisect" else "dma_probe/morph_probe"
        for label, kernel, plain in variants:
            n_in = 1 if label.startswith("1in") else 2
            trees = any(k in label for k in compute.get(p, ()))
            b_lo, b_by = bound(n_in * 4 * dot.numel(),
                               (NUMERATOR_OPS + COMPARE_OPS["i32"]) * dot.numel() if trees
                               else 0, ALU_OPS)
            k_ms = cuda_ms(kernel, 10)
            p_ms = cuda_ms(plain, 1)
            print(f"time kernel {p} {label}: {k_ms:.4f} ms, plain {p_ms:.3f} ms; bound "
                  f"{b_lo:.4f} ms ({b_by}), {b_lo / k_ms:.1%} of it; {beside[where]} [{card}]")
            if label == STREAM_ENTRY[p][0]:
                entries.append({"name": p, "route": "cuda",
                                "source": "mpc_iris_tpu_torch/csrc/stream_probes.cu",
                                "replaces": STREAM_ENTRY[p][1], "launches": launches[p],
                                "max_abs_err": err[p], "ms": k_ms, "plain_ms": p_ms,
                                "bound_ms": b_lo, "bound_by": b_by, "library_ms": None})
    check(len(entries) == len(runs), "every stream probe function has its entry")
    print(f"stream probe phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


def to_card(stream, dev: torch.device) -> torch.Tensor:
    """The coordinator's side: each received chunk to the card as it comes
    (the streams' host blocks are pinned), joined there."""
    return torch.cat([torch.from_numpy(b.view(np.int16)).to(dev) for b in stream])


def mpc_query(parties, masks, qp, qm, dev: torch.device):
    """One MPC query: every party's entry-major stream and the masks
    engine's, then the coordinator's batched decode steps on the card.
    Returns (winners int32 [3, B], spectrum [2, N, B]) on the host."""
    shares = tuple(to_card(p.stream(qp, qm, entry_major=True), dev) for p in parties)
    den = to_card(masks.stream(qm, entry_major=True), dev)
    return (_sum_decode_argmin_device_batch(shares, den).cpu(),
            _sum_decode_minfrac_device_batch(shares, den).cpu())


def mpc_phase(dev: torch.device, pat, msk, planted, dup, qpat, qmsk, card: str):
    """One 3-party MPC query (B = 8) on the card. Returns kernel (d)'s
    launches in the counted query, the data-carrying share (host), the
    winners and the query's host wall time."""
    n = pat.shape[0]
    t0 = time.perf_counter()
    data_share = share_split_device(pat, msk, 3, SHARE_KEY, device=dev, shares=[2])[0]
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    half = 2 * BITS * DEFAULT_CHUNK * (-(-n // DEFAULT_CHUNK) // 2)
    parties = [KeyedShareEngine(SHARE_KEY, 0, n, device=dev, hbm_budget=half),
               KeyedShareEngine(SHARE_KEY, 1, n, device=dev, hbm_budget=half),
               ShareEngine(data_share, device=dev)]
    masks = MasksEngine(msk, device=dev)
    plain = PlaintextEngine(pat, msk, device=dev, storage="packed")
    torch.cuda.synchronize()
    print(f"mpc: {n} entries; data share split on the card in {split_s:.2f} s "
          f"({data_share.nbytes / 2**30:.2f} GiB to the host); parties resident "
          f"{[p.resident_entries for p in parties]}, masks {masks.storage}; engines "
          f"built in {time.perf_counter() - t0:.2f} s; device memory "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")

    def query(qp, qm):
        return mpc_query(parties, masks, qp, qm, dev)

    bb = N_PLANTED
    share_planes_kernel.launches = 0
    win, nd = query(qpat[:bb], qmsk[:bb])
    launches = share_planes_kernel.launches
    print(f"launches in the MPC query: {json.dumps({'share_planes_kernel': launches})}")
    check(launches > 0, "the keyed parties' tails regenerated through the kernel")
    want = triples(plain.match(qpat[:bb], qmsk[:bb]))
    check(torch.equal(win, want), "mpc: winners equal PlaintextEngine.match")
    check(win[2].tolist() == list(planted[:bb]) and not win[0].any(),
          "mpc: planted self-matches at distance 0.0, the duplicate at its lower index")
    spectrum = plain.min_fractions(qpat[:bb], qmsk[:bb]).astype(np.int64)
    check(np.array_equal(nd.numpy().transpose(0, 2, 1), spectrum),
          "mpc: per-entry spectrum equals PlaintextEngine.min_fractions")
    ms = wall_ms(lambda: query(qpat[:bb], qmsk[:bb]), 3)
    print(f"mpc query N={n} B={bb}: winners equal PlaintextEngine.match, planted at 0.0, "
          f"duplicate {planted[0]}/{dup} -> {int(win[2, 0])}; spectrum equals "
          f"min_fractions; {ms:.3f} ms (median of 3, host wall; the three parties "
          f"and the coordinator one after another in one process) [{card}]")
    for i, p in enumerate(parties):
        p_ms = wall_ms(lambda: list(p.stream(qpat[:bb], qmsk[:bb], entry_major=True)), 3)
        print(f"  party {i} ({type(p).__name__}, {p.resident_entries} resident) stream: "
              f"{p_ms:.3f} ms [{card}]")
    m_ms = wall_ms(lambda: list(masks.stream(qmsk[:bb], entry_major=True)), 3)
    print(f"  masks stream: {m_ms:.3f} ms [{card}]")

    # party 2 again under the default budget policy, cut so that only part
    # of it is resident: the tail streams host -> card through the prefetch
    # worker, before and after a refresh, equal to the resident party
    prev = os.environ.get("MPC_IRIS_HBM_BUDGET")
    os.environ["MPC_IRIS_HBM_BUDGET"] = str(OOC_BUDGET)
    try:
        ooc = ShareEngine(data_share, device=dev, batch_hint=bb)
    finally:
        os.environ.pop("MPC_IRIS_HBM_BUDGET")
        if prev is not None:
            os.environ["MPC_IRIS_HBM_BUDGET"] = prev
    check(0 < ooc.resident_entries < n, "out-of-core party: part resident, part streamed")
    want = to_card(parties[2].stream(qpat[:bb], qmsk[:bb], entry_major=True), dev)
    for when in ("before", "after"):
        got = to_card(ooc.stream(qpat[:bb], qmsk[:bb], entry_major=True), dev)
        check(torch.equal(got, want), f"out-of-core party {when} refresh: stream equals "
              "the resident party's")
        ooc.refresh(data_share)
    o_ms = wall_ms(lambda: list(ooc.stream(qpat[:bb], qmsk[:bb], entry_major=True)), 3)
    print(f"  party 2 out of core ({ooc.resident_entries} of {n} resident, budget "
          f"{OOC_BUDGET / 2**30:.0f} GiB, default policy, prefetch on): stream equals the "
          f"resident party's before and after a refresh; {o_ms:.3f} ms [{card}]")
    return launches, data_share, win, ms


def result_rows(results):
    return [(r.index, r.distance, r.numerator, r.denominator) for r in results]


def cross_shard_pair(n: int, chunk: int, taken) -> tuple[int, int]:
    """(lower, higher) DB indices of a duplicate pair on different shards
    of the strided D-shard layout: the lower on the last shard, the higher
    on shard 0 near the DB's end, both clear of ``taken``."""
    lo = (SHARDS - 1) * chunk + 77
    hi = (n // chunk - SHARDS) * chunk + 123
    check(lo < hi and (lo // chunk) % SHARDS == SHARDS - 1 and (hi // chunk) % SHARDS == 0
          and not {lo, hi} & set(int(t) for t in taken), "cross-shard duplicate pair")
    return lo, hi


def shard_devices() -> list[torch.device]:
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(SHARDS)]


def party_devices() -> list[torch.device]:
    """The protocol phase's participant p on card p % device_count."""
    return [torch.device("cuda", p % torch.cuda.device_count()) for p in range(3)]


def check_shard_kernels(engines, sq, sm) -> dict:
    """Kernels (b) and (c) against their plain versions, bit for bit, on
    every shard's own slab at the shapes the sharded engines give them:
    ``engines`` is a list of (engine, mesh label, query row slices, one a
    launch). Returns each kernel's largest absolute difference (0)."""
    pairs = ((match_packed_small_b, match_packed_small_b_reference),
             (fractions_packed_small_b, fractions_packed_small_b_reference))
    err = {k.__name__: 0 for k, _ in pairs}
    for eng, shape, slices in engines:
        for i, per_dev in eng._db.items():
            for d_, db in per_dev.items():
                a, b = db.planes
                for rows_ in slices:
                    q_enc, q_mask = planes(sq[rows_], sm[rows_], d_)
                    for kern, ref in pairs:
                        got, want = kern(q_enc, q_mask, a, b), ref(q_enc, q_mask, a, b)
                        e = int((got.int() - want.int()).abs().max())
                        check(e == 0, f"{kern.__name__} on shard {i} of {shape} "
                              f"[{a.shape[0]} x {a.shape[1]}] B={q_enc.shape[0]}: kernel "
                              "equals plain version")
                        err[kern.__name__] = max(err[kern.__name__], e)
                        del got, want
    return err


def sharded_match_phase(dev, packed, pat, msk, planted, xpair, qpat, qmsk, card):
    """ShardedPlaintextEngine over the packed DB on D shards: match at B = 1,
    8 (kernel (b) per shard) and 13 (the scan through kernel (a) per shard),
    B = 8 on a (D/2, 2) mesh, min_fractions at B = 1 and find_under at B = 8
    (kernel (c) per shard), each bit-equal to the single-card engine. Row 0
    of the queries is the lower entry of a duplicate pair across shards,
    rows 1-8 the planted self-matches. Then kernels (b) and (c) on every
    shard's slab against their plain versions. Returns the kernels'
    launches and the largest differences of (b) and (c)."""
    devices = shard_devices()
    t0 = time.perf_counter()
    eng = ShardedPlaintextEngine(pat, msk, make_mesh(SHARDS, devices=devices))
    wide = ShardedPlaintextEngine(pat, msk, make_mesh(SHARDS // 2, 2, devices=devices))
    torch.cuda.synchronize()
    print(f"sharded: {SHARDS} shards on {[str(d) for d in devices]}, chunk {eng.chunk}, "
          f"{eng.g_blocks} chunks a shard, and a ({SHARDS // 2}, 2) mesh; built in "
          f"{time.perf_counter() - t0:.2f} s. " + (
              "One card runs the shards one after another, so the times below measure "
              "the sharded layer's overhead, not scaling" if len(set(devices)) == 1 else
              f"{len(set(devices))} cards run the shards side by side"))
    xl, xh = xpair
    sq = np.concatenate([pat[xl:xl + 1], qpat[:12]])
    sm = np.concatenate([msk[xl:xl + 1], qmsk[:12]])
    requests = [(eng, "(4, 1)", 1), (eng, "(4, 1)", 8), (eng, "(4, 1)", 13), (wide, "(2, 2)", 8)]
    counted = (select_chunk, match_packed_small_b, fractions_packed_small_b)

    for fn in counted:
        fn.launches = 0
    served = [e.match(sq[:bb], sm[:bb]) for e, _, bb in requests]
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"launches in the sharded match run: {json.dumps(launches)}")
    check(launches["select_chunk"] > 0 and launches["match_packed_small_b"] > 0,
          "kernels (a) and (b) launched on the sharded match path")
    for fn in (*counted, launch_fractions):
        fn.launches = 0
    spectrum = eng.min_fractions(sq[:1], sm[:1])
    under = eng.find_under(sq[:8], sm[:8], AUDIT_THRESHOLD)
    audit = {fn.__name__: fn.launches for fn in (*counted, launch_fractions)}
    print(f"launches in the sharded audit run: {json.dumps(audit)}")
    check(audit["fractions_packed_small_b"] > 0 and audit["launch_fractions"] > 0,
          "kernel (c) and its B = 1 kernel pk_fractions launched on the sharded audit path")
    launches["fractions_packed_small_b"] = audit["fractions_packed_small_b"]
    launches["pk_fractions"] = audit["launch_fractions"]

    for (e, shape, bb), res in zip(requests, served):
        check(result_rows(res) == result_rows(packed.match(sq[:bb], sm[:bb])),
              f"sharded {shape} B={bb}: winners bit-equal to the single-card engine")
        want = [(xl, 0.0)] + [(int(p), 0.0) for p in planted[:min(bb, 9) - 1]]
        check([(r.index, r.distance) for r in res[:9]] == want,
              f"sharded {shape} B={bb}: planted self-matches at 0.0, duplicate {xl}/{xh} "
              f"-> {res[0].index}")
        print(f"sharded request {shape} B={bb}: winners bit-equal to the single-card engine; "
              f"planted self-matches at 0.0; cross-shard duplicate {xl} (shard "
              f"{(xl // e.chunk) % e.n_shards}) / {xh} (shard {(xh // e.chunk) % e.n_shards}) -> "
              f"{res[0].index}")
    check(np.array_equal(spectrum, packed.min_fractions(sq[:1], sm[:1])),
          "sharded min_fractions B=1: spectrum bit-equal to the single-card engine")
    check(rows(under) == rows(packed.find_under(sq[:8], sm[:8], AUDIT_THRESHOLD)),
          "sharded find_under B=8: lists equal the single-card engine's")
    check([(m.index, m.distance) for m in under[0][:2]] == [(xl, 0.0), (xh, 0.0)],
          "sharded find_under: the cross-shard duplicates in index order")
    print(f"sharded audit: min_fractions B=1 bit-equal, find_under B=8 t={AUDIT_THRESHOLD} "
          f"equal to the single-card engine ({sum(map(len, under))} hits)")
    err = check_shard_kernels([(eng, "(4, 1)", (slice(0, 1), slice(0, 8))),
                               (wide, "(2, 2)", (slice(0, 4), slice(4, 8)))], sq, sm)
    print(f"kernels match_packed_small_b, fractions_packed_small_b: equal their plain "
          f"versions on every shard's slab ({eng.g_blocks} x {eng.chunk} on (4, 1) at B = 1 "
          f"and 8, {wide.g_blocks} x {wide.chunk} on (2, 2) at B = 4 a column, the "
          "sharded queries)")

    for e, shape, bb in requests:
        s_ms = wall_ms(lambda: e.match(sq[:bb], sm[:bb]), SHARDED_REPS)
        p_ms = wall_ms(lambda: packed.match(sq[:bb], sm[:bb]), SHARDED_REPS)
        print(f"time sharded request {shape} N={e.count} B={bb}: {s_ms:.3f} ms, single-card "
              f"{p_ms:.3f} ms (median of {SHARDED_REPS}, host wall) [{card}]")
    for bb in (1, 8):
        s_ms = wall_ms(lambda: eng.find_under(sq[:bb], sm[:bb], AUDIT_THRESHOLD), SHARDED_REPS)
        p_ms = wall_ms(lambda: packed.find_under(sq[:bb], sm[:bb], AUDIT_THRESHOLD),
                       SHARDED_REPS)
        print(f"time sharded find_under (4, 1) B={bb}: {s_ms:.3f} ms, single-card {p_ms:.3f} "
              f"ms (median of {SHARDED_REPS}, host wall) [{card}]")
    tri = [torch.randint(0, 12800, (3, 8), dtype=torch.int32, device=dev) for _ in range(SHARDS)]
    f_ms = cuda_ms(lambda: fraction_allmin(*zip(*tri), dev), 20)
    print(f"time fraction_allmin over {SHARDS} shards B=8: {f_ms:.4f} ms (CUDA events) [{card}]")
    return launches, err


def sharded_keyed_phase(dev, qpat, qmsk, n, card) -> int:
    """ShardedKeyedShareEngine at n entries on D shards, every chunk through
    kernel (d): the fold-pass checksum at B = 1 and 8 equals the single-card
    KeyedShareEngine's. Returns (d)'s launches in the counted pass (B = 1)."""
    keyed = ShardedKeyedShareEngine(SHARE_KEY, 0, n, make_mesh(SHARDS, devices=shard_devices()))
    single = KeyedShareEngine(SHARE_KEY, 0, n, device=dev, hbm_budget=0)
    q1 = planes(qpat[:1], qmsk[:1], dev)[0]
    share_planes_kernel.launches = 0
    checksum = keyed.fold_pass_fn()(q1)
    launches = share_planes_kernel.launches
    print(f"launches in the sharded keyed pass: {json.dumps({'share_planes_kernel': launches})}")
    check(launches == keyed.num_blocks() * SHARDS,
          "sharded keyed pass: one kernel (d) launch per chunk")
    for bb in (1, 8):
        q = planes(qpat[:bb], qmsk[:bb], dev)[0]
        got = int(keyed.fold_pass_fn()(q))
        check(got == int(single.fold_pass_fn()(q)) and (bb > 1 or got == int(checksum)),
              f"sharded keyed pass B={bb}: checksum equals the single-card engine's")
        s_ms = wall_ms(lambda: keyed.fold_pass_fn()(q), SHARDED_REPS)
        p_ms = wall_ms(lambda: single.fold_pass_fn()(q), SHARDED_REPS)
        print(f"sharded keyed pass N={n} B={bb}: checksum {got:#010x} equals the single-card "
              f"engine's; {s_ms:.3f} ms, single-card {p_ms:.3f} ms (median of {SHARDED_REPS}, "
              f"host wall) [{card}]")
    return launches


def sharded_mpc_phase(dev, dmsk, data_share, dqpat, dqmsk, want_win, single_ms, card) -> int:
    """One 3-party MPC query (B = 8) over sharded parties: two keyed, one
    data share, and a sharded masks engine; the coordinator's decode steps
    on the card. The winners equal the single-card MPC query's. Returns
    kernel (d)'s launches in the counted query."""
    mesh = make_mesh(SHARDS, devices=shard_devices())
    n = data_share.shape[0]
    parties = [ShardedKeyedShareEngine(SHARE_KEY, 0, n, mesh),
               ShardedKeyedShareEngine(SHARE_KEY, 1, n, mesh),
               ShardedShareEngine(data_share, mesh)]
    masks = ShardedMasksEngine(dmsk, mesh)
    bb = N_PLANTED
    share_planes_kernel.launches = 0
    win, _ = mpc_query(parties, masks, dqpat[:bb], dqmsk[:bb], dev)
    launches = share_planes_kernel.launches
    print(f"launches in the sharded MPC query: {json.dumps({'share_planes_kernel': launches})}")
    check(launches == 2 * parties[0].num_blocks() * SHARDS,
          "sharded MPC query: every keyed chunk regenerated through kernel (d)")
    check(torch.equal(win, want_win), "sharded MPC query: winners equal the single-card query's")
    ms = wall_ms(lambda: mpc_query(parties, masks, dqpat[:bb], dqmsk[:bb], dev), 3)
    print(f"sharded mpc query N={n} B={bb}: winners equal the single-card query's; "
          f"{ms:.3f} ms, single-card {single_ms:.3f} ms (median of 3, host wall) [{card}]")
    return launches


def served_round_ms(times: list, rounds: int) -> str:
    """The Coordinator's per-read-round times (``Coordinator.round_times``)
    of ``rounds`` served connection rounds: medians a read round, and sums
    a connection round."""
    st, up, dec = (np.array(c, dtype=np.float64) for c in zip(*times))
    return (f"{len(times)} read rounds ({len(times) / rounds:g} a connection round): a read "
            f"round, median pinned staging {np.median(st):.3f} ms (host wall), upload "
            f"{np.median(up):.3f} ms, decode step {np.median(dec):.3f} ms (CUDA events); a "
            f"connection round, staging {st.sum() / rounds:.3f}, upload "
            f"{up.sum() / rounds:.3f}, decode {dec.sum() / rounds:.3f} ms")


def plain_server(blob: bytes, request: int):
    """A plain socket server in a thread: reads one ``request``-byte request,
    sends ``blob`` (made before), closes. Returns (port, thread)."""
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(60)

    def serve():
        with srv:
            conn, _ = srv.accept()
            with conn:
                got = 0
                while got < request:
                    data = conn.recv(1 << 16)
                    if not data:
                        break
                    got += len(data)
                conn.sendall(blob)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return srv.getsockname()[1], th


async def protocol_rounds(dev, parties, db, plain, data_share, card: str):
    """The client-facing checks of the protocol phase, against participant
    processes ``parties``; returns the timings as (seconds, how taken) and
    the coordinator's per-read-round times of the served queries."""
    pat, msk, planted, dup, qpat, qmsk = db
    bb = N_PLANTED
    queries = [Template(Bits(a), Bits(m)) for a, m in zip(qpat[:bb], qmsk[:bb])]
    want = [(r.index, r.distance) for r in plain.match(qpat[:bb], qmsk[:bb])]
    masks = MasksEngine(msk, device=dev)
    n = masks.count
    times = {}

    def addrs(wire):
        return [("127.0.0.1", p["ports"][wire]) for p in parties]

    def coordinator(wire, **kw):
        return Coordinator(masks, addrs(wire), strict_scan=True, round_timeout=ROUND_TIMEOUT_S,
                           device=dev, **kw)

    def won(outcomes):
        return [(o.index, o.distance) for o in outcomes]

    async def clients(host, port, ts):
        return await asyncio.gather(*[query_remote(host, port, t) for t in ts])

    async def timed(fn):
        lat, out = [], None
        for _ in range(PROTOCOL_REPS):
            t0 = time.perf_counter()
            out = await fn()
            lat.append(time.perf_counter() - t0)
        return out, (float(np.median(lat)), f"median of {PROTOCOL_REPS}")

    # 0. the wire alone: drain the parties' B = 8 replies with a plain asyncio
    # reader (no coordinator work): one party, then all three at once
    payload = batched_query_bytes(qpat[:bb], qmsk[:bb])

    async def drain(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(payload)
        await writer.drain()
        got = 0
        while chunk := await reader.read(1 << 20):
            got += len(chunk)
        writer.close()
        await writer.wait_closed()
        return got

    for label, ports in (("1 party", [parties[-1]["ports"]["batched"]]),
                         ("3 parties at once", [p["ports"]["batched"] for p in parties])):
        t0 = time.perf_counter()
        got = await asyncio.gather(*[drain(p) for p in ports])
        times[f"raw reply drain, {label}, B=8"] = (time.perf_counter() - t0, "one run")
        check(got == [n * bb * 62] * len(ports), f"protocol: raw drain of {label}: every byte")
    # the same reader against a plain socket thread whose reply bytes are made
    # before: what the reader alone can take
    plain_port, th = plain_server(bytes(n * bb * 62), len(payload))
    t0 = time.perf_counter()
    got = await drain(plain_port)
    times["raw reply drain, a plain socket thread of this process, B=8"] = (
        time.perf_counter() - t0, "one run")
    th.join(timeout=60)
    check(got == n * bb * 62, "protocol: raw drain of the plain server: every byte")

    # 1. eight concurrent clients, micro-batched into batched-wire rounds
    coord = coordinator("batched")
    sizes, inner = [], coord.query_batch

    async def counted(ts):
        sizes.append(len(ts))
        return await inner(ts)

    coord.query_batch = counted
    coord.round_times = []
    server = QueryServer(coord, "127.0.0.1", 0, max_batch=bb, batch_window=0.5)
    host, port = await server.start()
    try:
        outs, times["batched B=8"] = await timed(lambda: clients(host, port, queries))
    finally:
        await server.close()
    rounds = {"batched B=8": served_round_ms(coord.round_times, len(sizes))}
    check(won(outs) == want, "protocol: 8 micro-batched clients' winners equal "
          "PlaintextEngine.match and the in-process MPC query")
    check(all(o.total == n for o in outs), "protocol: the whole DB scanned")
    check([o.index for o in outs] == list(planted[:bb]) and not any(d for _, d in want),
          "protocol: planted self-matches at 0.0, the duplicate at its lower index")
    print(f"protocol: {len(sizes)} rounds of B = {sizes} for {PROTOCOL_REPS} x {bb} "
          f"concurrent clients (QueryServer max_batch={bb}, batched wire)")

    # 2-4. the reference wire: one client, the audit service, a persistent client
    coord = coordinator("reference")
    server = QueryServer(coord, "127.0.0.1", 0)
    audit = QueryServer(coord, "127.0.0.1", 0, audit=True)
    host, port = await server.start()
    a_host, a_port = await audit.start()
    try:
        coord.round_times = []
        one, times["reference B=1"] = await timed(lambda: query_remote(host, port, queries[0]))
        rounds["reference B=1"] = served_round_ms(coord.round_times, PROTOCOL_REPS)
        coord.round_times = None
        under = await query_remote_under(a_host, a_port, queries[0], AUDIT_THRESHOLD)
        client = await PersistentQueryClient.connect(host, port)
        try:
            persist = [await client.query(t) for t in queries[:3]]
        finally:
            await client.close()
    finally:
        await server.close()
        await audit.close()
    check(won([one]) == want[:1], "protocol: the reference-wire query's winner")
    plain_under = [(m.index, m.distance)
                   for m in plain.find_under(qpat[:1], qmsk[:1], AUDIT_THRESHOLD)[0]]
    check([(m.index, m.distance) for m in under.matches] == plain_under and under.total == n,
          f"protocol: query_remote_under t={AUDIT_THRESHOLD} equals find_under")
    check(plain_under[:2] == [(int(planted[0]), 0.0), (dup, 0.0)],
          "protocol: the audit lists the planted entry and its duplicate")
    check(won(persist) == want[:3], "protocol: PersistentQueryClient's 3 records")
    print(f"protocol: reference wire B=1 winner, audit t={AUDIT_THRESHOLD} list "
          f"({len(under.matches)} hits) equal to find_under, 3 persistent records equal")

    # 5. the chain: the coordinator holds the data share, the keyed parties chain
    local = ShareEngine(data_share, device=dev)
    chain = Coordinator(masks, [("127.0.0.1", p["ports"]["chain"]) for p in parties[:-1]],
                        local_engine=local, chain=True, strict_scan=True,
                        round_timeout=ROUND_TIMEOUT_S, device=dev)
    chain.round_times = []
    outs, times["chain B=8"] = await timed(lambda: chain.query_batch(queries))
    rounds["chain B=8"] = served_round_ms(chain.round_times, PROTOCOL_REPS)
    check(won(outs) == want, "protocol: the chain round's winners")
    del local, chain

    # 6. two micro-batched rounds in flight
    coord = coordinator("batched")
    inflight, peak, inner2 = [0], [0], coord.query_batch

    async def tracked(ts):
        inflight[0] += 1
        peak[0] = max(peak[0], inflight[0])
        try:
            return await inner2(ts)
        finally:
            inflight[0] -= 1

    coord.query_batch = tracked
    server = QueryServer(coord, "127.0.0.1", 0, max_batch=bb // 2, batch_window=0.5,
                         rounds_inflight=2)
    host, port = await server.start()
    try:
        t0 = time.perf_counter()
        outs = await clients(host, port, queries)
        times["2 rounds in flight, B=4 each"] = (time.perf_counter() - t0, "one run")
    finally:
        await server.close()
    check(peak[0] == 2 and won(outs) == want,
          "protocol: two rounds in flight, each bit-equal to the solo rounds")
    return times, rounds


def protocol_phase(dev, seed: int, db, data_share, mpc_win, mpc_ms, card: str) -> int:
    """The serving roles on the card: the 3-party MPC query of ``mpc_phase``
    (262,144 entries; parties 0 and 1 keyed, half their chunks resident,
    party 2 the data share) with each participant in its own process, on
    card ``p % device_count``, serving its engine on the reference, batched
    and chain wires; the Coordinator and QueryServer in this process with a
    MasksEngine on ``dev``. Every winner must equal PlaintextEngine.match and
    the in-process MPC query, the audit list find_under. Returns kernel (d)'s
    launches in the keyed participants while they served."""
    pat, msk = db[:2]
    n = pat.shape[0]
    devices = party_devices()
    half = 2 * BITS * DEFAULT_CHUNK * (-(-n // DEFAULT_CHUNK) // 2)
    plain = PlaintextEngine(pat, msk, device=dev, storage="packed")
    bb = N_PLANTED
    check(mpc_win[2].tolist() == [r.index for r in plain.match(db[4][:bb], db[5][:bb])],
          "protocol: the in-process MPC query's winners are the reference here")
    t0 = time.perf_counter()
    parties = start_parties(n, seed, SHARE_KEY, devices, hbm_budget=half,
                            timeout=PARTIES_START_S)
    start_s = time.perf_counter() - t0
    try:
        times, rounds = asyncio.run(protocol_rounds(dev, parties, db, plain, data_share, card))
    finally:
        reports = stop_parties(parties, timeout=PARTIES_STOP_S)
    launches = [r["share_planes_kernel"] for r in reports]
    print(f"launches in the protocol run (participant processes): "
          f"{json.dumps({'share_planes_kernel': launches})}")
    check(all(k > 0 for k in launches[:2]),
          "protocol: every keyed participant process launched kernel (d)")
    print(f"protocol: participants {[p['pid'] for p in parties]} on "
          f"{[str(d) for d in devices]} started (engines built, resident "
          f"{[p['resident'] for p in parties]}) in {start_s:.1f} s and stopped by PID")
    for name, (t, how) in times.items():
        print(f"time protocol {name} N={n}: {t * 1e3:.3f} ms client-seen ({how}, host wall; "
              f"participants in their own processes, TCP on localhost) [{card}]")
    print(f"time in-process mpc query N={n} B={bb} (the same parties one after another in "
          f"one process, no socket): {mpc_ms:.3f} ms [{card}]")
    for s, r in enumerate(reports):
        served = {w: (st["served"], round(st["p50_s"] * 1e3, 3)) for w, st in r["stats"].items()}
        print(f"  participant {s} (served, p50 ms) by wire: {served} [{card}]")
    print(f"reply bytes per party: {n * bb * 62} per B={bb} round ({n} entries x {bb} x 62), "
          f"{n * 62} per B=1 round")
    for name, line in rounds.items():
        print(f"coordinator rounds, served {name}: {line} [{card}]")
    return sum(launches)


def party_phase(dev, seed: int, card: str) -> None:
    """Parties of several processes. First, on one card 2 ranks of 2 shards
    over gloo (NCCL refuses two ranks on one card); with several cards one
    rank per card, up to D, over NCCL. Then 4 ranks of one device each on a
    (2, 2) mesh, whose "db" rows span two ranks (NCCL with 4 cards, else
    gloo on the cards there are), over a quarter of the packed DB. Each
    rank's non-local rows are poisoned; the B = 8 match, a spectrum of the
    first ``mesh_batch`` queries, the find_under lists at the audit
    threshold, a share engine's dots and a keyed checksum must equal the
    single-card engines' on the clean data."""
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    procs = min(cards, SHARDS) if backend == "nccl" else 2
    for procs, backend, per_rank, mesh_batch, n in (
            (procs, backend, SHARDS // procs, 1, PACKED_DB),
            (4, "nccl" if cards >= 4 else "gloo", 1, 2, PACKED_DB // 4)):
        t0 = time.perf_counter()
        out = run_party(procs=procs, backend=backend, device=str(dev), n=n,
                        n_share=PARTY_SHARE_DB, chunk=DEFAULT_CHUNK, batch=N_PLANTED, seed=seed,
                        shards_per_rank=per_rank, mesh_batch=mesh_batch,
                        threshold=AUDIT_THRESHOLD, timeout=PARTY_TIMEOUT)
        party_s = time.perf_counter() - t0
        pat, msk, share = make_data(seed, n, PARTY_SHARE_DB)
        q = query_rows(n, N_PLANTED)
        single = PlaintextEngine(pat, msk, device=dev)
        res = single.match(pat[q], msk[q])
        what = f"{procs}-process party on a {tuple(out['mesh'])} mesh"
        check(out["winners"] == [[r.index, r.numerator, r.denominator] for r in res]
              and [r.index for r in res] == q.tolist(),
              f"{what} B=8: winners equal the single-card engine's, self-matches found")
        qs = q[:mesh_batch]
        check(out["spectrum_sha256"] == dots_digest(single.min_fractions(pat[qs], msk[qs])),
              f"{what}: B={mesh_batch} spectrum equals the single-card engine's")
        check(out["under_sha256"] == under_digest(single.find_under(pat[q], msk[q],
                                                                    AUDIT_THRESHOLD)),
              f"{what}: find_under lists equal the single-card engine's")
        check(out["dots_sha256"] == dots_digest(ShareEngine(share, device=dev).dots(pat[q],
                                                                                   msk[q])),
              f"{what}: share dots equal the single-card ShareEngine's on the clean share")
        keyed = KeyedShareEngine(KEY, 0, n, device=dev, hbm_budget=0)
        check(out["keyed_checksum"] == int(keyed.fold_pass_fn()(planes(pat[q], msk[q], dev)[0])),
              f"{what}: keyed checksum equals the single-card engine's")
        p_ms = wall_ms(lambda: single.match(pat[q], msk[q]), 3)
        print(f"{what}: backend {out['backend']}, {out['procs']} ranks on {out['devices']}, "
              f"rank 0 loaded {out['local_rows']} of {n} rows (the rest poisoned); match "
              f"B={N_PLANTED}, B={mesh_batch} spectrum, find_under ({out['under_hits']} hits), "
              f"share dots ({PARTY_SHARE_DB} rows) and keyed checksum equal the single-card "
              f"engines'; match {out['match_ms']:.3f} ms (rank 0, median of 3), single-card "
              f"{p_ms:.3f} ms; the party's run took {party_s:.1f} s [{card}]")
        del single, keyed
        torch.cuda.empty_cache()


def cli_run(argv: list) -> tuple[int, str, str, float]:
    """``mpc_iris_tpu_torch.cli.main(argv)`` in this process (so the kernels'
    launch counters see it): (exit code, stdout, stderr, seconds)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def winners(out: str) -> list:
    """(index, distance) of each ``query i: closest entry X [of T] at
    distance D`` line, in order."""
    return [(int(m[1]), float(m[2])) for m in re.finditer(
        r"^query \d+: closest entry (\d+)(?: of \d+)? at distance (\S+)", out, re.M)]


def audit_lines(out: str) -> list:
    return [l for l in out.splitlines() if l.startswith("query ") or l.startswith("  entry ")]


def wait_for(path: str, text: str, proc, deadline: float) -> str:
    """Poll the log file ``path`` until it holds ``text``; fails when
    ``proc`` exits first or the deadline passes."""
    while True:
        with open(path, errors="replace") as f:
            log = f.read()
        if text in log:
            return log
        check(proc.poll() is None, f"cli: pid {proc.pid} exited {proc.returncode} before "
              f"{text!r}:\n{log[-3000:]}")
        check(time.monotonic() < deadline, f"cli: no {text!r} from pid {proc.pid} in time:\n"
              f"{log[-3000:]}")
        time.sleep(0.2)


def stop_roles(roles: dict, timeout: float) -> dict:
    """SIGTERM each role by its PID, wait up to ``timeout`` s in all, kill at
    the deadline. Returns name -> (exit code, its stderr log)."""
    for proc, _ in roles.values():
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + timeout
    out = {}
    for name, (proc, log) in roles.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        with open(log, errors="replace") as f:
            out[name] = (proc.returncode, f.read())
    return out


def cli_phase(dev: torch.device, seed: int, card: str, n_db: int = CLI_DB,
              n_store: int = CLI_STORE) -> dict:
    """The CLI (``mpc_iris_tpu_torch.cli``, ``python -m mpc_iris_tpu_torch``)
    as a deployment drives it, in a fresh directory under build/ that is
    removed at the end (also on failure). In this process: ``generate`` of
    an ``n_db``-entry JSON DB and ``match --storage packed`` at B = 1, 8 and
    13 and ``--all-under 0.375`` at B = 8, each equal to an in-process
    PlaintextEngine over the same arrays; ``generate`` / ``prepare --backend
    device`` of an ``n_store``-entry 3-party store and ``store-check --key
    --deep``. Then the serving roles, each a process of its own: two keyed
    participants and the data party on the batched wire, a coordinator whose
    winners must equal ``match``, an ``enroll`` of 4 candidates (2
    duplicates) and a query that finds an enrolled entry after the parties
    adopted it (--watch, --watch-count); a SIGUSR2 trace of the second keyed
    party (nothing resident: kernel (d) every request) around a query, a
    SIGUSR1 stats line; every role stopped by SIGTERM and drained cleanly.
    Last ``bench-kernels``. Returns the launches in this process of (a),
    (b), (c) (``match``) and (d) (``prepare --backend device``)."""
    on_card = dev.type == "cuda"
    device = [] if on_card else ["--device", "cpu"]  # the default is the card
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli-phase-", dir=os.path.join(root, "build"))
    disk = shutil.disk_usage(tmp)
    print(f"cli: working directory {tmp}, {disk.free / 1e9:.1f} GB free of "
          f"{disk.total / 1e9:.1f} GB")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    roles = {}
    try:
        db, small = os.path.join(tmp, "db.json"), os.path.join(tmp, "small.json")
        rc, _, _, gen_s = cli_run(["generate", db, str(n_db), "--seed", str(seed)])
        check(rc == 0, "cli: generate")
        size = os.path.getsize(db)
        t0 = time.perf_counter()
        pats, msks = [], []
        with open(db, "rb") as f:
            for p, m in native.parse_templates_stream(f, batch=4096):
                pats.append(p)
                msks.append(m)
        parse_s = time.perf_counter() - t0
        dpat, dmsk = np.concatenate(pats), np.concatenate(msks)
        del pats, msks
        check(native.available() and dpat.shape == (n_db, BITS_BYTES),
              "cli: the C++ codec rendered and parsed the DB")
        print(f"time cli generate N={n_db}: {gen_s:.3f} s, {size / gen_s / 1e6:.1f} MB/s of "
              f"JSON ({size} bytes); parse {parse_s:.3f} s, {size / parse_s / 1e6:.1f} MB/s "
              f"(C++ codec, host wall) [{card}]")

        # ---- match through the CLI, counted
        requests = [(["--batch", "1", "--seed", str(seed + 1)], 1, None),
                    (["--batch", "8", "--seed", str(seed + 2)], 8, None),
                    (["--batch", "13", "--seed", str(seed + 3)], 13, None),
                    (["--batch", "8", "--seed", str(seed + 4), "--all-under",
                      str(AUDIT_THRESHOLD)], 8, AUDIT_THRESHOLD)]
        counted = (select_chunk, match_packed_small_b, fractions_packed_small_b,
                   share_planes_kernel)
        for fn in counted:
            fn.launches = 0
        outs = []
        for args, bb, t in requests:
            rc, out, err, s = cli_run(["match", db, "--storage", "packed", *args, *device])
            check(rc == 0, f"cli: match {' '.join(args)}")
            outs.append((out, err, s))
        launches = {fn.__name__: fn.launches for fn in counted[:3]}
        print(f"launches in the cli match run: {json.dumps(launches)}")

        # ---- the same requests on an in-process engine over the same arrays
        plain = PlaintextEngine(dpat, dmsk, device=dev, storage="packed")
        for (args, bb, t), (out, err, s) in zip(requests, outs):
            rng = np.random.default_rng(int(args[3]))  # the CLI's self-match queries
            idx = rng.integers(0, n_db, size=bb)
            rots = rng.integers(-15, 16, size=bb)
            qp = np.stack([Bits(dpat[i]).rotated(int(r)).data for i, r in zip(idx, rots)])
            qm = np.stack([Bits(dmsk[i]).rotated(int(r)).data for i, r in zip(idx, rots)])
            what = f"cli: match B={bb}" + (f" --all-under {t}" if t else "")
            if t is None:
                res = plain.match(qp, qm)
                check(winners(out) == [(r.index, r.distance) for r in res],
                      f"{what}: winners equal PlaintextEngine.match")
                check([i for i, _ in winners(out)] == idx.tolist()
                      and all(d == 0.0 for _, d in winners(out)),
                      f"{what}: each self-match names its source entry at 0.0")
                ms = wall_ms(lambda: plain.match(qp, qm), 3)
            else:
                lists = plain.find_under(qp, qm, t)
                want = []
                for i, hits in enumerate(lists):
                    want.append(f"query {i}: {len(hits)} entr{'y' if len(hits) == 1 else 'ies'} "
                                f"under {t}")
                    want += [f"  entry {m.index} at distance {m.distance}" for m in hits]
                check(audit_lines(out) == want, f"{what}: lists equal PlaintextEngine.find_under")
                check(all((int(i), 0.0) in [(m.index, m.distance) for m in hits]
                          for i, hits in zip(idx, lists)),
                      f"{what}: each query lists its source entry at 0.0")
                ms = wall_ms(lambda: plain.find_under(qp, qm, t), 3)
            line = next(l for l in err.splitlines() if " entries in " in l)
            print(f"time {what}: '{line}'; the call {s:.3f} s (parse, engine build, request); "
                  f"in-process engine {ms:.3f} ms (median of 3, host wall) [{card}]")
        if on_card:
            check(launches["match_packed_small_b"] > 0 and launches["select_chunk"] > 0
                  and launches["fractions_packed_small_b"] > 0,
                  "cli: match launched kernels (b) (B=1, 8), (a) (B=13), (c) (--all-under)")
        del plain, dpat, dmsk
        if on_card:
            torch.cuda.empty_cache()

        # ---- the MPC store, prepared on the device
        rc, _, _, _ = cli_run(["generate", small, str(n_store), "--seed", str(seed + 5)])
        check(rc == 0, "cli: generate the store's JSON")
        base, key = os.path.join(tmp, "mpc"), os.path.join(tmp, "mpc.key")
        share_planes_kernel.launches = 0
        rc, _, err, prep_s = cli_run(["prepare", small, "3", base, "--insecure-seed", "9",
                                      "--save-key", key, "--backend", "device", *device])
        check(rc == 0, f"cli: prepare --backend device:\n{err[-2000:]}")
        launches["share_planes_kernel"] = share_planes_kernel.launches
        print(f"launches in the cli prepare --backend device: "
              f"{json.dumps({'share_planes_kernel': launches['share_planes_kernel']})}")
        if on_card:
            check(launches["share_planes_kernel"] > 0, "cli: prepare launched kernel (d)")
        store_bytes = sum(os.path.getsize(f"{base}.{x}")
                          for x in ("masks", "share-0", "share-1", "share-2"))
        print(f"time cli prepare --backend device N={n_store} 3 shares: {prep_s:.3f} s, "
              f"{store_bytes / prep_s / 1e6:.1f} MB/s written ({store_bytes} bytes) [{card}]")
        with open(small, "rb") as f:  # the host path's bytes for the first rows
            p0, m0 = next(native.parse_templates_stream(f, batch=1000))
        host = native.share_split(native.encode_u16_native(p0, m0), 3,
                                  native.derive_insecure_key(9))
        for s in range(3):
            check(np.array_equal(np.fromfile(f"{base}.share-{s}", "<u2", count=len(p0) * BITS),
                                 host[s].reshape(-1)),
                  f"cli: prepare --backend device share {s} equals the host path's bytes")
        rc, _, err, _ = cli_run(["store-check", base, "--count", "3", "--key", key, "--deep",
                                 *device])
        check(rc == 0, f"cli: store-check --key --deep:\n{err[-2000:]}")
        print(f"cli: store-check --key --deep: {err.strip().splitlines()[-1]}")

        # ---- the serving roles, each in a process of its own
        with open(small, "rb") as f:
            spat, smsk = (np.concatenate(x) for x in zip(*native.parse_templates_stream(f)))
        rng = np.random.default_rng(seed + 6)
        src = rng.choice(n_store, 6, replace=False)
        qs = [Template(Bits(spat[i]), Bits(smsk[i])).rotated(int(r))
              for i, r in zip(src, rng.integers(-15, 16, 6))]
        qs += [Template.random(rng) for _ in range(2)]
        qfile = os.path.join(tmp, "q.json")
        with open(qfile, "wb") as f:
            write_templates_json(f, qs)
        ports = []
        for _ in range(3):
            with socket.socket() as s_:
                s_.bind(("127.0.0.1", 0))
                ports.append(s_.getsockname()[1])
        addrs = [f"127.0.0.1:{p}" for p in ports]
        prof = os.path.join(tmp, "prof")
        specs = {"keyed 0": ([f"keyed:0:{n_store}:{key}", "--watch-count", f"{base}.count"], {}),
                 "keyed 1": ([f"keyed:1:{n_store}:{key}", "--watch-count", f"{base}.count",
                              "--profile-dir", prof], {"MPC_IRIS_HBM_BUDGET": "0"}),
                 "data": ([f"{base}.share-2"], {})}
        cmd = [sys.executable, "-m", "mpc_iris_tpu_torch"]
        t0 = time.perf_counter()
        for (name, (args, extra)), addr in zip(specs.items(), addrs):
            log = os.path.join(tmp, f"{name.replace(' ', '')}.log")
            with open(log, "wb") as lf:
                proc = subprocess.Popen(
                    [*cmd, "participant", args[0], addr, "--wire", "batched", "--watch",
                     *args[1:], *device], stdout=lf, stderr=lf, cwd=tmp, env={**env, **extra})
            roles[name] = (proc, log)
        print(f"cli: participants {[p.pid for p, _ in roles.values()]}")
        deadline = time.monotonic() + PARTIES_START_S
        for proc, log in roles.values():
            wait_for(log, "listening on", proc, deadline)
        print(f"cli: participants listening in {time.perf_counter() - t0:.1f} s (process "
              f"start, torch import, engine build, warm-up) [{card}]")

        def role(*argv, timeout=CLI_ROLE_S):
            t0 = time.perf_counter()
            r = subprocess.run([*cmd, *argv, *device], capture_output=True, text=True,
                               cwd=tmp, env=env, timeout=timeout)
            return r, time.perf_counter() - t0

        keyed1, log1 = roles["keyed 1"]
        keyed1.send_signal(signal.SIGUSR2)
        wait_for(log1, "device trace STARTED", keyed1, time.monotonic() + 30)
        served, served_s = role("coordinator", *addrs, "--masks", f"{base}.masks",
                                "--queries-file", qfile, "--wire", "batched", "--batch", "8",
                                "--strict-scan", "--timeout", "120")
        keyed1.send_signal(signal.SIGUSR2)
        log = wait_for(log1, "device trace stopped", keyed1, time.monotonic() + 120)
        check(served.returncode == 0, f"cli: coordinator:\n{served.stderr[-3000:]}")
        rc, out, _, _ = cli_run(["match", small, "--queries-file", qfile, *device])
        check(rc == 0 and len(winners(out)) == len(qs), "cli: match --queries-file")
        check(winners(served.stdout) == winners(out),
              "cli: the served coordinator's winners equal match's")
        check([i for i, _ in winners(out)[:6]] == src.tolist()
              and all(d == 0.0 for _, d in winners(out)[:6]),
              "cli: the served self-matches name their source entries at 0.0")
        batch_line = next(l for l in served.stderr.splitlines() if l.startswith("batch of"))
        print(f"time cli coordinator N={n_store} B=8 (3 participant processes, batched wire): "
              f"'{batch_line}'; the process {served_s:.3f} s (start, masks engine, query) "
              f"[{card}]")
        trace_path = re.search(r"device trace stopped -> (\S+)", log)[1]
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        chacha = [e for e in events if "chacha_planes_kernel" in str(e.get("name", ""))
                  and e.get("cat") == "kernel"]
        print(f"cli: SIGUSR2 trace of keyed participant 1 ({os.path.getsize(trace_path)} bytes, "
              f"{len(events)} events): {len(chacha)} chacha_planes_kernel launches")
        if on_card:
            check(chacha, "cli: the SIGUSR2 trace names kernel (d)'s CUDA kernel")
        keyed0, log0 = roles["keyed 0"]
        keyed0.send_signal(signal.SIGUSR1)
        log = wait_for(log0, "participant: stats ", keyed0, time.monotonic() + 30)
        stats = json.loads(log.split("participant: stats ", 1)[1].splitlines()[0])
        print(f"cli: SIGUSR1 stats of keyed participant 0: {json.dumps(stats)}")
        check(stats["served"] >= 1 and (stats["hbm"]["bytes_in_use"] is not None or not on_card),
              "cli: SIGUSR1 stats line with the card's memory")

        # ---- enroll 4 candidates, 2 duplicates, then find an enrolled one
        fresh = [Template.random(np.random.default_rng(seed + 7 + k)) for k in range(2)]
        dup_of = int(src[0])
        cands = [Template(Bits(spat[dup_of]), Bits(smsk[dup_of])), fresh[0],
                 fresh[0].rotated(5), fresh[1]]
        cfile, qfile2 = os.path.join(tmp, "cands.json"), os.path.join(tmp, "q2.json")
        with open(cfile, "wb") as f:
            write_templates_json(f, cands)
        with open(qfile2, "wb") as f:
            write_templates_json(f, [fresh[1].rotated(-2), fresh[0]])
        enrolled, enroll_s = role("enroll", cfile, base, *addrs, "--count", "3", "--key", key,
                                  "--threshold", "0.36", "--wire", "batched", "--round", "4",
                                  "--timeout", "120")
        check(enrolled.returncode == 0, f"cli: enroll:\n{enrolled.stderr[-3000:]}")
        verdicts = [l for l in enrolled.stdout.splitlines() if l.startswith("candidate ")]
        want = [f"DUPLICATE of entry {dup_of} at distance 0.0",
                f"enrolled at index {n_store}",
                f"DUPLICATE of entry {n_store} at distance 0.0",
                f"enrolled at index {n_store + 1}"]
        check(len(verdicts) == 4 and all(w in v for w, v in zip(want, verdicts)),
              f"cli: enroll verdicts {verdicts}")
        print(f"time cli enroll of 4 candidates N={n_store} (one batched round): the process "
              f"{enroll_s:.3f} s [{card}]; verdicts {verdicts}")
        after, _ = role("coordinator", *addrs, "--masks", f"{base}.masks",
                        "--queries-file", qfile2, "--wire", "batched", "--batch", "2",
                        "--strict-scan", "--timeout", "120")
        check(after.returncode == 0, f"cli: coordinator after enroll:\n{after.stderr[-3000:]}")
        check(winners(after.stdout) == [(n_store + 1, 0.0), (n_store, 0.0)]
              and f" of {n_store + 2} " in after.stdout,
              "cli: the next query finds the enrolled entries, every party grown (--watch)")
        print(f"cli: after enroll, the served query finds entries {n_store + 1} and {n_store} "
              f"at 0.0 over {n_store + 2} entries")

        stopped = stop_roles(roles, PARTIES_STOP_S)
        roles = {}
        for name, (rc, log) in stopped.items():
            check(rc == 0 and "drained cleanly" in log,
                  f"cli: participant {name} exit {rc} after SIGTERM:\n{log[-2000:]}")
        print(f"cli: participants stopped by SIGTERM, each drained cleanly (exit 0)")

        # ---- bench-kernels (launches from here on are not counted)
        rc, out, _, bench_s = cli_run(["bench-kernels", "--json", "--sizes", "1000", "100000",
                                       *device])
        check(rc == 0, "cli: bench-kernels")
        rows_ = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
        names = [r["bench"] for r in rows_]
        if on_card:
            for k in ("match_packed_small_b/", "chacha_regen/"):
                picked = [r for r in rows_ if r["bench"].startswith(k)]
                check(picked and all(np.isfinite(r["time_s"]) and r["time_s"] > 0
                                     for r in picked), f"cli: bench-kernels {k} rows")
        print(f"cli: bench-kernels --json ({bench_s:.1f} s) [{card}]:")
        for r in rows_:
            rate = r.get("pairs_per_s") or r.get("items_per_s")
            print(f"  {r['bench']}: {r['time_s'] * 1e3:.4f} ms, {rate:.4g} /s"
                  + (f", {r['tmacs']:.1f} TMAC/s" if r.get("tmacs") else ""))
        check(any(n.startswith("etl/") for n in names), "cli: bench-kernels host rows")
        written = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp)
                      for f in fs)
        print(f"cli: {written} bytes written under {tmp}")
        return launches
    finally:
        if roles:
            stop_roles(roles, 10)
        shutil.rmtree(tmp, ignore_errors=True)


def golden_templates(seed: int) -> list:
    """tests/test_golden.py's ``generate_templates`` on the port's types (a
    copy: that module imports the JAX package): 8 random templates, a rotated
    copy of each with about 5% of its pattern bits flipped, and the empty
    template."""
    rng = np.random.default_rng(seed)
    templates = [Template.random(rng) for _ in range(8)]
    for i in range(8):
        t = templates[i].rotated(int(rng.integers(-15, 16)))
        noise = rng.random(BITS) < 0.05
        pat = np.unpackbits(t.pattern.data, bitorder="little") ^ noise
        templates.append(Template(Bits(np.packbits(pat, bitorder="little")),
                                  Bits(t.mask.data)))
    templates.append(Template(Bits(), Bits()))
    return templates


def interop_fixture(e: int) -> Template:
    """Entry ``e`` of tests/test_interop.py's fixture, from its closed-form
    bytes (``fx_pattern``, ``fx_mask``): dense irregular patterns, masks
    mostly set with entry-dependent holes."""
    j = np.arange(BITS_BYTES)
    pattern = (37 * e + 11 * j + 5) % 256
    mask = 255 - ((j * (e + 3)) % 7 == 0) * (1 << (j % 8))
    return Template(Bits(pattern.astype(np.uint8)), Bits(mask.astype(np.uint8)))


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def conformance_phase(dev: torch.device, card: str, demo_db: int = DEMO_DB) -> dict:
    """The repo's reference vectors through the port's engines and the four
    kernels, every f64 bit-equal to a value neither package computed:

    - the golden set (17 templates; DB the 6 entries of the golden pairs):
      the scalar oracle ``Template.distance`` of every (query, entry) pair,
      equal to the golden file on its pairs; packed and dense ``distances``
      equal to it; ``match`` at B = 8 (kernel (b)) and at all 17 queries
      (packed and dense: the scan through kernel (a)), each winner the row's
      minimum at its first index; ``min_fractions`` at B = 8 (kernel (c)),
      decoded by ``fraction_to_f64``; the encoded path with a keyed party 0
      (kernel (d) regenerates its rows) and a data-share party 1 from
      ``native.share_split``, decoded by ``decode_distance`` per golden pair;
    - the interop fixture: ``ShareEngine`` and ``MasksEngine`` records equal
      to the frozen records and decoded distances, ``PlaintextEngine.match``
      (kernel (b)) at their minimum, and the keystream known answers from
      kernel (d) itself, one past the u64 row carry;
    - ``examples/api_demo_torch.py`` at ``demo_db`` entries and B = 8, cut to
      DEMO_DB_CUT when the host's available memory cannot hold it.

    Returns the phase's launches of (a) to (d); on the card each must be
    nonzero. No check falls back: a mismatch raises."""
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    counted = (select_chunk, match_packed_small_b, fractions_packed_small_b,
               share_planes_kernel)
    for fn in counted:
        fn.launches = 0

    # ---- the golden set
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    templates = golden_templates(golden["seed"])
    check(len(templates) == golden["n_templates"], "golden: template count")
    want = {(r["left"], r["right"]): float("inf") if r["distance"] is None
            else float(r["distance"]) for r in golden["distances"]}
    right = sorted({e for _, e in want})
    left = sorted({q for q, _ in want})
    pat = np.stack([t.pattern.data for t in templates])
    msk = np.stack([t.mask.data for t in templates])
    dpat, dmsk = pat[right], msk[right]
    oracle = np.array([[q.distance(templates[e]) for e in right] for q in templates])
    for (q, e), d in want.items():
        check(oracle[q, right.index(e)] == d,
              f"golden ({q}, {e}): Template.distance equals the golden file")
    row_min, row_arg = oracle.min(axis=1), oracle.argmin(axis=1)

    def winners_at_row_min(results, what):
        check(len(results) > 0 and all(
            (r.index, r.distance) == (int(row_arg[q]), float(row_min[q]))
            for q, r in enumerate(results)),
            f"golden {what}: each winner is its row's minimum, first index")

    packed = PlaintextEngine(dpat, dmsk, device=dev, storage="packed")
    dense = PlaintextEngine(dpat, dmsk, device=dev, storage="dense")
    for name, eng in (("packed", packed), ("dense", dense)):
        check(np.array_equal(eng.distances(pat, msk), oracle),
              f"golden {name} distances: every pair equals Template.distance")
    winners_at_row_min(packed.match(pat[:8], msk[:8]), "packed match B=8 (kernel (b))")
    winners_at_row_min(packed.match(pat, msk), "packed match B=17 (the scan, kernel (a))")
    winners_at_row_min(dense.match(pat, msk), "dense match B=17 (kernel (a))")
    nd = packed.min_fractions(pat[:8], msk[:8])
    check(np.array_equal([[fraction_to_f64(n, d) for n, d in zip(*nd[:, q])]
                          for q in range(8)], oracle[:8]),
          "golden min_fractions B=8 (kernel (c)): fraction_to_f64 equals Template.distance")
    enc = np.stack([encode_template(templates[e]).data for e in right])
    shares = native.share_split(enc, 2, GOLDEN_KEY)
    parties = [KeyedShareEngine(GOLDEN_KEY, 0, len(right), device=dev),
               ShareEngine(shares[1], device=dev)]
    check(np.array_equal(parties[0].dots(pat[left], msk[left]),
                         ShareEngine(shares[0], device=dev).dots(pat[left], msk[left])),
          "golden keyed party 0 (kernel (d)): dots equal its share file's")
    dots = native.share_sum([p.dots(pat[left], msk[left]) for p in parties])
    dens = MasksEngine(dmsk, device=dev).dots(msk[left])
    for (q, e), d in want.items():
        got = decode_distance(dots[left.index(q), right.index(e)],
                              dens[left.index(q), right.index(e)])
        check(got == d, f"golden ({q}, {e}) encoded path, keyed party 0: "
              f"decode_distance {got!r} equals the golden {d!r}")
    check(np.array_equal(decode_distance_batch_np(dots.reshape(-1, 31), dens.reshape(-1, 31))
                         .reshape(len(left), -1), oracle[left]),
          "golden encoded path: every pair decodes to Template.distance")
    print(f"conformance golden: {len(want)} golden pairs and all {oracle.size} pairs of 17 "
          "queries x 6 entries bit-equal through packed and dense distances, match B=8 (b), "
          "B=17 (a), min_fractions B=8 (c), the encoded path with keyed party 0 (d)")
    del packed, dense, parties

    # ---- the interop fixture's frozen vectors
    fixture = [interop_fixture(e) for e in range(INTEROP_ENTRIES)]
    ipat = np.stack([t.pattern.data for t in fixture])
    imsk = np.stack([t.mask.data for t in fixture])
    ienc = np.stack([encode_template(t).data for t in fixture])
    s0 = ((12_345 * np.arange(INTEROP_ENTRIES)[:, None] + 7 * np.arange(BITS) + 1)
          % 65536).astype(np.uint16)  # the fixture's closed-form share 0
    s1 = ienc - s0  # wrapping u16
    query = interop_fixture(INTEROP_QUERY)
    qp, qm = query.pattern.data[None], query.mask.data[None]
    rec = native.share_sum([ShareEngine(s, device=dev).dots(qp, qm)[0] for s in (s0, s1)])
    den = MasksEngine(imsk, device=dev).dots(qm)[0]
    check(rec[1].tolist() == FROZEN_DIST_RECORD_E1, "interop: entry 1's distance record")
    check(den[1].tolist() == FROZEN_DEN_RECORD_E1, "interop: entry 1's denominator record")
    check([decode_distance(rec[e], den[e]) for e in range(INTEROP_ENTRIES)]
          == FROZEN_DISTANCES, "interop: the 8 decoded distances")
    (won,) = PlaintextEngine(ipat, imsk, device=dev).match(qp, qm)
    check((won.index, won.distance) == (int(np.argmin(FROZEN_DISTANCES)), min(FROZEN_DISTANCES)),
          "interop: PlaintextEngine.match (kernel (b)) at the frozen minimum")
    kw = key_tensor(bytes(range(32)), dev)
    inv = torch.from_numpy(np.argsort(k_permutation())).to(dev)
    for (sid, row), want4 in FROZEN_KEYED_ROWS.items():
        row0 = min(row, 0xFFFFFFFF)
        natural = planes_to_shares(*share_planes_kernel(kw, sid, row0, row - row0 + 1))[-1]
        check(natural[inv][:4].tolist() == want4,
              f"interop: keystream row (stream {sid}, row {row}) from kernel (d)")
    print(f"conformance interop: ShareEngine + MasksEngine records and the "
          f"{INTEROP_ENTRIES} decoded distances equal the frozen ones; match (b) at "
          f"{won.distance!r}; {len(FROZEN_KEYED_ROWS)} keystream rows from (d)")

    # ---- the library walkthrough
    need = 6 * demo_db * BITS * 2  # the shares, the encoding, two refresh copies
    avail = host_available_bytes()
    if need > avail:
        print(f"conformance demo: cut to {DEMO_DB_CUT} entries from {demo_db} "
              f"({avail / 1e9:.1f} GB available on the host, {need / 1e9:.1f} GB needed)")
        demo_db = DEMO_DB_CUT
    spec = importlib.util.spec_from_file_location(
        "api_demo_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "examples", "api_demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    t0 = time.perf_counter()
    ms = demo.main(["--device", str(dev), "--db", str(demo_db), "--batch", str(DEMO_BATCH)])
    print(f"time api_demo_torch N={demo_db} B={DEMO_BATCH}: {time.perf_counter() - t0:.1f} s; "
          f"steps (ms, host wall): {json.dumps({k: round(v, 1) for k, v in ms.items()})} "
          f"[{card}]")
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"launches in the conformance phase: {json.dumps(launches)}")
    if on_card:
        check(all(v > 0 for v in launches.values()),
              "conformance: kernels (a), (b), (c) and (d) each launched")
    print(f"conformance phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    b = _build.build()
    sources = ", ".join(str(p.relative_to(_build.CSRC.parent.parent))
                        for p in _build.sources())
    took = f"in {b.seconds:.2f} s" if b.seconds else "(reused, same sources)"
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS[:2])} {sources} -> "
          f"{b.path.name} {took}")
    kernel = "?"
    for line in b.log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("select_part_kernel", "packed_match_kernel_g8",
                                       "packed_match_kernel", "packed_fractions_kernel_g8",
                                       "packed_fractions_kernel", "fold_parts_kernel",
                                       "chacha_planes_kernel", "int8_gemm_kernel",
                                       "packed_gemm_kernel",
                                       "keyed_share_dot_kernel", "pk_dot_kernel",
                                       "pk_select_kernel", "pk_fractions_kernel",
                                       "tile_select_kernel",
                                       "fold_tiles_kernel", "stream_kernel")
                               if k in line), line)
            config = re.findall(r"L[ib](\d+)E", line)
            if config:  # the template arguments
                kernel += f"<{', '.join(config)}>"
        elif "Used" in line or "spill stores" in line or "C7512" in line or "C7513" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    pat, msk, planted, dup, qpat, qmsk = make_db(rng, PACKED_DB)
    xpair = cross_shard_pair(PACKED_DB, effective_chunk(DEFAULT_CHUNK, PACKED_DB, SHARDS, "cuda"),
                             [*planted, dup])
    pat[xpair[1]], msk[xpair[1]] = pat[xpair[0]], msk[xpair[0]]
    # the dense DB from its own generator: the protocol phase's participant
    # processes draw it again from the seed
    dpat, dmsk, dplanted, ddup, dqpat, dqmsk = make_db(db_rng(args.seed), DENSE_DB)
    print(f"data: packed DB {PACKED_DB} entries, dense DB {DENSE_DB} entries, "
          f"seed {args.seed}, made in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    packed = PlaintextEngine(pat, msk, device=dev, storage="packed")
    dense = PlaintextEngine(dpat, dmsk, device=dev, storage="dense")
    torch.cuda.synchronize()
    print(f"engines: packed chunk {packed.chunk}, dense chunk {dense.chunk}, built "
          f"(upload, unpack, kernel canary) in {time.perf_counter() - t0:.1f} s; "
          f"device memory {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")

    requests = [("packed", packed, 1, qpat, qmsk), ("packed", packed, 8, qpat, qmsk),
                ("packed", packed, 13, qpat, qmsk), ("packed", packed, 128, qpat, qmsk),
                ("dense", dense, 128, dqpat, dqmsk)]

    counted = (select_chunk, match_packed_small_b, fractions_packed_small_b, packed_gemm)

    # ---- the match path, counted
    for fn in counted:
        fn.launches = 0
    served = [eng.match(qp[:bb], qm[:bb]) for _, eng, bb, qp, qm in requests]
    launches = {"select_chunk": select_chunk.launches,
                "match_packed_small_b": match_packed_small_b.launches,
                "packed_gemm": packed_gemm.launches}
    print(f"launches in the main-path run: {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()), "every kernel launched on the main path")

    # ---- correctness of every request
    for (storage, eng, bb, qp, qm), res in zip(requests, served):
        q_enc, q_mask = planes(qp[:bb], qm[:bb], dev)
        if storage == "dense":
            plain = _match_scan(q_enc, q_mask, *eng._db.planes)
        elif bb <= 8:
            plain = match_packed_small_b_reference(q_enc, q_mask, *eng._db.planes)
        else:
            plain = _match_scan_packed(q_enc, q_mask, *eng._db.planes, fused=False)
        check(torch.equal(triples(res), plain.cpu()),
              f"{storage} B={bb}: winners equal the plain path on the card")
        pl, dp = (planted, dup) if eng is packed else (dplanted, ddup)
        for j in range(min(bb, N_PLANTED)):
            check(res[j].index == pl[j] and res[j].distance == 0.0,
                  f"{storage} B={bb}: planted query {j} -> entry {pl[j]} at 0.0, "
                  f"got {res[j]}")
        print(f"request {storage} B={bb}: winners equal the plain path; planted "
              f"self-matches at 0.0; duplicate {pl[0]}/{dp} -> {res[0].index}")

    for name, eng, db_pat, db_msk, qp, qm, pl, dp in (
            ("packed", packed, pat, msk, qpat, qmsk, planted, dup),
            ("dense", dense, dpat, dmsk, dqpat, dqmsk, dplanted, ddup)):
        q = [0, N_PLANTED]  # a planted query and a random one
        dist = eng.distances(qp[q], qm[q])
        check(dist.shape == (2, db_pat.shape[0]), f"{name}: distances shape")
        sample = np.concatenate([[pl[0], dp], rng.choice(db_pat.shape[0], 254, replace=False)])
        for row, qi in enumerate(q):
            qt = Template(Bits(qp[qi]), Bits(qm[qi]))
            for e in sample:
                want = qt.distance(Template(Bits(db_pat[e]), Bits(db_msk[e])))
                check(dist[row, e] == want, f"{name}: distances[{qi}, {e}] == "
                      f"Template.distance ({dist[row, e]!r} vs {want!r})")
        check(np.isfinite(dist[1]).all() and dist[0, pl[0]] == 0.0, f"{name}: distances")
        print(f"distances {name}: 2 x 256 sampled pairs equal Template.distance")

    # ---- the audit path: plain spectra first (torch ops, no kernel launch);
    # the packed one is the spectrum scan the engine itself runs at B = 13
    q_over = slice(N_PLANTED, N_PLANTED + 1)  # a random query
    plain = {bb: host_spectrum(fractions_packed_small_b_reference(
        *planes(qpat[:bb], qmsk[:bb], dev), *packed._db.planes), packed.count)
        for bb in (1, 8, 13)}
    plain_dense = host_spectrum(_fractions_scan(
        *planes(dqpat[:8], dqmsk[:8], dev), *dense._db.planes), dense.count)
    t_over, e_over, rank_over = overflow_threshold(plain[13][:, N_PLANTED])

    audit_requests = [("packed", packed, 1, qpat, qmsk), ("packed", packed, 8, qpat, qmsk),
                      ("packed", packed, 13, qpat, qmsk), ("dense", dense, 8, dqpat, dqmsk)]

    # ---- the audit path, counted
    for fn in (*counted, launch_fractions):
        fn.launches = 0
    spectra = {bb: packed.min_fractions(qpat[:bb], qmsk[:bb]) for bb in (1, 8)}
    audits = [eng.find_under(qp[:bb], qm[:bb], AUDIT_THRESHOLD)
              for _, eng, bb, qp, qm in audit_requests]
    over = packed.find_under(qpat[q_over], qmsk[q_over], t_over, compact_k=OVERFLOW_K)
    over_compacted = packed.find_under(qpat[q_over], qmsk[q_over], t_over)
    try:
        packed.find_under(qpat[q_over], qmsk[q_over], t_over, limit=OVERFLOW_RANK // 2)
        limit_raised = False
    except AuditLimitExceeded:
        limit_raised = True
    audit_launches = {fn.__name__: fn.launches for fn in (*counted, launch_fractions)}
    print(f"launches in the audit-path run: {json.dumps(audit_launches)}")
    check(audit_launches["fractions_packed_small_b"] > 0
          and audit_launches["launch_fractions"] > 0,
          "fractions_packed_small_b and its B = 1 kernel pk_fractions launched on the "
          "audit path")
    launches["fractions_packed_small_b"] = audit_launches["fractions_packed_small_b"]
    launches["pk_fractions"] = audit_launches["launch_fractions"]

    # ---- correctness of every audit request
    for bb, nd in spectra.items():
        check(nd.dtype == np.uint16 and np.array_equal(nd, plain[bb]),
              f"min_fractions packed B={bb}: spectrum bit-equal to the plain version")
    for j in range(N_PLANTED):
        for e in np.concatenate([[planted[j], dup], rng.choice(PACKED_DB, 6, replace=False)]):
            want = Template(Bits(qpat[j]), Bits(qmsk[j])).distance(
                Template(Bits(pat[e]), Bits(msk[e])))
            got = float(fractions_to_f64_np(spectra[8][0, j, e], spectra[8][1, j, e]))
            check(got == want, f"min_fractions[{j}, {e}] == Template.distance "
                  f"({got!r} vs {want!r})")
    print("min_fractions packed B=1, 8: spectra bit-equal to the plain version; "
          "8 x 8 sampled entries equal Template.distance")
    for (storage, eng, bb, qp, qm), res in zip(audit_requests, audits):
        want = plain_dense if eng is dense else plain[bb]
        check(rows(res) == rows(find_under_from_fractions(want, AUDIT_THRESHOLD)),
              f"find_under {storage} B={bb}: lists equal the plain spectrum's")
        pl, dp = (planted, dup) if eng is packed else (dplanted, ddup)
        for j in range(min(bb, N_PLANTED)):
            check((int(pl[j]), 0.0) in [(m.index, m.distance) for m in res[j]],
                  f"find_under {storage} B={bb}: planted {pl[j]} listed at 0.0")
        check([(m.index, m.distance) for m in res[0][:2]] == [(pl[0], 0.0), (dp, 0.0)],
              f"find_under {storage} B={bb}: duplicate {dp} after its twin {pl[0]}")
        print(f"audit {storage} B={bb} t={AUDIT_THRESHOLD}: lists equal the plain "
              f"spectrum's; {sum(map(len, res))} hits, planted self-matches at 0.0, "
              f"duplicate {pl[0]}/{dp} in index order")
    full = find_under_from_fractions(plain[13][:, q_over], t_over)
    n_over = len(full[0])
    meta, _ = _compact_under_device(
        torch.from_numpy(plain[13][:, q_over].astype(np.int16)).to(dev),
        np.float32(t_over * (1.0 + 1e-4)), OVERFLOW_K)
    check(int(meta[0, 0]) > OVERFLOW_K, "overflow case: candidates exceed the compact buffer")
    check(OVERFLOW_K < n_over <= rank_over, f"overflow case: {n_over} entries under t")
    check(rows(over) == rows(full) == rows(over_compacted),
          f"overflow case: compact_k={OVERFLOW_K} (full-spectrum fallback) equals the "
          "full path and the compacted path")
    check(e_over not in [m.index for m in over[0]], "overflow case: the entry at t excluded")
    check(limit_raised, f"overflow case: limit {OVERFLOW_RANK // 2} raises")
    print(f"audit overflow t={t_over!r} (rank {rank_over}): {n_over} hits, "
          f"{int(meta[0, 0])} candidates > "
          f"compact_k {OVERFLOW_K}; equal to the full path; entry {e_over} at t excluded; "
          f"limit {OVERFLOW_RANK // 2} raised")

    # ---- times (launches from here on are not counted above)
    for (storage, eng, bb, qp, qm) in requests:
        ms = wall_ms(lambda: eng.match(qp[:bb], qm[:bb]), 3)
        print(f"time request {storage} N={eng.count} B={bb}: {ms:.3f} ms "
              f"(median of 3, host wall) [{card}]")
    for (storage, eng, bb, qp, qm) in audit_requests:
        ms = wall_ms(lambda: eng.find_under(qp[:bb], qm[:bb], AUDIT_THRESHOLD), 3)
        print(f"time request find_under {storage} N={eng.count} B={bb} "
              f"t={AUDIT_THRESHOLD}: {ms:.3f} ms (median of 3, host wall) [{card}]")
    for bb in (1, 8):
        ms = wall_ms(lambda: packed.min_fractions(qpat[:bb], qmsk[:bb]), 3)
        print(f"time request min_fractions packed N={packed.count} B={bb}: {ms:.3f} ms "
              f"(median of 3, host wall; the host copy of the spectrum included) [{card}]")

    kernels = []
    # (a) select_chunk at the packed scan's shapes: one chunk's products
    q_enc, q_mask = planes(qpat, qmsk, dev)
    enc0, m0 = packed._db.encoded(0)
    a_rows = {}
    for bb in (13, 128):
        dot = dot_bits_batch(_fused_rows(q_enc[:bb]), enc0)
        den = dot_bits_batch(_fused_rows(q_mask[:bb]), m0)
        got = torch.stack(select_chunk(dot, den, 0))
        want = torch.stack(select_chunk_reference(dot, den, 0))
        err = int((got - want).abs().max())
        check(err == 0, f"select_chunk B={bb}: kernel equals plain version")
        k_ms = cuda_ms(lambda: select_chunk(dot, den, 0), 20)
        p_ms = cuda_ms(lambda: select_chunk_reference(dot, den, 0), 3)
        a_rows[bb] = (err, k_ms, p_ms)
        print(f"time kernel select_chunk [{bb * 32}, {packed.chunk}] int32: {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms [{card}]")
    err, k_ms, p_ms = a_rows[128]
    # reads the int32 dot and den [128 * 32, chunk] once, writes 3 x 128 int32
    bound_ms, bound_by = bound(2 * 128 * 32 * packed.chunk * 4 + 12 * 128, 0, INT8_OPS)
    kernels.append({"name": "select_chunk", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/select_chunk.cu",
                    "replaces": "mpc_iris_tpu/ops/select_pallas.py:156",
                    "launches": launches["select_chunk"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})

    # (e) packed_gemm: both products of one packed chunk at the scan's B = 128
    # shape, [4,096 x 12,800] query rows against the chunk's packed planes,
    # beside its plain version (the chunk unpacked, two int8 products) and the
    # same two library calls, torch._int_mm, which the scan no longer makes
    qe128, qm128 = _fused_rows(q_enc[:128]), _fused_rows(q_mask[:128])
    query = packed_query(qe128, qm128)
    pat0, msk0 = (p[0] for p in packed._db.planes)
    got = torch.stack(packed_gemm(query, pat0, msk0))
    err = int((got - torch.stack(packed_gemm_reference(query, pat0, msk0))).abs().max())
    del got
    check(err == 0, "packed_gemm B=128: kernel equals plain version")

    def unpack_int_mm():
        enc, m = _unpack_encode_chunk(pat0, msk0)
        return torch._int_mm(qe128, enc.t()), torch._int_mm(qm128, m.t())

    k_ms = cuda_ms(lambda: packed_gemm(query, pat0, msk0), 20)
    p_ms = cuda_ms(lambda: packed_gemm_reference(query, pat0, msk0), 5)
    l_ms = cuda_ms(unpack_int_mm, 5)
    m, c = qe128.shape[0], packed.chunk
    # reads both products' query rows and the packed chunk once, writes the
    # two int32 products; 2 products x 2 ops a MAC
    bound_ms, bound_by = bound(2 * m * BITS + 2 * c * BITS_BYTES + 2 * 4 * m * c,
                               2 * 2 * m * c * BITS, INT8_OPS)
    print(f"time kernel packed_gemm [{m}, {BITS}] x {c} packed entries: {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, unpack + 2 torch._int_mm {l_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / k_ms:.1%} of it [{card}]")
    kernels.append({"name": "packed_gemm", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/packed_gemm.cu",
                    "replaces": "mpc_iris_tpu/models/engines.py:227",
                    "launches": launches["packed_gemm"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": l_ms})

    # (b) match_packed_small_b over the whole packed DB at batches on both
    # sides of the dispatch boundary; beside it the packed scan through (a),
    # the path the engine takes past the boundary
    lib = _build.library()
    b_rows = {}
    for bb in SWEEP:
        args4 = (q_enc[:bb], q_mask[:bb], *packed._db.planes)
        got = match_packed_small_b(*args4)
        want = match_packed_small_b_reference(*args4)
        err = int((got - want).abs().max())
        check(err == 0, f"match_packed_small_b B={bb}: kernel equals plain version")
        k_ms = cuda_ms(lambda: match_packed_small_b(*args4), 5 if bb <= 16 else 2)
        p_ms = cuda_ms(lambda: match_packed_small_b_reference(*args4), 2) if bb <= 16 else None
        s_ms = cuda_ms(lambda: _match_scan_packed(*args4, fused=True), 2)
        bound_ms, bound_by = packed_bound(bb, packed.count, 12 * bb)
        b_rows[bb] = (err, k_ms, p_ms, bound_ms, bound_by)
        plain = f"plain {p_ms:.3f} ms, " if p_ms is not None else ""
        print(f"time kernel match_packed_small_b N={packed.count} B={bb}: {k_ms:.3f} ms, "
              f"{plain}packed scan through select_chunk {s_ms:.3f} ms [{card}]")
        print(f"  {packed_rate(bb, packed.count, k_ms)}; bound {bound_ms:.3f} ms "
              f"({bound_by}), {bound_ms / k_ms:.1%} of it; query slabs read from L2 "
              f"{query_l2_bytes(lib, bb, packed.count) / 1e9:.2f} GB")
        if bb == 8:
            # the group of 8 beside the loop it replaced there, two groups of 4
            fours = torch.empty_like(got)
            n_slab = packed._db.n_chunks * packed._db.chunk
            four = lambda: _launch_int8_group(lib, *args4, n_slab, 4, fours, 8)  # noqa: E731
            four()
            check(torch.equal(fours, want), "match_packed_small_b B=8 as groups of 4 equals "
                  "the plain version")
            print(f"  B=8: the group of 8 {k_ms:.3f} ms, as two groups of 4 "
                  f"{cuda_ms(four, 5):.3f} ms [{card}]")
    args4 = (q_enc[:16], q_mask[:16], *packed._db.planes)
    print(f"SM clock and power with match_packed_small_b B=16 running: "
          f"{clocks_under(lambda: match_packed_small_b(*args4), 60)} [{card}]")
    err, k_ms, p_ms, bound_ms, bound_by = b_rows[8]
    kernels.append({"name": "match_packed_small_b", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/packed_match.cu",
                    "replaces": "mpc_iris_tpu/ops/packed_match.py:114",
                    "launches": launches["match_packed_small_b"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})

    # (c) fractions_packed_small_b over the whole packed DB at the same
    # batches, beside its plain version, the spectrum scan the engine takes
    # past the boundary; and the compaction of its B = 8 spectrum
    c_rows = {}
    for bb in SWEEP:
        args4 = (q_enc[:bb], q_mask[:bb], *packed._db.planes)
        got = fractions_packed_small_b(*args4)
        want = fractions_packed_small_b_reference(*args4)
        err = int((got.int() - want.int()).abs().max())
        del want
        check(err == 0, f"fractions_packed_small_b B={bb}: kernel equals plain version")
        k_ms = cuda_ms(lambda: fractions_packed_small_b(*args4), 5 if bb <= 16 else 2)
        p_ms = cuda_ms(lambda: fractions_packed_small_b_reference(*args4), 2)
        bound_ms, bound_by = packed_bound(bb, packed.count, 4 * bb * packed.count)
        c_rows[bb] = (err, k_ms, p_ms, bound_ms, bound_by)
        print(f"time kernel fractions_packed_small_b N={packed.count} B={bb}: "
              f"{k_ms:.3f} ms, plain (the spectrum scan) {p_ms:.3f} ms [{card}]")
        print(f"  {packed_rate(bb, packed.count, k_ms)}; bound {bound_ms:.3f} ms "
              f"({bound_by}), {bound_ms / k_ms:.1%} of it")
        if bb == 8:
            # the group of 8 beside the loop it replaced there, two groups of 4
            fours = torch.empty_like(got)
            n_slab = packed._db.n_chunks * packed._db.chunk
            four = lambda: _launch_int8_fractions(  # noqa: E731
                lib, *args4, n_slab, 4, fours[0, 0], 8 * n_slab)
            four()
            check(torch.equal(fours, got), "fractions_packed_small_b B=8 as groups of 4 equals "
                  "the group of 8")
            print(f"  B=8: the group of 8 {k_ms:.3f} ms, as two groups of 4 "
                  f"{cuda_ms(four, 5):.3f} ms [{card}]")
            del fours
            t_hi, k = np.float32(AUDIT_THRESHOLD * (1.0 + 1e-4)), 65536
            c_ms = cuda_ms(lambda: _compact_under_device(got, t_hi, k), 20)
            print(f"time compaction _compact_under_device [2, 8, {got.shape[2]}] k={k}: "
                  f"{c_ms:.3f} ms (CUDA events; includes the host sync of nonzero) "
                  f"[{card}]")
        del got
    err, k_ms, p_ms, bound_ms, bound_by = c_rows[8]
    kernels.append({"name": "fractions_packed_small_b", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/packed_fractions.cu",
                    "replaces": "mpc_iris_tpu/ops/packed_match.py:227",
                    "launches": launches["fractions_packed_small_b"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
    # (c) at B = 1: pk_fractions_kernel as the sweep's call (operand, query
    # check, launch, the wait for the check) and as a kernel alone (operand
    # made once); beside it the int8 kernel at a group of 2 (two queries)
    err, k_ms, p_ms, bound_ms, bound_by = c_rows[1]
    q1 = _one_query_operand(q_enc[:1], q_mask[:1])
    spectrum = torch.empty((2, 1, packed.count), dtype=torch.int16, device=dev)
    kernel_ms = cuda_ms(lambda: launch_fractions("pk_fractions", lib, q1, *packed._db.planes,
                                                 packed.count, spectrum, packed.count), 20)
    check(torch.equal(spectrum, fractions_packed_small_b(q_enc[:1], q_mask[:1],
                                                         *packed._db.planes)),
          "pk_fractions: the bare launch equals the call")
    pair_ms = cuda_ms(lambda: fractions_packed_small_b(q_enc[:2], q_mask[:2],
                                                       *packed._db.planes), 5)
    print(f"time kernel pk_fractions N={packed.count} B=1: {k_ms:.4f} ms as a call, "
          f"{kernel_ms:.4f} ms as a kernel; bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / k_ms:.1%} / {bound_ms / kernel_ms:.1%} of it; plain {p_ms:.3f} ms; "
          f"the int8 kernel at B = 2 (a group of 2) {pair_ms:.4f} ms [{card}]")
    del spectrum
    kernels.append({"name": "pk_fractions", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/b1_packed.cu",
                    "replaces": "mpc_iris_tpu/ops/packed_match.py:227",
                    "launches": launches["pk_fractions"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})

    # (d) the ChaCha20 share planes: the keyed party, then the MPC query
    err = check_share_planes_kernel(dev, packed.chunk)
    launches["share_planes_kernel"] = keyed_phase(dev, qpat, qmsk, KEYED_DB, card)
    mpc_launches, data_share, mpc_win, mpc_ms = mpc_phase(dev, dpat, dmsk, dplanted, ddup,
                                                  dqpat, dqmsk, card)
    launches["share_planes_kernel"] += mpc_launches
    kw = key_tensor(SHARE_KEY, dev)
    k_ms = cuda_ms(lambda: share_planes_kernel(kw, 0, 0, packed.chunk), 20)
    p_ms = cuda_ms(lambda: share_planes_natural(kw, 0, 0, packed.chunk), 2)
    print(f"time kernel share_planes_kernel [{packed.chunk}, {BITS}] x2 int8: "
          f"{k_ms:.4f} ms, plain {p_ms:.3f} ms [{card}]")
    # writes the int8 lo and hi planes [chunk, 12800] once; CHACHA_OPS int32
    # ALU operations per 64-byte ChaCha20 block, 400 blocks per row
    bound_ms, bound_by = bound(2 * packed.chunk * BITS + 32,
                               packed.chunk * 400 * CHACHA_OPS, ALU_OPS)
    kernels.append({"name": "share_planes_kernel", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/chacha_planes.cu",
                    "replaces": "mpc_iris_tpu/ops/chacha.py:211",
                    "launches": launches["share_planes_kernel"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})

    kernels += probe_phase(dev, packed, qpat, qmsk, card)
    kernels += b1_select_probe_phase(dev, packed, qpat, qmsk, args.seed, card)
    kernels += stream_probe_phase(dev, args.seed, card)

    # the sharded phase, after the single-card engines it does not need
    del dense, eng, requests, audit_requests
    torch.cuda.empty_cache()
    sharded, shard_err = sharded_match_phase(dev, packed, pat, msk, planted, xpair, qpat,
                                             qmsk, card)
    sharded["share_planes_kernel"] = sharded_keyed_phase(dev, qpat, qmsk, KEYED_DB, card)
    sharded["share_planes_kernel"] += sharded_mpc_phase(dev, dmsk, data_share, dqpat, dqmsk,
                                                        mpc_win, mpc_ms, card)
    del packed, args4
    torch.cuda.empty_cache()
    served = protocol_phase(dev, args.seed, (dpat, dmsk, dplanted, ddup, dqpat, dqmsk),
                            data_share, mpc_win, mpc_ms, card)
    del data_share
    torch.cuda.empty_cache()
    party_phase(dev, args.seed, card)
    print(f"launches in the sharded paths: {json.dumps(sharded)}")
    check(all(v > 0 for v in sharded.values()), "every kernel launched on the sharded paths")
    cli = cli_phase(dev, args.seed, card)
    print(f"launches in the cli phase (this process): {json.dumps(cli)}")
    conf = conformance_phase(dev, card)
    # the main paths' launches: single-card, sharded, served, cli, conformance
    for k in kernels:
        k["launches"] += (sharded.get(k["name"], 0) + cli.get(k["name"], 0)
                          + conf.get(k["name"], 0))
        k["max_abs_err"] = max(k["max_abs_err"], shard_err.get(k["name"], 0))
        if k["name"] == "share_planes_kernel":
            k["launches"] += served

    check("jax" not in sys.modules, "no jax imported")
    ref = sorted(m for m in sys.modules if m == "mpc_iris_tpu" or m.startswith("mpc_iris_tpu."))
    check(not ref, f"no module of the JAX package imported: {ref}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
