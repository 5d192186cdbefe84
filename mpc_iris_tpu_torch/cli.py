"""Command-line interface of the PyTorch + CUDA port (counterpart of
``mpc_iris_tpu/cli.py``; ``python -m mpc_iris_tpu_torch``), with the same
subcommands, flags, files and results:

- ``generate``     random test templates to JSON (src/main.rs:186-267)
- ``prepare``      JSON templates -> mpc.masks + mpc.share-{0..n-1} (src/main.rs:268-383)
- ``decrypt``      shares -> templates JSON
- ``participant``  share-holding match server (src/main.rs:384-452)
- ``coordinator``  / ``resolver``: query orchestration + decode (src/main.rs:453-644),
                   including coordinator-as-participant via --share
- ``benchmark``    drive a participant with random queries (src/main.rs:645-686)
- ``match``        local plaintext uniqueness check on the card
- ``rerandomize``, ``rekey``, ``keygen``, ``pair-key``, ``store-check``,
  ``tls-cert``, ``query``, ``enroll``, ``bench-kernels``: as in the JAX CLI

Binary/JSON formats are byte-compatible with the reference and the JAX
package, so stores prepared by either CLI serve the other's roles.

Every role that touches a device runs on ``--device``: a comma-separated
list of torch devices, by default ``cuda`` (every visible card; raises
without one). One device builds the single-card engines; more build the
``Sharded*Engine``s over a mesh of them, and a device may repeat
(``cpu,cpu,cpu,cpu`` is four shards on the CPU). The host-side codec is the
C++ core in ``native/`` (a NumPy fallback without a toolchain).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

import numpy as np

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES, TEMPLATE_BYTES
from mpc_iris_tpu_torch.io.formats import open_masks, open_share
from mpc_iris_tpu_torch.types import Template
from mpc_iris_tpu_torch.utils.config import device_banner, parse_si
from mpc_iris_tpu_torch.utils.progress import Progress


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """{0,1} [..., 8*n] -> uint8 [..., n], LSB-first (bit i at byte i//8,
    position i%8), as ``ops.encode.pack_bits`` on host arrays."""
    return np.packbits(np.asarray(bits, dtype=bool), axis=-1, bitorder="little")


def parse_devices(spec: str) -> list:
    """``--device``: a comma-separated list of torch devices. ``cuda`` alone
    is every visible card (and raises without one); a device may repeat, as
    ``cpu,cpu,cpu,cpu`` for four shards on one device."""
    import torch

    from mpc_iris_tpu_torch.parallel.mesh import _default_devices, _device

    names = [x.strip() for x in spec.split(",") if x.strip()]
    if not names:
        raise ValueError(f"--device {spec!r} names no device")
    if any(x.startswith("cuda") for x in names) and not torch.cuda.is_available():
        raise RuntimeError(f"--device {spec}: no CUDA card is available "
                           "(--device cpu runs on the CPU)")
    if names == ["cuda"]:
        return [d for _, d in _default_devices()]
    devices = [torch.device(x) for x in names]
    if any(d.type not in ("cpu", "cuda") for d in devices):
        raise ValueError(f"--device {spec!r}: only cpu and cuda devices")
    return [_device(d) for d in devices]


def _parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise SystemExit(
            f"error: address {s!r} must be HOST:PORT (e.g. 127.0.0.1:1234)"
        ) from None


def _batched_templates(fp, batch: int):
    """Yield (patterns u8 [n,1600], masks u8 [n,1600]) batches from a JSON stream.

    Uses the native C++ streaming parser when available (~2 orders of magnitude
    faster than per-object json.loads + bytes.fromhex), with a pure-Python
    fallback inside parse_templates_stream."""
    from mpc_iris_tpu_torch import native

    yield from native.parse_templates_stream(fp, batch=batch)


# ------------------------------------------------------------------ generate


def cmd_generate(args) -> int:
    if os.path.exists(args.path) and not args.replace:
        print(f"error: {args.path} exists (use --replace)", file=sys.stderr)
        return 1
    from mpc_iris_tpu_torch import native

    rng = np.random.default_rng(args.seed)
    count = args.count
    progress = Progress("generate", total=count, unit="templates")

    with open(args.path, "wb") as f:
        f.write(b"[")
        remaining = count
        first = True
        while remaining > 0:
            n = min(remaining, 2000)
            raw = rng.integers(0, 256, size=(n, TEMPLATE_BYTES), dtype=np.uint8)
            if not first:
                f.write(b",")
            f.write(native.render_templates(raw[:, :BITS_BYTES], raw[:, BITS_BYTES:]))
            first = False
            progress.update(n, n * TEMPLATE_BYTES)
            remaining -= n
        f.write(b"]\n")
    progress.finish()
    print(f"wrote {count} templates to {args.path}", file=sys.stderr)
    return 0


# ------------------------------------------------------------------ prepare


def _validate_store(base: str, n_shares: int, *, require_all_shares: bool,
                    require_masks: bool = True) -> tuple[int, list[int]]:
    """On-disk consistency checks shared by prepare --append, enroll and
    rekey; returns (entry count, indices of present share files).

    Every present file must be a whole number of records and all counts
    must agree; `<base>.share-<n_shares>` must NOT exist (a smaller-than-
    built share count would silently write (n-1)-party math into an
    n-party store). The data share (index n_shares-1) is always required;
    keyed-party files 0..n-2 are optional unless ``require_all_shares``.
    Raises ValueError with a CLI-ready message."""
    counts = {}
    present = []
    masks_path = f"{base}.masks"
    if require_masks or os.path.exists(masks_path):
        if not os.path.exists(masks_path):
            raise ValueError(
                f"{masks_path} does not exist (run prepare first)")
        size = os.path.getsize(masks_path)
        if size % BITS_BYTES:
            raise ValueError(
                f"{masks_path} is not a whole number of records")
        counts[masks_path] = size // BITS_BYTES
    rec = 2 * BITS
    for i in range(n_shares):
        p = f"{base}.share-{i}"
        if not os.path.exists(p):
            if require_all_shares or i == n_shares - 1:
                raise ValueError(
                    f"{p} does not exist (run prepare first"
                    + ("" if i == n_shares - 1 else
                       "; keyed parties may drop their files, but "
                       "--append needs all of them") + ")")
            continue
        size = os.path.getsize(p)
        if size % rec:
            raise ValueError(f"{p} is not a whole number of records")
        counts[p] = size // rec
        present.append(i)
    if os.path.exists(f"{base}.share-{n_shares}"):
        raise ValueError(
            f"{base}.share-{n_shares} exists — the store was built with "
            f"more than {n_shares} shares; pass the original share count")
    if len(set(counts.values())) != 1:
        raise ValueError(f"record counts disagree across the store: {counts}")
    return next(iter(counts.values())), present


def _check_keyed_streams(base: str, key: bytes, keyed_local: list[int],
                         count: int) -> str | None:
    """Spot-check local keyed share files' first/last rows against ``key``'s
    streams (SPEC §4.1); returns a CLI-ready error string on mismatch.
    Catches a wrong key and rerandomized stores (keystream + noise) before
    an operation that assumes pure keystreams writes anything."""
    from mpc_iris_tpu_torch import native

    for i in keyed_local:
        mm = np.memmap(f"{base}.share-{i}", dtype="<u2", mode="r",
                       shape=(count, BITS))
        for r in {0, count - 1}:
            if not np.array_equal(np.asarray(mm[r]),
                                  native.row_stream_u16(key, i, r)):
                return (
                    f"{base}.share-{i} row {r} does not match the key's "
                    "keystream — the store was rerandomized (keyed serving "
                    "no longer applies; see SPEC 4.2) or the key is wrong")
        del mm
    return None


def cmd_prepare(args) -> int:
    """Pipelined ETL: native streaming JSON parse -> native encode + share split
    -> file writes (the reference's 3-stage prepare pipeline, src/main.rs:268-383,
    with the hex/RNG hot loops in C++)."""
    from mpc_iris_tpu_torch import native

    # --backend device: before any file is touched, so a missing card fails
    # with the store as it was
    device = parse_devices(args.device)[0] if args.backend == "device" else None
    if args.key is not None and args.insecure_seed is not None:
        print("error: --key and --insecure-seed both name the share key; "
              "pass one", file=sys.stderr)
        return 1
    if args.key is not None:
        # Reuse a saved key (--save-key output) — required when appending to
        # a DB served by keyed participants: their streams are addressed by
        # (key, share, row), so appended rows must extend the SAME streams.
        from mpc_iris_tpu_torch.protocol.keyagree import read_key32

        try:
            share_key = read_key32(args.key)
        except (OSError, ValueError) as e:
            print(f"error: --key {args.key}: {e}", file=sys.stderr)
            return 1
    elif args.insecure_seed is not None:
        # Explicit testing path: brute-forceable key space, reproducible files.
        share_key = native.derive_insecure_key(args.insecure_seed)
        print("warning: --insecure-seed shares are NOT cryptographically "
              "secure (testing only)", file=sys.stderr)
    else:
        # The security property of the whole system: share randomness is a
        # ChaCha20 stream keyed from 256 bits of OS entropy (reference draws
        # every share from thread_rng, src/encoded_bits.rs:27-33).
        share_key = os.urandom(32)
    if args.save_key:
        # The key regenerates every share s < n-1 (SPEC §4.1 addressable
        # streams) — exactly as sensitive as those share files. Enables
        # keyed participants (zero share I/O; models.KeyedShareEngine).
        fd = os.open(args.save_key, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                     0o600)
        with os.fdopen(fd, "w") as kf:
            kf.write(share_key.hex() + "\n")
        print(f"share key written to {args.save_key} (0600): keep it as "
              "secret as the share files — it regenerates shares 0.."
              f"{args.count - 2}", file=sys.stderr)
    n_shares = args.count
    base = args.output
    masks_path = f"{base}.masks"
    share_paths = [f"{base}.share-{i}" for i in range(n_shares)]
    row = 0
    if args.append:
        # Incremental ETL (the reference's explicit TODO, src/main.rs:402):
        # extend an existing store in place. With the original key the
        # appended rows continue the same addressable streams, so keyed
        # participants stay valid (refresh the row count, SPEC §4.1); running
        # file-backed roles pick the rows up via --watch.
        try:
            row, _ = _validate_store(base, n_shares, require_all_shares=True)
        except ValueError as e:
            print(f"error: --append: {e}", file=sys.stderr)
            return 1
        if args.key is None and args.insecure_seed is None:
            print("warning: --append with a fresh random key: file-backed "
                  "parties are unaffected, but keyed:<s>:...:<keyfile> specs "
                  "minted from the ORIGINAL key cannot regenerate the "
                  "appended rows — pass --key to extend the same streams",
                  file=sys.stderr)
        print(f"appending after {row} existing entries", file=sys.stderr)
    else:
        for p in [masks_path, *share_paths]:
            if os.path.exists(p):
                os.remove(p)

    # --backend device draws from the SAME addressable ChaCha20 streams as
    # the host path (ops/encode.py::share_split_device), so both backends are
    # crypto-grade, byte-identical for the same key, and --save-key works.

    progress = Progress("prepare", unit="templates")
    masks_f = open(masks_path, "ab")
    share_fs = [open(p, "ab") for p in share_paths]
    try:
        with open(args.input, "rb") as f:
            for pats, msks in _batched_templates(f, args.batch):
                n = pats.shape[0]
                if args.backend == "device":
                    from mpc_iris_tpu_torch.ops.encode import share_split_device

                    # shares 0..n-2 from the ChaCha20 kernel on the card
                    # (its plain version on a CPU device)
                    shares = share_split_device(pats, msks, n_shares, share_key,
                                                row_offset=row, device=device)
                else:
                    enc = native.encode_u16_native(pats, msks)  # [n, 12800] u16
                    shares = native.share_split(enc, n_shares, share_key,
                                                row_offset=row)
                masks_f.write(msks.tobytes())
                for i in range(n_shares):
                    # native-endianness == little on all supported hosts; the
                    # store format is explicitly little-endian (<u2).
                    share_fs[i].write(shares[i].astype("<u2", copy=False).tobytes())
                row += n
                progress.update(n, n * (BITS_BYTES + n_shares * 2 * BITS))
    finally:
        masks_f.close()
        for f in share_fs:
            f.close()
    progress.finish()
    # Count sidecar for keyed parties (they store no share bytes to stat):
    # written atomically so a `--watch-count` watcher never reads torn text.
    tmp = f"{base}.count.tmp"
    with open(tmp, "w") as cf:
        cf.write(f"{row}\n")
    os.replace(tmp, f"{base}.count")
    print(
        f"wrote {masks_path}, {n_shares} share files and {base}.count "
        f"({row} entries)", file=sys.stderr
    )
    return 0


# ------------------------------------------------------------------ decrypt


def parse_keyed_spec(spec: str) -> tuple[int, int, bytes]:
    """Parse ``keyed:<share-index>:<count>:<keyfile>`` -> (index, count, key).

    Single parser for every role that accepts keyed shares (participant,
    decrypt) so format evolution and validation cannot drift. Raises
    ValueError with a usage hint on any malformed part."""
    from mpc_iris_tpu_torch.ops.chacha import check_stream_id
    from mpc_iris_tpu_torch.utils.config import parse_si

    try:
        _, s_idx, s_count, key_path = spec.split(":", 3)
        sid = check_stream_id(int(s_idx))
        count = parse_si(s_count)
        with open(key_path) as kf:
            key = bytes.fromhex(kf.read().strip())
        if len(key) != 32:
            raise ValueError(f"key file holds {len(key)} bytes, want 32")
    except (ValueError, OSError) as e:
        raise ValueError(
            f"bad keyed share spec {spec!r} "
            f"(want keyed:<share-index>:<count>:<keyfile>): {e}"
        ) from e
    return sid, count, key


class _KeyedShareView:
    """Host-side lazy view of a PRF-backed share (SPEC §4.2): rows are
    regenerated from the key on slice access via the native ChaCha20 core.
    Lets `decrypt` reconstruct with keyed:<s>:<count>:<keyfile> specs in
    place of share files."""

    def __init__(self, key: bytes, stream_id: int, count: int):
        from mpc_iris_tpu_torch.ops.chacha import check_stream_id

        self._key = key
        self._sid = check_stream_id(stream_id)
        self.shape = (int(count), BITS)

    def __getitem__(self, sl):
        from mpc_iris_tpu_torch import native

        start, stop, step = sl.indices(self.shape[0])
        rows = range(start, stop, step)
        out = np.empty((len(rows), BITS), np.uint16)
        for i, r in enumerate(rows):
            # SPEC §4.1 row addressing lives in native.row_stream_u16 —
            # the single Python-side source of truth for the nonce layout.
            out[i] = native.row_stream_u16(self._key, self._sid, r)
        return out


def _open_share_or_keyed(spec):
    if isinstance(spec, str) and spec.startswith("keyed:"):
        sid, count, key = parse_keyed_spec(spec)
        return _KeyedShareView(key, sid, count)
    return open_share(spec)


def cmd_decrypt(args) -> int:
    from mpc_iris_tpu_torch import native

    mats = [_open_share_or_keyed(p) for p in args.shares]
    n = min(m.shape[0] for m in mats)
    if any(m.shape[0] != n for m in mats):
        print("warning: share files differ in length; truncating", file=sys.stderr)
    progress = Progress("decrypt", total=n, unit="templates")

    with open(args.output, "wb") as f:
        f.write(b"[")
        first = True
        for start in range(0, n, args.batch):
            end = min(n, start + args.batch)
            total = native.share_sum(
                [np.asarray(m[start:end], dtype=np.uint16) for m in mats]
            )
            # Invert the ring encoding per bit: 0 -> masked-out, 1 -> unset,
            # 0xFFFF -> set (reference src/lib.rs:16-26). Pattern bits outside
            # the mask decode as 0.
            pattern = _pack_bits_np(total == 0xFFFF)
            mask = _pack_bits_np(total != 0)
            if not first:
                f.write(b",")
            f.write(native.render_templates(pattern, mask))
            first = False
            progress.update(end - start)
        f.write(b"]\n")
    progress.finish()
    print(f"wrote {n} templates to {args.output}", file=sys.stderr)
    return 0


# ------------------------------------------------------------------ store-check


def cmd_store_check(args) -> int:
    """fsck for a share store: structural integrity of <base>.masks /
    <base>.share-i / <base>.count, optional keyed-keystream verification, and
    optional deep share<->masks consistency on sampled rows. The reference
    has no integrity tooling (its mmap'd casts trust the bytes,
    src/main.rs:386-400); a corrupted store would silently bias uniqueness
    verdicts."""
    import glob

    from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES

    base = args.store
    problems = []
    warnings_ = []

    def say(line):
        print(line, file=sys.stderr)

    # ---- discover files
    masks_path = f"{base}.masks"
    if not os.path.exists(masks_path):
        print(f"error: {masks_path} not found", file=sys.stderr)
        return 1
    # An fsck tool must survive the garbage it exists to find: skip (and
    # report) stray files like <base>.share-backup instead of crashing on
    # the numeric sort key.
    share_paths = []
    for p in glob.glob(f"{base}.share-*"):
        try:
            int(p.rsplit("-", 1)[1])
        except ValueError:
            problems.append(
                f"{p}: unrecognized share filename (expected {base}.share-<i>)"
            )
            continue
        share_paths.append(p)
    share_paths.sort(key=lambda p: int(p.rsplit("-", 1)[1]))
    if args.count and len(share_paths) != args.count:
        problems.append(
            f"expected {args.count} share files, found {len(share_paths)}"
        )
    if not share_paths:
        problems.append(f"no {base}.share-* files found")

    # ---- structural: whole records, equal row counts, torn tails
    def rows_of(path, rec):
        size = os.path.getsize(path)
        torn = size % rec
        if torn:
            msg = (f"{path}: {torn} trailing bytes beyond the last whole "
                   f"record (torn append in progress?)")
            (problems if args.strict else warnings_).append(msg)
        return size // rec

    n_masks = rows_of(masks_path, BITS_BYTES)
    share_rows_counts = [rows_of(p, 2 * BITS) for p in share_paths]
    say(f"{masks_path}: {n_masks} rows")
    for p, n in zip(share_paths, share_rows_counts):
        say(f"{p}: {n} rows")
    n = min([n_masks] + share_rows_counts) if share_paths else n_masks
    if share_paths and any(c != n_masks for c in share_rows_counts):
        problems.append(
            f"row counts differ: masks={n_masks}, shares="
            f"{share_rows_counts} (growth must append to every file)"
        )
    if n == 0:
        problems.append("store has zero whole records")

    count_path = f"{base}.count"
    if os.path.exists(count_path):
        try:
            with open(count_path) as cf:
                sidecar = int(cf.read().strip())
        except ValueError:
            problems.append(
                f"{count_path}: unparseable count sidecar (not an integer)"
            )
        else:
            say(f"{count_path}: {sidecar}")
            if sidecar != n_masks:
                problems.append(
                    f"count sidecar says {sidecar} but masks holds {n_masks} "
                    "whole rows (keyed parties follow the sidecar)"
                )

    # ---- sampled rows (deterministic spread incl. first and last)
    k = max(1, min(args.sample, n)) if n else 0
    sample = sorted({int(i) for i in np.linspace(0, max(0, n - 1), k)})

    masks_mm = np.memmap(masks_path, dtype=np.uint8, mode="r",
                         shape=(n_masks, BITS_BYTES)) if n_masks else None
    share_mms = [
        np.memmap(p, dtype="<u2", mode="r", shape=(c, BITS))
        for p, c in zip(share_paths, share_rows_counts)
    ]

    # ---- keyed keystream verification (--key): streams s < n_shares-1 must
    # be the exact ChaCha20 keystream of (key, s, row) — SPEC section 4.1.
    if args.key is not None and share_paths and sample:
        from mpc_iris_tpu_torch.ops.chacha import key_tensor, share_rows
        from mpc_iris_tpu_torch.protocol.keyagree import read_key32

        # the keystream rows on the first --device (int64 arithmetic there)
        kw = key_tensor(read_key32(args.key), parse_devices(args.device)[0])
        for s, mm in enumerate(share_mms[:-1]):
            bad = []
            for r in sample:
                if r >= mm.shape[0]:
                    continue
                want = share_rows(kw, s, r, 1)[0].cpu().numpy().astype(np.uint16)
                if not np.array_equal(np.asarray(mm[r]), want):
                    bad.append(r)
            if bad:
                problems.append(
                    f"{share_paths[s]}: rows {bad} are NOT the keystream of "
                    f"(key, stream {s}) — rerandomized store or wrong key"
                )
            else:
                say(f"{share_paths[s]}: keystream OK on {len(sample)} "
                    "sampled rows")

    # ---- deep share<->masks consistency (--deep): reconstruct sampled rows
    # from ALL share files; the ring alphabet must be {0, 1, 0xFFFF} and the
    # mask derived from the encoding must equal the masks file row.
    if args.deep and share_paths and sample:
        if any(c < n for c in share_rows_counts):
            problems.append("--deep needs every share file at the store's "
                            "row count")
        else:
            bad_alpha, bad_mask = [], []
            for r in sample:
                total = share_mms[0][r].astype(np.int64)
                for mm in share_mms[1:]:
                    total = (total + mm[r]) & 0xFFFF
                legal = np.isin(total, (0, 1, 0xFFFF))
                if not legal.all():
                    bad_alpha.append(r)
                    continue
                derived = _pack_bits_np((total != 0)[None])[0]
                if not np.array_equal(derived, np.asarray(masks_mm[r])):
                    bad_mask.append(r)
            if bad_alpha:
                problems.append(
                    f"rows {bad_alpha}: reconstructed encoding leaves the "
                    "{0, 1, 0xFFFF} ring alphabet — corrupted or mismatched "
                    "share files"
                )
            if bad_mask:
                problems.append(
                    f"rows {bad_mask}: mask derived from the reconstructed "
                    "encoding differs from the masks file — shares and masks "
                    "are out of sync"
                )
            if not bad_alpha and not bad_mask:
                say(f"deep check OK: {len(sample)} sampled rows reconstruct "
                    "to legal encodings matching the masks file")

    for w in warnings_:
        print(f"warning: {w}", file=sys.stderr)
    if problems:
        for p in problems:
            print(f"PROBLEM: {p}", file=sys.stderr)
        print(f"store-check: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print(f"store-check: OK ({n_masks} rows, {len(share_paths)} share files"
          + (f", {len(warnings_)} warning(s)" if warnings_ else "") + ")",
          file=sys.stderr)
    return 0


# ------------------------------------------------------------------ rerandomize


def cmd_rerandomize(args) -> int:
    """Refresh a share file with pairwise zero-sum ChaCha20 streams (the
    reference spec's "re-randomization via correlated PRNGs" — future work
    there, implemented here as an offline pass). Each --pair J:KEY names
    another party and the 256-bit key shared with it; the party with the LOWER
    index adds the stream, the higher one subtracts, so the noise cancels in
    reconstruction. All parties must run this with consistent pair keys before
    serving again.
    """
    from mpc_iris_tpu_torch import native

    pairs = []
    for spec in args.pair:
        j_s, _, key_s = spec.partition(":")
        if key_s.startswith("@"):  # hex keyfile, e.g. `pair-key --out` output
            from mpc_iris_tpu_torch.protocol.keyagree import read_key32

            try:
                key_bytes = read_key32(key_s[1:])
            except (OSError, ValueError) as e:
                print(f"error: pair keyfile {key_s[1:]}: {e}", file=sys.stderr)
                return 1
        else:
            key_int = int(key_s, 0)
            if not 0 <= key_int < 2**256:
                print(f"error: pair key {j_s}:... exceeds 256 bits",
                      file=sys.stderr)
                return 1
            key_bytes = key_int.to_bytes(32, "little")
        pairs.append((int(j_s), key_bytes))
    if not pairs:
        print("error: at least one --pair J:KEY is required", file=sys.stderr)
        return 1
    if any(j == args.index for j, _ in pairs):
        print("error: --pair index equals own --index", file=sys.stderr)
        return 1

    share = open_share(args.share)
    n = share.shape[0]
    out_path = args.output or args.share
    progress = Progress("rerandomize", total=n, unit="templates")
    tmp_path = out_path + ".tmp"
    with open(tmp_path, "wb") as out:
        for start in range(0, n, args.batch):
            end = min(n, start + args.batch)
            # Explicit copy: memmap slices are read-only views and rerandomize
            # mutates in place.
            block = np.array(share[start:end], dtype=np.uint16, copy=True)
            for j, pair_key in pairs:
                native.rerandomize(
                    block, pair_key, +1 if args.index < j else -1,
                    row_offset=start,
                )
            out.write(block.astype("<u2", copy=False).tobytes())
            progress.update(end - start, (end - start) * 2 * BITS)
    del share
    os.replace(tmp_path, out_path)
    progress.finish()
    print(f"rerandomized {n} shares -> {out_path}", file=sys.stderr)
    return 0


def cmd_rekey(args) -> int:
    """Rotate a keyed deployment's share-key epoch (SPEC §4.3).

    Keyed shares s < n-1 are fixed functions of the 32-byte key, so the
    file-oriented `rerandomize` cannot refresh them. Rotation replaces the
    key: for every row, new_data = old_data + Σ_s ks_old(s,row) −
    Σ_s ks_new(s,row) (wrapping u16), computed WITHOUT ever reconstructing
    the plaintext — the keystream sums come from share-splitting all-zero
    rows (shares of 0 are exactly the keystreams and their negated sum).
    Rewrites the data share (index n-1) and any locally-kept keyed-party
    files atomically (tmp+rename per file), then writes the new key (0600).
    Run it offline: parties must switch key/files for an epoch together."""
    from mpc_iris_tpu_torch import native
    from mpc_iris_tpu_torch.protocol.keyagree import read_key32

    try:
        old_key = read_key32(args.old_key)
    except (OSError, ValueError) as e:
        print(f"error: --old-key {args.old_key}: {e}", file=sys.stderr)
        return 1
    if args.insecure_new_seed is not None:
        new_key = native.derive_insecure_key(args.insecure_new_seed)
        print("warning: --insecure-new-seed keys are NOT cryptographically "
              "secure (testing only)", file=sys.stderr)
    else:
        new_key = os.urandom(32)
    if new_key == old_key:
        print("error: new key equals old key", file=sys.stderr)
        return 1

    base = args.store
    n_shares = args.count
    data_path = f"{base}.share-{n_shares - 1}"
    rec = 2 * BITS
    try:
        n, present = _validate_store(base, n_shares,
                                     require_all_shares=False,
                                     require_masks=False)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if n == 0:
        print("error: the store is empty — nothing to rekey", file=sys.stderr)
        return 1
    keyed_local = [i for i in present if i < n_shares - 1]
    # The rotation math assumes shares 0..n-2 are PURE keystream of the old
    # key; a rerandomized store or a wrong --old-key would silently corrupt
    # reconstruction of every entry.
    err = _check_keyed_streams(base, old_key, keyed_local, n)
    if err is not None:
        print(f"error: {err}; refusing to rotate", file=sys.stderr)
        return 1
    if not keyed_local:
        print("warning: no local keyed share file to verify --old-key "
              "against — a wrong key here corrupts the store irrecoverably; "
              "double-check it is the store's current epoch key",
              file=sys.stderr)

    # The new key is written FIRST (O_EXCL: no overwrite, no TOCTOU): once
    # any share file is replaced the old epoch cannot fully serve, and in a
    # keyed deployment the new keystream sums exist nowhere else — losing
    # the key after the replaces would destroy the DB.
    try:
        fd = os.open(args.new_key_out,
                     os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    except OSError as e:
        print(f"error: cannot create {args.new_key_out}: {e}",
              file=sys.stderr)
        return 1
    with os.fdopen(fd, "w") as kf:
        kf.write(new_key.hex() + "\n")

    data = np.memmap(data_path, dtype="<u2", mode="r", shape=(n, BITS))
    outs = {i: open(f"{base}.share-{i}.rekey.tmp", "wb")
            for i in [*keyed_local, n_shares - 1]}
    progress = Progress("rekey", total=n, unit="templates")
    replaced = False
    try:
        try:
            zeros = None
            with np.errstate(over="ignore"):
                for start in range(0, n, args.batch):
                    end = min(n, start + args.batch)
                    if zeros is None or zeros.shape[0] != end - start:
                        zeros = np.zeros((end - start, BITS), np.uint16)
                    # Shares of 0: zs[s] = ks(s, row) for s < n-1, and
                    # zs[n-1] = -(sum of keystreams).
                    zs_old = native.share_split(zeros, n_shares, old_key,
                                                row_offset=start)
                    zs_new = native.share_split(zeros, n_shares, new_key,
                                                row_offset=start)
                    block = np.array(data[start:end], dtype=np.uint16,
                                     copy=True)
                    block -= zs_old[n_shares - 1]  # += sum of old keystreams
                    block += zs_new[n_shares - 1]  # -= sum of new keystreams
                    outs[n_shares - 1].write(block.astype("<u2").tobytes())
                    for i in keyed_local:
                        outs[i].write(zs_new[i].astype("<u2").tobytes())
                    progress.update(end - start, (end - start) * rec)
        finally:
            for f in outs.values():
                f.close()
        del data
        progress.finish()
        # Keyed files first, the data share LAST: keyed files are
        # regenerable from either key, so the epoch is defined by the data
        # share and a crash mid-replace leaves a recoverable store (old
        # epoch still decodable).
        for i in keyed_local:
            os.replace(f"{base}.share-{i}.rekey.tmp", f"{base}.share-{i}")
            replaced = True
        os.replace(f"{data_path}.rekey.tmp", data_path)
    except BaseException:
        # Nothing switched epochs yet -> remove the stray new key (once any
        # file was replaced, BOTH keys matter and must be kept). Tmp files
        # are always safe to drop.
        if not replaced:
            try:
                os.unlink(args.new_key_out)
            except OSError:
                pass
        for i in outs:
            try:
                os.unlink(f"{base}.share-{i}.rekey.tmp")
            except OSError:
                pass
        raise
    print(f"rekeyed {n} entries across {len(outs)} local share files; new "
          f"key in {args.new_key_out} (0600) — switch every party to the "
          "new epoch together", file=sys.stderr)
    return 0


# ------------------------------------------------------------------ key agreement


def cmd_keygen(args) -> int:
    """Generate an X25519 re-randomization identity (spec future-work "DH"
    half; protocol/keyagree.py). Writes the private key to PATH (hex, 0600)
    and the public key to PATH.pub, and prints the public key to share with
    the other parties out of band."""
    from mpc_iris_tpu_torch.protocol import keyagree

    try:
        pub = keyagree.generate_identity(args.output)
    except (RuntimeError, FileExistsError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"identity written to {args.output} (public: {args.output}.pub)",
          file=sys.stderr)
    print(pub.hex())
    return 0


def cmd_pair_key(args) -> int:
    """Derive the 256-bit pairwise stream key shared with one peer from my
    X25519 identity and the peer's public key — both sides derive the SAME
    key (keyagree.derive_pair_key), ready for `rerandomize --pair J:KEY`."""
    from mpc_iris_tpu_torch.protocol import keyagree

    try:
        peer = keyagree.parse_public(args.peer_public)
        key = keyagree.derive_pair_key(
            args.identity, peer, context=args.context.encode()
        )
    except (RuntimeError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.out:
        try:
            fd = os.open(args.out, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        with os.fdopen(fd, "w") as f:
            f.write(key.hex() + "\n")
        print(f"pair key written to {args.out}; use "
              f"rerandomize --pair J:@{args.out}", file=sys.stderr)
    else:
        # Little-endian-integer form, directly usable inline as
        # --pair J:0x...; keyfiles accept it too (read_key32 decodes the 0x
        # form identically, so copying this line into a file is safe).
        print(f"0x{int.from_bytes(key, 'little'):064x}")
    return 0


def cmd_tls_cert(args) -> int:
    """Mint a self-signed key + certificate (protocol/tlsutil.py) for TLS on
    the participant wire — the reference protocol has no transport security
    (src/main.rs:405-445)."""
    from mpc_iris_tpu_torch.protocol import tlsutil

    try:
        key_path, crt_path = tlsutil.generate_self_signed(args.prefix, args.name)
    except (RuntimeError, FileExistsError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {key_path} (0600) and {crt_path}; distribute the .crt to "
          "peers as (part of) their --tls-ca bundle", file=sys.stderr)
    return 0


# ------------------------------------------------------------------ participant


def _sizes(chunk=None, batch_hint=None) -> dict:
    """Engine keyword arguments for the sizes a flag set; the engines' own
    defaults for those left unset (``models.engines.DEFAULT_CHUNK``)."""
    kw = {}
    if chunk:
        kw["chunk"] = chunk
    if batch_hint:
        kw["batch_hint"] = batch_hint
    return kw


def _db_mesh(devices):
    """A [len(devices), 1] mesh: the MPC engines shard the DB axis only."""
    from mpc_iris_tpu_torch.parallel import make_mesh

    return make_mesh(db=len(devices), batch=1, devices=devices)


def _make_share_engine(share_mat, chunk=None, batch_hint=None, device: str = "cuda"):
    """ShareEngine on the one ``--device``, or ShardedShareEngine over the
    DB axis of several."""
    from mpc_iris_tpu_torch.models import ShareEngine
    from mpc_iris_tpu_torch.parallel import ShardedShareEngine

    devices = parse_devices(device)
    if len(devices) > 1:
        return ShardedShareEngine(share_mat, _db_mesh(devices), **_sizes(chunk))
    return ShareEngine(share_mat, device=devices[0], **_sizes(chunk, batch_hint))


def _share_engine_from_spec(spec: str, chunk=None, batch_hint=None,
                            device: str = "cuda"):
    """Share engine for a share FILE or a ``keyed:<s>:<count>:<keyfile>``
    spec — the single constructor behind every role that serves a share
    (participant, coordinator --share), on ``device`` (the ``--device``
    list: sharded over the DB axis when it names several). batch_hint sizes
    the single-device engines' workspace headroom for the largest expected
    query batch. Raises ValueError on a malformed keyed spec."""
    if spec.startswith("keyed:"):
        # PRF-backed share (s < n-1) regenerated on device from the prepare
        # key by the ChaCha20 kernel: zero share I/O (SPEC §4.2; key from
        # `prepare --save-key`).
        from mpc_iris_tpu_torch.models import KeyedShareEngine
        from mpc_iris_tpu_torch.parallel import ShardedKeyedShareEngine

        sid, count, key = parse_keyed_spec(spec)
        devices = parse_devices(device)
        if len(devices) > 1:
            engine = ShardedKeyedShareEngine(key, sid, count, _db_mesh(devices),
                                             **_sizes(chunk))
        else:
            engine = KeyedShareEngine(key, sid, count, device=devices[0],
                                      **_sizes(chunk, batch_hint))
        print(f"keyed share {sid}: {count} entries regenerated on "
              f"{len(devices)} device(s) (no share file)",
              file=sys.stderr)
        return engine
    share = open_share(spec)
    print(f"opened share {spec}: {share.shape[0]} encrypted patterns "
          f"({os.path.getsize(spec)} bytes)", file=sys.stderr)
    return _make_share_engine(share, chunk, batch_hint, device)


def make_share_watcher(path: str, engine):
    """Zero-arg DB-sync callable for a file-backed share engine: stat the
    share file and adopt any appended whole records (the reference's TODO at
    src/main.rs:415). Torn trailing bytes from an in-progress append are
    ignored until the writer completes the record, and transient file errors
    (momentarily missing/replaced file) skip the sync instead of killing the
    serving loop. Returns rows added (0 on no change) so callers can log."""
    row_bytes = 2 * BITS

    def refresh() -> int:
        try:
            rows = os.path.getsize(path) // row_bytes
            if rows <= engine.count:
                return 0
            mm = np.memmap(path, dtype="<u2", mode="r", shape=(rows, BITS))
            added = engine.refresh(mm)
        except (OSError, ValueError) as e:
            print(f"db sync: skipping {path}: {e}", file=sys.stderr)
            return 0
        print(f"db sync: +{added} entries from {path} "
              f"({engine.count} total)", file=sys.stderr)
        return added

    return refresh


def make_keyed_count_watcher(path: str, engine):
    """DB-sync callable for a KEYED share engine: a keyed party stores no
    share bytes, so growth is learned from a count SOURCE — the text sidecar
    `prepare` maintains (`<base>.count`), delivered to the party out-of-band
    (it is public: the DB size). Unreadable/torn/empty files are skipped
    until the writer completes; a shrunk count is refused loudly (keyed
    refresh is append-only) but never kills the serving loop."""

    def refresh() -> int:
        try:
            with open(path) as cf:
                text = cf.read().strip()
            count = parse_si(text) if text else 0
        except (OSError, ValueError):
            return 0  # mid-write or absent: adopt it on the next request
        if count <= engine.count:
            if 0 < count < engine.count:
                print(f"db sync: ignoring shrunk count {count} < "
                      f"{engine.count} from {path} (append-only; restart "
                      "the participant for a rebuilt DB)", file=sys.stderr)
            return 0
        added = engine.refresh(count)
        print(f"db sync: +{added} keyed entries from {path} "
              f"({engine.count} total)", file=sys.stderr)
        return added

    return refresh


def make_keyed_masks_follower(local_engine, masks_engine):
    """Coordinator-side keyed sync: the masks DB and the share DB are the
    same logical DB, so after the masks watcher adopts appended rows the
    keyed local share simply follows the masks count (no sidecar needed)."""

    def refresh() -> int:
        target = masks_engine.count
        if target <= local_engine.count:
            return 0
        added = local_engine.refresh(target)
        print(f"db sync: +{added} keyed local-share rows (masks count "
              f"{target})", file=sys.stderr)
        return added

    return refresh


def make_db_watchers(masks_path: str, masks_engine, share_spec,
                     local_engine) -> list:
    """The coordinator-side DB-sync hook set (shared by coordinator --watch
    and enroll): adopt appended masks, then bring a local share engine along
    — a keyed local share follows the refreshed masks count (same logical
    DB), a file-backed one stats its own file."""
    watchers = [make_masks_watcher(masks_path, masks_engine)]
    if share_spec:
        if share_spec.startswith("keyed:"):
            watchers.append(
                make_keyed_masks_follower(local_engine, masks_engine))
        else:
            watchers.append(make_share_watcher(share_spec, local_engine))
    return watchers


def make_masks_watcher(path: str, engine):
    """DB-sync callable for a masks engine (coordinator side of the
    reference's sync TODO): adopt appended whole 1,600-byte mask records.
    Transient file errors skip the sync (same contract as
    make_share_watcher) — a blipping mount must not kill the query loop."""

    def refresh() -> int:
        try:
            rows = os.path.getsize(path) // BITS_BYTES
            if rows <= engine.count:
                return 0
            mm = np.memmap(path, dtype=np.uint8, mode="r",
                           shape=(rows, BITS_BYTES))
            added = engine.refresh(mm)
        except (OSError, ValueError) as e:
            print(f"db sync: skipping {path}: {e}", file=sys.stderr)
            return 0
        print(f"db sync: +{added} masks from {path} "
              f"({engine.count} total)", file=sys.stderr)
        return added

    return refresh


def _attach_observability(loop, role: str, stats_fn=None,
                          profile_dir: str | None = None, device=None):
    """On-demand serving observability without a restart (SPEC §5; the
    reference has only eprintln progress lines, src/main.rs:178-183):

    - SIGUSR1: dump the server's counters + latency quantiles (and the
      device memory of ``device``, the role's first device) as one JSON
      line on stderr.
    - SIGUSR2: toggle a ``torch.profiler`` trace (CPU ops and the cards'
      CUDA kernels, whichever thread launches them) into ``profile_dir``: a
      fresh trace-<timestamp> subdir per capture, exported there as a
      Chrome/Perfetto trace when the capture stops. Without --profile-dir
      the signal logs a hint instead.

    Both handlers run on the event-loop thread. Returns a cleanup() that
    stops and exports any open trace (so it is readable, not lost) and
    detaches the handlers."""
    import json as _json
    import signal as _signal
    import time as _time

    from mpc_iris_tpu_torch.utils.profiling import (
        device_memory_stats,
        start_trace,
        stop_trace,
    )

    state = {"active": False, "dir": None, "prof": None}

    def on_usr1():
        try:
            s = dict(stats_fn()) if stats_fn else {}
        except Exception as e:  # stats must never kill a serving role
            s = {"stats_error": str(e)}
        s["hbm"] = device_memory_stats(device)
        s["trace_active"] = state["active"]
        print(f"{role}: stats {_json.dumps(s)}", file=sys.stderr, flush=True)

    def on_usr2():
        if profile_dir is None:
            print(f"{role}: SIGUSR2 ignored — start with --profile-dir to "
                  "enable on-demand device traces", file=sys.stderr,
                  flush=True)
            return
        if not state["active"]:
            d = os.path.join(profile_dir,
                             _time.strftime("trace-%Y%m%d-%H%M%S"))
            try:
                os.makedirs(d, exist_ok=True)
                prof = start_trace()
            except Exception as e:
                print(f"{role}: trace start failed: {e}", file=sys.stderr,
                      flush=True)
                return
            state.update(active=True, dir=d, prof=prof)
            print(f"{role}: device trace STARTED -> {d} (SIGUSR2 again to "
                  "stop)", file=sys.stderr, flush=True)
        else:
            try:
                path = stop_trace(state["prof"], state["dir"])
            finally:
                state.update(active=False, prof=None)
            print(f"{role}: device trace stopped -> {path}",
                  file=sys.stderr, flush=True)

    hooked = []
    for sig, fn in ((getattr(_signal, "SIGUSR1", None), on_usr1),
                    (getattr(_signal, "SIGUSR2", None), on_usr2)):
        if sig is None:
            continue
        try:
            loop.add_signal_handler(sig, fn)
            hooked.append(sig)
        except (NotImplementedError, RuntimeError):
            pass  # non-Unix loop: observability signals unavailable

    def cleanup():
        if state["active"]:
            try:
                stop_trace(state["prof"], state["dir"])
            except Exception:
                pass
            state.update(active=False, prof=None)
            print(f"{role}: open device trace closed at shutdown -> "
                  f"{state['dir']}", file=sys.stderr, flush=True)
        for sig in hooked:
            try:
                loop.remove_signal_handler(sig)
            except (NotImplementedError, RuntimeError):
                pass

    return cleanup


async def _serve_until_signal(server, grace: float, role: str,
                              profile_dir: str | None = None,
                              device=None) -> int:
    """Run a serving role until SIGTERM/SIGINT, then DRAIN: stop accepting,
    let in-flight requests finish streaming (up to `grace` seconds — the
    reference's clean-shutdown TODO, src/main.rs:449/631/641). A second
    signal force-quits immediately; exit code 1 when the grace expired with
    requests still running. SIGUSR1/SIGUSR2 give an on-demand stats dump /
    device-trace toggle (see :func:`_attach_observability`)."""
    import contextlib
    import signal as _signal

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    obs_cleanup = _attach_observability(
        loop, role, stats_fn=getattr(server, "stats", None),
        profile_dir=profile_dir, device=device,
    )

    def on_signal():
        if stop.is_set():
            os._exit(1)
        stop.set()

    hooked = []
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            loop.add_signal_handler(sig, on_signal)
            hooked.append(sig)
        except (NotImplementedError, RuntimeError):
            pass  # non-Unix event loop: KeyboardInterrupt path still works

    serve_task = asyncio.ensure_future(server.serve_forever())
    stop_task = asyncio.ensure_future(stop.wait())
    try:
        await asyncio.wait({serve_task, stop_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if serve_task.done():
            # The server died (signal or not): surface that, don't "drain"
            # a dead listener into a clean exit.
            return serve_task.result() or 0  # propagates serve errors
        print(f"{role}: signal received — draining (no new connections; "
              f"up to {grace:.0f}s for in-flight requests; signal again to "
              "force quit)", file=sys.stderr)
        drained = await server.drain(grace)
        if not drained:
            # The connections that outlived the grace are exactly what would
            # make close() wait forever — hard-close them so shutdown stays
            # bounded, and bound close() itself as a backstop.
            n = server.abort_connections()
            print(f"{role}: drain grace expired — aborted {n} in-flight "
                  "connection(s)", file=sys.stderr)
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(server.close(), 10)
        if not drained:
            return 1
        print(f"{role}: drained cleanly", file=sys.stderr)
        return 0
    finally:
        for t in (serve_task, stop_task):
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception as e:  # a real serve error must not vanish
                print(f"{role}: server task failed: {e}", file=sys.stderr)
        obs_cleanup()
        for sig in hooked:
            loop.remove_signal_handler(sig)


def cmd_participant(args) -> int:
    from mpc_iris_tpu_torch.protocol import ParticipantServer

    # TLS material is validated FIRST: a typo'd cert path must fail in
    # milliseconds, not after the engine build and its warm-up pass.
    ssl_ctx = None
    if args.tls_cert or args.tls_key or args.tls_ca:
        if not (args.tls_cert and args.tls_key):
            print("error: TLS needs both --tls-cert and --tls-key",
                  file=sys.stderr)
            return 1
        import ssl

        from mpc_iris_tpu_torch.protocol import tlsutil

        try:
            ssl_ctx = tlsutil.server_context(args.tls_cert, args.tls_key,
                                             ca=args.tls_ca)
        except (OSError, ssl.SSLError) as e:
            print(f"error: cannot load TLS material: {e}", file=sys.stderr)
            return 1
        mode = "mutual TLS" if args.tls_ca else "TLS"
        print(f"{mode} enabled ({args.tls_cert})", file=sys.stderr)

    # Chain-hop TLS material is validated FIRST too — same fail-fast rule.
    upstream_ssl = None
    if args.chain_tls_ca:
        if args.wire != "chain":
            print("error: --chain-tls-ca requires --wire chain",
                  file=sys.stderr)
            return 1
        import ssl as _ssl

        from mpc_iris_tpu_torch.protocol import tlsutil

        try:
            upstream_ssl = tlsutil.client_context(
                args.chain_tls_ca, certfile=args.tls_cert,
                keyfile=args.tls_key,
            )
        except (OSError, _ssl.SSLError) as e:
            print(f"error: cannot load --chain-tls-ca material: {e}",
                  file=sys.stderr)
            return 1

    devices = parse_devices(args.device)
    print(device_banner(devices), file=sys.stderr)
    try:
        engine = _share_engine_from_spec(args.input, args.chunk,
                                         args.batch_hint, args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.warmup:
        # Run the per-chunk shapes once so the first real query is served at
        # steady-state speed (the allocator's pools and the libraries' first
        # calls are paid here).
        t0 = time.monotonic()
        rng = np.random.default_rng(0)
        wb = args.warmup_batch if args.wire in ("batched", "chain") else 1
        qp = rng.integers(0, 256, (wb, BITS_BYTES), dtype=np.uint8)
        qm = rng.integers(0, 256, (wb, BITS_BYTES), dtype=np.uint8)
        next(iter(engine.stream(qp, qm)))
        print(f"warmup done in {time.monotonic() - t0:.1f}s "
              f"(batch {wb})", file=sys.stderr)

    refresh = None
    if args.watch:
        if args.input.startswith("keyed:"):
            if not args.watch_count:
                print("error: --watch on a keyed share needs --watch-count "
                      "FILE (a keyed party stores no share bytes to stat; "
                      "`prepare` maintains the `<base>.count` sidecar — "
                      "deliver it alongside DB growth)", file=sys.stderr)
                return 1
            refresh = make_keyed_count_watcher(args.watch_count, engine)
            print(f"--watch: syncing keyed row count from "
                  f"{args.watch_count} before each request", file=sys.stderr)
        else:
            if args.watch_count:
                print("error: --watch-count is for keyed shares; a "
                      "file-backed share's count comes from the share file "
                      "itself", file=sys.stderr)
                return 1
            refresh = make_share_watcher(args.input, engine)
            print(f"--watch: syncing appended rows from {args.input} before "
                  "each request", file=sys.stderr)
    elif args.watch_count:
        print("error: --watch-count requires --watch", file=sys.stderr)
        return 1

    host, port = _parse_addr(args.bind)
    server = ParticipantServer(engine, host, port, wire=args.wire,
                               ssl_context=ssl_ctx,  # ctx validated up top
                               refresh=refresh, read_timeout=args.timeout,
                               upstream_ssl_context=upstream_ssl,
                               upstream_timeout=args.chain_timeout,
                               allowed_upstreams=(
                                   set(args.chain_allow)
                                   if args.chain_allow else None
                               ))

    async def run():
        await server.start()
        print(f"listening on {server.port}", file=sys.stderr)
        return await _serve_until_signal(server, args.drain_grace,
                                         "participant",
                                         profile_dir=args.profile_dir,
                                         device=devices[0])

    try:
        return asyncio.run(run())
    except KeyboardInterrupt:
        return 0


# ------------------------------------------------------------------ coordinator


def append_store_rows(base: str, n_shares: int, share_key: bytes,
                      pats: np.ndarray, msks: np.ndarray) -> int:
    """Append entries to a store (masks + locally-present share files + the
    atomic count sidecar); returns the first appended index.

    Share rows continue the store's addressable keystreams at the next row
    (SPEC §6.1), so keyed parties need only the new count. The data share
    (index n-1) must be local — it is the one share that cannot be
    regenerated from the key. Keyed parties' share FILES are optional
    locally; any that are present are appended too (byte-identical to their
    keystreams, so file-backed and keyed serving stay interchangeable)."""
    from mpc_iris_tpu_torch import native

    masks_path = f"{base}.masks"
    row = os.path.getsize(masks_path) // BITS_BYTES
    enc = native.encode_u16_native(pats, msks)
    shares = native.share_split(enc, n_shares, share_key, row_offset=row)
    targets = [masks_path] + [
        f"{base}.share-{i}" for i in range(n_shares)
        if i == n_shares - 1 or os.path.exists(f"{base}.share-{i}")
    ]
    sizes = {p: os.path.getsize(p) for p in targets}
    try:
        with open(masks_path, "ab") as f:
            f.write(msks.tobytes())
        for p in targets[1:]:
            i = int(p.rsplit("-", 1)[1])
            with open(p, "ab") as f:
                f.write(shares[i].astype("<u2", copy=False).tobytes())
    except BaseException:
        # A partial append (interrupt, ENOSPC) would leave the store with
        # unequal counts that every later append refuses — roll the touched
        # files back to their pre-append sizes before propagating.
        for p, size in sizes.items():
            try:
                os.truncate(p, size)
            except OSError:
                pass
        raise
    tmp = f"{base}.count.tmp"
    with open(tmp, "w") as cf:
        cf.write(f"{row + pats.shape[0]}\n")
    os.replace(tmp, f"{base}.count")
    return row


def cmd_enroll(args) -> int:
    """Uniqueness-check-and-insert — the spec notebook's actual use case
    ("Uniqueness": check a new iris code against the DB, enroll if no match).
    For each candidate template: run the full MPC min-distance query (like
    `coordinator`), and if the minimum FHD is >= --threshold, append the
    entry to the store (SPEC §6.1). Candidates are processed SEQUENTIALLY so
    a duplicate of a just-enrolled candidate is caught — provided every
    queried party adopts appends before the next query: same-host roles do
    via --watch/--watch-count on the same files; across hosts, deliver the
    appended records/count before continuing."""
    from mpc_iris_tpu_torch.models import MasksEngine
    from mpc_iris_tpu_torch.protocol import Coordinator
    from mpc_iris_tpu_torch.protocol.keyagree import read_key32

    try:
        ssl_ctx = _client_tls_context(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    # Chain preconditions fail FAST, before the minutes-long engine builds
    # (the same rule as cmd_coordinator / the TLS check above).
    if args.wire == "chain" and not args.share:
        print("error: --wire chain requires --share (SPEC 5.4: the "
              "coordinator-side share must stay out of the chain)",
              file=sys.stderr)
        return 1
    if args.wire == "chain" and not args.participants:
        print("error: --wire chain needs at least one participant",
              file=sys.stderr)
        return 1
    try:
        share_key = read_key32(args.key)
    except (OSError, ValueError) as e:
        print(f"error: --key {args.key}: {e}", file=sys.stderr)
        return 1

    base = args.store
    masks_path = f"{base}.masks"
    try:
        store_count, present = _validate_store(base, args.count,
                                               require_all_shares=False)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if store_count == 0:
        print("error: the store is empty — bootstrap it with `prepare` "
              "before enrolling against it", file=sys.stderr)
        return 1
    # A wrong --key would append rows splitting against the WRONG streams:
    # keyed parties reconstruct garbage for them (and a later duplicate of
    # such an entry would not be caught). Verify against any local keyed
    # file; with none present the key cannot be checked here.
    keyed_local = [i for i in present if i < args.count - 1]
    err = _check_keyed_streams(base, share_key, keyed_local, store_count)
    if err is not None:
        print(f"error: --key check failed: {err}", file=sys.stderr)
        return 1
    if not keyed_local:
        print("warning: no local keyed share file to verify --key against — "
              "a wrong key makes every appended entry reconstruct as "
              "garbage for keyed parties", file=sys.stderr)

    devices = parse_devices(args.device)
    print(device_banner(devices), file=sys.stderr)
    masks = open_masks(masks_path)
    masks_engine = MasksEngine(masks, device=devices[0], **_sizes(args.chunk))
    local_engine = None
    if args.share:
        try:
            local_engine = _share_engine_from_spec(
                args.share, args.chunk,
                batch_hint=args.round if args.wire in ("batched", "chain") else 1,
                device=args.device)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    participants = [_parse_addr(a) for a in args.participants]
    try:
        coord = Coordinator(masks_engine, participants,
                            local_engine=local_engine, ssl_context=ssl_ctx,
                            round_timeout=args.timeout,
                            strict_scan=args.strict_scan,
                            chain=args.wire == "chain", device=devices[0])
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    # Our own appends must be visible to the next candidate's query: watch
    # the engines this process holds (remote parties watch their own inputs).
    watchers = make_db_watchers(masks_path, masks_engine,
                                args.share, local_engine)

    async def run() -> tuple[int, int]:
        enrolled = dup = cand = 0

        def settle(t, outcome, kept, p_row, m_row):
            """Sequential-equivalent verdict for one candidate: the DB
            minimum from the MPC round, folded with exact plaintext
            distances to candidates kept EARLIER in the same round (the
            enroller holds candidate plaintext, and Template.distance is
            the same reference-exact f64 the MPC decode reproduces, so the
            fold equals querying the grown DB). Strict < keeps the
            earliest index on ties, matching the argmin semantics."""
            nonlocal enrolled, dup, cand
            best_d, best_i = outcome.distance, outcome.index
            for kt, kidx in kept:
                d = t.distance(kt)
                if d < best_d:
                    best_d, best_i = d, kidx
            if best_d < args.threshold:
                print(f"candidate {cand}: DUPLICATE of entry {best_i} at "
                      f"distance {best_d} — not enrolled")
                dup += 1
            else:
                idx = append_store_rows(base, args.count, share_key,
                                        p_row[None], m_row[None])
                print(f"candidate {cand}: unique (closest entry {best_i} "
                      f"at distance {best_d}); enrolled at index {idx}")
                kept.append((t, idx))
                enrolled += 1
            cand += 1

        pending = []  # batched wire: (template, pattern row, mask row)

        async def flush():
            if not pending:
                return
            for w in watchers:
                await asyncio.to_thread(w)
            outcomes = await coord.query_batch([t for t, _, _ in pending])
            kept = []
            for (t, p_row, m_row), outcome in zip(pending, outcomes):
                settle(t, outcome, kept, p_row, m_row)
            pending.clear()

        with open(args.input, "rb") as f:
            for pats, msks in _batched_templates(f, args.batch):
                for i in range(pats.shape[0]):
                    t = Template.from_bytes(
                        pats[i].tobytes() + msks[i].tobytes())
                    if args.wire in ("batched", "chain"):
                        # One MPC round per --round candidates; the kept
                        # cross-check in settle() preserves sequential
                        # semantics within the round. Copies: the rows must
                        # outlive this parse batch.
                        pending.append((t, pats[i].copy(), msks[i].copy()))
                        if len(pending) >= args.round:
                            await flush()
                    else:
                        for w in watchers:
                            await asyncio.to_thread(w)
                        outcome = await coord.query(t)
                        settle(t, outcome, [], pats[i], msks[i])
        await flush()
        return enrolled, dup

    try:
        enrolled, dup = asyncio.run(run())
    except KeyboardInterrupt:
        # append_store_rows rolls a torn append back, so the store is whole;
        # already-enrolled candidates stay enrolled.
        print("\ninterrupted — store is consistent; rerun with the "
              "remaining candidates", file=sys.stderr)
        return 130
    except ConnectionError as e:
        print(f"error: participant connection failed mid-run: {e} — store "
              "is consistent; rerun with the remaining candidates",
              file=sys.stderr)
        return 1
    print(f"enrolled {enrolled}, rejected {dup} duplicates "
          f"(store now {os.path.getsize(masks_path) // BITS_BYTES} entries)",
          file=sys.stderr)
    return 0


def _client_tls_context(args):
    """Client-side TLS context from --tls-* flags (coordinator/benchmark),
    or None when TLS is off. Raises ValueError on inconsistent flags or
    unloadable PEM material so callers can fail fast with a clean message."""
    if not args.tls_ca:
        if args.tls_cert or args.tls_key:
            raise ValueError(
                "--tls-cert/--tls-key need --tls-ca (the participant trust "
                "bundle)"
            )
        return None
    import ssl

    from mpc_iris_tpu_torch.protocol import tlsutil

    try:
        return tlsutil.client_context(args.tls_ca, certfile=args.tls_cert,
                                      keyfile=args.tls_key)
    except (OSError, ssl.SSLError) as e:
        raise ValueError(f"cannot load TLS material: {e}") from e


def cmd_coordinator(args) -> int:
    from mpc_iris_tpu_torch.models import MasksEngine
    from mpc_iris_tpu_torch.parallel import ShardedMasksEngine
    from mpc_iris_tpu_torch.protocol import Coordinator

    # Validate TLS material before the (slow) engine builds — fail fast.
    try:
        ssl_ctx = _client_tls_context(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    # Chain mode (SPEC 5.4) rides the batched round path everywhere.
    batched_mode = args.wire in ("batched", "chain")
    if args.wire == "chain" and not args.share:
        print("error: --wire chain requires --share — the coordinator's own "
              "share must stay OUT of the chain, else the chain head would "
              "reconstruct plaintext distances (SPEC 5.4)", file=sys.stderr)
        return 1
    if args.wire == "chain" and not args.participants:
        print("error: --wire chain needs at least one participant",
              file=sys.stderr)
        return 1
    if args.all_under is not None and (args.serve or batched_mode):
        print("error: --all-under runs self-generated audit queries on the "
              "reference wire; drop --serve/--wire batched (for a NETWORK "
              "audit service use --serve --audit)", file=sys.stderr)
        return 1
    if args.audit and not args.serve:
        print("error: --audit is a serving mode; add --serve", file=sys.stderr)
        return 1
    if args.strict_scan and args.watch:
        # Documented as an illegitimate pairing (see the --strict-scan help
        # text): under --watch, parties adopt appended rows at different
        # instants, so transiently short scans are EXPECTED — strict-scan
        # would abort healthy query rounds with spurious TruncatedScanErrors.
        print("error: --strict-scan cannot be combined with --watch (watch "
              "growth makes transiently short scans legitimate; strict-scan "
              "would abort healthy rounds)", file=sys.stderr)
        return 1
    if args.queries_file and args.serve:
        print("error: --serve answers NETWORK queries; --queries-file drives "
              "the self-querying loop (drop one of them; to send file "
              "templates at a serving coordinator use the `query` client)",
              file=sys.stderr)
        return 1
    serve_ssl = None
    if args.serve_tls_cert or args.serve_tls_key or args.serve_tls_ca:
        if not args.serve:
            print("error: --serve-tls-* configure the client-facing serving "
                  "socket; add --serve", file=sys.stderr)
            return 1
        if not (args.serve_tls_cert and args.serve_tls_key):
            print("error: serving TLS needs both --serve-tls-cert and "
                  "--serve-tls-key", file=sys.stderr)
            return 1
        import ssl as _ssl

        from mpc_iris_tpu_torch.protocol import tlsutil

        try:
            serve_ssl = tlsutil.server_context(
                args.serve_tls_cert, args.serve_tls_key, ca=args.serve_tls_ca
            )
        except (OSError, _ssl.SSLError) as e:
            print(f"error: cannot load serving TLS material: {e}",
                  file=sys.stderr)
            return 1
    if ssl_ctx is not None:
        print(f"TLS enabled (trusting {args.tls_ca})", file=sys.stderr)

    devices = parse_devices(args.device)
    print(device_banner(devices), file=sys.stderr)
    masks = open_masks(args.masks)
    print(f"opened masks {args.masks}: {masks.shape[0]} masks", file=sys.stderr)

    if len(devices) > 1:
        masks_engine = ShardedMasksEngine(
            masks, _db_mesh(devices), storage=args.storage, **_sizes(args.chunk)
        )
    else:
        masks_engine = MasksEngine(masks, device=devices[0], storage=args.storage,
                                   **_sizes(args.chunk))

    local_engine = None
    if args.share:
        try:
            # The coordinator issues its own batches: size the local
            # engine's workspace for exactly that batch.
            local_engine = _share_engine_from_spec(
                args.share, args.chunk,
                batch_hint=args.batch if batched_mode else 1,
                device=args.device,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    participants = [_parse_addr(a) for a in args.participants]
    coord = Coordinator(masks_engine, participants, local_engine=local_engine,
                        ssl_context=ssl_ctx, round_timeout=args.timeout,
                        strict_scan=args.strict_scan,
                        chain=args.wire == "chain", device=devices[0])
    if args.wire == "chain":
        head = participants[-1]
        print(f"chain mode: replies aggregate through {head[0]}:{head[1]} "
              f"(chain of {len(participants)}; coordinator ingress is ONE "
              "stream)", file=sys.stderr)
    rng = np.random.default_rng(args.seed)

    watchers = []
    if args.watch:
        # Coordinator half of the reference's DB-sync TODO: adopt appended
        # masks (and local share rows) before each query round. Participants
        # sync their own files via `participant --watch`; the per-round
        # shortest-prefix alignment tolerates transiently unequal counts.
        watchers = make_db_watchers(args.masks, masks_engine,
                                    args.share, local_engine)
        print("--watch: syncing appended rows before each query round",
              file=sys.stderr)

    if args.warmup:
        import torch

        from mpc_iris_tpu_torch.protocol.coordinator import (
            _sum_decode_argmin_device,
            _sum_decode_argmin_device_batch,
        )
        from mpc_iris_tpu_torch.protocol.wire import records_per_read

        t0 = time.monotonic()
        wb = args.batch if batched_mode else 1
        wrng = np.random.default_rng(0)
        qm = wrng.integers(0, 256, (wb, BITS_BYTES), dtype=np.uint8)
        next(iter(masks_engine.stream(qm)))
        if local_engine is not None:
            qp = wrng.integers(0, 256, (wb, BITS_BYTES), dtype=np.uint8)
            next(iter(local_engine.stream(qp, qm)))
        # Warm the fused per-batch dispatch at the first-round shape: P share
        # sources (participants + optional local share), entry count from the
        # byte-budgeted read size. Chain mode receives ONE aggregated remote
        # stream regardless of party count.
        n_remote = 1 if args.wire == "chain" else len(participants)
        n_parties = n_remote + (local_engine is not None)
        n0 = min(records_per_read(wb), masks.shape[0])
        # (the decode step takes int16 blocks on the coordinator's device,
        # as its rounds upload them)
        shape = (n0, wb, 31) if batched_mode else (n0, 31)
        decode = (_sum_decode_argmin_device_batch if batched_mode
                  else _sum_decode_argmin_device)
        shares = tuple(torch.zeros(shape, dtype=torch.int16, device=devices[0])
                       for _ in range(n_parties))
        decode(shares, torch.ones(shape, dtype=torch.int16, device=devices[0])).cpu()
        print(f"warmup done in {time.monotonic() - t0:.1f}s", file=sys.stderr)

    if args.serve:
        # Serve queries on --bind (the reference resolver declares the bind
        # address but self-generates queries instead, src/main.rs:139):
        # one raw 3,200-byte template per inbound connection, 24-byte
        # (i64 index, f64 distance, u64 total) LE reply — SPEC section 5.2.
        from mpc_iris_tpu_torch.protocol import QueryServer

        host, port = _parse_addr(args.bind)

        def refresh_all():
            for w in watchers:
                w()

        # --wire batched + --serve = micro-batching: concurrent clients
        # aggregate (up to --batch, --window seconds) into one MPC round
        # over the batched participant wire. Clients always speak the
        # single-query serving wire either way.
        server = QueryServer(
            coord, host, port,
            ssl_context=serve_ssl,
            refresh=refresh_all if watchers else None,
            read_timeout=args.timeout,
            max_batch=args.batch if batched_mode else 1,
            batch_window=args.window,
            audit=args.audit,
            max_matches=args.max_matches,
            max_inflight=args.max_inflight,
            rounds_inflight=args.rounds_inflight,
        )
        if serve_ssl is not None:
            print("serving over TLS"
                  + (" (mutual: clients must present a certificate from "
                     f"{args.serve_tls_ca})" if args.serve_tls_ca else ""),
                  file=sys.stderr)
        if args.audit:
            print("AUDIT service (SPEC 5.3): replies list every entry under "
                  "the client's threshold", file=sys.stderr)
        if batched_mode:
            print(f"micro-batching up to {args.batch} concurrent queries "
                  f"per MPC round ({args.window * 1e3:.0f} ms window, "
                  f"{args.rounds_inflight} round(s) in flight); "
                  "participants must run --wire batched", file=sys.stderr)

        async def serve():
            await server.start()
            print(f"serving uniqueness queries on {server.port}",
                  file=sys.stderr)
            return await _serve_until_signal(server, args.drain_grace,
                                             "query server",
                                             profile_dir=args.profile_dir,
                                             device=devices[0])

        try:
            return asyncio.run(serve())
        except KeyboardInterrupt:
            return 0

    q_source = None
    if args.queries_file:
        from mpc_iris_tpu_torch.io.json_stream import iter_json_array

        q_source = []
        with open(args.queries_file, "rb") as f:
            for item in iter_json_array(f):
                q_source.append(Template.from_json_obj(item))
                if args.queries and len(q_source) >= args.queries:
                    break
        print(f"loaded {len(q_source)} query templates from "
              f"{args.queries_file}", file=sys.stderr)

    async def run():
        n = 0

        def more() -> bool:
            if q_source is not None:
                return n < len(q_source)
            return args.queries == 0 or n < args.queries

        def next_queries(k: int) -> list:
            if q_source is not None:
                return q_source[n:n + k]
            return [Template.random(rng) for _ in range(k)]

        while more():
            for w in watchers:
                await asyncio.to_thread(w)
            if batched_mode:
                queries = next_queries(args.batch)
                t0 = time.monotonic()
                outcomes = await coord.query_batch(queries)
                dt = time.monotonic() - t0
                for outcome in outcomes:
                    verdict = ""
                    if args.threshold is not None:
                        verdict = (
                            "  DUPLICATE" if outcome.distance < args.threshold
                            else "  unique"
                        )
                    print(
                        f"query {n}: closest entry {outcome.index} of "
                        f"{outcome.total} at distance {outcome.distance}{verdict}"
                    )
                    n += 1
                total = outcomes[0].total * len(outcomes)
                print(
                    f"batch of {len(outcomes)}: {dt:.3f}s, "
                    f"{total / max(dt, 1e-9):.0f} query-entries/s",
                    file=sys.stderr,
                )
            elif args.all_under is not None:
                # MPC dedup audit: every entry under the threshold, not just
                # the argmin winner (same wire bytes as a normal query).
                query = next_queries(1)[0]
                t0 = time.monotonic()
                out = await coord.query_under(query, args.all_under)
                dt = time.monotonic() - t0
                print(f"query {n}: {len(out.matches)} of {out.total} entries "
                      f"under {args.all_under} ({dt:.3f}s)")
                for m in out.matches:
                    print(f"  entry {m.index} at distance {m.distance}")
                n += 1
            else:
                query = next_queries(1)[0]
                t0 = time.monotonic()
                outcome = await coord.query(query)
                dt = time.monotonic() - t0
                verdict = ""
                if args.threshold is not None:
                    verdict = (
                        "  DUPLICATE" if outcome.distance < args.threshold
                        else "  unique"
                    )
                print(
                    f"query {n}: closest entry {outcome.index} of {outcome.total} "
                    f"at distance {outcome.distance} ({dt:.3f}s, "
                    f"{outcome.total / max(dt, 1e-9):.0f} entries/s){verdict}"
                )
                n += 1

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


# ------------------------------------------------------------------ benchmark


def cmd_benchmark(args) -> int:
    rng = np.random.default_rng(args.seed)
    host, port = _parse_addr(args.participant)
    try:
        ssl_ctx = _client_tls_context(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    async def run():
        for q in range(args.queries):
            t0 = time.monotonic()
            reader, writer = await asyncio.open_connection(host, port,
                                                           ssl=ssl_ctx)
            if args.wire == "batched":
                from mpc_iris_tpu_torch.protocol.wire import batched_query_bytes

                raw = rng.integers(
                    0, 256, size=(args.batch, TEMPLATE_BYTES), dtype=np.uint8
                )
                writer.write(
                    batched_query_bytes(raw[:, :BITS_BYTES], raw[:, BITS_BYTES:])
                )
                group = args.batch * 62
            else:
                writer.write(Template.random(rng).to_bytes())
                group = 62
            await writer.drain()
            total = 0
            while True:
                data = await reader.read(1 << 20)
                if not data:
                    break
                total += len(data)
            dt = time.monotonic() - t0
            writer.close()
            await writer.wait_closed()
            entries = total // group
            print(
                f"round {q}: {entries} entries, {total / 1e6:.1f} MB in {dt:.3f}s "
                f"({entries / max(dt, 1e-9):.0f} entries/s, "
                f"{total / 1e6 / max(dt, 1e-9):.1f} MB/s)"
            )

    asyncio.run(run())
    return 0


# ------------------------------------------------------------------ query (client)


def cmd_query(args) -> int:
    """Client for a serving coordinator (SPEC section 5.2): send each input
    template to `coordinator --serve` and print the outcome record."""
    from mpc_iris_tpu_torch.io.json_stream import iter_json_array
    from mpc_iris_tpu_torch.protocol import query_remote

    host, port = _parse_addr(args.service)
    try:
        ssl_ctx = _client_tls_context(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    templates = []
    with open(args.input, "rb") as f:
        for item in iter_json_array(f):
            templates.append(Template.from_json_obj(item))
            if args.count and len(templates) >= args.count:
                break

    async def run() -> int:
        from mpc_iris_tpu_torch.protocol import (
            PersistentQueryClient,
            query_remote_under,
        )

        # Several templates reuse ONE connection (the persistent wire,
        # SPEC 5.5) so the per-query TCP/TLS handshake is paid once;
        # --one-shot forces a fresh connection per query (the reference's
        # connection discipline, src/main.rs:411-447).
        client = None
        if len(templates) > 1 and not args.one_shot:
            try:
                client = await PersistentQueryClient.connect(
                    host, port, ssl_context=ssl_ctx,
                    audit=args.audit is not None)
            except (ConnectionError, OSError) as e:
                print(f"error: cannot connect to {host}:{port}: {e}",
                      file=sys.stderr)
                return 1

        worst = 0
        for i, t in enumerate(templates):
            t0 = time.monotonic()
            try:
                if client is not None:
                    if args.audit is not None:
                        out = await client.query_under(t, args.audit)
                    else:
                        out = await client.query(t)
                elif args.audit is not None:
                    out = await query_remote_under(
                        host, port, t, args.audit, ssl_context=ssl_ctx
                    )
                else:
                    out = await query_remote(host, port, t, ssl_context=ssl_ctx)
            except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
                print(f"query {i}: FAILED ({e})", file=sys.stderr)
                worst = 1
                if client is not None:
                    # The persistent session is dead (close-without-reply or
                    # a torn stream); remaining queries fall back to fresh
                    # one-shot connections rather than failing in cascade.
                    await client.close()
                    client = None
                continue
            dt = time.monotonic() - t0
            if args.audit is not None:
                print(f"query {i}: {len(out.matches)} of {out.total} entries "
                      f"under {args.audit} ({dt:.3f}s)")
                for m in out.matches:
                    print(f"  entry {m.index} at distance {m.distance}")
                continue
            verdict = ""
            if args.threshold is not None:
                verdict = ("  DUPLICATE" if out.distance < args.threshold
                           else "  unique")
            print(f"query {i}: closest entry {out.index} of "
                  f"{out.total} at distance {out.distance} "
                  f"({dt:.3f}s){verdict}")
        if client is not None:
            await client.close()
        return worst

    return asyncio.run(run())


# ------------------------------------------------------------------ match (local)


def cmd_match(args) -> int:
    from mpc_iris_tpu_torch.models import PlaintextEngine
    from mpc_iris_tpu_torch.parallel import ShardedPlaintextEngine, make_mesh, mesh_shape_for

    devices = parse_devices(args.device)
    print(device_banner(devices), file=sys.stderr)
    pats, msks = [], []
    with open(args.db, "rb") as f:
        for p, m in _batched_templates(f, 4096):
            pats.append(p)
            msks.append(m)
    dpat, dmsk = np.concatenate(pats), np.concatenate(msks)
    print(f"loaded {dpat.shape[0]} templates", file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    if args.queries_file:
        qp, qm = [], []
        with open(args.queries_file, "rb") as f:
            for p, m in _batched_templates(f, 4096):
                qp.append(p)
                qm.append(m)
        qpat, qmsk = np.concatenate(qp), np.concatenate(qm)
    else:
        # self-match smoke: rotated copies of random DB entries — exercises
        # the rotation-min (distance must still come back exactly 0.0)
        from mpc_iris_tpu_torch.types import Bits

        idx = rng.integers(0, dpat.shape[0], size=args.batch)
        rots = rng.integers(-15, 16, size=args.batch)
        qpat = np.stack([Bits(dpat[i]).rotated(int(r)).data
                         for i, r in zip(idx, rots)])
        qmsk = np.stack([Bits(dmsk[i]).rotated(int(r)).data
                         for i, r in zip(idx, rots)])

    n_dev = len(devices)
    if n_dev > 1:
        # Size the mesh's batch axis from the REAL query count (a queries file
        # may not divide by --batch).
        db_ax, batch_ax = mesh_shape_for(n_dev, qpat.shape[0])
        mesh = make_mesh(db=db_ax, batch=batch_ax, devices=devices)
        engine = ShardedPlaintextEngine(
            dpat, dmsk, mesh, storage=args.storage, **_sizes(args.chunk)
        )
    else:
        engine = PlaintextEngine(dpat, dmsk, device=devices[0], storage=args.storage,
                                 **_sizes(args.chunk))

    if args.profile_dir:
        from mpc_iris_tpu_torch.utils.profiling import device_trace

        with device_trace(args.profile_dir):
            engine.match(qpat, qmsk)  # traced warm pass
        print(f"wrote device trace to {args.profile_dir}", file=sys.stderr)

    if args.distances_out:
        # Research export: the full per-entry f64 distance spectrum (min over
        # 31 rotations, reference-exact decode) — the raw material for
        # threshold calibration (genuine/impostor distributions, ROC curves).
        from mpc_iris_tpu_torch.ops.decode import fractions_to_f64_np

        t0 = time.monotonic()
        nd = engine.min_fractions(qpat, qmsk)
        dist = fractions_to_f64_np(nd[0], nd[1])
        dt = time.monotonic() - t0
        np.save(args.distances_out, dist)
        print(f"wrote f64 distance matrix {dist.shape} to "
              f"{args.distances_out} ({dt:.3f}s)", file=sys.stderr)
        if args.all_under is None:
            return 0

    if args.all_under is not None:
        # Dedup audit: the full under-threshold collision list per query
        # (exact rational compare; the spec's uniqueness flow keeps only the
        # argmin — this is its audit complement).
        t0 = time.monotonic()
        lists = engine.find_under(qpat, qmsk, args.all_under)
        dt = time.monotonic() - t0
        for i, hits in enumerate(lists):
            print(f"query {i}: {len(hits)} entr"
                  f"{'y' if len(hits) == 1 else 'ies'} under {args.all_under}")
            for m in hits:
                print(f"  entry {m.index} at distance {m.distance}")
        cmp_rate = len(lists) * dpat.shape[0] / max(dt, 1e-9)
        print(
            f"{len(lists)} queries x {dpat.shape[0]} entries in {dt:.3f}s "
            f"({cmp_rate:.3e} full matches/s incl. 31 rotations)",
            file=sys.stderr,
        )
        return 0

    t0 = time.monotonic()
    results = engine.match(qpat, qmsk)
    dt = time.monotonic() - t0
    for i, r in enumerate(results):
        verdict = ""
        if args.threshold is not None:
            verdict = (
                f"  DUPLICATE (< {args.threshold})"
                if r.distance < args.threshold
                else f"  unique (>= {args.threshold})"
            )
        print(f"query {i}: closest entry {r.index} at distance {r.distance}{verdict}")
    cmp_rate = len(results) * dpat.shape[0] / max(dt, 1e-9)
    print(
        f"{len(results)} queries x {dpat.shape[0]} entries in {dt:.3f}s "
        f"({cmp_rate:.3e} full matches/s incl. 31 rotations)",
        file=sys.stderr,
    )
    return 0


# ------------------------------------------------------------------ parser


def _version_string() -> str:
    """Version + build metadata (== the reference's shadow-rs --version,
    src/build.rs + src/main.rs:44-48)."""
    import platform
    import subprocess

    from mpc_iris_tpu_torch import __version__

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        sha = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
        dirty = subprocess.run(
            ["git", "-C", repo, "status", "--porcelain"],
            capture_output=True, text=True, timeout=5,
        ).stdout.strip()
        sha += "-dirty" if dirty else ""
    except Exception:
        sha = "unknown"
    try:
        import torch

        torchver = f"torch {torch.__version__}  cuda {torch.version.cuda or 'none'}"
    except Exception:
        torchver = "torch unavailable"
    return (
        f"mpc-iris-tpu-torch {__version__} (git {sha})\n"
        f"python {platform.python_version()}  {torchver}"
    )


DEVICE_HELP = (
    "torch devices the roles run on, comma-separated (default: cuda = every "
    "visible card; raises without one). One device builds the single-card "
    "engines, several the sharded ones over a mesh of them; a device may "
    "repeat (cpu,cpu,cpu,cpu = four shards on the CPU)")
CHUNK_HELP = "DB entries per device step (default: the engine's, 16,384)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpc-iris-tpu-torch",
        description="privacy-preserving iris-code matching on PyTorch + CUDA",
    )
    p.add_argument("--version", action="version", version=_version_string())
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.add_argument(
        "--threads", type=int, default=0,
        help="native codec threads (0 = all cores; reference src/main.rs:53-57)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="generate random test data in json")
    g.add_argument("path")
    g.add_argument("count", nargs="?", type=parse_si, default=10**6)
    g.add_argument("--replace", action="store_true")
    g.add_argument("--seed", type=int, default=None)
    g.set_defaults(fn=cmd_generate)

    g = sub.add_parser("prepare", help="prepare secret shares from json input")
    g.add_argument("input")
    g.add_argument("count", nargs="?", type=int, default=3)
    g.add_argument("output", nargs="?", default="mpc")
    g.add_argument(
        "--insecure-seed", type=int, default=None, metavar="N",
        help="TESTING ONLY: derive the share key from this small seed instead "
        "of os.urandom(32); the resulting shares are brute-forceable",
    )
    g.add_argument("--batch", type=int, default=1000)
    g.add_argument(
        "--backend", choices=["native", "device"], default="native",
        help="where encode + share-keystream run: native = multithreaded C++ "
        "ChaCha20 on the host; device = the same addressable ChaCha20 "
        "streams generated on --device by the ChaCha20 kernel — both "
        "crypto-grade and byte-identical for the same key",
    )
    g.add_argument(
        "--save-key", default=None, metavar="PATH",
        help="also write the 32-byte share key (hex, mode 0600): enables "
        "keyed participants that regenerate shares 0..n-2 on device with "
        "zero share I/O (see `participant keyed:...`). The key is exactly "
        "as sensitive as those share files",
    )
    g.add_argument(
        "--key", default=None, metavar="PATH",
        help="reuse a saved share key (--save-key output) instead of drawing "
        "a fresh one — required with --append when keyed participants must "
        "regenerate the appended rows",
    )
    g.add_argument(
        "--append", action="store_true",
        help="extend an existing store in place (incremental ETL — a TODO "
        "in the reference, src/main.rs:402): new entries are appended to "
        "the masks and every share file; running roles adopt them via "
        "--watch. Counts must agree across the store",
    )
    g.set_defaults(fn=cmd_prepare)

    g = sub.add_parser("decrypt", help="combine secret shares back to json")
    g.add_argument(
        "shares", nargs="+",
        help="share files; any PRF-backed share (index < n-1, original "
        "prepare output) may instead be keyed:<index>:<count>:<keyfile>",
    )
    g.add_argument("--output", default="decrypted.json")
    g.add_argument("--batch", type=int, default=1000)
    g.set_defaults(fn=cmd_decrypt)

    g = sub.add_parser(
        "rerandomize",
        help="refresh a share file with pairwise zero-sum PRF noise "
        "(spec future-work item, implemented here)",
    )
    g.add_argument("share", help="share file to refresh")
    g.add_argument("--index", type=int, required=True, help="this party's index")
    g.add_argument(
        "--pair", action="append", default=[], metavar="J:KEY",
        help="peer party index and the pairwise key shared with it (repeat). "
        "KEY is an integer (0x-hex accepted) up to 256 bits; use a 256-bit "
        "secret from a secure exchange — small keys are testing-only",
    )
    g.add_argument("--output", default=None, help="write here instead of in place")
    g.add_argument("--batch", type=int, default=1000)
    g.set_defaults(fn=cmd_rerandomize)

    g = sub.add_parser(
        "rekey",
        help="rotate a keyed deployment's share-key epoch: rewrite the data "
        "share (and locally-kept keyed files) for a fresh key without ever "
        "reconstructing the plaintext",
    )
    g.add_argument("store", help="store base: rewrites <store>.share-(n-1) "
                   "and any local <store>.share-i in place (tmp+rename)")
    g.add_argument("--count", type=int, default=3,
                   help="total share count n the store was prepared with")
    g.add_argument("--old-key", required=True, metavar="PATH",
                   help="the store's current share key")
    g.add_argument("--new-key-out", required=True, metavar="PATH",
                   help="where to write the fresh key (refuses to overwrite)")
    g.add_argument(
        "--insecure-new-seed", type=int, default=None, metavar="N",
        help="TESTING ONLY: derive the new key from this small seed",
    )
    g.add_argument("--batch", type=int, default=1000)
    g.set_defaults(fn=cmd_rekey)

    g = sub.add_parser(
        "keygen",
        help="generate an X25519 identity for pairwise key agreement "
        "(the DH half of the spec's re-randomization sketch)",
    )
    g.add_argument("output", help="private-key path (hex, mode 0600); the "
                   "public key lands at <output>.pub")
    g.set_defaults(fn=cmd_keygen)

    g = sub.add_parser(
        "pair-key",
        help="derive the shared 256-bit rerandomize pair key from my "
        "identity + a peer's public key (both sides derive the same key)",
    )
    g.add_argument("identity", help="my private key (from keygen)")
    g.add_argument("peer_public", help="peer public key: 64 hex chars or a "
                   ".pub file path")
    g.add_argument("--context", default="",
                   help="domain-separation label (e.g. a refresh round id); "
                   "must match on both sides")
    g.add_argument("--out", default=None, metavar="PATH",
                   help="write the key as a hex keyfile (mode 0600) instead "
                   "of printing it; pass as rerandomize --pair J:@PATH")
    g.set_defaults(fn=cmd_pair_key)

    g = sub.add_parser(
        "store-check",
        help="fsck for a share store: record structure, row-count agreement, "
        "count sidecar, keyed-keystream spot checks (--key), deep "
        "share<->masks reconstruction consistency (--deep)",
    )
    g.add_argument("store", help="store base: <store>.masks / .share-i / .count")
    g.add_argument("--count", type=int, default=0,
                   help="expected number of share files (0 = discover)")
    g.add_argument("--key", default=None, metavar="PATH",
                   help="verify streams s < n-1 against the ChaCha20 "
                   "keystream of this share key on sampled rows (fails on "
                   "rerandomized stores or a wrong key)")
    g.add_argument("--deep", action="store_true",
                   help="reconstruct sampled rows from ALL share files and "
                   "check ring alphabet + masks-file consistency")
    g.add_argument("--sample", type=parse_si, default=8,
                   help="rows sampled for --key/--deep (spread incl. first "
                   "and last)")
    g.add_argument("--strict", action="store_true",
                   help="treat torn trailing bytes (an append in progress) "
                   "as a problem instead of a warning")
    g.set_defaults(fn=cmd_store_check)

    g = sub.add_parser("participant", help="start share-holding participant server")
    g.add_argument(
        "input",
        help="share file (mpc.share-i), or keyed:<share-index>:<count>:"
        "<keyfile> to regenerate a PRF-backed share (index < n-1) on device "
        "from the `prepare --save-key` key — no share file needed",
    )
    g.add_argument("bind", nargs="?", default="127.0.0.1:1234")
    g.add_argument("--chunk", type=parse_si, default=None, help=CHUNK_HELP)
    g.add_argument(
        "--batch-hint", type=parse_si, default=None,
        help="largest coordinator query batch to size device workspace "
        "headroom for (out-of-core / keyed engines: larger hints keep "
        "less of the DB resident but cannot OOM mid-pass; default: the "
        "engine's)",
    )
    g.add_argument(
        "--wire", choices=["reference", "batched", "chain"],
        default="reference",
        help="reference = byte-compatible single-query wire; batched = "
        "multi-query extension (pair with coordinator --wire batched); "
        "chain = batched + chained reply aggregation (SPEC 5.4): this party "
        "adds its upstream chain's stream to its own shares and forwards "
        "ONE summed stream (pair with coordinator --wire chain)",
    )
    g.add_argument("--chain-tls-ca", default=None, metavar="PEM",
                   help="with --wire chain: connect chain hops over TLS, "
                   "trusting this bundle (this party's --tls-cert/--tls-key "
                   "are presented as its client identity for mutual TLS)")
    g.add_argument("--chain-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="with --wire chain: per-read deadline on the "
                   "UPSTREAM stream (distinct from --timeout — upstream "
                   "slices legitimately take device-compute time); a "
                   "stalled upstream aborts the chain reply. default: wait "
                   "forever")
    g.add_argument("--chain-allow", action="append", default=None,
                   metavar="HOST:PORT",
                   help="with --wire chain: only connect to these upstream "
                   "addresses (repeatable). Unset = any (trusted network); "
                   "set it on untrusted networks — an unrestricted chain "
                   "party is an outbound-connection relay")
    g.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip the startup warm-up pass")
    g.add_argument("--warmup-batch", type=parse_si, default=16,
                   help="batch size to warm on the batched wire")
    g.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                   help="close a connection whose client sends no complete "
                   "query within this many seconds (a silent client "
                   "otherwise pins its connection forever; SPEC section 5). "
                   "default: wait forever, like the reference")
    g.add_argument("--drain-grace", type=float, default=30.0,
                   metavar="SECONDS",
                   help="on SIGTERM/SIGINT, stop accepting and let in-flight "
                   "replies finish streaming for up to this long before "
                   "exiting (second signal force-quits)")
    g.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="enable on-demand device traces: SIGUSR2 toggles a "
                   "torch.profiler capture into DIR (fresh trace-<ts> subdir "
                   "per capture, a Chrome/Perfetto trace.json). SIGUSR1 "
                   "dumps serving stats any time, with or without this flag")
    g.add_argument("--watch", action="store_true",
                   help="before each request, adopt rows appended to the "
                   "share file since startup (DB sync — a TODO in the "
                   "reference, src/main.rs:415)")
    g.add_argument("--watch-count", default=None, metavar="FILE",
                   help="with --watch on a keyed share: adopt DB growth "
                   "from this text count file (`prepare` maintains "
                   "`<base>.count`; the count is public). Keyed parties "
                   "store no share bytes, so growth arrives as a number, "
                   "not records")
    g.add_argument("--tls-cert", default=None, metavar="PEM",
                   help="serve TLS with this certificate (see `tls-cert`); "
                   "wire inside the tunnel is unchanged")
    g.add_argument("--tls-key", default=None, metavar="PEM",
                   help="private key for --tls-cert")
    g.add_argument("--tls-ca", default=None, metavar="PEM",
                   help="require MUTUAL TLS: clients must present a "
                   "certificate from this trust bundle")
    g.set_defaults(fn=cmd_participant, warmup=True)

    for name in ("coordinator", "resolver"):
        g = sub.add_parser(name, help="start the coordinator/resolver")
        g.add_argument("participants", nargs="*")
        g.add_argument("--masks", default="mpc.masks")
        g.add_argument("--share", default=None,
                       help="optional share if the resolver is also a "
                       "participant: a share file, or keyed:<s>:<count>:"
                       "<keyfile> (regenerated on device, no file)")
        g.add_argument(
            "--bind", default="127.0.0.1:8080",
            help="with --serve: accept query templates on this address "
            "(without --serve, queries are self-generated like the "
            "reference resolver, which declares a bind but never serves "
            "on it — src/main.rs:139)",
        )
        g.add_argument(
            "--serve", action="store_true",
            help="run as a uniqueness SERVICE: one raw 3,200-byte template "
            "per inbound connection on --bind, reply = 24-byte LE record "
            "(i64 winning index, f64 distance, u64 entries compared) — "
            "SPEC section 5.2. Concurrent clients are served concurrently; "
            "with --wire batched they micro-batch into shared MPC rounds "
            "(up to --batch per round)",
        )
        g.add_argument(
            "--audit", action="store_true",
            help="with --serve: run the AUDIT service instead (SPEC 5.3) — "
            "each request is a template + the client's f64 threshold, the "
            "reply lists EVERY entry under it (count/total header + (index, "
            "distance) records). Micro-batches like the argmin service",
        )
        g.add_argument(
            "--max-inflight", type=int, default=32,
            help="with --serve: cap CONCURRENT MPC rounds (every connection "
            "costs a full DB scan); excess clients queue, 0 = unlimited. "
            "Micro-batched mode (--wire batched) is inherently bounded",
        )
        g.add_argument(
            "--max-matches", type=parse_si, default=65536,
            help="with --serve --audit: close (no reply) any client whose "
            "threshold matches more entries than this — guards the server "
            "against O(N) match lists from huge thresholds",
        )
        g.add_argument(
            "--window", type=float, default=0.005, metavar="SECONDS",
            help="micro-batching window for --serve --wire batched: after "
            "the first queued query, wait at most this long for more "
            "before dispatching the MPC round (default 5 ms)",
        )
        g.add_argument(
            "--rounds-inflight", type=int, default=1, metavar="K",
            help="with --serve --wire batched: run up to K micro-batched "
            "MPC rounds concurrently so one round's reply streams overlap "
            "the next round's compute (default 1 = one round at a time)",
        )
        g.add_argument("--queries", type=int, default=0, help="0 = loop forever")
        g.add_argument("--queries-file", default=None, metavar="JSON",
                       help="drive REAL query templates from a JSON array "
                       "instead of self-generated random ones (reference "
                       "behavior); runs each once (--queries caps the count). "
                       "Works with the normal, --wire batched, and "
                       "--all-under audit modes")
        g.add_argument("--chunk", type=parse_si, default=None, help=CHUNK_HELP)
        g.add_argument("--seed", type=int, default=None)
        g.add_argument(
            "--storage", choices=["auto", "dense", "packed"], default="auto",
            help="masks DB storage (packed = 1.6 KB/entry, 8x the device capacity)",
        )
        g.add_argument(
            "--wire", choices=["reference", "batched", "chain"],
            default="reference",
            help="batched = send --batch queries per round (participants "
            "must also run --wire batched); chain = batched rounds with "
            "chained reply aggregation (SPEC 5.4): connect only to the LAST "
            "participant, which recursively sums the others' streams — "
            "requires --share (the coordinator's own share must stay out of "
            "the chain) and participants running --wire chain",
        )
        g.add_argument("--batch", type=parse_si, default=16,
                       help="queries per round on the batched wire")
        g.add_argument("--threshold", type=float, default=None,
                       help="print DUPLICATE/unique verdicts against this FHD")
        g.add_argument("--all-under", type=float, default=None, metavar="FHD",
                       help="dedup audit: per query, list EVERY DB entry with "
                       "distance strictly under this FHD (exact rational "
                       "compare) instead of just the argmin winner; "
                       "reference-wire self-generated queries only")
        g.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                       help="per-read-round deadline for each participant's "
                       "reply stream; a connected-but-silent party aborts "
                       "the query loudly instead of hanging it forever "
                       "(StalledPartyError, SPEC section 5). default: wait "
                       "forever, like the reference")
        g.add_argument("--drain-grace", type=float, default=30.0,
                       metavar="SECONDS",
                       help="with --serve: on SIGTERM/SIGINT, stop accepting "
                       "and answer every in-flight query for up to this long "
                       "before exiting (second signal force-quits)")
        g.add_argument("--profile-dir", default=None, metavar="DIR",
                       help="with --serve: SIGUSR2 toggles an on-demand "
                       "torch.profiler device trace into DIR (fresh trace-<ts> "
                       "subdir per capture); SIGUSR1 dumps serving stats any "
                       "time, with or without this flag")
        g.add_argument("--strict-scan", action="store_true",
                       help="abort a query loudly (TruncatedScanError) if the "
                       "reply streams end before the full masks DB is "
                       "scanned — a participant crashing mid-stream looks "
                       "like clean EOF, and a uniqueness verdict over the "
                       "prefix is unsafe (SPEC section 5). default: truncate "
                       "like the reference (required with --watch, where "
                       "transiently unequal counts are legitimate)")
        g.add_argument("--watch", action="store_true",
                       help="before each query round, adopt rows appended to "
                       "the masks file (and a file-backed --share) since "
                       "startup (DB sync — a TODO in the reference, "
                       "src/main.rs:402)")
        g.add_argument("--no-warmup", dest="warmup", action="store_false",
                       help="skip the startup warm-up pass")
        g.add_argument("--serve-tls-cert", default=None, metavar="PEM",
                       help="with --serve: serve clients over TLS >= 1.3 with "
                       "this certificate (independent of the participant-"
                       "facing --tls-* flags)")
        g.add_argument("--serve-tls-key", default=None, metavar="PEM",
                       help="private key for --serve-tls-cert")
        g.add_argument("--serve-tls-ca", default=None, metavar="PEM",
                       help="with --serve-tls-cert: demand mutual TLS — "
                       "clients must present a certificate from this bundle")
        g.add_argument("--tls-ca", default=None, metavar="PEM",
                       help="connect to participants over TLS, trusting this "
                       "certificate bundle (peers are authenticated by cert, "
                       "not hostname)")
        g.add_argument("--tls-cert", default=None, metavar="PEM",
                       help="client certificate for participants requiring "
                       "mutual TLS")
        g.add_argument("--tls-key", default=None, metavar="PEM",
                       help="private key for --tls-cert")
        g.set_defaults(fn=cmd_coordinator, warmup=True)

    g = sub.add_parser(
        "query",
        help="client for a serving coordinator (`coordinator --serve`): "
        "send templates from a JSON file and print index/distance outcomes "
        "(SPEC section 5.2)",
    )
    g.add_argument("service", help="host:port of `coordinator --serve`")
    g.add_argument("input", help="query templates (JSON array)")
    g.add_argument("--count", type=parse_si, default=0,
                   help="stop after this many templates (0 = all)")
    g.add_argument("--threshold", type=float, default=None,
                   help="print DUPLICATE/unique verdicts against this FHD")
    g.add_argument("--audit", type=float, default=None, metavar="FHD",
                   help="speak the AUDIT wire (server must run --serve "
                   "--audit): list every entry under this threshold per "
                   "query instead of the argmin outcome (SPEC 5.3)")
    g.add_argument("--one-shot", action="store_true",
                   help="open a fresh connection per query (the reference's "
                   "connection discipline) instead of the default persistent "
                   "connection reuse for multi-template runs (SPEC 5.5)")
    g.add_argument("--tls-ca", default=None, metavar="PEM",
                   help="connect over TLS, trusting this bundle")
    g.add_argument("--tls-cert", default=None, metavar="PEM",
                   help="client certificate for mutual TLS")
    g.add_argument("--tls-key", default=None, metavar="PEM",
                   help="private key for --tls-cert")
    g.set_defaults(fn=cmd_query)

    g = sub.add_parser(
        "enroll",
        help="uniqueness-check candidate templates against the live DB and "
        "append the unique ones to the store (the spec's 'Uniqueness' use "
        "case; sequential, so within-run duplicates are caught)",
    )
    g.add_argument("input", help="candidate templates (JSON array)")
    g.add_argument("store", help="store base: <store>.masks, "
                   "<store>.share-i, <store>.count")
    g.add_argument("participants", nargs="*",
                   help="share-holding parties to query (host:port)")
    g.add_argument("--count", type=int, default=3,
                   help="total share count n the store was prepared with")
    g.add_argument("--key", required=True, metavar="PATH",
                   help="the store's share key (--save-key output): appended "
                   "rows must continue the same keystreams")
    g.add_argument("--threshold", type=float, required=True,
                   help="FHD below which a candidate is a DUPLICATE (the "
                   "enrollment policy; the spec suggests ~0.36)")
    g.add_argument("--share", default=None,
                   help="this process's own share, if it is also a party: a "
                   "share file or keyed:<s>:<count>:<keyfile>")
    g.add_argument("--chunk", type=parse_si, default=None, help=CHUNK_HELP)
    g.add_argument("--batch", type=parse_si, default=1000,
                   help="JSON parse batch (verdicts are always "
                   "sequential-equivalent)")
    g.add_argument(
        "--wire", choices=["reference", "batched", "chain"],
        default="reference",
        help="batched = ONE MPC round per --round candidates (participants "
        "must run --wire batched); within-round duplicates are still caught "
        "via exact plaintext cross-checks among the round's kept candidates; "
        "chain = batched rounds over chained reply aggregation (SPEC 5.4; "
        "requires --share, participants run --wire chain)",
    )
    g.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                   help="per-read-round deadline for participant replies "
                   "(see coordinator --timeout); an enroll run aborts "
                   "loudly on a stalled party rather than hanging")
    g.add_argument("--strict-scan", action="store_true",
                   help="abort if a candidate's scan ends before the full "
                   "masks DB (see coordinator --strict-scan) — a truncated "
                   "scan here would ENROLL a duplicate. Leave off when "
                   "remote parties sync appended rows with a lag (their "
                   "--watch window makes transiently short scans legitimate)")
    g.add_argument("--round", type=parse_si, default=64,
                   help="candidates per MPC round on the batched wire")
    g.add_argument("--tls-ca", default=None, metavar="PEM")
    g.add_argument("--tls-cert", default=None, metavar="PEM")
    g.add_argument("--tls-key", default=None, metavar="PEM")
    g.set_defaults(fn=cmd_enroll)

    g = sub.add_parser(
        "tls-cert",
        help="mint a self-signed TLS key+certificate for a party (the .crt "
        "doubles as the peers' trust-bundle entry)",
    )
    g.add_argument("name", help="certificate common name (party label)")
    g.add_argument("prefix", help="output prefix: writes <prefix>.key (0600) "
                   "and <prefix>.crt")
    g.set_defaults(fn=cmd_tls_cert)

    g = sub.add_parser("benchmark", help="benchmark a participant")
    g.add_argument("participant")
    g.add_argument("--queries", type=int, default=3)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--wire", choices=["reference", "batched"], default="reference")
    g.add_argument("--batch", type=parse_si, default=16,
                   help="queries per round on the batched wire")
    g.add_argument("--tls-ca", default=None, metavar="PEM",
                   help="connect over TLS, trusting this certificate bundle")
    g.add_argument("--tls-cert", default=None, metavar="PEM",
                   help="client certificate for mutual TLS")
    g.add_argument("--tls-key", default=None, metavar="PEM",
                   help="private key for --tls-cert")
    g.set_defaults(fn=cmd_benchmark)

    g = sub.add_parser(
        "bench-kernels",
        help="criterion-equivalent kernel benchmark suite (src/arch/mod.rs:22-72)",
    )
    g.add_argument("--json", action="store_true")
    g.add_argument("--batch", type=int, default=128)
    g.add_argument("--sizes", type=int, nargs="*", default=None)
    g.add_argument("--host-only", action="store_true")

    def _bench_kernels(a):
        from mpc_iris_tpu_torch.benchmarks import main as bmain

        argv = ["--device", a.device]
        if a.json:
            argv.append("--json")
        if a.host_only:
            argv.append("--host-only")
        argv += ["--batch", str(a.batch)]
        if a.sizes is not None:
            argv += ["--sizes", *map(str, a.sizes)]
        return bmain(argv)

    g.set_defaults(fn=_bench_kernels)

    g = sub.add_parser("match", help="local plaintext uniqueness check on the card")
    g.add_argument("db", help="template JSON file")
    g.add_argument("--queries-file", default=None)
    g.add_argument("--batch", type=parse_si, default=8)
    g.add_argument("--chunk", type=parse_si, default=None, help=CHUNK_HELP)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument(
        "--storage", choices=["auto", "dense", "packed"], default="auto",
        help="packed = 3.2 KB/entry bit-plane device storage; dense = "
        "25.6 KB/entry int8 planes",
    )
    g.add_argument(
        "--threshold", type=float, default=None,
        help="uniqueness threshold: report DUPLICATE when the minimum distance "
        "is below it (the spec notebook's uniqueness check; ~0.36 typical)",
    )
    g.add_argument(
        "--all-under", type=float, default=None, metavar="FHD",
        help="dedup audit: per query, list EVERY DB entry with distance "
        "strictly under this FHD (exact rational compare; ascending "
        "distance) instead of just the argmin winner",
    )
    g.add_argument(
        "--distances-out", default=None, metavar="FILE.npy",
        help="research export: save the full [B, N] f64 distance matrix "
        "(min over 31 rotations, reference-exact decode) — raw material "
        "for threshold calibration; 8 B/entry/query, so audit-sized "
        "batches only",
    )
    g.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of one warm match pass "
        "(Chrome/Perfetto trace.json) here",
    )
    g.set_defaults(fn=cmd_match)

    # --device after the subcommand too (it overrides the top-level one)
    for g in sub.choices.values():
        g.add_argument("--device", default=argparse.SUPPRESS, help=DEVICE_HELP)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.threads > 0:
        os.environ["IRIS_NATIVE_THREADS"] = str(args.threads)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
