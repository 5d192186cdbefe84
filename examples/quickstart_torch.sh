#!/usr/bin/env bash
# End-to-end demo of the full MPC pipeline on one machine, through the
# PyTorch + CUDA port's CLI (examples/quickstart.sh drives the JAX package's).
#
#   bash examples/quickstart_torch.sh [workdir]
#
# generate -> prepare (3-party shares) -> decrypt roundtrip -> keyed
# participants -> rerandomize with X25519 pair keys -> two participants +
# coordinator-holding-the-third-share over TCP (star, then chain) -> local
# match and audit on the card. Every role runs on the card; DEVICE=cpu runs
# them on the CPU instead (the port's `--device`, whose default `cuda` raises
# without a card). The package is taken from this checkout. Uses small data
# (4,096 templates) so it finishes in minutes; scale `COUNT` up at will.
set -euo pipefail

ROOT="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
DIR="${1:-$(mktemp -d)}"
COUNT=4096
PORT0=47001
PORT1=47002
CLI="python -m mpc_iris_tpu_torch --device ${DEVICE:-cuda}"
cd "$DIR"
echo "== workdir: $DIR"

echo "== 1. generate $COUNT random templates"
$CLI generate db.json "$COUNT" --replace --seed 7

echo "== 2. prepare: split into 3 additive shares + public masks (+ key)"
$CLI prepare db.json 3 mpc --insecure-seed 1 --save-key mpc.key

echo "== 3. decrypt: reconstruct and sanity-check the roundtrip"
$CLI decrypt mpc.share-0 mpc.share-1 mpc.share-2 --output roundtrip.json

echo "== 3b. keyed shares: party 1 serves with NO share file AND the"
echo "       coordinator's own share 0 is keyed too — only the data-carrying"
echo "       share 2 touches disk (must run before rerandomize — SPEC 4.2)"
$CLI participant "keyed:1:$COUNT:mpc.key" 127.0.0.1:$PORT0 &
K0=$!
$CLI participant mpc.share-2 127.0.0.1:$PORT1 &
K1=$!
trap 'kill $K0 $K1 2>/dev/null || true' EXIT
for _ in $(seq 1 120); do
  if { exec 3<>/dev/tcp/127.0.0.1/$PORT0 && exec 3<&-; } 2>/dev/null \
     && { exec 3<>/dev/tcp/127.0.0.1/$PORT1 && exec 3<&-; } 2>/dev/null; then
    break
  fi
  sleep 5
done
$CLI coordinator 127.0.0.1:$PORT0 127.0.0.1:$PORT1 \
  --masks mpc.masks --share "keyed:0:$COUNT:mpc.key" --queries 1 --seed 5
kill $K0 $K1 2>/dev/null || true
wait $K0 $K1 2>/dev/null || true

echo "== 4. rerandomize: refresh shares with pairwise zero-sum noise."
echo "      Pair keys come from X25519 agreement (keygen/pair-key): parties"
echo "      exchange .pub files; both ends of a pair derive the SAME key."
for i in 0 1 2; do $CLI keygen "p$i.id"; done >/dev/null
$CLI pair-key p0.id p1.id.pub --context r1 --out k01.hex
$CLI pair-key p0.id p2.id.pub --context r1 --out k02.hex
$CLI pair-key p1.id p0.id.pub --context r1 --out k10.hex
$CLI pair-key p1.id p2.id.pub --context r1 --out k12.hex
$CLI pair-key p2.id p0.id.pub --context r1 --out k20.hex
$CLI pair-key p2.id p1.id.pub --context r1 --out k21.hex
cmp k01.hex k10.hex && echo "   pair 0-1 derived identically on both sides ✓"
$CLI rerandomize mpc.share-0 --index 0 --pair 1:@k01.hex --pair 2:@k02.hex
$CLI rerandomize mpc.share-1 --index 1 --pair 0:@k10.hex --pair 2:@k12.hex
$CLI rerandomize mpc.share-2 --index 2 --pair 0:@k20.hex --pair 1:@k21.hex
$CLI decrypt mpc.share-0 mpc.share-1 mpc.share-2 --output roundtrip2.json
cmp roundtrip.json roundtrip2.json && echo "   reconstruction unchanged ✓"

echo "== 5. start two participant servers (third share stays local)"
$CLI participant mpc.share-0 127.0.0.1:$PORT0 &
P0=$!
$CLI participant mpc.share-1 127.0.0.1:$PORT1 &
P1=$!
trap 'kill $P0 $P1 2>/dev/null || true' EXIT
# wait for both to warm up and listen
for _ in $(seq 1 120); do
  if { exec 3<>/dev/tcp/127.0.0.1/$PORT0 && exec 3<&-; } 2>/dev/null \
     && { exec 3<>/dev/tcp/127.0.0.1/$PORT1 && exec 3<&-; } 2>/dev/null; then
    break
  fi
  sleep 5
done

echo "== 6. coordinator: 3 MPC uniqueness checks (resolver holds share-2)"
$CLI coordinator 127.0.0.1:$PORT0 127.0.0.1:$PORT1 \
  --masks mpc.masks --share mpc.share-2 --queries 3 --threshold 0.36 --seed 5
kill $P0 $P1 2>/dev/null || true
wait $P0 $P1 2>/dev/null || true

echo "== 6b. same checks over CHAINED aggregation (SPEC 5.4): replies sum"
echo "       hop-by-hop; coordinator ingress is ONE stream, any party count"
$CLI participant mpc.share-0 127.0.0.1:$PORT0 --wire chain &
C0=$!
$CLI participant mpc.share-1 127.0.0.1:$PORT1 --wire chain \
  --chain-allow 127.0.0.1:$PORT0 &
C1=$!
trap 'kill $C0 $C1 2>/dev/null || true' EXIT
for _ in $(seq 1 120); do
  if { exec 3<>/dev/tcp/127.0.0.1/$PORT0 && exec 3<&-; } 2>/dev/null \
     && { exec 3<>/dev/tcp/127.0.0.1/$PORT1 && exec 3<&-; } 2>/dev/null; then
    break
  fi
  sleep 5
done
$CLI coordinator 127.0.0.1:$PORT0 127.0.0.1:$PORT1 \
  --masks mpc.masks --share mpc.share-2 --wire chain --batch 3 \
  --queries 3 --threshold 0.36 --seed 5
kill $C0 $C1 2>/dev/null || true
wait $C0 $C1 2>/dev/null || true

echo "== 7. local plaintext match on the card (no MPC)"
$CLI match db.json --batch 8 --seed 3 --threshold 0.36

echo "== 8. dedup audit: EVERY entry under the threshold, not just the argmin"
$CLI match db.json --batch 8 --seed 3 --all-under 1e-6

echo "== quickstart complete (artifacts in $DIR)"
