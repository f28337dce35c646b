#!/usr/bin/env bash
# Cluster launcher for the headline benchmark (analog of the reference's
# PBS GPU job script: pin a device, run the 1024x1024 case 5x, log to a
# timestamped output file).
#
# Usage: scripts/job.sh [device_index] [repeats]
set -euo pipefail

DEVICE="${1:-0}"
REPEATS="${2:-5}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
OUT="$REPO/d2q9-bgk.out"

{
  echo "host:    $(hostname)"
  echo "date:    $(date -Is)"
  echo "device:  LBM_DEVICE=$DEVICE"
  echo "repeats: $REPEATS"
  echo
  cd "$REPO"
  export LBM_DEVICE="$DEVICE"
  TMP="$(mktemp -d)"
  python3 tools/gen_inputs.py 1024x1024 "$TMP"
  for i in $(seq 1 "$REPEATS"); do
    echo "--- run $i/$REPEATS ---"
    python3 -m lbm_tpu.cli run \
      "$TMP/input_1024x1024.params" "$TMP/obstacles_1024x1024.dat" \
      --output-dir "$TMP/out_$i"
  done
} 2>&1 | tee "$OUT"
