#!/bin/bash
# Parent vs change of the PyTorch/CUDA port on one card, in turns
# (parent, change, change, parent per round), so both meet the same host.
#
#   mkdir -p PARENT_DIR && git archive <parent> | tar -x -C PARENT_DIR
#   bash tools/torch_ab.sh PARENT_DIR [ROUNDS]
#
# Runs, from the repo root and from PARENT_DIR: the direct 4 GiB write+read
# of chip_smoke.py's main path (2 x ROUNDS rounds), the same on the native
# engine (--tpubackend pjrt, chip_smoke.py phase 8's setting; ROUNDS
# rounds), then a 1 GiB staged --verify file written once and read in turns
# (3 x ROUNDS rounds), all with 2 MiB chunks. Prints one line per run with
# the CSV's MiB/s.
set -euo pipefail
P=$(cd "$1" && pwd); C=$(pwd); ROUNDS=${2:-1}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in "$C" "$P"; do
  (cd "$t" && python -c "from elbencho_tpu_torch import engine
from elbencho_tpu_torch.ops import verify_kernel
engine.load_lib(); verify_kernel.load_lib()") &
done
wait
D=$(mktemp -d /dev/shm/ebt_ab.XXXX)
trap 'rm -rf "$D"' EXIT
run() {  # label tree args...
  local label=$1 tree=$2; shift 2
  (cd "$tree" && EBT_TPU_CHUNK_BYTES=2097152 python -m elbencho_tpu_torch.cli \
    "$@" --nolive --csvfile "$D/o.csv" >/dev/null 2>"$D/err") \
    || { echo "$label FAILED"; cat "$D/err"; return 1; }
  python - "$label" "$D/o.csv" <<'PY'
import csv, sys
rows = csv.DictReader(open(sys.argv[2]))
print(sys.argv[1], " ".join(f"{r['operation']} {r['MiB/s last']} MiB/s"
                            for r in rows), flush=True)
PY
  rm -f "$D/o.csv"
}
turns() {  # label rounds args...
  local label=$1 n=$2; shift 2
  for _ in $(seq "$n"); do
    for side in parent change change parent; do
      local tree=$C; [ $side = parent ] && tree=$P
      run "$label $side" "$tree" "$@"
      rm -f "$D/f4g"  # every direct run writes a new file
    done
  done
}
turns direct-4G $((2 * ROUNDS)) -w -r -t 4 -s 4G -b 8M --iodepth 4 \
  --gpuids 0 --tpubackend direct --lat "$D/f4g"
turns native-4G "$ROUNDS" -w -r -t 4 -s 4G -b 8M --iodepth 4 \
  --gpuids 0 --tpubackend pjrt --lat "$D/f4g"
run "verify-write change" "$C" -w -t 2 -s 1G -b 4M --verify 42 --gpuids 0 \
  "$D/f1g"
turns verify-read $((3 * ROUNDS)) -r -t 2 -s 1G -b 4M --verify 42 \
  --gpuids 0 "$D/f1g"
