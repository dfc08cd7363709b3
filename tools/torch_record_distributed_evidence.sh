#!/bin/bash
#
# torch_record_distributed_evidence.sh — the real-device distributed
# evidence run of tools/record-distributed-evidence.sh over the PyTorch/CUDA
# port: two localhost port services and a port master, --tpubackend pjrt
# (the port's native CUDA engine) with --gpuids 0 on the card, per-chip
# transfer latency fanned in host-prefixed with clock provenance. Output
# goes to results/torch_distributed/<date>/ (master_output.txt and the two
# service logs); the exit code is the master's.
#
# The run is the original's, read from tools/record-distributed-evidence.sh
# when this runs, with its five launcher lines (./bin/elbencho-tpu, bare or
# behind timeout) on bin/elbencho-tpu-torch, its output directory OUT and
# the evidence header's device line replaced.
set -u

here="$(cd "$(dirname "$0")" && pwd)"
out_old='OUT="results/distributed/$DATE"'
out_new='OUT="results/torch_distributed/$DATE"'
dev_old='  echo "# two localhost services + master, --tpubackend pjrt, 1 real TPU"'
dev_new='  echo "# two localhost port services + master, --tpubackend pjrt (native CUDA engine), 1 GPU"'
script=$(sed -e 's#^\(timeout [0-9]* \)\{0,1\}\./bin/elbencho-tpu #\1./bin/elbencho-tpu-torch #' \
             "$here/record-distributed-evidence.sh" |
         awk -v oo="$out_old" -v on="$out_new" -v dvo="$dev_old" \
             -v dvn="$dev_new" '$0 == oo { print on; next }
                               $0 == dvo { print dvn; next } { print }') ||
  exit 1
# refuse a run that would still start the original's launcher or write the
# original's evidence directory
launchers=$(grep -c '^\(timeout [0-9]* \)\{0,1\}\./bin/elbencho-tpu-torch ' \
            <<<"$script")
if [ "$launchers" != 5 ] || grep -q '\./bin/elbencho-tpu ' <<<"$script" ||
   ! grep -qxF "$out_new" <<<"$script" ||
   ! grep -qxF "$dev_new" <<<"$script"; then
  echo "tools/record-distributed-evidence.sh no longer starts" \
       "./bin/elbencho-tpu and sets OUT as expected. Abort!"
  exit 1
fi
# $0 of the run is this script, so it runs from the repository root
exec bash -c "$script" "$here/torch_record_distributed_evidence.sh" "$@"
