#!/bin/bash
#
# torch_baseline_configs.sh — BASELINE.md "Configs to reproduce" #1-#3 (seq
# read of one large file, random 4KiB IOPS over AIO and io_uring, the
# mdtest-style 100k-file cycle) over the PyTorch/CUDA port's launcher,
# bin/elbencho-tpu-torch, with the raw outputs archived under
# results/torch-baseline-configs/<date>/.
#
# The runs are the original's, read from tools/baseline-configs.sh when this
# runs, with two lines replaced: the launcher (EB) and the default archive
# directory (OUT). Same arguments ([workparent] [outdir]), configs, run
# counts and SUMMARY.txt; see that script.
set -u

here="$(cd "$(dirname "$0")" && pwd)"
eb_old='EB="$REPO/bin/elbencho-tpu"'
eb_new='EB="$REPO/bin/elbencho-tpu-torch"'
out_old='OUT="${2:-$REPO/results/baseline-configs/$(date +%F)}"'
out_new='OUT="${2:-$REPO/results/torch-baseline-configs/$(date +%F)}"'
script=$(awk -v eo="$eb_old" -v en="$eb_new" -v oo="$out_old" \
             -v on="$out_new" '$0 == eo { print en; next }
                                $0 == oo { print on; next } { print }' \
             "$here/baseline-configs.sh") || exit 1
# refuse runs that would still use the original's launcher or archive
if ! grep -qxF "$eb_new" <<<"$script" || ! grep -qxF "$out_new" <<<"$script"
then
  echo "tools/baseline-configs.sh no longer sets EB/OUT as expected. Abort!"
  exit 1
fi
# $0 of the runs is this script, so REPO is the repository root
exec bash -c "$script" "$here/torch_baseline_configs.sh" "$@"
