#!/bin/bash
#
# torch_storage_sweep.sh — the file-size sweep of tools/storage-sweep.sh
# (LOSF to large files, mean-of-N-runs aggregation, chart output) over the
# PyTorch/CUDA port's launchers, bin/elbencho-tpu-torch and
# bin/elbencho-tpu-torch-chart.
#
# The sweep itself is the original's, read from tools/storage-sweep.sh when
# this runs, with its two launcher lines replaced: the same options, dry-run
# plan (-n), datasets, commands and aggregation. See that script for the
# options.
set -u

here="$(cd "$(dirname "$0")" && pwd)"
eb='EB="./bin/elbencho-tpu-torch"'
chart='CHART="./bin/elbencho-tpu-torch-chart"'
script=$(sed -e "s|^EB=\"./bin/elbencho-tpu\"\$|$eb|" \
             -e "s|^CHART=\"./bin/elbencho-tpu-chart\"\$|$chart|" \
             "$here/storage-sweep.sh") || exit 1
# refuse a sweep that would still run the original's launchers
if ! grep -qxF "$eb" <<<"$script" || ! grep -qxF "$chart" <<<"$script"; then
  echo "tools/storage-sweep.sh no longer sets EB/CHART as expected. Abort!"
  exit 1
fi
# $0 of the sweep is this script, so it runs from the repository root
exec bash -c "$script" "$here/torch_storage_sweep.sh" "$@"
