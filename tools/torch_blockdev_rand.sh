#!/bin/bash
#
# torch_blockdev_rand.sh — the fio-style random block-device one-liner of
# tools/blockdev-rand.sh over the PyTorch/CUDA port's launcher,
# bin/elbencho-tpu-torch.
#
# The tool itself is the original's, read from tools/blockdev-rand.sh when
# this runs, with its launcher line (EB) replaced: the same options, the
# same refusal of a non-block device, and the same guard that refuses to
# WRITE to a device that is mounted (or has a mounted partition). See that
# script for the options.
set -u

here="$(cd "$(dirname "$0")" && pwd)"
eb_old='EB="./bin/elbencho-tpu"'
eb_new='EB="./bin/elbencho-tpu-torch"'
script=$(awk -v eo="$eb_old" -v en="$eb_new" \
             '$0 == eo { print en; next } { print }' \
             "$here/blockdev-rand.sh") || exit 1
# refuse a run that would still start the original's launcher
if ! grep -qxF "$eb_new" <<<"$script"; then
  echo "tools/blockdev-rand.sh no longer sets EB as expected. Abort!"
  exit 1
fi
# $0 of the tool is this script, so it runs from the repository root
exec bash -c "$script" "$here/torch_blockdev_rand.sh" "$@"
