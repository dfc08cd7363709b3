#!/bin/bash
# End-to-end smoke test harness of the PyTorch/CUDA port.
#
# The counterpart of tools/test-examples.sh over bin/elbencho-tpu-torch, with
# the same tiers and flags: multi-file tests with --verify and a dir-mode
# metadata cycle, block-device tests on loopback devices (skipped where loop
# devices are unavailable), a companion-tooling tier (the port's chart
# launcher and storage sweep, then the native CUDA data path), and the
# distributed tiers: two localhost services, four services on the native
# path with the --start barrier and a time-limited phase, and two services
# reducing their slice stats over two devices.
#
# Device: the native runs (--tpubackend pjrt) go through the port's mock CUDA
# driver on the CPU (EBT_CUDA_DRIVER, built by engine.build_mock(), with
# EBT_TORCH_DEVICE=cpu) where the original points EBT_PJRT_PLUGIN at its mock
# plugin. With --card they run on the CUDA driver (libcuda.so.1) with
# --gpuids 0 instead; nothing falls back, so without a CUDA device they fail
# with the port's own refusal. The slice-stats tier runs on two CPU devices
# in both modes, as the original's runs on two CPU JAX devices.
#
# Flags: -b skip blockdev, -d skip distributed, -m skip multifile,
#        -t skip tooling, --card run the native runs on the card.
# Each tier ends with a line "TIER <name> <pass|fail|skipped> <seconds>".
set -u

cd "$(dirname "$0")/.."
# EBT_TEST_EB wraps the binary (e.g. "env LD_PRELOAD=libtsan... ./bin/...")
EB="${EBT_TEST_EB:-./bin/elbencho-tpu-torch}"
CHART="./bin/elbencho-tpu-torch-chart"
SWEEP="tools/torch_storage_sweep.sh"
SKIP_BLOCK=0 SKIP_DIST=0 SKIP_MULTI=0 SKIP_TOOLS=0 CARD=0
SKIPPED_TIERS=0 SKIPPED_RUNS=0
FAILED=0

ARGS=()
for a in "$@"; do
  if [ "$a" = "--card" ]; then CARD=1; else ARGS+=("$a"); fi
done
set -- ${ARGS[@]+"${ARGS[@]}"}
while getopts "bdmt" opt; do
  case $opt in
    b) SKIP_BLOCK=1;;
    d) SKIP_DIST=1;;
    m) SKIP_MULTI=1;;
    t) SKIP_TOOLS=1;;
    *) echo "usage: $0 [-b] [-d] [-m] [-t] [--card]"; exit 1;;
  esac
done
WORK="$(mktemp -d "${TMPDIR:-/tmp}/ebt-torch-examples.XXXXXX")"

# the native runs' device: DEV_ENV for their processes, GPUIDS for their
# arguments
# START_MARGIN: the seconds from the four services' answering to the --start
# barrier, which their prepare must not outlast (on the card each of the
# five processes starts CUDA, and 15 s has not always sufficed there)
START_MARGIN=15
if [ "$CARD" = 1 ]; then
  unset EBT_CUDA_DRIVER EBT_TORCH_DEVICE
  DEV_ENV=(env)
  GPUIDS=(--gpuids 0)
  START_MARGIN=30
else
  if ! MOCK=$(python -c 'from elbencho_tpu_torch import engine
print(engine.build_mock())'); then
    echo "!!! FAILED: cannot build the mock CUDA driver"
    exit 1
  fi
  DEV_ENV=(env EBT_TORCH_DEVICE=cpu "EBT_CUDA_DRIVER=$MOCK")
  GPUIDS=()
fi

cleanup() {
  [ -n "${SVC_PIDS:-}" ] && kill $SVC_PIDS 2>/dev/null
  [ -n "${LOOPDEV:-}" ] && losetup -d "$LOOPDEV" 2>/dev/null
  [ -n "${LOOPDEV2:-}" ] && losetup -d "$LOOPDEV2" 2>/dev/null
  rm -rf "$WORK"
}
trap cleanup EXIT

run() {
  echo "### $*"
  if ! "$@"; then
    echo "!!! FAILED: $*"
    FAILED=1
    TIER_FAILED=1
  fi
  echo
}

tier_begin() {
  TIER_NAME=$1 TIER_FAILED=0 TIER_T0=$(date +%s.%N)
}

tier_end() {
  local secs; secs=$(awk -v a="$TIER_T0" -v b="$(date +%s.%N)" \
                         'BEGIN{printf "%.1f", b - a}')
  local verdict=pass
  [ "$TIER_FAILED" = 1 ] && verdict=fail
  [ "${1:-}" = skipped ] && verdict=skipped
  echo "TIER $TIER_NAME $verdict $secs"
}

free_port() {
  python -c 'import socket
s = socket.socket(); s.bind(("127.0.0.1", 0)); print(s.getsockname()[1])'
}

# start one foreground service per port (extra env before the command) and
# wait until each answers /info (python rather than curl, which a host may
# lack)
start_services() {
  local envs=("$@") p
  for p in $PORTS; do
    "${envs[@]}" $EB --service --foreground --port "$p" \
      >"$WORK/svc$p.log" 2>&1 &
    SVC_PIDS="${SVC_PIDS:-} $!"
  done
  python -c 'import sys, time, urllib.request
deadline = time.monotonic() + 120
for port in sys.argv[1:]:
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                   timeout=2).read()
            break
        except OSError:
            if time.monotonic() > deadline:
                sys.exit(f"service on port {port} did not come up")
            time.sleep(0.2)' $PORTS && return 0
  echo "!!! FAILED: services on $PORTS did not come up"
  FAILED=1 TIER_FAILED=1
}

hosts_of() {
  local p out=""
  for p in $PORTS; do out="${out:+$out,}127.0.0.1:$p"; done
  echo "$out"
}

echo "=== multi-file / large-file tests ==="
if [ "$SKIP_MULTI" = 0 ]; then
  tier_begin multifile
  run $EB -w -r -t 2 -s 16M -b 1M --verify 1 --nolive "$WORK/f1" "$WORK/f2"
  run $EB -w -r --rand --randalign -b 4k --iodepth 16 -t 2 -s 8M --nolive "$WORK/f1"
  run $EB -F -t 2 --nolive "$WORK/f1" "$WORK/f2"
  mkdir -p "$WORK/dirs"
  run $EB -d -w --stat -r -F -D -t 4 -n 2 -N 16 -s 4k -b 4k --nolive "$WORK/dirs"
  tier_end
fi

echo "=== block device tests (loopback) ==="
if [ "$SKIP_BLOCK" = 0 ]; then
  tier_begin blockdev
  truncate -s 64M "$WORK/loopfile"
  truncate -s 64M "$WORK/loopfile2"
  if LOOPDEV=$(losetup --show -f "$WORK/loopfile" 2>/dev/null); then
    LOOPDEV2=$(losetup --show -f "$WORK/loopfile2" 2>/dev/null) || LOOPDEV2=""
    run $EB -r --rand --randalign -b 4k -t 1 --randamount 8M --lat --nolive "$LOOPDEV"
    if [ -n "$LOOPDEV2" ]; then
    run $EB -w --rand --randalign -b 4k -t 16 --iodepth 16 --randamount 16M \
        --nolive "$LOOPDEV" "$LOOPDEV2"
    else
    run $EB -w --rand --randalign -b 4k -t 16 --iodepth 16 --randamount 16M \
        --nolive "$LOOPDEV"
    fi
    run $EB -r -b 1M -t 8 --nolive "$LOOPDEV"
    if $EB --version | grep -q IOURING; then
      run $EB -w --rand --randalign -b 4k -t 16 --iodepth 16 \
          --ioengine uring --randamount 16M --nolive "$LOOPDEV"
    fi
    run $EB -w -b 1M -t 2 --verify 7 --nolive "$LOOPDEV"
    run $EB -r -b 1M -t 2 --verify 7 --nolive "$LOOPDEV"
    tier_end
  else
    SKIPPED_TIERS=$((SKIPPED_TIERS + 1))
    echo "SKIPPED TIER (blockdev): loop devices unavailable - needs privileges"
    tier_end skipped
  fi
fi

echo "=== companion tooling (chart + sweep) ==="
if [ "$SKIP_TOOLS" = 0 ]; then
  tier_begin tooling
  run $EB -w -t 2 -s 4M -b 1M --csvfile "$WORK/tools.csv" --nolive "$WORK/ct1"
  run $EB -F -t 2 --nolive "$WORK/ct1"
  run $CHART -c "$WORK/tools.csv"
  run $CHART -o "$WORK/tools.csv"
  # the image needs matplotlib, which a host may lack (-c and -o do not)
  if python -c 'import matplotlib' 2>/dev/null; then
    run $CHART -x "block size" -y "MiB/s last:WRITE" --bars \
        --imgfile "$WORK/tools.svg" "$WORK/tools.csv"
  else
    SKIPPED_RUNS=$((SKIPPED_RUNS + 1))
    echo "SKIPPED RUN (chart image): matplotlib is not installed"
  fi
  run $SWEEP -n -t 2 -s "$WORK" -o "$WORK/sweep-dry"
  run $SWEEP -r s -t 2 -F 8 -B -N 1 -s "$WORK" -o "$WORK/sweep-real"
  run test -s "$WORK/sweep-real/sweep.csv"
  tier_end
  # the native CUDA data path: the default tier (registered buffers), then
  # the opt-in transfer-manager tier
  tier_begin native
  run "${DEV_ENV[@]}" $EB -w -r -t 2 -s 4M -b 1M --tpubackend pjrt \
      ${GPUIDS[@]+"${GPUIDS[@]}"} --nolive "$WORK/pjrt-f1"
  run "${DEV_ENV[@]}" EBT_PJRT_XFER_MGR=1 $EB -r -t 2 -s 4M -b 1M \
      --tpubackend pjrt ${GPUIDS[@]+"${GPUIDS[@]}"} --nolive "$WORK/pjrt-f1"
  run $EB -F -t 2 --nolive "$WORK/pjrt-f1"
  tier_end
fi

echo "=== distributed test (two localhost services) ==="
if [ "$SKIP_DIST" = 0 ]; then
  tier_begin dist2
  PORTS="$(free_port) $(free_port)"
  SVC_PIDS=""
  start_services env
  HOSTS=$(hosts_of)
  run $EB --hosts "$HOSTS" -w -r -t 2 -s 8M -b 1M --verify 1 --nolive "$WORK/dist-f1"
  run $EB --hosts "$HOSTS" -F -t 2 --nolive "$WORK/dist-f1"
  run $EB --hosts "$HOSTS" --quit
  SVC_PIDS=""
  tier_end
fi

echo "=== distributed test (4 services, native CUDA path, --start, --timelimit) ==="
if [ "$SKIP_DIST" = 0 ]; then
  tier_begin dist4
  PORTS="$(free_port) $(free_port) $(free_port) $(free_port)"
  SVC_PIDS=""
  start_services "${DEV_ENV[@]}"
  HOSTS4=$(hosts_of)
  START=$(( $(date +%s) + START_MARGIN ))
  run $EB --hosts "$HOSTS4" -w -r -t 2 -s 8M -b 1M --verify 1 \
      --hostverify --start "$START" --tpubackend pjrt \
      ${GPUIDS[@]+"${GPUIDS[@]}"} --lat --nolive "$WORK/dist4-f1"
  run $EB --hosts "$HOSTS4" -w --rand --randalign -b 4k -t 2 -s 64M \
      --randamount 16G --timelimit 1 --nolive "$WORK/dist4-f1"
  run $EB --hosts "$HOSTS4" -F -t 2 --nolive "$WORK/dist4-f1"
  run $EB --hosts "$HOSTS4" --quit
  SVC_PIDS=""
  tier_end
fi

echo "=== distributed test (mesh slice-stats over the staged backend) ==="
if [ "$SKIP_DIST" = 0 ]; then
  tier_begin mesh
  PORTS="$(free_port) $(free_port)"
  SVC_PIDS=""
  start_services env EBT_TORCH_DEVICE=cpu
  HOSTS5=$(hosts_of)
  run $EB --hosts "$HOSTS5" -w -r -t 2 -s 4M -b 1M --gpuids 0,1 \
      --tpubackend staged --nolive "$WORK/dist5-f1"
  run $EB --hosts "$HOSTS5" -F -t 2 --nolive "$WORK/dist5-f1"
  run $EB --hosts "$HOSTS5" --quit
  SVC_PIDS=""
  tier_end
fi

if [ "$SKIPPED_TIERS" != 0 ] || [ "$SKIPPED_RUNS" != 0 ]; then
  echo "WARNING: $SKIPPED_TIERS tier(s) and $SKIPPED_RUNS run(s) skipped" \
       "(see SKIPPED lines above)"
fi
if [ "$FAILED" = 0 ]; then
  echo "ALL TESTS PASSED"
else
  echo "SOME TESTS FAILED"
  exit 1
fi
