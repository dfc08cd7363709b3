# Build system for the TPU-native elbencho rebuild.
#
# Reference analogue: the reference's Makefile + build_helpers/AutoDetection.mk
# auto-detect CUDA/cuFile; here the native core is accelerator-agnostic (the
# device hook is injected at runtime by the Python/JAX layer), and we
# auto-detect the TPU runtime at the Python level instead (elbencho_tpu/tpu/).
#
# Targets:
#   make / make core   - build the native engine -> elbencho_tpu/libebtcore.so
#   make debug         - native engine with -O0 -g and sanitizer-friendly flags
#   make tsan/asan/ubsan - sanitizer builds (core_{tsan,asan,ubsan}.so)
#   make test          - build + run the pytest suite
#   make check         - static-analysis gate: check-tsa + audit + tidy
#   make check-tsa     - clang -Wthread-safety over the annotated native core
#   make audit         - clang-free analyzer suite (tools/audit/): lockcheck
#                        + protocol schema registry + counter coverage +
#                        interface lint, one report format
#   make lint          - the interface-drift analyzer alone (same report)
#   make clean

CXX      ?= g++
CXXFLAGS ?= -O3 -std=c++17 -Wall -Wextra -fPIC -pthread
CPPFLAGS += -Icore/include -Icore/third_party
LDFLAGS  += -shared -pthread -ldl

CORE_SRCS := core/src/engine.cpp core/src/capi.cpp core/src/pjrt_path.cpp \
             core/src/uring.cpp core/src/reactor.cpp core/src/numa.cpp
# native selftest build inputs (no capi — the selftest drives the C++ API)
SELFTEST_SRCS := core/src/engine.cpp core/src/pjrt_path.cpp core/src/uring.cpp \
                 core/src/reactor.cpp core/src/numa.cpp \
                 core/test/native_selftest.cpp
CORE_HDRS := $(wildcard core/include/ebt/*.h) core/third_party/pjrt/pjrt_c_api.h
CORE_LIB  := elbencho_tpu/libebtcore.so
# mock PJRT plugin: host-memory accelerator for CI (tests the native
# plugin-loading + transfer path end-to-end without TPU hardware)
MOCK_LIB  := elbencho_tpu/libebtpjrtmock.so

.PHONY: all core debug tsan asan ubsan test test-tsan test-asan test-ubsan \
        test-examples-dist-tsan test-d2h test-lanes test-stripe \
        test-checkpoint test-uring test-load test-faults test-ingest \
        test-reactor test-reshard test-campaign test-serving check \
        check-tsa \
        audit lint tidy clean help deb rpm probe \
        torch torch-deb torch-rpm torch-test-examples-dist-tsan

all: core

core: $(CORE_LIB) $(MOCK_LIB)

# Standalone native transfer probe: the raw PJRT h2d ceiling bench.py
# divides the framework by (build/pjrt_probe [total_mib] [chunk_mib]
# [depth] [burn_mib] [nbufs] [confirm_arrival])
probe: build/pjrt_probe

build/pjrt_probe: core/tools/pjrt_probe.cpp core/third_party/pjrt/pjrt_c_api.h
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O2 -std=c++17 -Wall -Wextra core/tools/pjrt_probe.cpp -ldl -o $@

$(CORE_LIB): $(CORE_SRCS) $(CORE_HDRS)
	$(CXX) $(CPPFLAGS) $(CXXFLAGS) $(CORE_SRCS) $(LDFLAGS) -o $@

$(MOCK_LIB): core/src/pjrt_mock_plugin.cpp core/third_party/pjrt/pjrt_c_api.h
	$(CXX) $(CPPFLAGS) $(CXXFLAGS) core/src/pjrt_mock_plugin.cpp -shared -pthread -o $@

debug: CXXFLAGS := -O0 -g -std=c++17 -Wall -Wextra -fPIC -pthread -D_FORTIFY_SOURCE=2
debug: $(CORE_LIB)

# Run tests against a sanitizer build with e.g.:
#   LD_PRELOAD=/lib/x86_64-linux-gnu/libtsan.so.2 \
#   EBT_CORE_LIB=$$PWD/elbencho_tpu/libebtcore_tsan.so python -m pytest tests/
# (LD_PRELOAD avoids the static-TLS dlopen limitation of libtsan)
tsan: $(CORE_SRCS) $(CORE_HDRS) $(MOCK_LIB)
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -fPIC -pthread -fsanitize=thread \
	  $(CORE_SRCS) -shared -ldl -o elbencho_tpu/libebtcore_tsan.so
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread -fsanitize=thread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest_tsan
	TSAN_OPTIONS="report_bugs=1 exitcode=66" \
	  ./build/native_selftest_tsan $(MOCK_LIB) pjrt

# Note: running the pytest suite against the ASAN build requires a main
# binary that initializes the ASAN runtime before dlopen; under a plain
# LD_PRELOAD into python, ASAN's __cxa_throw interceptor is uninitialized and
# aborts on the engine's first (intentional) WorkerError throw. TSAN does not
# have this limitation — it is the continuously-run sanitizer (test-tsan).
# ASAN coverage instead comes from the native selftest below (test-asan),
# whose instrumented C++ main exercises engine + PJRT path leak-checked.
asan: $(CORE_SRCS) $(CORE_HDRS) $(MOCK_LIB)
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -fPIC -pthread -fsanitize=address \
	  $(CORE_SRCS) -shared -ldl -o elbencho_tpu/libebtcore_asan.so

test-asan: $(MOCK_LIB)
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread -fsanitize=address \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest_asan
	ASAN_OPTIONS=detect_leaks=1 ./build/native_selftest_asan $(MOCK_LIB)

# UBSan rounds out the sanitizer matrix (tsan: data races, asan: memory
# errors + leaks, ubsan: signed overflow / misaligned loads / bad shifts in
# the offset-generator and histogram integer math). Same selftest vehicle as
# test-asan: an instrumented C++ main exercising engine + PJRT path;
# -fno-sanitize-recover makes the first report fail the run.
ubsan: $(CORE_SRCS) $(CORE_HDRS) $(MOCK_LIB)
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -fPIC -pthread \
	  -fsanitize=undefined -fno-sanitize-recover=all \
	  $(CORE_SRCS) -shared -ldl -o elbencho_tpu/libebtcore_ubsan.so

test-ubsan: $(MOCK_LIB)
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  -fsanitize=undefined -fno-sanitize-recover=all \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest_ubsan
	./build/native_selftest_ubsan $(MOCK_LIB)

# ---- static analysis gate (docs/STATIC_ANALYSIS.md) ----

# Lock-discipline enforcement: clang's -Wthread-safety analysis over the
# annotated native core (core/include/ebt/annotate.h). Zero warnings is the
# contract — -Werror=thread-safety turns any violation into a build failure.
# Skips with a notice when clang is not installed (the annotations are
# no-ops under g++, so `make core` is unaffected either way).
TSA_SRCS := $(CORE_SRCS) core/src/pjrt_mock_plugin.cpp \
            core/test/native_selftest.cpp core/tools/pjrt_probe.cpp
CLANGXX := $(shell command -v clang++ 2>/dev/null)
check-tsa:
ifeq ($(CLANGXX),)
	@echo "check-tsa: clang++ not found - skipping (install clang to run" \
	      "the -Wthread-safety lock-discipline analysis)"
else
	$(CLANGXX) $(CPPFLAGS) -std=c++17 -fsyntax-only \
	  -Wthread-safety -Werror=thread-safety $(TSA_SRCS)
	@echo "check-tsa: zero -Wthread-safety warnings"
endif

# The clang-free audit suite (docs/STATIC_ANALYSIS.md): lock-order checker
# over the annotated native core (hierarchy vs docs/CONCURRENCY.md, raw
# mutexes, cv predicate loops), exit-path resource-pairing verifier
# (EBT_PAIR_BEGIN/END/HOLDER), hot-path purity ratchet (EBT_HOT roots,
# baselined in tools/audit/hotpath_baseline.json, writes
# build/hotpath_report.txt), protocol golden-schema registry
# (tools/audit/schemas/), counter-coverage chain audit, pod fan-in
# merge-law analyzer (mergecheck: declared merge classes vs the actual
# remote.py/stats.py merge operations, associativity/commutativity gated,
# writes build/merge_report.txt), and the interface-drift linter — one
# `audit:<analyzer>: file:line: cause` report format, written to
# build/audit_report.txt (all three reports uploaded as CI artifacts).
audit:
	@mkdir -p build
	python3 -m tools.audit --report build/audit_report.txt

# Interface-drift analyzer alone: capi.cpp ebt_* exports vs the ctypes
# bindings (restype/argtypes presence AND shape: arg count + pointer-ness
# vs the C signatures), and CLI flags vs config keys vs bash completion vs
# README flag tables. Same driver and report format as make audit.
lint:
	python3 -m tools.audit --only interfaces

# clang-tidy (bugprone-*, concurrency-*, performance-* via .clang-tidy);
# advisory depth on top of check-tsa/lint, skipped when not installed.
CLANG_TIDY := $(shell command -v clang-tidy 2>/dev/null)
tidy:
ifeq ($(CLANG_TIDY),)
	@echo "tidy: clang-tidy not found - skipping"
else
	$(CLANG_TIDY) $(CORE_SRCS) -- $(CPPFLAGS) -std=c++17
endif

# Aggregate static-analysis gate: everything that needs no hardware and no
# sanitizer runtime. CI runs this next to the tier-1 pytest suite. tidy is
# advisory (leading '-') until it has a clean baseline on a clang host —
# matching CI, where it runs in the non-blocking sanitizer job.
check: core check-tsa audit
	-$(MAKE) -s tidy

test: core
	python -m pytest tests/ -x -q
	$(MAKE) -s test-tsan
	$(MAKE) -s test-asan

# Deferred-D2H write-pipeline tier-1 marker group (--d2hdepth): the
# pipelined-vs-serial A/B, overlap accounting, write-gen deferral, and the
# EBT_MOCK_D2H_FAIL_AT mid-pipeline fault drain — CI runs this in the
# blocking section next to the full tier-1 suite.
test-d2h: core
	python -m pytest tests/ -q -m d2h

# Mesh-striped fill gate (docs/DATA_PATH_TIERS.md "striped tier"): the
# tier-1 stripe marker group (planner properties incl. uneven block
# counts, scatter/gather E2E on 4 mock devices, single-device A/B byte
# identity, alignment refusal, per-device fault injection, the bench
# stripe leg) plus the native selftest's stripe scatter/gather hammer
# (4 threads x 4 mock devices under service time; unit accounting must
# reconcile exactly). The same hammer runs under TSAN/ASAN/UBSAN via
# make tsan / test-asan / test-ubsan. Blocking in CI.
test-stripe: core
	python -m pytest tests/ -q -m stripe
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) stripe

# Checkpoint-restore gate (docs/CHECKPOINT.md): the tier-1 checkpoint
# marker group (manifest edge-case refusals, the 4-mock-device restore
# E2E with byte-exact placement + shard-residency reconciliation,
# EBT_MOCK_STRIPE_FAIL_AT-style shard fault attribution, the bench ttr
# leg) plus the native selftest's restore hammer (4 threads x 4 mock
# devices under service time; per-shard byte reconciliation must be
# exact, fault injection must attribute "device N shard S"). The same
# hammer runs under TSAN/ASAN/UBSAN via make tsan / test-asan /
# test-ubsan. Blocking in CI.
test-checkpoint: core
	python -m pytest tests/ -q -m checkpoint
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) ckpt

# io_uring backend + unified buffer registration gate (docs/IO_BACKENDS.md):
# the tier-1 uring marker group (probe/fallback resolution, the
# EBT_URING_DISABLE byte-identical A/B, eviction unity of DmaMap handle +
# fixed-buffer slot, in-flight-SQE eviction holds, register fault
# injection, the dense re-register fallback, SQPOLL wakeups, the
# aio_setup_retries surface, result-tree/pod fan-in) plus the native
# selftest's registration hammer (engine E2E through the EBT_MOCK_URING
# shim + 4 threads mixing claim/release/holds under concurrent ring
# churn). The same hammer runs under TSAN/ASAN/UBSAN via make tsan /
# test-asan / test-ubsan. Blocking in CI.
test-uring: core
	python -m pytest tests/ -q -m uring
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) uring

# Open-loop load-generation gate (docs/OPEN_LOOP.md): the tier-1 load
# marker group (pacer math incl. the Poisson inter-arrival distribution
# check and paced exactness, backlog carry-over across blocks/hot-loop
# re-entries, timelimit drop accounting, tenant-class separation, the
# EBT_LOAD_CLOSED_LOOP byte-identical A/B, result-tree/pod fan-in, and
# the >= 100-simulated-host control-plane scale test with one injected
# straggler and one injected dead host) plus the native selftest's
# pacer/tenant hammer (4 threads x 2 classes, poisson + over-offered
# paced schedules, exact arrivals == completions + dropped
# reconciliation). The hammer also runs in the full selftest scope
# (test-asan/test-ubsan); TSAN coverage rides the test-tsan pytest list.
# Blocking in CI.
test-load: core
	python -m pytest tests/ -q -m load
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) load

# Fault-tolerance gate (docs/FAULT_TOLERANCE.md): the tier-1 faults
# marker group (retry/backoff, error-budget absorption, the --maxerrors 0
# first-error-abort A/B, device ejection + live replanning byte-exact
# through stripe AND checkpoint phases, the chaos-seam reachability
# matrix, interrupt-wakes-backoff, host-level partial-result salvage,
# result-tree/pod fan-in) plus the native selftest's eject/replan hammer
# (4 threads x 4 mock devices with a mid-phase injected lane failure;
# exact byte reconciliation through the recovery) and a short chaos
# campaign (tools/chaos.py: recovery invariants asserted across seeded
# rounds). The hammer also runs in the full and pjrt selftest scopes, so
# make tsan / test-asan / test-ubsan cover it. Blocking in CI.
test-faults: core
	python -m pytest tests/ -q -m faults
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) faults
	python3 tools/chaos.py --rounds 2

# DL-ingestion gate (docs/INGEST.md): the tier-1 ingest marker group
# (shuffle determinism — same seed => identical order across runs and
# across ranks' partitions; window=1 sequential degeneration; window >> 1
# distribution sanity; the 4-mock-device multi-epoch E2E with exact
# per-epoch records_read == resident + dropped reconciliation; mid-epoch
# fault attribution "device N epoch E"; open-loop ingest; config
# refusals; result-tree/pod fan-in; the bench ingest leg) plus the native
# selftest's ingest hammer (4 threads x 4 mock devices x 2 epochs under
# service time; per-epoch byte reconciliation must be exact, a rearm'd
# second round must reconcile from zero). The same hammer runs under
# TSAN/ASAN/UBSAN via make tsan / test-asan / test-ubsan. Blocking in CI.
test-ingest: core
	python -m pytest tests/ -q -m ingest
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) ingest

# Topology-shift reshard gate (docs/RESHARD.md): the tier-1 reshard
# marker group (N->M planner properties — fuzz over uneven shard/device
# grids asserting every byte placed exactly once, the N==M identity plan
# emitting zero moves with byte-identical A/B vs a plain restore, M<N
# consolidation draining evicted lanes exactly; the 4-mock-device
# reshard E2E with per-unit byte reconciliation and the lane-pair
# matrix; the EBT_D2D_DISABLE=1 host-bounce control; EBT_MOCK_D2D_FAIL_AT
# settle-time recovery; config refusals; result-tree/pod fan-in; the
# bench reshard leg with its REFUSED-when-unengaged grade) plus the
# native selftest's D2D hammer (4 threads x 4 mock devices under
# per-pair service time across clean/injected/disabled rounds; the
# src->dst pair byte reconciliation must stay exact through an injected
# in-flight move failure) and a chaos campaign reshard round. The same
# hammer runs under TSAN/ASAN/UBSAN via make tsan / test-asan /
# test-ubsan. Blocking in CI.
test-reshard: core
	python -m pytest tests/ -q -m reshard
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) reshard
	python3 tools/chaos.py --rounds 1 --scenario reshard

# Completion-reactor + NUMA-placement gate (docs/CONCURRENCY.md): the
# tier-1 reactor marker group (reactor-vs-polling byte-identical A/Bs on
# the serial/async/mmap hot loops + ingest, open-loop ledger exactness
# under the unified wait, the EBT_MOCK_REACTOR_FAIL_AT eventfd-bridge
# injection unwinding to the polling shape with a latched cause,
# interrupt-wakes-reactor-backoff, --numazones single-node and
# EBT_NUMA_DISABLE_MBIND fallback modes, result-tree/pod fan-in, the
# bench load-leg reactor gates) plus the native selftest's reactor
# hammer (4 workers x 2 mock devices, mixed CQ/OnReady/arrival wakeups
# under EBT_MOCK_PJRT_XFER_US with exact wakeup-counter reconciliation;
# engine-based like the load hammer, so ASAN/UBSAN cover it via the
# full selftest scope and TSAN via the test-tsan pytest list).
# Blocking in CI.
test-reactor: core
	python -m pytest tests/ -q -m reactor
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) reactor

# Scenario-campaign + streaming-observability gate (docs/CAMPAIGNS.md):
# the tier-1 campaign marker group (spec refusal-with-cause, the
# invariant catalog, the seeded soak-reproducibility acceptance test —
# restore -> ramp -> ejection -> reshard twice with identical
# stage-level reports — Prometheus-text validity, degraded/mid-ejection
# /phase-transition scrapes, the service /metrics endpoint and the
# --metricsport master listener) plus the 2-stage seeded
# campaigns/ci-smoke.json smoke with one injected fault and its
# invariant assertions. Blocking in CI.
test-campaign: core
	python -m pytest tests/ -q -m campaign
	python3 tools/campaign.py campaigns/ci-smoke.json

# Serving-under-rotation gate (docs/SERVING.md): the tier-1 serving
# marker group (--arrival trace grammar refusals + THE shipped sampler's
# cross-host/rank reproducibility, the rotation E2E with per-rotation
# reconciliation at every swap + double-buffer retention released
# exactly + zero leaked buffers, the background QoS token buckets and
# the adaptive controller, SLO-goodput accounting, result-tree/pod
# fan-in, the /metrics rotation gauges with scrapes racing swaps, the
# campaign engine's start_at scheduling and the chaos-serving campaign)
# plus the native selftest's rotation hammer (3 foreground threads
# racing a rotator through begin/restore/swap cycles under service time
# + a lane bg budget; pjrt-only, so `make tsan`'s pjrt scope AND the
# full asan/ubsan scopes cover it) and the seeded chaos-serving round.
# Blocking in CI.
test-serving: core
	python -m pytest tests/ -q -m serving
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) serving
	python3 tools/chaos.py --rounds 1 --scenario serving

# Lane-contention gate (docs/CONCURRENCY.md): the native selftest's PJRT
# scope, which includes the lane/shard locking hammer (4 worker threads x
# 2 mock devices, mixed submit/await/window-register/unmap/evict under
# EBT_MOCK_PJRT_XFER_US service time) plus the EBT_PJRT_SINGLE_LANE=1 A/B.
# Unsanitized (fast, runs everywhere) — CI runs it in the BLOCKING section;
# the sanitizer matrix runs the same hammer under TSAN/ASAN/UBSAN.
test-lanes: $(MOCK_LIB)
	@mkdir -p build
	$(CXX) $(CPPFLAGS) -O1 -g -std=c++17 -pthread \
	  $(SELFTEST_SRCS) \
	  -ldl -o build/native_selftest
	./build/native_selftest $(MOCK_LIB) pjrt

# Continuous TSAN verification of the native engine (VERDICT r1 item 10):
# runs the engine test layer against the instrumented core. LD_PRELOAD works
# around libtsan's static-TLS dlopen limitation; exitcode=66 makes any race
# report fail the run. Skips (with a notice) if libtsan is not installed.
# detect_deadlocks=0: this container's libtsan FATALs when its second-order
# deadlock detector overflows the 64-locks-per-thread table (observed under
# the Python+JAX process: sanitizer_deadlock_detector.h:67 CHECK), killing
# the run mid-suite — and its double-lock reports here are all instances of
# the documented destroyed-mutex metadata loss (tests/tsan.supp, class 2).
# Lock ORDERING is gated statically by tools/audit/lockcheck.py (make
# audit) and dynamically, without suppressions, by the selftest hammers.
TSAN_RT := $(firstword $(wildcard \
  /usr/lib/*-linux-gnu/libtsan.so.* /lib/*-linux-gnu/libtsan.so.* \
  /usr/lib64/libtsan.so.* /usr/lib/libtsan.so.*))
ifeq ($(TSAN_RT),)
test-tsan:
	@echo "test-tsan: libtsan runtime not found - skipping"
else
test-tsan: tsan
	TSAN_OPTIONS="report_bugs=1 exitcode=66 detect_deadlocks=0 suppressions=$(CURDIR)/tests/tsan.supp" \
	  LD_PRELOAD=$(TSAN_RT) \
	  EBT_CORE_LIB=$(CURDIR)/elbencho_tpu/libebtcore_tsan.so \
	  python -m pytest tests/test_engine.py tests/test_regressions.py \
	    tests/test_pjrt_native.py tests/test_matrix.py \
	    tests/test_d2h_pipeline.py tests/test_uring.py \
	    tests/test_load.py tests/test_reactor.py -x -q
# tests/test_faults.py is deliberately NOT in the test-tsan list: its many
# short-lived engine handles hit the documented class-2 libtsan artifact
# (tests/tsan.supp: stale mutex metadata on heap reuse) flakily through
# ctypes. The fault machinery's TSAN coverage rides the native selftest's
# eject/replan hammer instead (make tsan runs the pjrt scope, which
# includes it — statically linked, deterministic, unsuppressed).
# tests/test_ingest.py stays out for the same reason (one engine handle
# per E2E test); the ingest ledger's TSAN coverage rides the selftest's
# ingest hammer, which is in the pjrt scope `make tsan` runs.
# tests/test_serving.py stays out for the same reason again (every
# rotation E2E builds its own engine); the rotation ledger's TSAN
# coverage rides the selftest's serving rotation hammer — pjrt-only by
# design, so the `make tsan` pjrt scope runs it unsuppressed.

# Distributed tiers of the example harness under the TSAN engine: 4 services
# with the native mock-PJRT path, --start barrier, time-limited phase, and
# the mesh slice-stats tier. The sanitizer is scoped to the benchmark
# processes via EBT_TEST_EB (preloading libtsan into bash/the sh launcher
# segfaults); PYTHONPATH is cleared so host sitecustomize hooks (which may
# preload non-TSAN-clean runtimes) stay out of the services.
test-examples-dist-tsan: tsan
	EBT_TEST_EB="env TSAN_OPTIONS=report_bugs=1:exitcode=66:suppressions=$(CURDIR)/tests/tsan.supp \
	  LD_PRELOAD=$(TSAN_RT) \
	  EBT_CORE_LIB=$(CURDIR)/elbencho_tpu/libebtcore_tsan.so \
	  PYTHONPATH= python -m elbencho_tpu.cli" \
	  tools/test-examples.sh -b -m -t
endif

VERSION := $(shell sed -n 's/^__version__ = "\(.*\)"/\1/p' elbencho_tpu/__init__.py)
DEB_ARCH := $(shell dpkg --print-architecture 2>/dev/null || echo amd64)
PKGROOT := build/pkg/elbencho-tpu_$(VERSION)

# deb package (reference analogue: make deb via packaging/debian)
deb: core
	rm -rf $(PKGROOT)
	mkdir -p $(PKGROOT)/DEBIAN $(PKGROOT)/usr/lib/elbencho-tpu \
	  $(PKGROOT)/usr/bin $(PKGROOT)/usr/share/bash-completion/completions \
	  $(PKGROOT)/usr/share/doc/elbencho-tpu
	sed -e 's/__VERSION__/$(VERSION)/' -e 's/^Architecture: .*/Architecture: $(DEB_ARCH)/' \
	  packaging/debian/control > $(PKGROOT)/DEBIAN/control
	cp -r elbencho_tpu $(PKGROOT)/usr/lib/elbencho-tpu/
	# ship only the production library - no sanitizer builds, no bytecode
	rm -rf $(PKGROOT)/usr/lib/elbencho-tpu/elbencho_tpu/libebtcore_tsan.so \
	  $(PKGROOT)/usr/lib/elbencho-tpu/elbencho_tpu/libebtcore_asan.so
	find $(PKGROOT)/usr/lib/elbencho-tpu -name __pycache__ -type d -exec rm -rf {} +
	install -m 755 bin/elbencho-tpu bin/elbencho-tpu-chart $(PKGROOT)/usr/bin/
	install -m 644 dist/bash_completion.d/elbencho-tpu \
	  dist/bash_completion.d/elbencho-tpu-chart \
	  $(PKGROOT)/usr/share/bash-completion/completions/
	install -m 644 LICENSE CHANGELOG.md \
	  $(PKGROOT)/usr/share/doc/elbencho-tpu/
	dpkg-deb --build --root-owner-group $(PKGROOT) \
	  build/elbencho-tpu_$(VERSION)_$(DEB_ARCH).deb

rpm:
	@echo "render packaging/rpm.spec.template with VERSION=$(VERSION) and run rpmbuild"
	sed 's/__VERSION__/$(VERSION)/' packaging/rpm.spec.template > build/elbencho-tpu.spec 2>/dev/null || \
	  (mkdir -p build && sed 's/__VERSION__/$(VERSION)/' packaging/rpm.spec.template > build/elbencho-tpu.spec)

# ---- the PyTorch/CUDA port (elbencho_tpu_torch) ----

PYTHON ?= python3
TORCH_PREBUILT := elbencho_tpu_torch/_prebuilt
TORCH_VERSION := $(shell sed -n 's/^__version__ = "\(.*\)"/\1/p' elbencho_tpu_torch/__init__.py)
TORCH_PKGROOT := build/pkg/elbencho-tpu-torch_$(TORCH_VERSION)
TORCH_LIBDIR := /usr/lib/elbencho-tpu-torch
# a packaged launcher: bin/'s, with the package's directory moved from the
# launcher's parent to ../lib/elbencho-tpu-torch (= $(TORCH_LIBDIR) from
# /usr/bin); packaging/rpm-torch.spec.template runs the same expression
TORCH_LAUNCHER_SED := s|^pkgdir=\(.*\)/\.\."$$|pkgdir=\1/../lib/elbencho-tpu-torch"|

# the port's counterpart of `make core` plus package data: its engine, mock
# driver, copy probe and (where nvcc is found) kernel library, built by the
# port's own build functions and copied into $(TORCH_PREBUILT), which an installed
# port loads and never compiles into
torch:
	$(PYTHON) -m elbencho_tpu_torch.prebuild

# deb package of the port (the counterpart of `make deb`)
torch-deb: torch
	rm -rf $(TORCH_PKGROOT)
	mkdir -p $(TORCH_PKGROOT)/DEBIAN $(TORCH_PKGROOT)$(TORCH_LIBDIR) \
	  $(TORCH_PKGROOT)/usr/bin $(TORCH_PKGROOT)/usr/share/bash-completion/completions \
	  $(TORCH_PKGROOT)/usr/share/doc/elbencho-tpu-torch
	sed -e 's/__VERSION__/$(TORCH_VERSION)/' -e 's/^Architecture: .*/Architecture: $(DEB_ARCH)/' \
	  packaging/debian-torch/control > $(TORCH_PKGROOT)/DEBIAN/control
	cp -r elbencho_tpu_torch $(TORCH_PKGROOT)$(TORCH_LIBDIR)/
	find $(TORCH_PKGROOT)$(TORCH_LIBDIR) -name __pycache__ -type d -exec rm -rf {} +
	for l in elbencho-tpu-torch elbencho-tpu-torch-chart; do \
	  grep -q '^pkgdir=.*/\.\."$$' bin/$$l || { echo "bin/$$l: no pkgdir line"; exit 1; }; \
	  sed '$(TORCH_LAUNCHER_SED)' bin/$$l > $(TORCH_PKGROOT)/usr/bin/$$l; \
	  chmod 755 $(TORCH_PKGROOT)/usr/bin/$$l; \
	done
	install -m 644 dist/bash_completion.d/elbencho-tpu-torch \
	  dist/bash_completion.d/elbencho-tpu-torch-chart \
	  $(TORCH_PKGROOT)/usr/share/bash-completion/completions/
	install -m 644 LICENSE CHANGELOG.md \
	  $(TORCH_PKGROOT)/usr/share/doc/elbencho-tpu-torch/
	dpkg-deb --build --root-owner-group $(TORCH_PKGROOT) \
	  build/elbencho-tpu-torch_$(TORCH_VERSION)_$(DEB_ARCH).deb

# rpm spec of the port (the counterpart of `make rpm`): rendered into
# build/elbencho-tpu-torch.spec for rpmbuild
torch-rpm:
	@mkdir -p build
	sed 's/__VERSION__/$(TORCH_VERSION)/' packaging/rpm-torch.spec.template \
	  > build/elbencho-tpu-torch.spec

# the examples harness's distributed tiers under the port's TSAN engine and
# mock driver (the counterpart of test-examples-dist-tsan)
torch-test-examples-dist-tsan:
	$(PYTHON) tools/torch_test_tsan.py --examples-dist

clean:
	rm -rf $(CORE_LIB) $(MOCK_LIB) elbencho_tpu/libebtcore_tsan.so \
	  elbencho_tpu/libebtcore_asan.so elbencho_tpu/libebtcore_ubsan.so build \
	  $(TORCH_PREBUILT)

help:
	@echo "Targets: core (default), debug, tsan, asan, ubsan, test, test-d2h," \
	      "test-lanes, test-stripe, test-checkpoint, test-uring, test-load," \
	      "test-faults, test-ingest, test-reactor, test-reshard," \
	      "test-serving, test-tsan, test-asan," \
	      "test-ubsan, check, check-tsa," \
	      "audit, lint, tidy, deb, rpm, clean;" \
	      "the port: torch, torch-deb, torch-rpm," \
	      "torch-test-examples-dist-tsan"
