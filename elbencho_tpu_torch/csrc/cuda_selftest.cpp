/* Native selftest of the port's CUDA transfer engine: CudaPath
 * (csrc/cuda_path.h) over a CUDA driver, the storage engine (ebt/engine.h)
 * with CudaPath as its DevCopyFn, and the four kernels' C entries, driven
 * from an instrumented C++ main. It is the port's counterpart of the
 * original package's core/test/native_selftest.cpp and its sanitizer
 * matrix (make tsan / test-asan / test-ubsan and the per-ledger gates),
 * written anew against the port's API with the original's checks.
 *
 *   cuda_selftest DRIVER_SO KERNEL_LIB [SCOPE]
 *
 * DRIVER_SO is the mock driver (build/torch_core/libebtcudamock.so, whose
 * own C entries serve as KERNEL_LIB) or libcuda.so.1 with the nvcc-built
 * kernel library. SCOPE is one of path regwindow d2h lanes stripe ckpt
 * serving reshard ingest faults reactor xfermgr kernels, or all (the
 * default). Lanes: on the mock, four mock devices (EBT_MOCK_CUDA_DEVICES=4,
 * set here); on a card, four lanes of device 0 (as --gpuids 0,0,0,0).
 * Every failed CHECK prints "FAIL: what (file:line)" and makes the exit
 * code 1; the last line is "cuda selftest: all checks passed" otherwise.
 * A check that needs the mock (a fault seam, the mock's counters) is not
 * run on a card: its block prints "needs the mock: ..." with its count.
 * Knobs (EBT_MOCK_CUDA_*, EBT_PJRT_*, EBT_D2D_DISABLE) are set only while
 * no CudaPath exists: the mock reads them with getenv from its stream
 * threads, and a setenv beside them would be a race of the test's making.
 * The python driver is elbencho_tpu_torch/selftest.py.
 *
 * Parity with the original's CudaPath-relevant functions
 * (core/test/native_selftest.cpp), check by check:
 *   testPjrtPath :94-167 -> scope path. h2d + barrier, round trip + d2h
 *     content, from-hbm bytes, late enableVerify refused (sealed),
 *     dmaSupported, register -> zero-copy count moves -> deregister,
 *     unregistered source stays staged, raw zero-copy ceiling > 0,
 *     re-register left to the teardown, enableVerify on a fresh path,
 *     verify pass, corruption rc 2 at "file offset 777": all ported. Added:
 *     to-hbm bytes, the raw D2H ceiling, the ceilings' register/unregister
 *     balance and the teardown's (mock registration gauge), no leaked
 *     device buffer, enableWriteGen with the fill kernel's pattern checked,
 *     a clean odd-length verified block, and B1/B3 launch counts.
 *     "mock device count == 1" becomes numDevices() == 1 of a one-lane path.
 *   testRegWindowLocking :169-213 -> scope regwindow, under
 *     EBT_MOCK_CUDA_UNREGISTER_US and a 1 ms copy latency, with a budget of
 *     2 windows (the original: 4) so evictions meet windows under in-flight
 *     copies. All four checks ported (no transfer error, hits + misses ==
 *     registrations, 0 pinned, peak within budget). Added: no transfer
 *     error latched (a copy from a window unpinned under it faults the
 *     mock's stream, as CUDA error 719 does on a card).
 *   testRegWindowOverlapGuard :1257-1287 -> scope regwindow. All eight
 *     checks ported.
 *   testDeferredD2HLocking :215-265 -> scope d2h. All three checks ported;
 *     awaitD2H is direction 7 on the port. Added: every fetched block equals
 *     the bytes the device holds (the rotating sources, and with
 *     enableWriteGen the fill kernel's pattern).
 *   testLaneContention :267-372 -> scope lanes, 4 workers over 4 lanes
 *     (the original: 2 devices). All checks ported (lane count, sharded,
 *     byte totals, per-lane sums, submits, awaits, out-of-range lane, the
 *     EBT_PJRT_SINGLE_LANE control). Added: each lane's latency samples
 *     equal its copies.
 *   testStripeScatterGather :374-549 -> scope stripe. All checks ported;
 *     the draining-hold race (mock delay) and the per-device fault
 *     (EBT_MOCK_CUDA_DEV_FAIL_AT, the original's EBT_MOCK_STRIPE_FAIL_AT)
 *     need the mock. The fault's cause names "device 2 unit 2".
 *   testCkptRestore :551-679 -> scope ckpt. All checks ported; the fault
 *     half needs the mock.
 *   testServingRotationHammer :681-808 -> scope serving. All checks ported
 *     but one: the original's "teardown released every retained buffer"
 *     (rotationState[5] == 0 after drainAll) has no counterpart, because the
 *     port frees a generation's memory in its destructor, not in drainAll;
 *     the mock's live-buffer gauge after the destructor checks the same
 *     thing (needs the mock). Added: the active generation's bytes read back
 *     (rotationRead) and the lane bucket's throttle time.
 *   testReshardHammer :810-987 -> scope reshard. All checks ported; the
 *     in-flight failure round (EBT_MOCK_CUDA_D2D_FAIL_AT) needs the mock.
 *   testIngestHammer :989-1108 -> scope ingest. All checks ported; the
 *     fault half needs the mock.
 *   testFaultEjectReplan :1110-1255 -> scope faults. All checks ported (the
 *     injected hammer and the interrupt wait need the mock). Added: the
 *     mock's byte count and checksum exact through the fault, each block
 *     landed once, under the hammer and in the interleaving that counted a
 *     block twice, forced by EBT_MOCK_CUDA_HOSTFUNC_DELAY_US (a completion
 *     queued behind another worker's faulting copy on the same stream), and
 *     a forced ejection mid-run that runs on a card too, with its replanned
 *     units and lane bytes exact.
 *   testReactorHammer :1554-1668 -> scope reactor. All checks ported, with
 *     CudaPath::copyTrampoline as the engine's dev_copy over 4 lanes.
 * Not in the original: scope xfermgr (the transfer-manager tier: blocks
 * counted, one latency sample per block, nothing held after teardown) and
 * scope kernels (the four C entries against plain host loops, tails,
 * misaligned starts, planted corruption at exact offsets, and four threads,
 * each with its own stream and workspace, keeping 16 verify launches in
 * flight; on the card only: on the mock it prints "needs the card").
 * Not ported: testEngine :56-92, testUringRegistration and
 * testUringRegHammer :1300-1429, and testOpenLoopLoad :1439-1534. They test
 * only core/src, the original's selftest covers that same source, and no
 * one edits it; they would add nothing that CudaPath runs.
 */
#include <dlfcn.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "cuda_api.h"
#include "cuda_path.h"
#include "ebt/engine.h"
#include "ebt/rand.h"

using namespace ebt;

namespace {

std::atomic<int> g_failures{0};
std::atomic<int> g_checks{0};
int g_need_mock = 0;

#define CHECK(cond, what)                                            \
  do {                                                               \
    g_checks++;                                                      \
    if (!(cond)) {                                                   \
      std::fprintf(stderr, "FAIL: %s (%s:%d)\n", std::string(what).c_str(), \
                   __FILE__, __LINE__);                              \
      g_failures++;                                                  \
    }                                                                \
  } while (0)

using Clock = std::chrono::steady_clock;
constexpr uint64_t kKiB = 1024;
constexpr uint64_t kMiB = 1024 * 1024;

struct Target {
  std::string driver;
  std::string kernels;
  bool mock = false;
  void* mock_h = nullptr;
  std::string dir;  // scratch files of the reactor scope
  // four lanes: four mock devices, or four lanes of a card's device 0
  std::vector<int> four() const {
    return mock ? std::vector<int>{0, 1, 2, 3} : std::vector<int>{0, 0, 0, 0};
  }
};
Target g;

template <typename Fn>
Fn mockFn(const char* name) {
  return g.mock_h ? reinterpret_cast<Fn>(dlsym(g.mock_h, name)) : nullptr;
}
uint64_t mockU64(const char* name) {
  auto fn = mockFn<uint64_t (*)()>(name);
  return fn ? fn() : 0;
}
int64_t mockLiveBuffers() {
  auto fn = mockFn<int64_t (*)()>("ebt_mock_live_buffers");
  return fn ? fn() : 0;
}
void mockReset() {
  if (auto fn = mockFn<void (*)()>("ebt_mock_reset")) fn();
}

// true (and the block's checks counted as not run) on a card
bool needsMock(int nchecks, const char* what) {
  if (g.mock) return false;
  std::printf("needs the mock: %s (%d checks)\n", what, nchecks);
  g_need_mock += nchecks;
  return true;
}

// knobs for the lifetime of a block; declare before the block's CudaPath,
// which is then destroyed first
class Knobs {
 public:
  Knobs(std::initializer_list<std::pair<const char*, const char*>> kv) {
    for (const auto& [k, v] : kv) {
      setenv(k, v, 1);
      names_.push_back(k);
    }
  }
  ~Knobs() {
    for (const char* n : names_) unsetenv(n);
  }
  Knobs(const Knobs&) = delete;
  Knobs& operator=(const Knobs&) = delete;

 private:
  std::vector<const char*> names_;
};

// page-aligned host memory (windows are pinned per page)
class HostBuf {
 public:
  explicit HostBuf(size_t n, int fill = 0) : n_(n) {
    if (posix_memalign(&p_, 4096, n ? n : 1)) p_ = nullptr;
    if (p_) std::memset(p_, fill, n);
  }
  ~HostBuf() { std::free(p_); }
  HostBuf(const HostBuf&) = delete;
  HostBuf& operator=(const HostBuf&) = delete;
  char* data() const { return (char*)p_; }
  size_t size() const { return n_; }

 private:
  void* p_ = nullptr;
  size_t n_;
};

// a one-shot gate the hammer threads wait at
class Latch {
 public:
  explicit Latch(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lk(m_);
    cv_.wait(lk, [this] { return n_ <= 0; });
  }
  void arrive() {
    std::lock_guard<std::mutex> lk(m_);
    if (--n_ <= 0) cv_.notify_all();
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  int n_;
};

template <typename Fn>
void hammer(int n, Fn&& fn) {
  std::vector<std::thread> ts;
  for (int t = 0; t < n; t++) ts.emplace_back([&fn, t] { fn(t); });
  for (auto& th : ts) th.join();
}

uint64_t laneSamples(const CudaPath& path, int lane) {
  LatencyHistogram h;
  return path.deviceLatency(lane, &h) ? h.count() : 0;
}

std::string okText(const CudaPath& path) {
  return "path init: " + (path.ok() ? std::string("ok") : path.error());
}

// ------------------------------------------------------------------ path

void scopePath() {
  HostBuf buf(kMiB), out(kMiB);
  const uint64_t hostreg0 = mockU64("ebt_mock_hostreg_active");
  const int64_t live0 = mockLiveBuffers();
  {
    CudaPath path(g.driver, kMiB, kMiB, false, {0});
    CHECK(path.ok(), okText(path));
    CHECK(path.numDevices() == 1, "one lane");
    fillVerifyPattern(buf.data(), buf.size(), 0, 99);

    // deferred h2d + barrier
    CHECK(path.copy(0, 0, /*h2d*/ 0, buf.data(), buf.size(), 0) == 0, "h2d");
    CHECK(path.copy(0, 0, /*barrier*/ 2, buf.data(), 0, 0) == 0, "barrier");
    // write leg: the round trip's bytes come back by direction 1
    CHECK(path.copy(0, 0, /*round trip*/ 3, buf.data(), buf.size(), 0) == 0,
          "round-trip h2d");
    CHECK(path.copy(0, 0, /*d2h*/ 1, out.data(), out.size(), 0) == 0, "d2h");
    CHECK(std::memcmp(buf.data(), out.data(), buf.size()) == 0,
          "round-trip content");
    uint64_t to = 0, from = 0;
    path.stats(&to, &from);
    CHECK(from == kMiB, "from-hbm stats");
    CHECK(to == 2 * kMiB, "to-hbm stats (h2d + round trip)");

    // the kernel entries are read lock-free on the hot path: enabling them
    // after the first transfer is refused (the sealed path)
    CHECK(!path.enableVerify(99, g.kernels).empty(),
          "late enableVerify rejected");
    CHECK(!path.enableWriteGen(99, g.kernels).empty(),
          "late enableWriteGen rejected");

    // registered tier: register -> zero-copy submit -> barrier -> deregister
    CHECK(path.dmaSupported(), "driver supports cuMemHostRegister");
    CHECK(path.registerBuffer(buf.data(), buf.size()) == 0, "register");
    const uint64_t zc_before = path.zeroCopyCount();
    CHECK(path.copy(0, 0, 0, buf.data(), buf.size(), 0) == 0,
          "zero-copy h2d");
    CHECK(path.copy(0, 0, 2, buf.data(), 0, 0) == 0, "zero-copy barrier");
    CHECK(path.zeroCopyCount() > zc_before, "zero-copy submission counted");
    CHECK(path.deregisterBuffer(buf.data()) == 0, "deregister");
    const uint64_t zc_after = path.zeroCopyCount();
    CHECK(path.copy(0, 0, 0, buf.data(), buf.size(), 0) == 0,
          "staged again");
    CHECK(path.copy(0, 0, 2, buf.data(), 0, 0) == 0, "staged barrier");
    CHECK(path.zeroCopyCount() == zc_after, "unregistered stays staged");

    // the raw ceilings: sources pinned before the clock, unpinned after,
    // and no path counter moves
    const uint64_t reg_before = mockU64("ebt_mock_hostreg_active");
    path.stats(&to, &from);
    CHECK(path.rawH2DCeiling(2 * kMiB, 2, 0, kMiB, /*zero copy*/ 1) > 0,
          "raw zero-copy ceiling: " + path.rawError());
    CHECK(path.rawD2HCeiling(2 * kMiB, 2, 0, kMiB) > 0,
          "raw d2h ceiling: " + path.rawError());
    uint64_t to2 = 0, from2 = 0;
    path.stats(&to2, &from2);
    CHECK(to2 == to && from2 == from, "the ceilings move no path counter");
    if (!needsMock(1, "the ceilings' register/unregister balance"))
      CHECK(mockU64("ebt_mock_hostreg_active") == reg_before,
            "the ceilings unregister every source they pinned");
    // the destructor deregisters what is left
    CHECK(path.registerBuffer(buf.data(), buf.size()) == 0,
          "re-register for the teardown");
  }
  if (!needsMock(2, "the teardown's registration and allocation balance")) {
    CHECK(mockU64("ebt_mock_hostreg_active") == hostreg0,
          "teardown deregistered every range");
    CHECK(mockLiveBuffers() == live0, "no leaked device buffer");
  }

  // the kernels launched from C++, on a fresh path (enabled before the
  // first data copy, as preparation does)
  uint64_t k0[2];
  CudaPath::kernelLaunches(k0);
  {
    CudaPath vpath(g.driver, kMiB, kMiB, false, {0});
    CHECK(vpath.ok(), okText(vpath));
    CHECK(vpath.enableVerify(99, g.kernels).empty(), "enableVerify");
    CHECK(vpath.enableWriteGen(99, g.kernels).empty(), "enableWriteGen");
    // B3: a verified write's source is generated on the device
    std::memset(out.data(), 0, out.size());
    CHECK(vpath.copy(0, 0, /*d2h*/ 1, out.data(), out.size(), 8 * kMiB) == 0,
          "generated d2h");
    CHECK(checkVerifyPattern(out.data(), out.size(), 8 * kMiB, 99) ==
              UINT64_MAX,
          "the fill kernel wrote the offset+salt pattern");
    // B1: the block is checked on the device
    fillVerifyPattern(buf.data(), buf.size(), 0, 99);
    CHECK(vpath.copy(0, 0, /*h2d*/ 0, buf.data(), buf.size(), 0) == 0,
          "device verify pass");
    // an odd-length block: the kernel takes the words, the host the tail
    const uint64_t odd = kMiB / 2 + 5;
    fillVerifyPattern(buf.data(), odd, 3 * kMiB, 99);
    CHECK(vpath.copy(0, 0, 0, buf.data(), odd, 3 * kMiB) == 0,
          "device verify pass with a sub-word tail");
    fillVerifyPattern(buf.data(), buf.size(), 0, 99);
    buf.data()[777] ^= 0x55;
    CHECK(vpath.copy(0, 0, 0, buf.data(), buf.size(), 0) == 2,
          "device verify catches corruption");
    CHECK(vpath.firstTransferError().find("file offset 777") !=
              std::string::npos,
          "exact corrupt offset: " + vpath.firstTransferError());
  }
  uint64_t k1[2];
  CudaPath::kernelLaunches(k1);
  CHECK(k1[0] - k0[0] == 3, "verify kernel launched once per block");
  CHECK(k1[1] - k0[1] == 1, "fill kernel launched once per block");
  std::printf("path: kernel launches from C++: verify_u32 %llu fill_u64 "
              "%llu\n",
              (unsigned long long)(k1[0] - k0[0]),
              (unsigned long long)(k1[1] - k0[1]));
}

// ------------------------------------------------------------- regwindow

void scopeRegWindow() {
  // the --regwindow LRU pin cache hit from 4 threads: registration ahead of
  // the cursor, eviction scans over other threads' windows, ranged unpins,
  // with each unpin taking time in the driver (the mock's seam), so copies
  // riding a window race its eviction
  {
    Knobs knobs{{"EBT_MOCK_CUDA_UNREGISTER_US", "200"},
                {"EBT_MOCK_CUDA_DELAY_US", "1000"}};
    CudaPath path(g.driver, 64 * kKiB, 64 * kKiB, false, {0});
    CHECK(path.ok(), okText(path));
    CHECK(path.dmaSupported(), "driver supports cuMemHostRegister");
    // at most 2 x 64 KiB windows for 4 threads whose copies each stay in
    // flight for a millisecond: eviction scans meet windows under copies
    path.setRegWindow(128 * kKiB);

    constexpr int kThreads = 4;
    constexpr int kIters = 200;
    constexpr uint64_t kWin = 64 * kKiB;
    std::vector<std::unique_ptr<HostBuf>> bufs;
    for (int t = 0; t < kThreads; t++)
      bufs.push_back(std::make_unique<HostBuf>(kMiB, 'x'));
    std::atomic<int> errors{0};
    hammer(kThreads, [&](int t) {
      char* base = bufs[t]->data();
      for (int i = 0; i < kIters; i++) {
        const uint64_t off = (uint64_t)(i % 16) * kWin;
        char* w = base + off;
        if (path.registerWindow(w, kWin) == 0) {
          if (path.copy(t, 0, /*h2d*/ 0, w, kWin, off) != 0) errors++;
          if (path.copy(t, 0, /*barrier*/ 2, w, 0, 0) != 0) errors++;
        }
        // a ranged unpin of this thread's own quiescent windows races the
        // other threads' eviction scans
        if (i % 32 == 31) path.deregisterRange(base, kMiB);
      }
      path.deregisterRange(base, kMiB);
    });
    CHECK(errors.load() == 0, "transfers from cached windows");
    CHECK(path.firstTransferError().empty(),
          "no copy ran from a window unpinned under it: " +
              path.firstTransferError());
    const CudaPath::RegCacheStats st = path.regCacheStats();
    CHECK(st.hits + st.misses == (uint64_t)kThreads * kIters,
          "every registration counted as hit or miss");
    CHECK(st.pinned_bytes == 0, "all windows unpinned");
    CHECK(st.pinned_peak_bytes <= 128 * kKiB + 4096, "budget respected");
  }
  // an overlapping-but-not-covered request stays staged: registering it
  // would double-pin live memory
  {
    CudaPath path(g.driver, 64 * kKiB, 64 * kKiB, false, {0});
    CHECK(path.ok(), okText(path));
    CHECK(path.dmaSupported(), "driver supports cuMemHostRegister");
    const CudaPath::RegCacheStats st0 = path.regCacheStats();
    HostBuf buf(kMiB, 'x');
    CHECK(path.registerWindow(buf.data(), 256 * kKiB) == 0, "initial window");
    CHECK(path.registerWindow(buf.data(), 512 * kKiB) == 1,
          "same-base larger-length request refused");
    CHECK(path.regError().find("overlaps a live registration") !=
              std::string::npos,
          "refusal records its cause");
    CHECK(path.registerWindow(buf.data() + 128 * kKiB, 256 * kKiB) == 1,
          "partially-overlapping request refused");
    CudaPath::RegCacheStats st = path.regCacheStats();
    CHECK(st.pinned_bytes - st0.pinned_bytes == 256 * kKiB,
          "budget untouched by refused requests");
    CHECK(st.staged_fallbacks - st0.staged_fallbacks == 2,
          "refusals counted as staged fallbacks");
    CHECK(path.registerWindow(buf.data(), 64 * kKiB) == 0,
          "covered request still hits");
    path.deregisterRange(buf.data(), buf.size());
    st = path.regCacheStats();
    CHECK(st.pinned_bytes == st0.pinned_bytes, "window unpinned");
  }
}

// ------------------------------------------------------------------- d2h

// the block a rank's rotating device sources serve (CudaPath::deviceSource:
// one chunk-sized source per variant, rank-seeded random content)
std::vector<char> rotatingSources(int rank, uint64_t chunk, uint64_t len) {
  std::vector<char> out(len);
  for (uint64_t off = 0, i = 0; off < len; off += chunk, i++) {
    const uint64_t n = std::min(chunk, len - off);
    RandAlgoXoshiro rng(0x9E3779B97F4A7C15ULL ^ (uint64_t)(rank + 1) ^
                        ((uint64_t)(i % 4 + 1) << 32));
    rng.fillBuf(out.data() + off, n);
  }
  return out;
}

void scopeD2H() {
  // the deferred D2H engine's pending queues and draining ledger hit from
  // 4 threads, with the mock's copies landing late: every fetch is
  // deferred, the two barrier flavors (direction 2 and the pre-write
  // direction 7) alternate, and each block must hold the device's bytes
  // once its barrier returns
  constexpr int kThreads = 4;
  constexpr int kIters = 32;
  constexpr uint64_t kBlock = 256 * kKiB;
  constexpr uint64_t kChunk = 64 * kKiB;
  for (int gen = 0; gen < 2; gen++) {
    Knobs knobs{{"EBT_MOCK_CUDA_DELAY_US", "200"}};
    CudaPath path(g.driver, kChunk, kBlock, false, {0});
    CHECK(path.ok(), okText(path));
    if (gen) CHECK(path.enableWriteGen(7, g.kernels).empty(), "write gen");
    path.setD2HDepth(8);
    std::vector<std::unique_ptr<HostBuf>> bufs;
    std::vector<std::vector<char>> want;
    for (int t = 0; t < kThreads; t++) {
      bufs.push_back(std::make_unique<HostBuf>(kBlock));
      want.push_back(rotatingSources(t, kChunk, kBlock));
    }
    std::atomic<int> errors{0}, wrong{0};
    hammer(kThreads, [&](int t) {
      char* buf = bufs[t]->data();
      for (int i = 0; i < kIters; i++) {
        const uint64_t off = (uint64_t)i * kBlock;
        if (path.copy(t, 0, /*d2h*/ 1, buf, kBlock, off) != 0) errors++;
        if (i % 4 == 3) {
          if (path.copy(t, 0, /*barrier*/ 2, buf, 0, 0) != 0) errors++;
        } else {
          if (path.copy(t, 0, /*pre-write barrier*/ 7, buf, 0, 0) != 0)
            errors++;
        }
        const bool same =
            gen ? checkVerifyPattern(buf, kBlock, off, 7) == UINT64_MAX
                : std::memcmp(buf, want[t].data(), kBlock) == 0;
        if (!same) wrong++;
      }
    });
    const char* what = gen ? " (fill kernel)" : " (rotating sources)";
    CHECK(errors.load() == 0,
          std::string("deferred d2h submits/awaits") + what);
    CHECK(wrong.load() == 0,
          std::string("every block back holds the device's bytes") + what);
    uint64_t st[3];
    path.d2hStats(st);
    CHECK(st[0] == (uint64_t)kThreads * kIters,
          std::string("every block rode the deferred engine") + what);
    uint64_t to = 0, from = 0;
    path.stats(&to, &from);
    CHECK(from == (uint64_t)kThreads * kIters * kBlock,
          std::string("deferred d2h bytes accounted") + what);
  }
}

// ----------------------------------------------------------------- lanes

void scopeLanes() {
  // the per-lane structure (lanes, queue shards, the registration lock)
  // from 4 workers over 4 lanes under per-copy service time: window
  // register/evict/unpin, submits, deferred fetches, both barriers. The
  // per-lane sums must equal the global totals exactly.
  constexpr int kThreads = 4;
  constexpr int kIters = 48;
  constexpr uint64_t kBlk = 64 * kKiB;
  {
    Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "30"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.numDevices() == 4, "four lanes");
    CHECK(!path.singleLane(), "sharded by default");
    path.setRegWindow(256 * kKiB);  // small budget: eviction churn races
    path.setD2HDepth(4);            // deferred d2h engine engaged
    std::vector<std::unique_ptr<HostBuf>> rd, wr;
    for (int t = 0; t < kThreads; t++) {
      rd.push_back(std::make_unique<HostBuf>(kMiB, 'r'));
      wr.push_back(std::make_unique<HostBuf>(kBlk));
    }
    std::atomic<int> errors{0};
    hammer(kThreads, [&](int t) {
      char* rbase = rd[t]->data();
      char* wbuf = wr[t]->data();
      for (int i = 0; i < kIters; i++) {
        const uint64_t off = (uint64_t)(i % 16) * kBlk;
        char* w = rbase + off;
        // hit, miss, eviction of another thread's window or a staged
        // fallback under budget pressure: all legal
        path.registerWindow(w, kBlk);
        if (path.copy(t, t, /*h2d*/ 0, w, kBlk, off) != 0) errors++;
        if (path.copy(t, t, /*barrier*/ 2, w, 0, 0) != 0) errors++;
        if (path.copy(t, t, /*d2h*/ 1, wbuf, kBlk, off) != 0) errors++;
        if (i % 4 == 3) {
          if (path.copy(t, t, 2, wbuf, 0, 0) != 0) errors++;
        } else {
          if (path.copy(t, t, /*pre-write*/ 7, wbuf, 0, 0) != 0) errors++;
        }
        if (i % 16 == 15) path.deregisterRange(rbase, kMiB);
      }
      path.deregisterRange(rbase, kMiB);
    });
    CHECK(errors.load() == 0, "lane-contention transfers");
    uint64_t to = 0, from = 0;
    path.stats(&to, &from);
    CHECK(to == (uint64_t)kThreads * kIters * kBlk, "h2d bytes complete");
    CHECK(from == (uint64_t)kThreads * kIters * kBlk, "d2h bytes complete");
    uint64_t lane_to = 0, lane_from = 0, submits = 0, awaits = 0;
    for (int l = 0; l < path.numDevices(); l++) {
      CudaPath::LaneStats ls;
      CHECK(path.laneStats(l, &ls), "laneStats in range");
      CHECK(ls.submits > 0, "every lane saw traffic");
      // one sample per copy: each worker's 48 blocks each way on its lane
      CHECK(laneSamples(path, l) == 2 * (uint64_t)kIters,
            "latency samples per lane equal its copies");
      lane_to += ls.bytes_to_hbm;
      lane_from += ls.bytes_from_hbm;
      submits += ls.submits;
      awaits += ls.awaits;
    }
    CHECK(lane_to == to, "per-lane h2d byte sums equal the global total");
    CHECK(lane_from == from, "per-lane d2h byte sums equal the global total");
    CHECK(submits == (uint64_t)kThreads * kIters * 2,
          "every data-moving submit counted in exactly one lane");
    CHECK(awaits > 0, "barrier settles counted");
    CudaPath::LaneStats oob;
    CHECK(!path.laneStats(4, &oob), "out-of-range lane rejected");
  }
  // the A/B control: one queue shard moves byte-identical traffic
  {
    Knobs knobs{{"EBT_PJRT_SINGLE_LANE", "1"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.singleLane(), "single-lane control engaged");
    HostBuf buf(kBlk, 'x');
    CHECK(path.copy(0, 1, 0, buf.data(), kBlk, 0) == 0, "single-lane h2d");
    CHECK(path.copy(0, 1, 2, buf.data(), 0, 0) == 0, "single-lane barrier");
    uint64_t to = 0, from = 0;
    path.stats(&to, &from);
    CHECK(to == kBlk, "single-lane bytes identical");
    CudaPath::LaneStats ls;
    CHECK(path.laneStats(1, &ls) && ls.bytes_to_hbm == kBlk,
          "lane accounting intact under the single-lane control");
  }
}

// ---------------------------------------------------------------- stripe

void scopeStripe() {
  // the striped fill from 4 workers over 4 lanes: the planner routes each
  // block round-robin, direction-2 reuse barriers and the direction-8
  // gather settle them concurrently; units awaited == submitted and the
  // per-lane sums must reconcile exactly
  constexpr int kThreads = 4;
  constexpr int kSlots = 16;
  constexpr uint64_t kBlk = 64 * kKiB;
  {
    Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "20"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.numDevices() == 4, "four lanes");
    const uint64_t total_blocks = (uint64_t)kThreads * kSlots * 2;
    CHECK(path.setStripePlan(/*rr*/ 1, total_blocks, 1) == 0,
          "stripe plan installed");
    CHECK(path.stripeDeviceFor(0) == 0, "unit 0 -> lane 0");
    CHECK(path.stripeDeviceFor(5 * kBlk) == 1, "unit 5 -> lane 1");
    CHECK(path.stripeDeviceFor((total_blocks - 1) * kBlk) ==
              (int)((total_blocks - 1) % 4),
          "tail unit placement");
    std::vector<std::unique_ptr<HostBuf>> bufs;
    for (int t = 0; t < kThreads; t++)
      bufs.push_back(std::make_unique<HostBuf>(kSlots * kBlk, 's'));
    std::atomic<int> errors{0};
    for (int round = 0; round < 2; round++) {
      // round 1 runs a concurrent gather beside the workers' submits and
      // reuse barriers: no unit may be lost or counted twice
      std::thread gatherer;
      if (round == 1)
        gatherer = std::thread([&] {
          if (path.copy(0, 0, /*gather*/ 8, nullptr, 0, 0) != 0) errors++;
        });
      hammer(kThreads, [&](int t) {
        char* base = bufs[t]->data();
        for (int i = 0; i < kSlots; i++) {
          const uint64_t gblock = (uint64_t)round * kThreads * kSlots +
                                  (uint64_t)t * kSlots + (uint64_t)i;
          if (path.copy(t, t, 0, base + i * kBlk, kBlk, gblock * kBlk) != 0)
            errors++;
          if (round == 1 && i % 4 == 3 &&
              path.copy(t, t, 2, base + i * kBlk, 0, 0) != 0)
            errors++;
        }
      });
      if (gatherer.joinable()) gatherer.join();
      CHECK(path.copy(0, 0, 8, nullptr, 0, 0) == 0, "gather barrier");
    }
    CHECK(errors.load() == 0, "striped submits/barriers");
    const CudaPath::StripeStats st = path.stripeStats();
    CHECK(st.units_submitted == total_blocks, "every block planner-routed");
    CHECK(st.units_awaited == st.units_submitted,
          "units awaited reconcile with units submitted");
    CHECK(st.barriers == 3, "end-of-round gathers + the concurrent one");
    CHECK(path.stripeError().empty(), "no stripe failure");
    uint64_t to = 0, from = 0;
    path.stats(&to, &from);
    CHECK(to == total_blocks * kBlk, "all striped bytes resident");
    uint64_t lane_to = 0;
    for (int l = 0; l < path.numDevices(); l++) {
      CudaPath::LaneStats ls;
      CHECK(path.laneStats(l, &ls), "laneStats in range");
      CHECK(ls.bytes_to_hbm == total_blocks * kBlk / 4,
            "round-robin lane balance");
      lane_to += ls.bytes_to_hbm;
    }
    CHECK(lane_to == to, "per-lane stripe byte sums equal the global total");
  }
  // the reuse-barrier-vs-gather race, deterministically: a late copy still
  // reading buf is swept out of pending by a gather on another thread; the
  // owner's direction-2 barrier must block until that settle
  if (!needsMock(5, "the draining-hold race (EBT_MOCK_CUDA_DELAY_US)")) {
    Knobs knobs{{"EBT_MOCK_CUDA_DELAY_US", "200000"}};
    CudaPath path(g.driver, kBlk, kBlk, false, {0});
    CHECK(path.ok(), okText(path));
    CHECK(path.setStripePlan(1, 4, 1) == 0, "race-test plan");
    HostBuf buf(kBlk, 'A');
    CHECK(path.copy(0, 0, 0, buf.data(), kBlk, 0) == 0, "delayed submit");
    std::thread gatherer([&] { path.copy(0, 0, 8, nullptr, 0, 0); });
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    const auto t0 = Clock::now();
    CHECK(path.copy(0, 0, 2, buf.data(), 0, 0) == 0,
          "reuse barrier during gather");
    const auto waited = std::chrono::duration_cast<std::chrono::milliseconds>(
                            Clock::now() - t0)
                            .count();
    gatherer.join();
    CHECK(waited > 100, "reuse barrier waited out the gather's draining hold");
  }
  // per-device in-flight fault: lane 2's 2nd copy (the warm-up is its 1st)
  // fails on its stream; the gather names device and unit, and the clean
  // lanes' units still settle. The fault is sticky for the stream, as on a
  // card, so only six blocks go out: unit 2 is the one on lane 2
  if (!needsMock(5, "the per-device fault (EBT_MOCK_CUDA_DEV_FAIL_AT)")) {
    mockReset();
    Knobs knobs{{"EBT_MOCK_CUDA_DEV_FAIL_AT", "2:2"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.setStripePlan(1, 8, 1) == 0, "fault-injection plan");
    HostBuf buf(8 * kBlk, 'f');
    int submit_rc = 0;
    for (int i = 0; i < 6; i++)
      submit_rc |= path.copy(0, 0, 0, buf.data() + i * kBlk, kBlk, i * kBlk);
    const int brc = path.copy(0, 0, 8, nullptr, 0, 0);
    CHECK(submit_rc != 0 || brc != 0, "injected failure surfaces");
    CHECK(path.stripeError().find("device 2 unit 2") != std::string::npos,
          "gather names the failing device and unit: " + path.stripeError());
    const CudaPath::StripeStats st = path.stripeStats();
    CHECK(st.units_awaited == st.units_submitted,
          "failed units still settle (no leak)");
  }
}

// ------------------------------------------------------------------ ckpt

void scopeCkpt() {
  // the restore ledger from 4 workers over 4 lanes: shard begins (9),
  // submits to the manifest lane, reuse barriers, the all-resident seal
  // (10); per-shard and per-lane resident bytes must reconcile exactly
  constexpr uint64_t kBlk = 64 * kKiB;
  {
    Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "20"}};
    constexpr int kThreads = 4;
    constexpr int kShards = 8;  // 2 per thread, lanes s % 4
    constexpr uint64_t kBlocksPerShard = 4;
    constexpr uint64_t kShardBytes = kBlocksPerShard * kBlk;
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.numDevices() == 4, "four lanes");
    std::vector<int> shard, dev;
    std::vector<uint64_t> bytes;
    for (int s = 0; s < kShards; s++) {
      shard.push_back(s);
      dev.push_back(s % 4);
      bytes.push_back(kShardBytes);
    }
    CHECK(path.setCkptPlan(kShards, shard, dev, bytes) == 0,
          "ckpt plan installed");
    CHECK(path.ckptBeginShard(0, kShards) != 0, "out-of-range shard refused");
    // two restore sessions on one plan: the begins re-arm each shard
    for (int round = 0; round < 2; round++) {
      std::vector<std::unique_ptr<HostBuf>> bufs;
      for (int t = 0; t < kThreads; t++)
        bufs.push_back(std::make_unique<HostBuf>(kShardBytes, 'a' + round));
      std::atomic<int> errors{0};
      hammer(kThreads, [&](int t) {
        char* base = bufs[t]->data();
        for (int s = t; s < kShards; s += kThreads) {
          if (path.copy(t, s % 4, /*shard begin*/ 9, nullptr, s, 0) != 0)
            errors++;
          for (uint64_t b = 0; b < kBlocksPerShard; b++) {
            char* blk = base + b * kBlk;
            if (path.copy(t, s % 4, 0, blk, kBlk, b * kBlk) != 0) errors++;
            if (path.copy(t, s % 4, 2, blk, 0, 0) != 0) errors++;
          }
        }
        if (path.copy(t, 0, /*all resident*/ 10, nullptr, 0, 0) != 0)
          errors++;
      });
      CHECK(errors.load() == 0, "restore submits/barriers");
      const CudaPath::CkptStats st = path.ckptStats();
      CHECK(st.shards_total == kShards, "plan shard count");
      CHECK(st.shards_resident == kShards,
            "every shard resident after the all-resident barrier");
      uint64_t totals[2];
      path.ckptByteTotals(totals);
      CHECK(totals[0] == totals[1], "submitted == resident");
      CHECK(totals[1] == (uint64_t)kShards * kShardBytes,
            "resident bytes equal the manifest bytes");
      CHECK(path.ckptError().empty(), "no restore failure");
    }
    const std::vector<uint64_t> devb = path.ckptDevBytes();
    CHECK(devb.size() == 4, "one resident counter per lane");
    for (uint64_t v : devb)
      CHECK(v == 2 * 2 * kShardBytes, "per-lane resident balance");
  }
  // a restore transfer failing in flight: "device N shard S: cause", and
  // the failed shard is not resident while the clean ones settle
  if (!needsMock(6, "the per-device restore fault "
                   "(EBT_MOCK_CUDA_DEV_FAIL_AT)")) {
    mockReset();
    Knobs knobs{{"EBT_MOCK_CUDA_DEV_FAIL_AT", "2:2"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.setCkptPlan(4, {0, 1, 2, 3}, {0, 1, 2, 3},
                           std::vector<uint64_t>(4, kBlk)) == 0,
          "fault-injection plan");
    HostBuf buf(4 * kBlk, 'f');
    int rc = 0;
    for (int s = 0; s < 4; s++) {
      rc |= path.copy(0, s, 9, nullptr, s, 0);
      rc |= path.copy(0, s, 0, buf.data() + s * kBlk, kBlk, 0);
    }
    const int brc = path.copy(0, 0, 10, nullptr, 0, 0);
    CHECK(rc != 0 || brc != 0, "injected failure surfaces");
    CHECK(path.ckptError().find("device 2 shard 2") != std::string::npos,
          "restore failure carries device + shard: " + path.ckptError());
    CHECK(path.ckptStats().shards_resident == 3,
          "failed shard not counted resident");
    uint64_t totals[2];
    path.ckptByteTotals(totals);
    CHECK(totals[0] == 4 * kBlk && totals[1] == 3 * kBlk,
          "submitted/resident reconcile around the failure");
  }
}

// --------------------------------------------------------------- serving

void scopeServing() {
  // live model rotation at the device layer: 3 foreground threads submit
  // serving reads while this thread (the rotator, rank 9) runs full
  // rotation cycles, begin -> shard begins + background submits through
  // the lane bucket -> reuse barriers -> all-resident (10) -> swap, plus a
  // deliberately aborted last rotation that the teardown must clean up
  constexpr int kFgThreads = 3;
  constexpr int kShards = 4;
  constexpr uint64_t kBlk = 64 * kKiB;
  constexpr uint64_t kBlocksPerShard = 2;
  constexpr uint64_t kShardBytes = kBlocksPerShard * kBlk;
  constexpr int kRotations = 3;
  constexpr int kFgBlocks = 128;
  const int64_t live0 = mockLiveBuffers();
  {
    Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "20"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.numDevices() == 4, "four lanes");
    std::vector<int> shard, dev;
    std::vector<uint64_t> bytes;
    for (int s = 0; s < kShards; s++) {
      shard.push_back(s);
      dev.push_back(s % 4);
      bytes.push_back(kShardBytes);
    }
    CHECK(path.setCkptPlan(kShards, shard, dev, bytes) == 0,
          "ckpt plan installed");
    path.setBgBudget(64 * kMiB);
    CHECK(path.rotateSwap(99) != 0, "swap without a begun rotation refused");
    CHECK(path.rotateBegin(9, 0, 0) != 0, "generation 0 refused");

    std::atomic<int> errors{0};
    std::atomic<bool> stop{false};
    std::vector<std::unique_ptr<HostBuf>> fg_bufs;
    for (int t = 0; t < kFgThreads; t++)
      fg_bufs.push_back(std::make_unique<HostBuf>(kBlk, 'A' + t));
    std::vector<std::thread> fg;
    for (int t = 0; t < kFgThreads; t++) {
      fg.emplace_back([&, t] {
        char* buf = fg_bufs[t]->data();
        for (int b = 0; b < kFgBlocks && !stop.load(); b++) {
          if (path.copy(t, t % 4, 0, buf, kBlk, b * kBlk) != 0) errors++;
          if (path.copy(t, t % 4, 2, buf, 0, 0) != 0) errors++;
        }
      });
    }
    HostBuf rbuf(kShardBytes);
    for (int gen = 1; gen <= kRotations + 1; gen++) {
      std::memset(rbuf.data(), 'a' + gen, rbuf.size());
      CHECK(path.rotateBegin(9, gen, 32 * kMiB) == 0, "rotation begin");
      for (int s = 0; s < kShards; s++) {
        if (path.copy(9, s % 4, /*shard begin*/ 9, nullptr, s, 0) != 0)
          errors++;
        for (uint64_t b = 0; b < kBlocksPerShard; b++) {
          char* blk = rbuf.data() + b * kBlk;
          if (path.copy(9, s % 4, 0, blk, kBlk, b * kBlk) != 0) errors++;
          if (path.copy(9, s % 4, 2, blk, 0, 0) != 0) errors++;
        }
      }
      if (gen <= kRotations) {
        if (path.copy(9, 0, /*all resident*/ 10, nullptr, 0, 0) != 0)
          errors++;
        CHECK(path.rotateSwap(9) == 0, "rotation swap");
      }
    }
    stop = true;
    for (auto& th : fg) th.join();
    CHECK(errors.load() == 0, "hammer submits/barriers");
    CHECK(path.rotationCount() == kRotations, "one record per swap");
    uint64_t prev_retained = 0;
    for (int i = 0; i < kRotations; i++) {
      CudaPath::RotationRecord r;
      CHECK(path.rotationRecord(i, &r), "record readable");
      CHECK(r.generation == (uint64_t)(i + 1), "generation order");
      CHECK(r.shards_resident == r.shards_total, "shards reconcile");
      CHECK(r.bytes_submitted == r.bytes_resident, "bytes reconcile");
      CHECK(r.bytes_resident == (uint64_t)kShards * kShardBytes,
            "rotation bytes equal the manifest");
      CHECK(r.retained_buffers > 0, "double buffer retained");
      CHECK(r.released_buffers == prev_retained,
            "previous generation released at the swap");
      prev_retained = r.retained_buffers;
    }
    uint64_t st[6];
    path.rotationState(st);
    CHECK(st[0] == (uint64_t)kRotations, "published generation");
    CHECK(st[1] == 1, "aborted tail still marked restoring");
    CHECK(st[3] > 0, "the lane bucket throttled the background class");
    CHECK(st[4] >= (uint64_t)(kRotations + 1) * kShards * kShardBytes,
          "background bytes counted at the lanes");
    // the active generation holds the last swapped rotation's bytes
    HostBuf back(kShardBytes);
    bool same = true;
    for (int s = 0; s < kShards; s++) {
      std::memset(back.data(), 0, back.size());
      same = same && path.rotationRead(s, 0, 0, kShardBytes, back.data()) == 0;
      for (uint64_t i = 0; same && i < kShardBytes; i++)
        same = back.data()[i] == (char)('a' + kRotations);
    }
    CHECK(same, "the active generation reads back its rotation's bytes");
  }
  if (!needsMock(1, "the mock's live-buffer gauge"))
    CHECK(mockLiveBuffers() == live0,
          "no leaked device buffers after the rotation hammer (teardown "
          "freed both generations, the aborted one included)");
}

// --------------------------------------------------------------- reshard

void scopeReshard() {
  // the N->M reshard ledger + the device-to-device tier from 4 workers
  // over 4 lanes under per-pair service time. Three rounds on one 16-unit
  // plan (4 resident, 8 moves draining lanes 2/3 onto 0/1, 4 storage
  // reads): clean; one move failing in flight and recovered through the
  // bounce; EBT_D2D_DISABLE=1 (every move bounced). Each round:
  // submitted == resident == plan bytes and the pair matrix exact.
  constexpr int kThreads = 4;
  constexpr int kUnits = 16;
  constexpr uint64_t kBlk = 64 * kKiB;
  constexpr uint64_t kChunks = 2;
  constexpr uint64_t kUnitBytes = kChunks * kBlk;
  auto action_of = [](int u) { return u % 2 ? 1 : (u % 4 == 0 ? 0 : 2); };
  auto dst_of = [](int u) {
    return u % 2 ? (u < kUnits / 2 ? 0 : 1) : (u / 4) % 2;
  };
  for (int round = 0; round < 3; round++) {
    // the checks of one round: 18 common, 2 of the round, 17 of the matrix
    if (round == 1 &&
        needsMock(18 + 2 + 17, "the in-flight move failure "
                               "(EBT_MOCK_CUDA_D2D_FAIL_AT)"))
      continue;
    mockReset();  // the d2d call counter anchors FAIL_AT
    Knobs knobs{{"EBT_MOCK_CUDA_D2D_US", "20"},
                {"EBT_MOCK_CUDA_XFER_US", "20"},
                {"EBT_MOCK_CUDA_D2D_FAIL_AT", round == 1 ? "3" : ""},
                {"EBT_D2D_DISABLE", round == 2 ? "1" : "0"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.numDevices() == 4, "four lanes");
    CHECK(path.d2dSupported() == (round != 2),
          "EBT_D2D_DISABLE latches the capability off");
    std::vector<int> actions, srcs, dsts;
    std::vector<uint64_t> bytes;
    int moves = 0, reads = 0;
    for (int u = 0; u < kUnits; u++) {
      const int a = action_of(u), d = dst_of(u);
      actions.push_back(a);
      srcs.push_back(a == 1 ? d + 2 : d);
      dsts.push_back(d);
      bytes.push_back(kUnitBytes);
      moves += a == 1;
      reads += a == 2;
    }
    CHECK(path.setReshardPlan(actions, srcs, dsts, bytes) == 0,
          "reshard plan installed");
    CHECK(path.reshardPreload() == 0,
          "move sources preloaded: " + path.firstTransferError());
    CHECK(path.reshardBeginUnit(0, kUnits) != 0, "out-of-range unit refused");
    std::vector<std::unique_ptr<HostBuf>> bufs;
    for (int t = 0; t < kThreads; t++)
      bufs.push_back(std::make_unique<HostBuf>(kUnitBytes, 'r' + round));
    std::atomic<int> errors{0};
    hammer(kThreads, [&](int t) {
      char* base = bufs[t]->data();
      for (int u = t; u < kUnits; u += kThreads) {
        const int a = action_of(u);
        if (a == 1) {
          if (path.copy(t, 0, /*move*/ 14, nullptr, u, 0) != 0) errors++;
        } else if (a == 2) {
          if (path.copy(t, 0, /*unit begin*/ 13, nullptr, u, 0) != 0)
            errors++;
          for (uint64_t c = 0; c < kChunks; c++) {
            char* blk = base + c * kBlk;
            if (path.copy(t, dst_of(u), 0, blk, kBlk, c * kBlk) != 0)
              errors++;
            if (path.copy(t, dst_of(u), 2, blk, 0, 0) != 0) errors++;
          }
        }
      }
      if (path.copy(t, 0, /*all resharded*/ 15, nullptr, 0, 0) != 0)
        errors++;
    });
    CHECK(errors.load() == 0, "reshard submits/moves/barriers");
    CHECK(path.reshardError().empty(), "no reshard failure: " +
                                           path.reshardError());
    CHECK(path.setReshardPlan(actions, srcs, dsts, bytes) != 0,
          "sealed plan re-install refused");
    const CudaPath::ReshardStats st = path.reshardStats();
    CHECK(st.units_total == (uint64_t)kUnits, "plan unit count");
    CHECK(st.units_resident == (uint64_t)(kUnits - moves - reads),
          "resident units counted");
    CHECK(st.units_moved == (uint64_t)moves, "every move unit resident");
    CHECK(st.units_read == (uint64_t)reads, "every read unit resident");
    CHECK(st.d2d_submitted_bytes == (uint64_t)moves * kUnitBytes,
          "move bytes submitted");
    CHECK(st.d2d_resident_bytes == st.d2d_submitted_bytes,
          "move bytes resident == submitted");
    CHECK(st.d2d_moves + st.bounce_moves == (uint64_t)moves * kChunks,
          "every chunk move settled through exactly one tier");
    if (round == 0) {
      CHECK(st.d2d_moves == (uint64_t)moves * kChunks,
            "clean round: all moves device to device");
      CHECK(path.d2dEngaged(), "clean round engages the tier");
    } else if (round == 1) {
      CHECK(st.move_recovered >= 1,
            "in-flight failure recovered through the bounce");
      CHECK(st.d2d_moves + st.move_recovered >= (uint64_t)moves * kChunks,
            "recovery preserves the move count");
    } else {
      CHECK(st.d2d_moves == 0, "disable control: no device-to-device move");
      CHECK(st.bounce_moves == (uint64_t)moves * kChunks,
            "disable control: every move bounced");
      CHECK(!path.d2dEngaged(), "the bounce never claims the tier");
    }
    uint64_t totals[2];
    path.reshardByteTotals(totals);
    CHECK(totals[0] == totals[1], "unit bytes submitted == resident");
    CHECK(totals[1] == (uint64_t)(moves + reads) * kUnitBytes,
          "unit bytes equal the plan's data in motion");
    uint64_t mat[16 * 2];
    CHECK(path.reshardPairMatrix(mat, 16) == 4, "4x4 pair matrix");
    for (int s = 0; s < 4; s++) {
      for (int d = 0; d < 4; d++) {
        const uint64_t mv = mat[(s * 4 + d) * 2];
        const uint64_t by = mat[(s * 4 + d) * 2 + 1];
        if ((s == 2 && d == 0) || (s == 3 && d == 1)) {
          CHECK(mv == (uint64_t)moves / 2 * kChunks &&
                    by == (uint64_t)moves / 2 * kUnitBytes,
                "planned pair carries its chunk moves and bytes exactly");
        } else {
          CHECK(mv == 0 && by == 0, "unplanned pair stays empty");
        }
      }
    }
  }
}

// ---------------------------------------------------------------- ingest

void scopeIngest() {
  // the DL-ingestion ledger from 4 workers over 4 lanes across 2 epochs:
  // epoch begins (11), batches through reuse barriers over a 2-buffer
  // rotation, the all-resident seal (12); read == submitted == resident
  // and dropped == 0 per epoch, and again after a rearm
  constexpr uint64_t kRec = 4 * kKiB;
  constexpr uint64_t kBlk = 64 * kKiB;  // 16 records per batch
  {
    Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "20"}};
    constexpr int kThreads = 4;
    constexpr int kEpochs = 2;
    constexpr uint64_t kBatches = 4;
    constexpr uint64_t kEpochBytes = kThreads * kBatches * kBlk;
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.numDevices() == 4, "four lanes");
    CHECK(path.setIngestPlan(kRec, kEpochs) == 0, "ingest plan installed");
    CHECK(path.ingestBeginEpoch(0, kEpochs) != 0, "out-of-range epoch refused");
    for (int round = 0; round < 2; round++) {
      if (round) path.ingestRearm();
      std::vector<std::unique_ptr<HostBuf>> bufs;
      for (int t = 0; t < kThreads; t++)
        bufs.push_back(std::make_unique<HostBuf>(2 * kBlk, 'a' + round));
      std::atomic<int> errors{0};
      hammer(kThreads, [&](int t) {
        for (int e = 0; e < kEpochs; e++) {
          if (path.copy(t, t % 4, /*epoch begin*/ 11, nullptr, e, 0) != 0)
            errors++;
          for (uint64_t b = 0; b < kBatches; b++) {
            char* blk = bufs[t]->data() + (b % 2) * kBlk;
            if (path.copy(t, t % 4, 2, blk, 0, 0) != 0) errors++;
            if (path.copy(t, t % 4, 0, blk, kBlk, b * kBlk) != 0) errors++;
          }
        }
        if (path.copy(t, 0, /*all resident*/ 12, nullptr, 0, 0) != 0)
          errors++;
      });
      CHECK(errors.load() == 0, "ingest submits/barriers");
      const CudaPath::IngestStats st = path.ingestStats();
      CHECK(st.read_bytes == kEpochs * kEpochBytes,
            "read bytes cover every batch of every epoch");
      CHECK(st.read_bytes == st.submitted_bytes, "read == submitted");
      CHECK(st.resident_bytes == st.read_bytes && st.dropped_bytes == 0,
            "every record resident, none dropped");
      CHECK(st.batch_coalesce_count == kEpochs * kThreads * kBatches,
            "every multi-record batch counted coalesced");
      CHECK(st.barriers >= (uint64_t)kThreads, "one seal per worker");
      for (int e = 0; e < kEpochs; e++) {
        uint64_t eb[4];
        CHECK(path.ingestEpochBytes(e, eb), "epoch in range");
        CHECK(eb[0] == kEpochBytes && eb[1] == kEpochBytes &&
                  eb[2] == kEpochBytes && eb[3] == 0,
              "per-epoch read == submitted == resident, dropped == 0");
      }
      CHECK(path.ingestError().empty(), "no ingest failure");
    }
  }
  // a mid-epoch transfer failure: "device N epoch E: cause", with the
  // dropped bytes keeping read == resident + dropped
  if (!needsMock(7, "the per-device ingest fault "
                   "(EBT_MOCK_CUDA_DEV_FAIL_AT)")) {
    mockReset();
    Knobs knobs{{"EBT_MOCK_CUDA_DEV_FAIL_AT", "2:2"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.setIngestPlan(kRec, 1) == 0, "fault-injection plan");
    HostBuf buf(4 * kBlk, 'f');
    int rc = path.copy(0, 0, 11, nullptr, 0, 0);
    for (int b = 0; b < 4; b++)
      rc |= path.copy(0, b, 0, buf.data() + b * kBlk, kBlk, 0);
    const int brc = path.copy(0, 0, 12, nullptr, 0, 0);
    CHECK(rc != 0 || brc != 0, "injected failure surfaces");
    CHECK(path.ingestError().find("device 2 epoch 0") != std::string::npos,
          "ingest failure carries device + epoch: " + path.ingestError());
    uint64_t eb[4];
    CHECK(path.ingestEpochBytes(0, eb), "epoch 0 in range");
    CHECK(eb[0] == 4 * kBlk, "all four batches read");
    CHECK(eb[0] == eb[2] + eb[3] && eb[3] == kBlk,
          "read == resident + dropped through the injected failure");
  }
}

// ---------------------------------------------------------------- faults

// the block content of (thread, slot): one byte value per block, so the
// mock's additive checksum tells blocks apart
char blockByte(int t, int i) { return (char)(1 + (t * 16 + i) % 251); }

void scopeFaults() {
  constexpr int kThreads = 4;
  constexpr int kSlots = 16;
  constexpr uint64_t kBlk = 64 * kKiB;
  const uint64_t total_blocks = (uint64_t)kThreads * kSlots;
  // Shared by both hammers: 4 workers stripe round-robin over 4 lanes, so
  // every lane's stream carries every worker's copies; per-buffer reuse
  // barriers race the recoveries; the gather settles the rest; the ledgers
  // and the per-lane bytes reconcile exactly through the ejection. half(t),
  // when given, runs in worker t before its second half.
  auto run = [&](CudaPath& path, std::vector<std::unique_ptr<HostBuf>>& bufs,
                 std::atomic<int>& errors,
                 const std::function<void(int)>& half) {
    hammer(kThreads, [&](int t) {
      char* base = bufs[t]->data();
      for (int i = 0; i < kSlots; i++) {
        if (half && i == kSlots / 2) half(t);
        const uint64_t gblock = (uint64_t)t * kSlots + (uint64_t)i;
        if (path.copy(t, t, 0, base + i * kBlk, kBlk, gblock * kBlk) != 0)
          errors++;
        if (i % 3 == 2 && path.copy(t, t, 2, base + i * kBlk, 0, 0) != 0)
          errors++;
      }
    });
  };
  auto reconcile = [&](CudaPath& path) {
    CHECK(path.stripeError().empty(),
          "a recovered failure never latches a stripe error: " +
              path.stripeError());
    const CudaPath::StripeStats st = path.stripeStats();
    CHECK(st.units_submitted == total_blocks, "every block routed");
    CHECK(st.units_awaited == st.units_submitted,
          "units awaited reconcile through the ejection");
    uint64_t to = 0, from = 0;
    path.stats(&to, &from);
    CHECK(to == total_blocks * kBlk, "every submitted byte resident");
    uint64_t lane_sum = 0;
    for (int l = 0; l < path.numDevices(); l++) {
      CudaPath::LaneStats ls;
      CHECK(path.laneStats(l, &ls), "laneStats in range");
      lane_sum += ls.bytes_to_hbm;
    }
    CHECK(lane_sum == to, "per-lane byte sums equal the global total");
  };
  auto bufsFor = [&] {
    std::vector<std::unique_ptr<HostBuf>> bufs;
    for (int t = 0; t < kThreads; t++) {
      bufs.push_back(std::make_unique<HostBuf>(kSlots * kBlk));
      for (int i = 0; i < kSlots; i++)
        std::memset(bufs[t]->data() + i * kBlk, blockByte(t, i), kBlk);
    }
    return bufs;
  };

  // a forced ejection mid-run (what a card allows: a real fault is sticky
  // for the whole device context): every worker waits at its half while
  // lane 2 is ejected, so its second half replans lane 2's placements
  {
    Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "20"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    path.setFaultPolicy(1, 1, 1);
    CHECK(path.setStripePlan(1, total_blocks, 1) == 0, "stripe plan");
    auto bufs = bufsFor();
    std::atomic<int> errors{0};
    Latch arrived(kThreads);  // every worker is at its half
    Latch go(1);              // the ejection is done
    run(path, bufs, errors, [&](int t) {
      arrived.arrive();
      if (t == 0) {
        arrived.wait();
        CHECK(path.ejectDevice(2, "forced by the selftest") == 0,
              "forced ejection");
        go.arrive();
      }
      go.wait();
    });
    CHECK(path.copy(0, 0, /*gather*/ 8, nullptr, 0, 0) == 0, "gather");
    CHECK(errors.load() == 0, "no submit/barrier failed around the ejection");
    const CudaPath::FaultStats fs = path.faultStats();
    CHECK(fs.ejected_devices == 1, "exactly one lane ejected");
    CHECK((path.ejectedMask() >> 2) & 1, "lane 2 carries the ejection");
    CHECK(path.ejectedDevices().find("device 2: forced by the selftest") !=
              std::string::npos,
          "ejection attribution names the lane and cause");
    // each worker's second half places slots 10 and 14 on lane 2
    CHECK(fs.replanned_units == 2 * (uint64_t)kThreads,
          "every later lane-2 placement replanned");
    CudaPath::LaneStats ls2;
    CHECK(path.laneStats(2, &ls2) && ls2.bytes_to_hbm == 2 * kThreads * kBlk,
          "lane 2 holds only its first-half blocks");
    reconcile(path);
    CHECK(path.ejectDevice(2, "again") != 0, "an ejected lane refuses again");
    CHECK(path.ejectDevice(4, "out of range") != 0,
          "out-of-range lane refused");
    CHECK(path.ejectDevice(0, "test") == 0, "second ejection ok");
    CHECK(path.ejectDevice(1, "test") == 0, "third ejection ok");
    CHECK(path.ejectDevice(3, "test") != 0, "last healthy lane refuses");
  }
  // an injected in-flight fault on lane 2's stream, which every worker's
  // copies share: the failing copy settles at a barrier, the lane is
  // ejected (budget 1), its pendings are recovered onto survivors, later
  // placements replan; the mock's byte count and checksum must equal the
  // blocks' exactly. Where another worker's copy landed just before the
  // fault with its completion behind it, that block lands twice and the
  // mock takes the first landing back (the next block forces the case).
  if (!needsMock(24, "the injected lane fault (EBT_MOCK_CUDA_DEV_FAIL_AT)")) {
    mockReset();
    Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "20"},
                {"EBT_MOCK_CUDA_DEV_FAIL_AT", "2:2"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    const uint64_t bytes0 = mockU64("ebt_mock_total_bytes");
    const uint64_t sum0 = mockU64("ebt_mock_checksum");
    path.setFaultPolicy(1, 1, 1);
    CHECK(path.setStripePlan(1, total_blocks, 1) == 0, "stripe plan");
    auto bufs = bufsFor();
    uint64_t want_sum = 0;
    for (int t = 0; t < kThreads; t++)
      for (int i = 0; i < kSlots; i++)
        want_sum += kBlk * (uint64_t)(unsigned char)blockByte(t, i);
    std::atomic<int> errors{0};
    run(path, bufs, errors, nullptr);
    CHECK(path.copy(0, 0, 8, nullptr, 0, 0) == 0,
          "gather barrier clean after recovery");
    CHECK(errors.load() == 0, "no submit/barrier failed under recovery");
    const CudaPath::FaultStats fs = path.faultStats();
    CHECK(fs.dev_errors >= 1, "injected failure recorded");
    CHECK(fs.ejected_devices == 1, "exactly one lane ejected");
    CHECK((path.ejectedMask() >> 2) & 1, "lane 2 carries the ejection");
    CHECK(fs.dev_retry_success >= 1, "failed pending recovered");
    CHECK(fs.replanned_units >= 1, "replanner re-routed blocks");
    CHECK(path.ejectedDevices().find("device 2") != std::string::npos,
          "ejection attribution names the lane");
    reconcile(path);
    CHECK(mockU64("ebt_mock_total_bytes") - bytes0 == total_blocks * kBlk,
          "every block landed exactly once (the mock's byte count)");
    CHECK(mockU64("ebt_mock_checksum") - sum0 == want_sum,
          "the mock's checksum exact through the fault");
    CHECK(path.ejectDevice(0, "test") == 0, "second ejection ok");
    CHECK(path.ejectDevice(1, "test") == 0, "third ejection ok");
    CHECK(path.ejectDevice(3, "test") != 0,
          "the last healthy lane refuses ejection");
  }
  // the same interleaving, deterministically: worker A's copy lands on lane
  // 2 and, while A is still attaching its completion (the mock holds each
  // cuLaunchHostFunc call 50 ms), worker B's copy faults lane 2's stream.
  // A's completion queues behind the fault and is dropped, A's block is
  // recovered onto a survivor, and the mock counts each block once.
  if (!needsMock(8, "the dropped completion behind another worker's fault "
                    "(EBT_MOCK_CUDA_HOSTFUNC_DELAY_US)")) {
    mockReset();
    Knobs knobs{{"EBT_MOCK_CUDA_DEV_FAIL_AT", "2:3"},
                {"EBT_MOCK_CUDA_HOSTFUNC_DELAY_US", "50000"}};
    CudaPath path(g.driver, kBlk, kBlk, false, g.four());
    CHECK(path.ok(), okText(path));
    const uint64_t bytes0 = mockU64("ebt_mock_total_bytes");
    const uint64_t sum0 = mockU64("ebt_mock_checksum");
    auto dev_h2d = mockFn<uint64_t (*)(int)>("ebt_mock_dev_h2d_count");
    path.setFaultPolicy(1, 1, 1);
    HostBuf a(kBlk, 0x11), b(kBlk, 0x22);
    std::thread worker_a([&] {
      CHECK(path.copy(0, 2, 0, a.data(), kBlk, 0) == 0, "A's submit");
    });
    // A's copy is lane 2's second (the warm-up was its first)
    const auto deadline = Clock::now() + std::chrono::seconds(10);
    while (dev_h2d && dev_h2d(2) < 2 && Clock::now() < deadline)
      std::this_thread::sleep_for(std::chrono::microseconds(100));
    CHECK(path.copy(1, 2, 0, b.data(), kBlk, kBlk) == 0,
          "B's submit (lane 2's faulting copy)");
    worker_a.join();
    CHECK(path.copy(0, 2, 2, a.data(), 0, 0) == 0,
          "A's barrier recovers the block whose completion was dropped");
    CHECK(path.copy(1, 2, 2, b.data(), 0, 0) == 0,
          "B's barrier recovers the faulted block");
    CHECK(path.faultStats().ejected_devices == 1 &&
              ((path.ejectedMask() >> 2) & 1),
          "lane 2 ejected");
    CHECK(mockU64("ebt_mock_total_bytes") - bytes0 == 2 * kBlk,
          "each block landed once");
    CHECK(mockU64("ebt_mock_checksum") - sum0 == kBlk * (0x11 + 0x22),
          "the mock took A's landing before the fault back out");
  }
  // a recovery backoff wakes at once on the engine's interrupt flag: one
  // lane, the warm-up is copy 1, the block copy 2 fails in flight, the
  // recovery's copy 3 fails at the call, the 2nd attempt's 2 s backoff
  // must bail out
  if (!needsMock(4, "the interrupted recovery backoff "
                   "(EBT_MOCK_CUDA_FAIL_AT)")) {
    mockReset();
    Knobs knobs{{"EBT_MOCK_CUDA_DEV_FAIL_AT", "0:2"},
                {"EBT_MOCK_CUDA_FAIL_AT", "3"}};
    CudaPath path(g.driver, kBlk, kBlk, false, {0});
    CHECK(path.ok(), okText(path));
    std::atomic<bool> interrupt{true};
    path.setInterruptFlag(&interrupt);
    path.setFaultPolicy(1, 8, 2000);
    HostBuf buf(kBlk, 'i');
    CHECK(path.copy(0, 0, 0, buf.data(), kBlk, 0) == 0, "doomed submit");
    const auto t0 = Clock::now();
    CHECK(path.copy(0, 0, 2, buf.data(), 0, 0) != 0,
          "abandoned recovery reports the failure");
    const auto waited = std::chrono::duration_cast<std::chrono::milliseconds>(
                            Clock::now() - t0)
                            .count();
    CHECK(waited < 1500, "interrupted backoff woke promptly");
  }
}

// --------------------------------------------------------------- reactor

int runPhase(Engine& e, int phase) {
  e.startPhase(phase);
  int st;
  while ((st = e.waitDone(500)) == 0) {
  }
  return st;
}

uint64_t totalBytes(Engine& e) {
  uint64_t total = 0;
  for (int i = 0; i < e.numWorkers(); i++)
    total += e.worker(i).live.bytes.load();
  return total;
}

void scopeReactor() {
  // the engine's completion reactor with CudaPath as its dev_copy: 4
  // workers over 4 lanes at iodepth 4 on a paced open-loop schedule with
  // deferred device submits, so the unified wait sees mixed wakeup causes
  // (CQ completions, host-function landings, arrivals); waits reconcile
  // with the per-cause wakeups, the open-loop ledger stays exact, and the
  // EBT_REACTOR_DISABLE / EBT_MOCK_REACTOR_FAIL_AT shapes move the same
  // bytes
  constexpr uint64_t kBlk = 16 * kKiB;
  Knobs knobs{{"EBT_MOCK_CUDA_XFER_US", "100"}};
  CudaPath path(g.driver, kBlk, kBlk, false, g.four());
  CHECK(path.ok(), okText(path));
  EngineConfig cfg;
  cfg.paths = {g.dir + "/f-reactor"};
  cfg.path_type = kPathFile;
  cfg.num_threads = 4;
  cfg.num_dataset_threads = 4;
  cfg.block_size = kBlk;
  cfg.file_size = kMiB;  // 64 blocks, 16 per worker
  cfg.do_trunc_to_size = true;
  cfg.iodepth = 4;
  cfg.arrival_mode = kArrivalPaced;
  cfg.arrival_rate = 200;  // 5 ms gaps: every completion lands during the
                           // next arrival wait, even under a sanitizer
  cfg.dev_backend = 2;
  cfg.dev_deferred = true;
  cfg.num_devices = 4;
  cfg.dev_copy = &CudaPath::copyTrampoline;
  cfg.dev_ctx = &path;

  uint64_t reactor_bytes = 0;
  {
    Engine e(cfg);
    CHECK(e.preparePaths().empty(), "reactor preparePaths");
    CHECK(e.prepare().empty(), "reactor prepare");
    CHECK(e.reactorEnabled(), "reactor armed");
    CHECK(e.reactorCause().empty(), "no inactive cause when armed");
    CHECK(runPhase(e, kPhaseCreateFiles) == 1, "reactor write");
    CHECK(runPhase(e, kPhaseReadFiles) == 1,
          "reactor read: " + e.firstError());
    reactor_bytes = totalBytes(e);
    CHECK(reactor_bytes == cfg.file_size, "reactor read bytes");
    ReactorStats rs;
    e.reactorStats(&rs);
    CHECK(rs.reactor_waits > 0, "reactor engaged (waits moved)");
    CHECK(rs.reactor_waits ==
              rs.reactor_wakeups_cq + rs.reactor_wakeups_onready +
                  rs.reactor_wakeups_arrival + rs.reactor_wakeups_timeout +
                  rs.reactor_wakeups_interrupt,
          "waits reconcile exactly with the per-cause wakeups");
    CHECK(rs.reactor_wakeups_arrival > 0, "arrival wakeups present");
    CHECK(rs.reactor_wakeups_cq + rs.reactor_wakeups_onready > 0,
          "completion wakeups present (CQ or host function)");
    TenantStats s;
    CHECK(e.numTenants() == 1 && e.tenantStats(0, &s), "implicit class");
    CHECK(s.arrivals == s.completions + s.dropped,
          "reactor open-loop reconciliation");
    CHECK(s.dropped == 0, "clean finish drops nothing");
    e.terminate();
  }
  auto read_once = [&](const char* what) -> uint64_t {
    Engine e(cfg);
    CHECK(e.prepare().empty(), what);
    CHECK(runPhase(e, kPhaseReadFiles) == 1, what);
    TenantStats s;
    CHECK(e.numTenants() == 1 && e.tenantStats(0, &s), what);
    CHECK(s.arrivals == s.completions + s.dropped,
          "open-loop ledger exact");
    const uint64_t bytes = totalBytes(e);
    e.terminate();
    return bytes;
  };
  // the polling shape moves identical bytes (knobs of the engine, read at
  // its preparation; no engine thread runs while they change)
  setenv("EBT_REACTOR_DISABLE", "1", 1);
  {
    Engine e(cfg);
    CHECK(e.prepare().empty(), "disable prepare");
    CHECK(!e.reactorEnabled(), "disable control inactive");
    CHECK(e.reactorCause().find("EBT_REACTOR_DISABLE") != std::string::npos,
          "disable cause latched");
    CHECK(runPhase(e, kPhaseReadFiles) == 1, "disable read");
    CHECK(totalBytes(e) == reactor_bytes, "disable A/B byte-identical");
    ReactorStats rs;
    e.reactorStats(&rs);
    CHECK(rs.reactor_waits == 0, "polling shape never waits in a reactor");
    e.terminate();
  }
  unsetenv("EBT_REACTOR_DISABLE");
  setenv("EBT_MOCK_REACTOR_FAIL_AT", "1", 1);
  {
    Engine e(cfg);
    CHECK(e.prepare().empty(), "inject prepare");
    CHECK(e.reactorCause().find("EBT_MOCK_REACTOR_FAIL_AT") !=
              std::string::npos,
          "injection cause latched");
    CHECK(runPhase(e, kPhaseReadFiles) == 1, "inject read completes");
    CHECK(totalBytes(e) == reactor_bytes, "inject A/B byte-identical");
    e.terminate();
  }
  unsetenv("EBT_MOCK_REACTOR_FAIL_AT");
  CHECK(read_once("re-arm read") == reactor_bytes, "re-arm byte-identical");
  std::remove(cfg.paths[0].c_str());
}

// --------------------------------------------------------------- xfermgr

void scopeXferMgr() {
  // the transfer-manager tier (EBT_PJRT_XFER_MGR) from 4 workers over 4
  // lanes: one stream-ordered device buffer per block, its chunks copied
  // into it, freed at the block's settle; blocks counted, one latency
  // sample per block, nothing held after the teardown
  constexpr int kThreads = 4;
  constexpr int kBlocks = 16;
  constexpr uint64_t kChunk = 64 * kKiB;
  constexpr uint64_t kBlock = 4 * kChunk;
  const int64_t live0 = mockLiveBuffers();
  {
    Knobs knobs{{"EBT_PJRT_XFER_MGR", "1"}, {"EBT_MOCK_CUDA_XFER_US", "20"}};
    CudaPath path(g.driver, kChunk, kBlock, false, g.four());
    CHECK(path.ok(), okText(path));
    CHECK(path.xferMgrActive(), "tier active: " + path.regError());
    const uint64_t allocs0 = mockU64("ebt_mock_xfer_mgr_count");
    std::vector<std::unique_ptr<HostBuf>> bufs;
    for (int t = 0; t < kThreads; t++)
      bufs.push_back(std::make_unique<HostBuf>(2 * kBlock, 'm' + t));
    std::atomic<int> errors{0};
    hammer(kThreads, [&](int t) {
      for (int b = 0; b < kBlocks; b++) {
        char* blk = bufs[t]->data() + (b % 2) * kBlock;
        if (path.copy(t, t, 2, blk, 0, 0) != 0) errors++;
        if (path.copy(t, t, 0, blk, kBlock, (uint64_t)b * kBlock) != 0)
          errors++;
      }
      for (int b = 0; b < 2; b++)
        if (path.copy(t, t, 2, bufs[t]->data() + b * kBlock, 0, 0) != 0)
          errors++;
    });
    CHECK(errors.load() == 0, "tier submits/barriers");
    CHECK(path.xferMgrCount() == (uint64_t)kThreads * kBlocks,
          "every block counted on the tier");
    uint64_t to = 0, from = 0;
    path.stats(&to, &from);
    CHECK(to == (uint64_t)kThreads * kBlocks * kBlock, "tier bytes resident");
    for (int l = 0; l < 4; l++)
      CHECK(laneSamples(path, l) == (uint64_t)kBlocks,
            "one latency sample per block");
    if (!needsMock(1, "the mock's tier allocation count"))
      CHECK(mockU64("ebt_mock_xfer_mgr_count") - allocs0 ==
                (uint64_t)kThreads * kBlocks,
            "one device buffer per block");
  }
  if (!needsMock(1, "the mock's live-buffer gauge"))
    CHECK(mockLiveBuffers() == live0, "0 bytes held after the teardown");
}

// --------------------------------------------------------------- kernels

using IngestWsFn = uint64_t (*)(int sms, uint64_t n_ranks);
using IngestFn = int (*)(const void* data, uint64_t n_lanes, uint64_t n_ranks,
                         uint64_t rank_stride_lanes, const void* bases,
                         void* out, void* workspace, int sms, void* stream);
using SumRowsFn = int (*)(const void* rows, uint64_t n_rows, uint64_t k,
                          void* out, void* stream);

// the plain host loops the kernels are held against
void verifyLoop(const uint32_t* lanes, uint64_t n_lanes, uint64_t base,
                int64_t out[3]) {
  const uint64_t n_words = n_lanes / 2;
  uint64_t bad_lanes = 0, bad_words = 0, first = n_words;
  for (uint64_t w = 0; w < n_words; w++) {
    const uint64_t want = base + 8 * w;
    const bool lo = lanes[2 * w] != (uint32_t)want;
    const bool hi = lanes[2 * w + 1] != (uint32_t)(want >> 32);
    bad_lanes += lo + hi;
    if (lo || hi) {
      bad_words++;
      if (first == n_words) first = w;
    }
  }
  if (n_lanes & 1)
    bad_lanes += lanes[n_lanes - 1] != (uint32_t)(base + 8 * n_words);
  out[0] = (int64_t)bad_lanes;
  out[1] = (int64_t)bad_words;
  out[2] = (int64_t)first;
}

void ingestLoop(const uint32_t* lanes, uint64_t n_lanes, uint64_t base,
                int64_t out[4]) {
  const uint64_t n_words = n_lanes / 2;
  uint64_t bad = 0, first = n_words;
  uint32_t csum = 0;
  for (uint64_t w = 0; w < n_words; w++) {
    csum += lanes[2 * w] + lanes[2 * w + 1];
    const uint64_t want = base + 8 * w;
    if (lanes[2 * w] != (uint32_t)want ||
        lanes[2 * w + 1] != (uint32_t)(want >> 32)) {
      bad++;
      if (first == n_words) first = w;
    }
  }
  out[0] = bad ? 0 : (int64_t)(uint32_t)(n_lanes * 4);
  out[1] = (int64_t)bad;
  out[2] = (int64_t)first;
  out[3] = (int64_t)csum;
}

void patternLanes(uint32_t* lanes, uint64_t n_lanes, uint64_t base) {
  for (uint64_t i = 0; i < n_lanes; i++) {
    const uint64_t w = base + 8 * (i / 2);
    lanes[i] = i % 2 ? (uint32_t)(w >> 32) : (uint32_t)w;
  }
}

// the card's device 0 through the driver table, with its primary
// context current on the calling thread
struct Card {
  cu::Api api{};
  cu::CUcontext ctx = nullptr;
  cu::CUdevice dev = 0;
  int sms = 0;
  bool ok = false;
  std::string err;

  Card() {
    if (!cu::loadApi(g.driver, &api, &err)) return;
    if (api.cuInit(0) || api.cuDeviceGet(&dev, 0) ||
        api.cuDevicePrimaryCtxRetain(&ctx, dev) || !current() ||
        api.cuDeviceGetAttribute(
            &sms, cu::CU_DEVICE_ATTRIBUTE_MULTIPROCESSOR_COUNT, dev)) {
      err = "device 0 could not be opened";
      return;
    }
    ok = true;
  }
  ~Card() {
    if (ctx) api.cuDevicePrimaryCtxRelease(dev);
  }
  bool current() { return api.cuCtxSetCurrent(ctx) == cu::CUDA_SUCCESS; }
  cu::CUdeviceptr alloc(uint64_t n) {
    cu::CUdeviceptr p = 0;
    return api.cuMemAlloc(&p, n ? n : 8) ? 0 : p;
  }
  bool put(cu::CUdeviceptr dst, const void* src, uint64_t n, cu::CUstream s) {
    return !api.cuMemcpyHtoDAsync(dst, src, n, s) &&
           !api.cuStreamSynchronize(s);
  }
  bool get(void* dst, cu::CUdeviceptr src, uint64_t n, cu::CUstream s) {
    return !api.cuMemcpyDtoHAsync(dst, src, n, s) &&
           !api.cuStreamSynchronize(s);
  }
};

void scopeKernels() {
  if (g.mock) {
    // the mock's kernel entries are host loops: holding them against the
    // host loops here would check none of the port's code
    std::printf("needs the card: the four kernel entries against their "
                "host loops\n");
    return;
  }
  Card card;
  CHECK(card.ok, "open device 0: " + card.err);
  if (!card.ok) return;
  void *vf = nullptr, *vws = nullptr, *ff = nullptr, *inf = nullptr,
       *inws = nullptr, *sf = nullptr;
  std::string err;
  const bool have = cu::loadKernel(g.kernels, "ebt_verify_u32", &vf, &err) &&
                    cu::loadKernel(g.kernels, "ebt_verify_workspace_bytes",
                                   &vws, &err) &&
                    cu::loadKernel(g.kernels, "ebt_fill_u64", &ff, &err) &&
                    cu::loadKernel(g.kernels, "ebt_ingest_verify_u32", &inf,
                                   &err) &&
                    cu::loadKernel(g.kernels, "ebt_ingest_workspace_bytes",
                                   &inws, &err) &&
                    cu::loadKernel(g.kernels, "ebt_sum_rows_u64", &sf, &err);
  CHECK(have, "the kernel library's four entries: " + err);
  if (!have) return;
  auto verify = (cu::VerifyU32Fn)vf;
  auto fill = (cu::FillU64Fn)ff;
  auto ingest = (IngestFn)inf;
  auto sum_rows = (SumRowsFn)sf;
  cu::Api& api = card.api;
  cu::CUstream stream = nullptr;
  CHECK(!api.cuStreamCreate(&stream, cu::CU_STREAM_NON_BLOCKING), "stream");
  uint64_t n_verify = 0, n_fill = 0, n_ingest = 0, n_sum = 0;
  const uint64_t wrap = ~0ull - 8 * 1000 + 3;  // the pattern wraps past 2^64

  // B1/B2: clean, then one planted corrupt lane, at sizes with tails and
  // an 8-mod-16 start; the workspace is zeroed once and reused throughout
  {
    const uint64_t ws_bytes = ((cu::VerifyWorkspaceBytesFn)vws)(card.sms);
    cu::CUdeviceptr ws = card.alloc(ws_bytes), out = card.alloc(24);
    const uint64_t max_lanes = (4 * kMiB) / 4 + 3;
    cu::CUdeviceptr data = card.alloc(max_lanes * 4 + 16);
    CHECK(ws && out && data, "verify buffers");
    CHECK(!api.cuMemsetD8Async(ws, 0, ws_bytes, stream) &&
              !api.cuStreamSynchronize(stream),
          "workspace zeroed");
    std::vector<uint32_t> lanes(max_lanes);
    for (uint64_t n : {1ull, 2ull, 3ull, 5ull, 4095ull, 4097ull, 65539ull,
                       (unsigned long long)max_lanes}) {
      for (int misalign = 0; misalign < 2; misalign++) {
        const uint64_t base = n % 2 ? wrap : 4096 * n + 42;
        patternLanes(lanes.data(), n, base);
        for (int corrupt = 0; corrupt < 2; corrupt++) {
          const uint64_t at = (n * 7 / 11) % n;  // the planted lane
          if (corrupt) lanes[at] ^= 0x00100000u;
          const cu::CUdeviceptr d = data + 8 * misalign;
          int64_t got[3] = {-1, -1, -1}, want[3];
          verifyLoop(lanes.data(), n, base, want);
          const bool ran =
              card.put(d, lanes.data(), n * 4, stream) &&
              verify((const void*)(uintptr_t)d, n, base,
                     (void*)(uintptr_t)out, (void*)(uintptr_t)ws, card.sms,
                     stream) == 0 &&
              card.get(got, out, 24, stream);
          n_verify++;
          const std::string what = "verify_u32 n_lanes " + std::to_string(n) +
                                   (misalign ? " start 8 mod 16" : "") +
                                   (corrupt ? " corrupt" : " clean");
          CHECK(ran && std::memcmp(got, want, sizeof want) == 0,
                what + " equals the host loop");
          if (corrupt && at < n / 2 * 2)
            CHECK(got[2] == (int64_t)(at / 2) && got[1] == 1 && got[0] == 1,
                  what + ": the planted word at its exact offset");
          else if (corrupt)
            CHECK(got[0] == 1 && got[1] == 0, what + ": the tail lane");
          if (corrupt) lanes[at] ^= 0x00100000u;
        }
      }
    }
    for (cu::CUdeviceptr p : {ws, out, data})
      if (p) api.cuMemFree(p);
  }

  // B3: words base + 8 i (wrapping), odd counts, an 8-mod-16 start; the
  // word behind the last must stay untouched
  {
    const uint64_t max_words = (1 << 20) + 3;
    cu::CUdeviceptr dst = card.alloc(max_words * 8 + 24);
    CHECK(dst, "fill buffer");
    std::vector<uint64_t> got(max_words + 1);
    for (uint64_t n : {1ull, 2ull, 3ull, 1025ull, 65537ull,
                       (unsigned long long)max_words}) {
      for (int misalign = 0; misalign < 2; misalign++) {
        const cu::CUdeviceptr d = dst + 8 * misalign;
        const uint64_t base = n % 2 ? wrap : 8 * n;
        const bool ran =
            !api.cuMemsetD8Async(dst, 0xAB, max_words * 8 + 24, stream) &&
            fill((void*)(uintptr_t)d, n, base, stream) == 0 &&
            card.get(got.data(), d, (n + 1) * 8, stream);
        n_fill++;
        bool same = ran;
        for (uint64_t i = 0; same && i < n; i++) same = got[i] == base + 8 * i;
        CHECK(same, "fill_u64 n_words " + std::to_string(n) +
                        (misalign ? " start 8 mod 16" : "") +
                        " equals the host loop");
        CHECK(ran && got[n] == 0xABABABABABABABABull,
              "fill_u64 writes nothing past its words");
      }
    }
    api.cuMemFree(dst);
  }

  // B4: batches of ranks, each rank with its own base, rank starts
  // alternating between 16-byte and 8-mod-16 alignment, one corrupt rank
  {
    const uint64_t max_lanes = (1 << 20) + 2;
    const uint64_t max_ranks = 3;
    const uint64_t ws_bytes = ((IngestWsFn)inws)(card.sms, max_ranks);
    cu::CUdeviceptr ws = card.alloc(ws_bytes);
    cu::CUdeviceptr data = card.alloc((max_lanes + 4) * 4 * max_ranks + 16);
    cu::CUdeviceptr bases_d = card.alloc(8 * max_ranks);
    cu::CUdeviceptr out = card.alloc(32 * max_ranks + 8);
    CHECK(ws && data && bases_d && out, "ingest buffers");
    CHECK(!api.cuMemsetD8Async(ws, 0, ws_bytes, stream) &&
              !api.cuStreamSynchronize(stream),
          "workspace zeroed");
    for (uint64_t n : {2ull, 6ull, 4098ull, (unsigned long long)max_lanes}) {
      for (uint64_t ranks : {1ull, 3ull}) {
        const uint64_t stride = n + (n % 4 == 0 ? 2 : 4);  // 2 mod 4 lanes
        std::vector<uint32_t> lanes(stride * ranks, 0);
        std::vector<int64_t> bases(ranks);
        for (uint64_t r = 0; r < ranks; r++) {
          bases[r] = (int64_t)(r == 1 ? wrap : 1000 * n + 64 * r);
          patternLanes(lanes.data() + r * stride, n, (uint64_t)bases[r]);
        }
        const uint64_t bad_rank = ranks - 1, bad_lane = (n * 5 / 9) % n;
        lanes[bad_rank * stride + bad_lane] ^= 0x40;
        std::vector<int64_t> got(4 * ranks + 1, -7), want(4 * ranks);
        for (uint64_t r = 0; r < ranks; r++)
          ingestLoop(lanes.data() + r * stride, n, (uint64_t)bases[r],
                     want.data() + 4 * r);
        const bool ran =
            card.put(data, lanes.data(), lanes.size() * 4, stream) &&
            card.put(bases_d, bases.data(), 8 * ranks, stream) &&
            !api.cuMemsetD8Async(out, 0xCD, 32 * ranks + 8, stream) &&
            ingest((const void*)(uintptr_t)data, n, ranks, stride,
                   (const void*)(uintptr_t)bases_d, (void*)(uintptr_t)out,
                   (void*)(uintptr_t)ws, card.sms, stream) == 0 &&
            card.get(got.data(), out, 32 * ranks + 8, stream);
        n_ingest++;
        const std::string what = "ingest_verify_u32 n_lanes " +
                                 std::to_string(n) + " ranks " +
                                 std::to_string(ranks);
        CHECK(ran && std::memcmp(got.data(), want.data(), 32 * ranks) == 0,
              what + " equals the host loop");
        CHECK(ran && got[4 * bad_rank + 1] == 1 &&
                  got[4 * bad_rank + 2] == (int64_t)(bad_lane / 2),
              what + ": the planted word at its exact offset");
        CHECK(ran && got[4 * ranks] == (int64_t)0xCDCDCDCDCDCDCDCDull,
              what + ": nothing written past the last rank");
      }
    }
    for (cu::CUdeviceptr p : {ws, data, bases_d, out})
      if (p) api.cuMemFree(p);
  }

  // B5: column sums mod 2^64 with values of 2^63 and above
  {
    cu::CUdeviceptr rows_d = card.alloc(100 * 37 * 8), out = card.alloc(38 * 8);
    CHECK(rows_d && out, "reduction buffers");
    RandAlgoXoshiro rng(5);
    const std::pair<uint64_t, uint64_t> shapes[] = {
        {1, 1}, {4, 5}, {33, 7}, {100, 37}};
    for (auto [n_rows, k] : shapes) {
      std::vector<uint64_t> rows(n_rows * k), want(k, 0), got(k + 1, 0);
      for (uint64_t i = 0; i < rows.size(); i++)
        rows[i] = i % 3 ? rng.next() : (1ull << 63) + i;
      for (uint64_t r = 0; r < n_rows; r++)
        for (uint64_t c = 0; c < k; c++) want[c] += rows[r * k + c];
      const bool ran = card.put(rows_d, rows.data(), rows.size() * 8, stream) &&
                       !api.cuMemsetD8Async(out, 0xEF, (k + 1) * 8, stream) &&
                       sum_rows((const void*)(uintptr_t)rows_d, n_rows, k,
                                (void*)(uintptr_t)out, stream) == 0 &&
                       card.get(got.data(), out, (k + 1) * 8, stream);
      n_sum++;
      CHECK(ran && std::memcmp(got.data(), want.data(), k * 8) == 0,
            "sum_rows_u64 " + std::to_string(n_rows) + " x " +
                std::to_string(k) + " equals the host loop");
      CHECK(ran && got[k] == 0xEFEFEFEFEFEFEFEFull,
            "sum_rows_u64 writes nothing past its columns");
    }
    api.cuMemFree(rows_d);
    api.cuMemFree(out);
  }

  // the workspace/ticket protocol: 4 threads, each on its own stream with
  // its own workspace, start together and queue kIters verify launches back
  // to back (clean and corrupt alternating, each into its own result slot)
  // before one synchronize. A stream's launches share its workspace in
  // stream order, the ticket handing it on from one launch to the next;
  // the four streams' launches overlap on the card
  {
    constexpr int kThreads = 4;
    constexpr int kIters = 16;
    const uint64_t n = (1 << 18) + 1;  // odd: a tail lane every launch
    const uint64_t ws_bytes = ((cu::VerifyWorkspaceBytesFn)vws)(card.sms);
    std::atomic<int> wrong{0}, launched{0}, ready{0};
    hammer(kThreads, [&](int t) {
      const uint64_t base = 1000003ull * (t + 1);
      std::vector<uint32_t> lanes(n);
      patternLanes(lanes.data(), n, base);
      const uint64_t at = 12345 + 1000 * t;
      cu::CUstream s = nullptr;
      cu::CUdeviceptr clean = 0, bad = 0, ws = 0, out = 0;
      int64_t* host = nullptr;
      bool ok = card.current() &&
                !api.cuStreamCreate(&s, cu::CU_STREAM_NON_BLOCKING);
      if (ok) {
        clean = card.alloc(n * 4);
        bad = card.alloc(n * 4);
        ws = card.alloc(ws_bytes);
        out = card.alloc(24 * kIters);
      }
      ok = ok && clean && bad && ws && out &&
           !api.cuMemHostAlloc((void**)&host, 24 * kIters, 0) &&
           !api.cuMemsetD8Async(ws, 0, ws_bytes, s) &&
           card.put(clean, lanes.data(), n * 4, s);
      lanes[at] ^= 1u;
      ok = ok && card.put(bad, lanes.data(), n * 4, s);
      ready++;  // whether or not this thread can launch: no one waits forever
      while (ready.load() < kThreads) std::this_thread::yield();
      for (int i = 0; ok && i < kIters; i++) {
        ok = verify((const void*)(uintptr_t)((i + t) % 2 ? bad : clean), n,
                    base, (void*)(uintptr_t)(out + 24 * i),
                    (void*)(uintptr_t)ws, card.sms, s) == 0;
        if (ok) launched++;
      }
      ok = ok && !api.cuMemcpyDtoHAsync(host, out, 24 * kIters, s) &&
           !api.cuStreamSynchronize(s);
      for (int i = 0; ok && i < kIters; i++) {
        const bool corrupt = (i + t) % 2;
        const int64_t* r = host + 3 * i;
        if (r[0] != (corrupt ? 1 : 0) || r[1] != (corrupt ? 1 : 0) ||
            r[2] != (int64_t)(corrupt ? at / 2 : n / 2))
          wrong++;
      }
      if (!ok) wrong++;
      for (cu::CUdeviceptr p : {clean, bad, ws, out})
        if (p) api.cuMemFree(p);
      if (host) api.cuMemFreeHost(host);
      if (s) api.cuStreamDestroy(s);
    });
    n_verify += launched.load();
    CHECK(wrong.load() == 0 && launched.load() == kThreads * kIters,
          "4 threads x a stream and a workspace each x 16 launches in "
          "flight: every launch exact");
  }
  if (stream) api.cuStreamDestroy(stream);
  std::printf("kernels: held against host loops: verify_u32 %llu fill_u64 "
              "%llu ingest_verify_u32 %llu sum_rows_u64 %llu launches\n",
              (unsigned long long)n_verify, (unsigned long long)n_fill,
              (unsigned long long)n_ingest, (unsigned long long)n_sum);
}

struct Scope {
  const char* name;
  void (*fn)();
};
const Scope kScopes[] = {
    {"path", scopePath},       {"regwindow", scopeRegWindow},
    {"d2h", scopeD2H},         {"lanes", scopeLanes},
    {"stripe", scopeStripe},   {"ckpt", scopeCkpt},
    {"serving", scopeServing}, {"reshard", scopeReshard},
    {"ingest", scopeIngest},   {"faults", scopeFaults},
    {"reactor", scopeReactor}, {"xfermgr", scopeXferMgr},
    {"kernels", scopeKernels},
};

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s DRIVER_SO KERNEL_LIB [SCOPE|all]\n", argv[0]);
    return 2;
  }
  g.driver = argv[1];
  g.kernels = argv[2];
  const std::string want = argc > 3 ? argv[3] : "all";
  g.mock_h = dlopen(g.driver.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!g.mock_h) {
    std::fprintf(stderr, "cannot load %s: %s\n", g.driver.c_str(), dlerror());
    return 2;
  }
  g.mock = dlsym(g.mock_h, "ebt_mock_reset") != nullptr;
  if (!g.mock) {
    dlclose(g.mock_h);
    g.mock_h = nullptr;
  }
  if (g.mock) setenv("EBT_MOCK_CUDA_DEVICES", "4", 1);  // no thread runs yet
  const char* tmp = getenv("TMPDIR");
  std::string tmpl = std::string(tmp && *tmp ? tmp : "/tmp") +
                     "/ebt-cuda-selftest-XXXXXX";
  std::vector<char> t(tmpl.begin(), tmpl.end());
  t.push_back('\0');
  if (!mkdtemp(t.data())) {
    std::perror("mkdtemp");
    return 2;
  }
  g.dir = t.data();

  bool found = false;
  for (const Scope& s : kScopes) {
    if (want != "all" && want != s.name) continue;
    found = true;
    const int c0 = g_checks.load(), f0 = g_failures.load(), m0 = g_need_mock;
    uint64_t k0[2];
    CudaPath::kernelLaunches(k0);
    const auto t0 = Clock::now();
    s.fn();
    const double secs =
        std::chrono::duration<double>(Clock::now() - t0).count();
    uint64_t k1[2];
    CudaPath::kernelLaunches(k1);
    const int failed = g_failures.load() - f0;
    std::printf("scope %s: %d checks passed, %d failed, %d need the mock, "
                "%.3f s, CudaPath kernel launches verify %llu fill %llu\n",
                s.name, g_checks.load() - c0 - failed, failed,
                g_need_mock - m0, secs, (unsigned long long)(k1[0] - k0[0]),
                (unsigned long long)(k1[1] - k0[1]));
    std::fflush(stdout);
  }
  rmdir(g.dir.c_str());
  if (!found) {
    std::fprintf(stderr, "unknown scope %s\n", want.c_str());
    return 2;
  }
  if (g_failures.load()) {
    std::printf("cuda selftest: %d FAILURES\n", g_failures.load());
    return 1;
  }
  std::printf("cuda selftest: all checks passed (%d checks, %d need the "
              "mock)\n",
              g_checks.load(), g_need_mock);
  return 0;
}
