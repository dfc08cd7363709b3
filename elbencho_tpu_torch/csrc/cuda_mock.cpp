/* Mock CUDA driver for the CPU tests: a library exporting the driver entries
 * the native transfer engine resolves (cuda_api.cpp) and the kernels' C
 * entries (csrc/verify.cu, csrc/fill.cu), with host memory standing in for
 * device memory. The port's counterpart of the original package's mock PJRT
 * plugin (core/src/pjrt_mock_plugin.cpp): with EBT_TORCH_DEVICE=cpu and
 * EBT_CUDA_DRIVER naming build/torch_core/libebtcudamock.so the tests run
 * the real C++ engine (cuda_path.cpp) end to end.
 *
 * Streams are worker threads that run their operations in order: copies,
 * memsets, event records, host functions and kernels. Completion is really
 * deferred, so the engine's barriers are exercised, not short-circuited.
 * Like the real driver, a host-to-device copy from pageable memory takes its
 * source at the call (host-synchronous for the source), while a copy from
 * registered memory reads the source when it runs on the stream; a
 * device-to-host copy into pageable memory returns only once it has landed.
 *
 * Environment seams (read at each call):
 *   EBT_MOCK_CUDA_DEVICES     device count (default 1)
 *   EBT_MOCK_CUDA_DELAY_US    a copy runs no earlier than N us after it was
 *                             enqueued: pure latency, copies overlap
 *   EBT_MOCK_CUDA_XFER_US     per-copy service time on its device's channel:
 *                             copies to one device queue, devices overlap
 *   EBT_MOCK_CUDA_FAIL_AT     fail the Nth cuMemcpyHtoDAsync (1-based)
 *   EBT_MOCK_CUDA_DEV_FAIL_AT  "<dev>:<n>": the Nth cuMemcpyHtoDAsync that
 *                             targets device <dev> (0-based dev, 1-based n,
 *                             warm-up copies included) fails in flight: the
 *                             call succeeds, the copy lands nothing, and its
 *                             stream stays in error, as after a real
 *                             asynchronous fault: later work on it is
 *                             accepted and never runs, and every query,
 *                             synchronise or event wait on it reports the
 *                             fault (the original mock's
 *                             EBT_MOCK_STRIPE_FAIL_AT)
 *   EBT_MOCK_CUDA_XFER_FAIL_AT  fail the Nth cuMemcpyDtoHAsync (1-based)
 *   EBT_MOCK_CUDA_FAIL_READY_AT  fail the Nth completion attach
 *                             (cuLaunchHostFunc or cuEventRecord, 1-based)
 *   EBT_MOCK_CUDA_HOSTFUNC_UNSUPPORTED  cuLaunchHostFunc returns
 *                             CUDA_ERROR_NOT_SUPPORTED
 *   EBT_MOCK_CUDA_NO_HOSTREG  devices report no cuMemHostRegister support
 *   EBT_MOCK_CUDA_HOSTREG_FAIL        every cuMemHostRegister fails
 *   EBT_MOCK_CUDA_HOSTREG_FAIL_AT     the Nth cuMemHostRegister fails
 *   EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER  every cuMemHostRegister after the Nth
 *                             fails (the init probe passes, real ones fail)
 *   EBT_MOCK_CUDA_HOSTREG_MAX_BYTES   ranges larger than N bytes fail
 *   EBT_MOCK_CUDA_UNREGISTER_US  cuMemHostUnregister takes N us, during
 *                             which the range still counts as registered,
 *                             as the driver's unpin does
 *   EBT_MOCK_CUDA_D2D_US      service time of a device-to-device copy
 *                             (cuMemcpyPeerAsync, cuMemcpyDtoDAsync) on its
 *                             (src, dst) pair's channel: moves on distinct
 *                             pairs overlap, one pair's moves queue (default
 *                             EBT_MOCK_CUDA_XFER_US; the original mock's
 *                             EBT_MOCK_D2D_US)
 *   EBT_MOCK_CUDA_D2D_FAIL_AT  the Nth device-to-device copy (1-based)
 *                             fails in flight: the call succeeds, nothing
 *                             lands, and the completion enqueued right
 *                             behind it on its stream is dropped and
 *                             reported as the fault once, by the next
 *                             query, synchronise or event wait on the
 *                             stream; later work runs (the original mock's
 *                             EBT_MOCK_D2D_FAIL_AT)
 *   EBT_MOCK_CUDA_ALLOC_MAX_BYTES  cuMemAlloc of more than N bytes fails
 *                             (a rotation generation's shard that does not
 *                             fit)
 *   EBT_MOCK_CUDA_NO_D2D      the device-to-device copies return
 *                             CUDA_ERROR_NOT_SUPPORTED (a driver that
 *                             refuses them; the original's
 *                             EBT_MOCK_PJRT_NO_D2D)
 *   EBT_MOCK_CUDA_NO_XFERMGR  devices report no memory-pool support
 *                             (CU_DEVICE_ATTRIBUTE_MEMORY_POOLS_SUPPORTED
 *                             0): the transfer-manager tier downgrades at
 *                             init (the original's EBT_MOCK_PJRT_NO_XFERMGR)
 *   EBT_MOCK_CUDA_XFERMGR_FAIL  every cuMemAllocAsync fails: the tier's
 *                             init probe downgrades it (the original's
 *                             EBT_MOCK_PJRT_XFERMGR_FAIL, a stubbed slot)
 *   EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT  the Nth cuMemcpyHtoDAsync into a
 *                             tier block buffer (memory of cuMemAllocAsync)
 *                             fails at the call, 1-based, the init probe's
 *                             copy counted as 1 (the original's
 *                             EBT_MOCK_PJRT_XFER_FAIL_AT). Copies into tier
 *                             block buffers have this counter of their
 *                             own: EBT_MOCK_CUDA_FAIL_AT and _DEV_FAIL_AT
 *                             do not count them, as the original's
 *                             BufferFromHostBuffer seams do not count
 *                             TransferData
 * A read-only mapping registered without CU_MEMHOSTREGISTER_READ_ONLY is
 * refused, as the real driver refuses it.
 *
 * Test helpers: ebt_mock_total_bytes / ebt_mock_checksum (bytes landed on
 * the devices by host-to-device and device-to-device copies and their
 * additive checksum), ebt_mock_d2d_count (device-to-device copy calls),
 * ebt_mock_exec_count(dev) (kernel launches per device),
 * ebt_mock_dev_h2d_count(dev) (host-to-device copies per device),
 * ebt_mock_hostreg_active (registered ranges), ebt_mock_live_buffers
 * (allocated minus freed device buffers, cuMemAllocAsync's included),
 * ebt_mock_xfer_mgr_count (tier block buffers allocated, the original
 * mock's count of managers created), ebt_mock_h2d_count /
 * ebt_mock_completion_count (calls so far, for the *_AT seams) and
 * ebt_mock_reset.
 */
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

using CUresult = int;
using Clock = std::chrono::steady_clock;

constexpr CUresult kOk = 0;
constexpr CUresult kInvalidValue = 1;
constexpr CUresult kNotReady = 600;
constexpr CUresult kOsCallFailed = 304;
constexpr CUresult kAlreadyRegistered = 712;
constexpr CUresult kNotRegistered = 713;
constexpr CUresult kNotSupported = 801;
constexpr CUresult kInjected = 999;  // CUDA_ERROR_UNKNOWN
constexpr int kMaxDevices = 64;

int env_int(const char* name, long long dflt = 0) {
  const char* v = std::getenv(name);
  return v && *v ? std::atoi(v) : (int)dflt;
}

long long env_ll(const char* name) {
  const char* v = std::getenv(name);
  return v && *v ? std::atoll(v) : 0;
}

// the message of this thread's last injected failure, for cuGetErrorString
thread_local std::string t_injected;

CUresult inject(const char* msg) {
  t_injected = msg;
  return kInjected;
}

std::atomic<uint64_t> g_total_bytes{0};
std::atomic<uint64_t> g_checksum{0};
std::atomic<uint64_t> g_h2d_calls{0};
std::atomic<uint64_t> g_d2h_calls{0};
std::atomic<uint64_t> g_completion_calls{0};
std::atomic<uint64_t> g_d2d_calls{0};
std::atomic<uint64_t> g_hostreg_calls{0};
std::atomic<uint64_t> g_exec[kMaxDevices];
std::atomic<uint64_t> g_dev_h2d[kMaxDevices];
std::atomic<int64_t> g_live_buffers{0};
std::atomic<uint64_t> g_xfer_mgr_allocs{0};
std::atomic<uint64_t> g_xfer_copy_calls{0};

// stream-ordered allocations (cuMemAllocAsync): base -> length, so a copy
// into a tier block buffer is told apart from any other
std::mutex g_pool_m;
std::map<uintptr_t, uint64_t> g_pool_allocs;

bool pool_alloc(uintptr_t dst, uint64_t len) {
  std::lock_guard<std::mutex> lk(g_pool_m);
  auto it = g_pool_allocs.upper_bound(dst);
  if (it == g_pool_allocs.begin()) return false;
  --it;
  return dst + len <= it->first + it->second;
}

// one opaque memory-pool handle per device
char g_pools[kMaxDevices];

// the current context's device, per thread
struct Ctx {
  int device;
};
Ctx g_ctx[kMaxDevices];
thread_local int t_device = 0;

// registered (pinned) host ranges: base -> length
std::mutex g_reg_m;
std::map<uintptr_t, uint64_t> g_reg;

bool registered(const void* p, uint64_t len) {
  std::lock_guard<std::mutex> lk(g_reg_m);
  uintptr_t pos = (uintptr_t)p;
  const uintptr_t end = pos + len;
  auto it = g_reg.upper_bound(pos);
  if (it == g_reg.begin()) return false;
  --it;
  // adjacent registrations cover jointly, as per-page pinning does
  while (it != g_reg.end() && it->first <= pos) {
    if (it->first + it->second >= end) return true;
    pos = it->first + it->second;
    ++it;
  }
  return false;
}

bool writable_mapping(const void* p) {
  FILE* f = std::fopen("/proc/self/maps", "r");
  if (!f) return true;
  char line[512];
  const unsigned long a = (unsigned long)(uintptr_t)p;
  bool w = true;
  while (std::fgets(line, sizeof line, f)) {
    unsigned long lo = 0, hi = 0;
    char perms[8] = {0};
    if (std::sscanf(line, "%lx-%lx %7s", &lo, &hi, perms) == 3 && a >= lo &&
        a < hi) {
      w = perms[1] == 'w';
      break;
    }
  }
  std::fclose(f);
  return w;
}

// per-device service channels (EBT_MOCK_CUDA_XFER_US)
struct Channel {
  std::mutex m;
  Clock::time_point busy_until{};
};
Channel g_channels[kMaxDevices];

// per (src, dst) pair channels of device-to-device copies
Channel g_pair_channels[kMaxDevices * kMaxDevices];

Clock::time_point reserve_on(Channel& ch, int us) {
  std::lock_guard<std::mutex> lk(ch.m);
  auto now = Clock::now();
  auto start = ch.busy_until > now ? ch.busy_until : now;
  ch.busy_until = start + std::chrono::microseconds(us);
  return ch.busy_until;
}

Clock::time_point reserve_service(int dev, int us) {
  Channel& ch = g_channels[dev % kMaxDevices];
  std::lock_guard<std::mutex> lk(ch.m);
  auto now = Clock::now();
  auto start = ch.busy_until > now ? ch.busy_until : now;
  ch.busy_until = start + std::chrono::microseconds(us);
  return ch.busy_until;
}

struct Op {
  std::function<void()> fn;
  Clock::time_point not_before{};
  int service_us = 0;
  int pair_src = -1;  // a device-to-device copy: served on the pair channel
  std::string fault;  // EBT_MOCK_CUDA_DEV_FAIL_AT: puts the stream in error
  // EBT_MOCK_CUDA_D2D_FAIL_AT: this copy fails and drops the completion
  // behind it
  std::string transient;
  bool completion = false;  // a host function or event record
  bool always = false;  // runs on a stream in error too (a stream-ordered
                        // free, so the mock does not leak its memory)
};

struct Stream {
  int device = 0;
  std::mutex m;
  std::condition_variable cv;       // work arrived / stop
  std::condition_variable idle_cv;  // queue drained
  std::deque<Op> q;
  bool busy = false;
  bool stop = false;
  std::string fault;  // non-empty: the stream is in error, work is dropped
  std::string drop_next;  // a failed copy's fault: drop the next completion
  std::string transient;  // reported once by the next query or wait
  std::thread worker;

  void run() {
    std::unique_lock<std::mutex> lk(m);
    for (;;) {
      cv.wait(lk, [this] { return stop || !q.empty(); });
      if (q.empty()) return;  // stop requested and drained
      Op op = std::move(q.front());
      q.pop_front();
      busy = true;
      const bool dropped = !fault.empty() && !op.always;
      lk.unlock();
      bool drop_this = false;
      if (!dropped && op.completion) {
        lk.lock();
        if (!drop_next.empty()) {
          transient = drop_next;
          drop_next.clear();
          drop_this = true;
        }
        lk.unlock();
      }
      if (!dropped && !drop_this) {
        if (op.not_before > Clock::now())
          std::this_thread::sleep_until(op.not_before);
        if (op.service_us > 0)
          std::this_thread::sleep_until(
              op.pair_src >= 0
                  ? reserve_on(g_pair_channels[(op.pair_src % kMaxDevices) *
                                                   kMaxDevices +
                                               device % kMaxDevices],
                               op.service_us)
                  : reserve_service(device, op.service_us));
        if (op.fault.empty() && op.transient.empty()) op.fn();
      }
      lk.lock();
      if (!dropped && !op.transient.empty()) drop_next = op.transient;
      if (!dropped && !op.fault.empty()) fault = op.fault;
      busy = false;
      if (q.empty()) idle_cv.notify_all();
    }
  }
  void push(Op op) {
    std::lock_guard<std::mutex> lk(m);
    q.push_back(std::move(op));
    cv.notify_one();
  }
  void sync() {
    std::unique_lock<std::mutex> lk(m);
    idle_cv.wait(lk, [this] { return q.empty() && !busy; });
  }
  bool idle() {
    std::lock_guard<std::mutex> lk(m);
    return q.empty() && !busy;
  }
  // the sticky fault, else a pending transient one (reported once)
  std::string error() {
    std::lock_guard<std::mutex> lk(m);
    if (!fault.empty()) return fault;
    std::string t;
    t.swap(transient);
    return t;
  }
};

struct Event {
  std::mutex m;
  std::condition_variable cv;
  uint64_t recorded = 0;
  uint64_t completed = 0;
  Stream* stream = nullptr;  // of the last record
};

Op copy_op(std::function<void()> fn) {
  Op op;
  op.fn = std::move(fn);
  int delay = env_int("EBT_MOCK_CUDA_DELAY_US");
  if (delay > 0)
    op.not_before = Clock::now() + std::chrono::microseconds(delay);
  op.service_us = env_int("EBT_MOCK_CUDA_XFER_US");
  return op;
}

void land(const char* data, uint64_t n) {
  uint64_t sum = 0;
  for (uint64_t i = 0; i < n; i++) sum += (unsigned char)data[i];
  g_checksum += sum;
  g_total_bytes += n;
}

// the device pattern word i = base + 8*i, as verify.cu / fill.cu define it
void verify_host(const uint32_t* lanes, uint64_t n_lanes, uint64_t base,
                 int64_t* out) {
  const uint64_t n_words = n_lanes / 2;
  uint64_t bad_lanes = 0, bad_words = 0, first = n_words;
  for (uint64_t w = 0; w < n_words; w++) {
    uint64_t got;
    std::memcpy(&got, lanes + 2 * w, 8);
    const uint64_t x = got ^ (base + 8 * w);
    bad_lanes += ((uint32_t)x != 0) + ((uint32_t)(x >> 32) != 0);
    if (x) {
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

}  // namespace

extern "C" {

// ---- driver entries (the subset csrc/cuda_api.h declares) ----

CUresult cuGetErrorString(CUresult error, const char** str) {
  switch (error) {
    case kOk: *str = "no error"; break;
    case kInvalidValue: *str = "invalid argument"; break;
    case kNotReady: *str = "device not ready"; break;
    case kOsCallFailed:
      *str = "OS call failed or operation not supported on this OS";
      break;
    case kAlreadyRegistered:
      *str = "part or all of the requested memory range is already mapped";
      break;
    case kNotRegistered: *str = "pointer does not correspond to a registered memory region"; break;
    case kNotSupported: *str = "operation not supported"; break;
    case kInjected:
      *str = t_injected.empty() ? "unknown error" : t_injected.c_str();
      break;
    default: *str = "unrecognized error code"; break;
  }
  return kOk;
}

CUresult cuInit(unsigned) { return kOk; }

CUresult cuDeviceGetCount(int* count) {
  int n = env_int("EBT_MOCK_CUDA_DEVICES", 1);
  *count = n < 0 ? 0 : (n > kMaxDevices ? kMaxDevices : n);
  return kOk;
}

CUresult cuDeviceGet(int* device, int ordinal) {
  int n = 0;
  cuDeviceGetCount(&n);
  if (ordinal < 0 || ordinal >= n) return kInvalidValue;
  *device = ordinal;
  return kOk;
}

CUresult cuDeviceGetAttribute(int* value, int attrib, int) {
  switch (attrib) {
    case 16:  // multiprocessor count
      *value = 132;
      return kOk;
    case 99:  // host register supported
      *value = env_int("EBT_MOCK_CUDA_NO_HOSTREG") ? 0 : 1;
      return kOk;
    case 113:  // read-only host register supported
      *value = 1;
      return kOk;
    case 115:  // memory pools supported
      *value = env_int("EBT_MOCK_CUDA_NO_XFERMGR") ? 0 : 1;
      return kOk;
    default:
      return kInvalidValue;
  }
}

CUresult cuDevicePrimaryCtxRetain(void** ctx, int device) {
  if (device < 0 || device >= kMaxDevices) return kInvalidValue;
  g_ctx[device].device = device;
  *ctx = &g_ctx[device];
  return kOk;
}

CUresult cuDevicePrimaryCtxRelease_v2(int) { return kOk; }

CUresult cuCtxSetCurrent(void* ctx) {
  t_device = ctx ? static_cast<Ctx*>(ctx)->device : 0;
  return kOk;
}

CUresult cuStreamCreate(void** stream, unsigned) {
  auto* s = new Stream();
  s->device = t_device;
  s->worker = std::thread([s] { s->run(); });
  *stream = s;
  return kOk;
}

CUresult cuStreamDestroy_v2(void* stream) {
  auto* s = static_cast<Stream*>(stream);
  {
    std::lock_guard<std::mutex> lk(s->m);
    s->stop = true;
    s->cv.notify_all();
  }
  s->worker.join();
  delete s;
  return kOk;
}

CUresult cuStreamSynchronize(void* stream) {
  auto* s = static_cast<Stream*>(stream);
  s->sync();
  std::string fault = s->error();
  return fault.empty() ? kOk : inject(fault.c_str());
}

CUresult cuStreamQuery(void* stream) {
  auto* s = static_cast<Stream*>(stream);
  std::string fault = s->error();
  if (!fault.empty()) return inject(fault.c_str());
  return s->idle() ? kOk : kNotReady;
}

CUresult cuEventCreate(void** event, unsigned) {
  *event = new Event();
  return kOk;
}

CUresult cuEventDestroy_v2(void* event) {
  delete static_cast<Event*>(event);
  return kOk;
}

CUresult cuEventRecord(void* event, void* stream) {
  uint64_t n = ++g_completion_calls;
  if (env_int("EBT_MOCK_CUDA_FAIL_READY_AT") == (long long)n)
    return inject("mock completion failure (EBT_MOCK_CUDA_FAIL_READY_AT)");
  auto* e = static_cast<Event*>(event);
  uint64_t gen;
  {
    std::lock_guard<std::mutex> lk(e->m);
    gen = ++e->recorded;
    e->stream = static_cast<Stream*>(stream);
  }
  Op op;
  op.completion = true;
  op.fn = [e, gen] {
    std::lock_guard<std::mutex> lk(e->m);
    e->completed = gen;
    e->cv.notify_all();
  };
  static_cast<Stream*>(stream)->push(std::move(op));
  return kOk;
}

CUresult cuEventSynchronize(void* event) {
  auto* e = static_cast<Event*>(event);
  std::unique_lock<std::mutex> lk(e->m);
  // a stream in error never reaches the record: report its fault instead
  while (!e->cv.wait_for(lk, std::chrono::milliseconds(2),
                         [e] { return e->completed >= e->recorded; })) {
    std::string fault = e->stream ? e->stream->error() : std::string();
    if (!fault.empty()) return inject(fault.c_str());
  }
  return kOk;
}

CUresult cuLaunchHostFunc(void* stream, void (*fn)(void*), void* arg) {
  if (env_int("EBT_MOCK_CUDA_HOSTFUNC_UNSUPPORTED")) return kNotSupported;
  uint64_t n = ++g_completion_calls;
  if (env_int("EBT_MOCK_CUDA_FAIL_READY_AT") == (long long)n)
    return inject("mock completion failure (EBT_MOCK_CUDA_FAIL_READY_AT)");
  Op op;
  op.completion = true;
  op.fn = [fn, arg] { fn(arg); };
  static_cast<Stream*>(stream)->push(std::move(op));
  return kOk;
}

CUresult cuMemAlloc_v2(unsigned long long* dptr, size_t bytes) {
  const long long max_bytes = env_ll("EBT_MOCK_CUDA_ALLOC_MAX_BYTES");
  if (max_bytes > 0 && (long long)bytes > max_bytes)
    return inject("mock allocation failure "
                  "(EBT_MOCK_CUDA_ALLOC_MAX_BYTES)");
  void* p = std::calloc(1, bytes ? bytes : 1);
  if (!p) return 2;  // CUDA_ERROR_OUT_OF_MEMORY
  g_live_buffers++;
  *dptr = (unsigned long long)(uintptr_t)p;
  return kOk;
}

CUresult cuMemFree_v2(unsigned long long dptr) {
  std::free((void*)(uintptr_t)dptr);
  g_live_buffers--;
  return kOk;
}

CUresult cuMemcpyHtoDAsync_v2(unsigned long long dst, const void* src,
                              size_t bytes, void* stream) {
  if (pool_alloc((uintptr_t)dst, bytes)) {
    // into a tier block buffer: its own counter and seam
    uint64_t n = ++g_xfer_copy_calls;
    if (env_int("EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT") == (long long)n)
      return inject("mock tier copy failure "
                    "(EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT)");
    char* d = (char*)(uintptr_t)dst;
    auto* st = static_cast<Stream*>(stream);
    if (registered(src, bytes)) {
      st->push(copy_op([d, src, bytes] {
        std::memcpy(d, src, bytes);
        land(d, bytes);
      }));
    } else {
      auto staged = std::make_shared<std::vector<char>>(
          (const char*)src, (const char*)src + bytes);
      st->push(copy_op([d, staged, bytes] {
        std::memcpy(d, staged->data(), bytes);
        land(d, bytes);
      }));
    }
    return kOk;
  }
  uint64_t n = ++g_h2d_calls;
  if (env_int("EBT_MOCK_CUDA_FAIL_AT") == (long long)n)
    return inject("mock transfer failure (EBT_MOCK_CUDA_FAIL_AT)");
  auto* st = static_cast<Stream*>(stream);
  const int sdev = st->device % kMaxDevices;
  const uint64_t dev_n = ++g_dev_h2d[sdev];
  const char* df = std::getenv("EBT_MOCK_CUDA_DEV_FAIL_AT");
  int fdev = -1, fn = 0;
  if (df && *df && std::sscanf(df, "%d:%d", &fdev, &fn) == 2 &&
      fdev == sdev && fn > 0 && dev_n == (uint64_t)fn) {
    Op op = copy_op([] {});
    op.fault = "mock stripe transfer failure (EBT_MOCK_CUDA_DEV_FAIL_AT "
               "device " + std::to_string(fdev) + ")";
    st->push(std::move(op));
    return kOk;
  }
  char* d = (char*)(uintptr_t)dst;
  if (registered(src, bytes)) {
    // pinned source: read when the copy runs, so a premature reuse of the
    // host buffer corrupts what lands; a source unpinned before then faults
    // the stream, as the copy engine's read of unmapped memory does
    Op op = copy_op({});
    op.fn = [d, src, bytes, st] {
      if (!registered(src, bytes)) {
        std::lock_guard<std::mutex> lk(st->m);
        if (st->fault.empty())
          st->fault = "mock copy from host memory unregistered while the "
                      "copy was in flight";
        return;
      }
      std::memcpy(d, src, bytes);
      land(d, bytes);
    };
    st->push(std::move(op));
  } else {
    // pageable source: taken at the call, like the driver's staging copy
    auto staged = std::make_shared<std::vector<char>>((const char*)src,
                                                      (const char*)src + bytes);
    static_cast<Stream*>(stream)->push(copy_op([d, staged, bytes] {
      std::memcpy(d, staged->data(), bytes);
      land(d, bytes);
    }));
  }
  return kOk;
}

CUresult cuMemcpyDtoHAsync_v2(void* dst, unsigned long long src, size_t bytes,
                              void* stream) {
  uint64_t n = ++g_d2h_calls;
  if (env_int("EBT_MOCK_CUDA_XFER_FAIL_AT") == (long long)n)
    return inject("mock d2h fetch failure (EBT_MOCK_CUDA_XFER_FAIL_AT)");
  const char* s = (const char*)(uintptr_t)src;
  auto* st = static_cast<Stream*>(stream);
  st->push(copy_op([dst, s, bytes] { std::memcpy(dst, s, bytes); }));
  // into pageable memory the call returns only once the copy has landed
  if (!registered(dst, bytes)) {
    st->sync();
    std::string fault = st->error();
    if (!fault.empty()) return inject(fault.c_str());
  }
  return kOk;
}

// device-to-device copies (the reshard move tier): the pair (src device,
// dst stream's device) owns a service channel
static CUresult d2d_copy(unsigned long long dst, unsigned long long src,
                         size_t bytes, int src_dev, void* stream) {
  if (env_int("EBT_MOCK_CUDA_NO_D2D")) return kNotSupported;
  const uint64_t n = ++g_d2d_calls;
  auto* st = static_cast<Stream*>(stream);
  char* d = (char*)(uintptr_t)dst;
  const char* s = (const char*)(uintptr_t)src;
  Op op;
  op.fn = [d, s, bytes] {
    std::memmove(d, s, bytes);
    land(d, bytes);
  };
  int delay = env_int("EBT_MOCK_CUDA_DELAY_US");
  if (delay > 0)
    op.not_before = Clock::now() + std::chrono::microseconds(delay);
  int us = env_int("EBT_MOCK_CUDA_D2D_US");
  op.service_us = us > 0 ? us : env_int("EBT_MOCK_CUDA_XFER_US");
  op.pair_src = src_dev;
  if (env_int("EBT_MOCK_CUDA_D2D_FAIL_AT") == (long long)n)
    op.transient = "mock d2d move failure (EBT_MOCK_CUDA_D2D_FAIL_AT)";
  st->push(std::move(op));
  return kOk;
}

CUresult cuMemcpyPeerAsync(unsigned long long dst, void*,
                           unsigned long long src, void* src_ctx, size_t bytes,
                           void* stream) {
  return d2d_copy(dst, src, bytes,
                  src_ctx ? static_cast<Ctx*>(src_ctx)->device : 0, stream);
}

CUresult cuMemcpyDtoDAsync_v2(unsigned long long dst, unsigned long long src,
                              size_t bytes, void* stream) {
  return d2d_copy(dst, src, bytes, static_cast<Stream*>(stream)->device,
                  stream);
}

CUresult cuDeviceCanAccessPeer(int* can, int dev, int peer) {
  *can = dev != peer ? 1 : 0;
  return kOk;
}

CUresult cuCtxEnablePeerAccess(void*, unsigned) { return kOk; }

// ---- the stream-ordered allocator (the transfer-manager tier) ----

CUresult cuMemAllocAsync(unsigned long long* dptr, size_t bytes, void*) {
  if (env_int("EBT_MOCK_CUDA_XFERMGR_FAIL"))
    return inject("mock tier allocation failure (EBT_MOCK_CUDA_XFERMGR_FAIL)");
  void* p = std::calloc(1, bytes ? bytes : 1);
  if (!p) return 2;  // CUDA_ERROR_OUT_OF_MEMORY
  {
    std::lock_guard<std::mutex> lk(g_pool_m);
    g_pool_allocs[(uintptr_t)p] = bytes ? bytes : 1;
  }
  g_live_buffers++;
  g_xfer_mgr_allocs++;
  *dptr = (unsigned long long)(uintptr_t)p;
  return kOk;
}

CUresult cuMemFreeAsync(unsigned long long dptr, void* stream) {
  {
    std::lock_guard<std::mutex> lk(g_pool_m);
    if (!g_pool_allocs.count((uintptr_t)dptr)) return kInvalidValue;
  }
  // freed when the stream reaches it: the copies queued before it still
  // write into the buffer
  Op op;
  op.always = true;
  op.fn = [dptr] {
    {
      std::lock_guard<std::mutex> lk(g_pool_m);
      g_pool_allocs.erase((uintptr_t)dptr);
    }
    std::free((void*)(uintptr_t)dptr);
    g_live_buffers--;
  };
  static_cast<Stream*>(stream)->push(std::move(op));
  return kOk;
}

CUresult cuDeviceGetDefaultMemPool(void** pool, int dev) {
  if (dev < 0 || dev >= kMaxDevices) return kInvalidValue;
  *pool = &g_pools[dev];
  return kOk;
}

// host memory is never handed back: the release threshold has no effect
CUresult cuMemPoolSetAttribute(void* pool, int attr, void* value) {
  return pool && value && attr == 4 ? kOk : kInvalidValue;
}

CUresult cuMemPoolTrimTo(void* pool, size_t) {
  return pool ? kOk : kInvalidValue;
}

CUresult cuMemsetD8Async(unsigned long long dst, unsigned char value,
                         size_t bytes, void* stream) {
  void* d = (void*)(uintptr_t)dst;
  Op op;
  op.fn = [d, value, bytes] { std::memset(d, value, bytes); };
  static_cast<Stream*>(stream)->push(std::move(op));
  return kOk;
}

CUresult cuMemHostRegister_v2(void* p, size_t bytes, unsigned flags) {
  uint64_t n = ++g_hostreg_calls;
  if (env_int("EBT_MOCK_CUDA_NO_HOSTREG")) return kNotSupported;
  if (env_int("EBT_MOCK_CUDA_HOSTREG_FAIL"))
    return inject("mock host registration failure "
                  "(EBT_MOCK_CUDA_HOSTREG_FAIL)");
  int at = env_int("EBT_MOCK_CUDA_HOSTREG_FAIL_AT");
  if (at > 0 && n == (uint64_t)at)
    return inject("mock host registration failure "
                  "(EBT_MOCK_CUDA_HOSTREG_FAIL_AT)");
  int after = env_int("EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER");
  if (after > 0 && n > (uint64_t)after)
    return inject("mock host registration failure "
                  "(EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER)");
  long long max_bytes = env_ll("EBT_MOCK_CUDA_HOSTREG_MAX_BYTES");
  if (max_bytes > 0 && (long long)bytes > max_bytes)
    return inject("mock host registration failure: range exceeds "
                  "EBT_MOCK_CUDA_HOSTREG_MAX_BYTES");
  if (!(flags & 0x08) && !writable_mapping(p)) return kOsCallFailed;
  std::lock_guard<std::mutex> lk(g_reg_m);
  const uintptr_t b = (uintptr_t)p;
  for (const auto& kv : g_reg)
    if (kv.first < b + bytes && b < kv.first + kv.second)
      return kAlreadyRegistered;
  g_reg[b] = bytes;
  return kOk;
}

CUresult cuMemHostUnregister(void* p) {
  if (int us = env_int("EBT_MOCK_CUDA_UNREGISTER_US"))
    std::this_thread::sleep_for(std::chrono::microseconds(us));
  std::lock_guard<std::mutex> lk(g_reg_m);
  auto it = g_reg.find((uintptr_t)p);
  if (it == g_reg.end()) return kNotRegistered;
  g_reg.erase(it);
  return kOk;
}

CUresult cuMemHostAlloc(void** pp, size_t bytes, unsigned) {
  void* p = nullptr;
  if (posix_memalign(&p, 4096, bytes ? bytes : 1)) return 2;
  std::memset(p, 0, bytes);
  std::lock_guard<std::mutex> lk(g_reg_m);
  g_reg[(uintptr_t)p] = bytes ? bytes : 1;  // pinned from birth
  *pp = p;
  return kOk;
}

CUresult cuMemFreeHost(void* p) {
  {
    std::lock_guard<std::mutex> lk(g_reg_m);
    g_reg.erase((uintptr_t)p);
  }
  std::free(p);
  return kOk;
}

// ---- the kernels' C entries, run in stream order on the host ----

uint64_t ebt_verify_workspace_bytes(int) { return 8; }

int ebt_verify_u32(const void* data, uint64_t n_lanes, uint64_t base,
                   void* out, void*, int sms, void* stream) {
  if (sms < 1 || !stream) return kInvalidValue;
  auto* s = static_cast<Stream*>(stream);
  g_exec[s->device % kMaxDevices]++;
  Op op;
  op.fn = [data, n_lanes, base, out] {
    verify_host((const uint32_t*)data, n_lanes, base, (int64_t*)out);
  };
  s->push(std::move(op));
  return kOk;
}

int ebt_fill_u64(void* dst, uint64_t n_words, uint64_t base, void* stream) {
  if (!stream) return kInvalidValue;
  auto* s = static_cast<Stream*>(stream);
  g_exec[s->device % kMaxDevices]++;
  Op op;
  op.fn = [dst, n_words, base] {
    uint64_t* w = (uint64_t*)dst;
    for (uint64_t i = 0; i < n_words; i++) w[i] = base + 8 * i;
  };
  s->push(std::move(op));
  return kOk;
}

// ---- test helpers ----

uint64_t ebt_mock_total_bytes() { return g_total_bytes; }
uint64_t ebt_mock_checksum() { return g_checksum; }
uint64_t ebt_mock_exec_count(int dev) {
  return dev >= 0 && dev < kMaxDevices ? g_exec[dev].load() : 0;
}
uint64_t ebt_mock_dev_h2d_count(int dev) {
  return dev >= 0 && dev < kMaxDevices ? g_dev_h2d[dev].load() : 0;
}
uint64_t ebt_mock_hostreg_active() {
  std::lock_guard<std::mutex> lk(g_reg_m);
  return g_reg.size();
}
int64_t ebt_mock_live_buffers() { return g_live_buffers; }
uint64_t ebt_mock_h2d_count() { return g_h2d_calls; }
uint64_t ebt_mock_completion_count() { return g_completion_calls; }
uint64_t ebt_mock_d2d_count() { return g_d2d_calls; }
uint64_t ebt_mock_xfer_mgr_count() { return g_xfer_mgr_allocs; }

// zero the counters; the live-buffer and registration gauges stay, so a
// test can reset after prepare and still check the teardown balance
void ebt_mock_reset() {
  g_total_bytes = 0;
  g_checksum = 0;
  g_h2d_calls = 0;
  g_d2h_calls = 0;
  g_completion_calls = 0;
  g_d2d_calls = 0;
  g_hostreg_calls = 0;
  g_xfer_mgr_allocs = 0;
  g_xfer_copy_calls = 0;
  for (auto& e : g_exec) e = 0;
  for (auto& e : g_dev_h2d) e = 0;
}

}  // extern "C"
