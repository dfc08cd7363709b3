/* Native storage <-> GPU transfer engine over the CUDA driver API: the
 * port's `--tpubackend pjrt` data path (the flag keeps its name for CLI and
 * result-tree parity with the original package).
 *
 * CudaPath ports the part of the original package's PjrtPath
 * (core/include/ebt/pjrt_path.h, core/src/pjrt_path.cpp) that the read and
 * write legs run, with no Python on the hot path. DevCopyFn directions:
 *   0   host buffer -> device, chunked cuMemcpyHtoDAsync on the lane's H2D
 *       stream; completion deferred to the pre-reuse barrier (direction 2).
 *       With --verify the block is checked on the device instead: its chunks
 *       land in one device block buffer and the verify kernel (csrc/verify.cu)
 *       is launched once per block, synchronously.
 *   1   device -> host buffer (write-phase source): the pattern generated on
 *       the device by the fill kernel (csrc/fill.cu) on verified writes, the
 *       block this rank just staged (direction 3) when it has one, else
 *       rotating rank-seeded random device sources. --d2hdepth > 1 defers the
 *       fetches to the direction-7 barrier.
 *   3   verify round trip: stage the block synchronously so the next
 *       direction-1 fetch serves the same bytes back.
 *   4/5/6  registration: cuMemHostRegister in place of PJRT's DmaMap, with
 *       the same lifetime pins and --regwindow LRU window cache, sharing the
 *       engine's UringReg slot authority.
 *   2/7 the pre-reuse and pre-write barriers.
 * Every other direction (stripe, checkpoint, ingest, reshard, rotation) is
 * not ported: it returns 1 with a latched cause.
 *
 * Tiers. A copy from registered (pinned) host memory is an asynchronous DMA:
 * that is the "zero-copy" tier, under the original's field names
 * (zero_copy_count, tier zero_copy). A copy from pageable memory is staged by
 * the driver through its own pinned buffer and is host-synchronous for its
 * source: the "staged" tier. A failed registration drops that buffer (or
 * window) to the staged tier with its cause in regError(), as a failed DmaMap
 * does in the original.
 *
 * Completion. Each chunk's copy is followed on its stream by a host function
 * (cuLaunchHostFunc) that stamps the per-device latency, marks the chunk's
 * tracker done and wakes the submitting worker's reactor: the "onready"
 * clock. With EBT_PJRT_NO_READY / EBT_PJRT_NO_LATENCY, or a driver that
 * refuses host functions, an event recorded behind the copy is awaited at the
 * barrier instead and latency is sampled there: the "await" clock.
 *
 * Device memory is never allocated or freed per chunk (cuMemFree synchronises
 * the device): per lane a landing buffer and the verify workspace are made at
 * construction / enableVerify, per (rank, lane) the verify block buffer, the
 * round-trip buffer, the fill output and the verify result at first use, and
 * the rotating write sources once per (rank, length, variant). They are freed
 * at teardown.
 *
 * Streams: one H2D and one D2H stream per device lane, so the copy engines of
 * the two directions overlap. A host function blocks its stream while it
 * runs, so the trampoline takes one leaf lock and calls no driver API.
 *
 * Lock hierarchy (as in PjrtPath): reg_mutex_ > QueueShard::m > {err_mutex_,
 * src_mutex_, rank_mutex_, Lane::histo_m, Tracker::m}.
 */
#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <map>
#include <memory>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

#include "cuda_api.h"
#include "ebt/annotate.h"
#include "ebt/histogram.h"

namespace ebt {

class CudaPath {
 public:
  // Never throws: check ok()/error() after construction. device_ids selects
  // CUDA device ordinals (--gpuids); empty = every device the driver sees.
  CudaPath(const std::string& driver_path, uint64_t chunk_bytes,
           uint64_t block_size, const std::vector<int>& device_ids);
  ~CudaPath();
  CudaPath(const CudaPath&) = delete;
  CudaPath& operator=(const CudaPath&) = delete;

  bool ok() const { return init_error_.empty(); }
  const std::string& error() const { return init_error_; }
  int numDevices() const { return (int)lanes_.size(); }

  // DevCopyFn (engine.h): 0 ok, 1 transfer error, 2 verify mismatch.
  int copy(int worker_rank, int device_idx, int direction, void* buf,
           uint64_t len, uint64_t file_offset);
  static int copyTrampoline(void* ctx, int worker_rank, int device_idx,
                            int direction, void* buf, uint64_t len,
                            uint64_t file_offset);

  // ---- registration tier ----
  bool dmaSupported() const { return dma_ok_; }
  int registerBuffer(void* buf, uint64_t len) EBT_EXCLUDES(reg_mutex_);
  int deregisterBuffer(void* buf) EBT_EXCLUDES(reg_mutex_);
  std::string regError() const EBT_EXCLUDES(reg_mutex_);
  void setRegWindow(uint64_t bytes) EBT_EXCLUDES(reg_mutex_);
  int registerWindow(void* buf, uint64_t len) EBT_EXCLUDES(reg_mutex_);
  void deregisterRange(void* buf, uint64_t len) EBT_EXCLUDES(reg_mutex_);
  struct RegCacheStats {
    uint64_t hits = 0, misses = 0, evictions = 0;
    uint64_t pinned_bytes = 0, pinned_peak_bytes = 0, staged_fallbacks = 0;
  };
  RegCacheStats regCacheStats() const EBT_EXCLUDES(reg_mutex_);
  uint64_t zeroCopyCount() const {
    return zero_copy_count_.load(std::memory_order_relaxed);
  }
  // true when hot-path copies from registered memory take the zero-copy
  // gate: capability, and not the EBT_PJRT_NO_READY diagnostic (which the
  // original also excludes from the tier)
  bool zeroCopyEngaged() const { return dma_ok_ && !no_ready_diag_; }
  bool onReadyClock() const {
    return onready_ok_.load(std::memory_order_relaxed);
  }

  // ---- lanes ----
  struct LaneStats {
    uint64_t submits = 0, awaits = 0, lock_wait_ns = 0;
    uint64_t bytes_to_hbm = 0, bytes_from_hbm = 0;
  };
  bool laneStats(int lane, LaneStats* out) const;
  bool singleLane() const { return single_lane_; }

  // ---- on-device kernels (enabled before the first data copy) ----
  // kernel_lib: the library exporting ebt_verify_u32 /
  // ebt_verify_workspace_bytes / ebt_fill_u64. "" ok, else the cause.
  std::string enableVerify(uint64_t salt, const std::string& kernel_lib);
  std::string enableWriteGen(uint64_t salt, const std::string& kernel_lib);
  // Kernel launches made by every path of the process (like the Python
  // wrappers' counters): out[0] = verify kernel, out[1] = fill kernel
  static void kernelLaunches(uint64_t out[2]);
  static void resetKernelLaunches();

  void stats(uint64_t* bytes_to_hbm, uint64_t* bytes_from_hbm) const;
  bool deviceLatency(int device_idx, LatencyHistogram* out) const;
  void resetDeviceLatency();
  std::string firstTransferError() const EBT_EXCLUDES(err_mutex_);

  // ---- deferred D2H ----
  void setD2HDepth(int depth) {
    d2h_depth_.store(depth < 1 ? 1 : depth, std::memory_order_relaxed);
  }
  // out[0] = deferred blocks, out[1] = ns the pre-write barriers blocked,
  // out[2] = bytes whose fetch had completed before its barrier started
  void d2hStats(uint64_t out[3]) const;

  void drainAll();

 private:
  using Clock = std::chrono::steady_clock;

  // one copy's completion: signalled by the host function behind it
  struct Tracker {
    CudaPath* path = nullptr;
    int device = -1;  // latency attribution; -1 = no sample
    Clock::time_point t0{};
    int reactor_fd = -1;
    Mutex m;
    std::condition_variable cv;
    bool done EBT_GUARDED_BY(m) = false;
  };
  struct Pending {
    Tracker* tracker = nullptr;   // onready clock
    cu::CUevent event = nullptr;  // await clock
    cu::CUstream stream = nullptr;
    int lane = 0;
    int device = -1;  // await-clock latency attribution
    Clock::time_point t0{};
    uint64_t bytes = 0;  // counted at enqueue; undone on a failed settle
    bool d2h = false;
    bool ready_failed = false;  // completion could not be attached
  };
  struct QueueShard {
    mutable Mutex m;
    std::condition_variable cv;
    std::unordered_map<uint64_t, std::vector<Pending>> pending
        EBT_GUARDED_BY(m);
    std::unordered_map<uint64_t, uint64_t> draining EBT_GUARDED_BY(m);
  };
  static constexpr int kQueueShards = 16;
  static constexpr int kSrcVariants = 4;

  struct Lane {
    cu::CUdevice dev = 0;
    cu::CUcontext ctx = nullptr;
    bool ctx_retained = false;
    cu::CUstream h2d = nullptr;
    cu::CUstream d2h = nullptr;
    int sms = 0;
    bool host_register = false;
    bool read_only_register = false;
    // where read-phase chunks land; the H2D stream orders every write to it
    cu::CUdeviceptr landing = 0;
    cu::CUdeviceptr verify_ws = 0;  // used on the H2D stream only
    std::atomic<uint64_t> submits{0};
    std::atomic<uint64_t> awaits{0};
    std::atomic<uint64_t> lock_wait_ns{0};
    std::atomic<uint64_t> bytes_to_hbm{0};
    std::atomic<uint64_t> bytes_from_hbm{0};
    mutable Mutex histo_m;
    LatencyHistogram histo EBT_GUARDED_BY(histo_m);
  };
  // per (worker rank, lane) device buffers; used only by that rank's thread
  struct RankBufs {
    int lane = 0;
    cu::CUdeviceptr verify = 0, staged = 0, gen = 0, result = 0;
    uint64_t verify_cap = 0, staged_cap = 0, gen_cap = 0;
    int64_t* host = nullptr;  // pinned: verify result int64[3] + one word
    uint64_t staged_len = 0;  // bytes of the last round trip; 0 = none
  };
  struct RegEntry {
    uint64_t len = 0;
    uint64_t lru_seq = 0;
    bool window = false;
    int uring_idx = -1;
  };

  QueueShard& shardFor(const void* buf) const {
    uint64_t h = ((uint64_t)(uintptr_t)buf >> 12) * 0x9E3779B97F4A7C15ull;
    return *shards_[(h >> 32) % shards_.size()];
  }
  int laneIndex(int device_idx) const {
    return (device_idx < 0 ? 0 : device_idx) % (int)lanes_.size();
  }
  Lane& laneFor(int device_idx) const {
    return *lanes_[(size_t)laneIndex(device_idx)];
  }

  // Make lane `lane`'s primary context current on the calling thread (worker
  // threads, the thread that prepares, Python's calling threads).
  bool makeCurrent(int lane, bool force);
  void latchXferError(const std::string& msg) EBT_EXCLUDES(err_mutex_);
  void latchRegError(const std::string& msg) EBT_EXCLUDES(reg_mutex_);
  bool check(const char* what, cu::CUresult rc);  // false + latch on error

  static void hostFnTrampoline(void* arg);
  void addDevLatency(int device_idx, uint64_t us);
  void attachCompletion(Pending& p, int lane, cu::CUstream stream,
                        int device_idx, Clock::time_point t0);
  int awaitRelease(Pending& p);
  int syncStream(int lane, cu::CUstream stream);  // all work enqueued so far
  void enqueue(void* buf, std::vector<Pending>& ps) EBT_EXCLUDES(reg_mutex_);

  RankBufs& rankBufs(int worker_rank, int lane) EBT_EXCLUDES(rank_mutex_);
  bool ensureBuffer(int lane, cu::CUdeviceptr* p, uint64_t* cap,
                    uint64_t len);

  int submitH2D(int device_idx, const char* buf, uint64_t len);
  int submitH2DVerified(int worker_rank, int device_idx, const char* buf,
                        uint64_t len, uint64_t file_off);
  int roundTripH2D(int worker_rank, int device_idx, const char* buf,
                   uint64_t len);
  int serveD2H(int worker_rank, int device_idx, char* buf, uint64_t len,
               uint64_t file_off);
  int generateD2H(int worker_rank, int device_idx, char* buf, uint64_t len,
                  uint64_t file_off, bool deferred);
  int fetchDeviceSource(int worker_rank, int device_idx, char* buf,
                        uint64_t len, bool deferred);
  cu::CUdeviceptr deviceSource(int worker_rank, int device_idx, uint64_t len,
                               int variant) EBT_EXCLUDES(src_mutex_);
  int settle(void* buf, int device_idx, bool d2h_barrier);
  void waitShardDrained(QueueShard& shard, uint64_t key) const;

  int hostRegister(void* buf, uint64_t len, bool window, bool reserved)
      EBT_EXCLUDES(reg_mutex_);
  void hostUnregister(void* buf);
  bool bufferRegisteredLocked(const void* p, uint64_t len) const
      EBT_REQUIRES(reg_mutex_);
  bool rangeInTransitLocked(uintptr_t base, uint64_t len) const
      EBT_REQUIRES(reg_mutex_);
  void inflightSpans(std::vector<std::pair<uint64_t, uint64_t>>* out) const;

  cu::Api api_{};
  std::string init_error_;
  uint64_t chunk_bytes_;
  uint64_t block_size_;
  uint64_t landing_cap_ = 0;
  uint64_t gen_;  // instance generation: keys the thread-local context cache
  std::vector<std::unique_ptr<Lane>> lanes_;
  std::vector<std::unique_ptr<QueueShard>> shards_;
  bool single_lane_ = false;
  bool no_ready_diag_ = false;
  bool no_latency_diag_ = false;
  bool dma_ok_ = false;
  std::atomic<bool> onready_ok_{false};
  std::atomic<uint64_t> zero_copy_count_{0};
  std::atomic<int> d2h_depth_{1};
  std::atomic<uint64_t> d2h_deferred_count_{0};
  std::atomic<uint64_t> d2h_await_wait_ns_{0};
  std::atomic<uint64_t> d2h_overlap_bytes_{0};
  std::atomic<bool> sealed_{false};

  // on-device kernels
  bool verify_on_ = false;
  bool write_gen_on_ = false;
  uint64_t verify_salt_ = 0;
  cu::VerifyU32Fn verify_fn_ = nullptr;
  cu::FillU64Fn fill_fn_ = nullptr;
  static inline std::atomic<uint64_t> verify_launches_{0};
  static inline std::atomic<uint64_t> fill_launches_{0};

  mutable Mutex err_mutex_;
  std::string xfer_error_ EBT_GUARDED_BY(err_mutex_);

  mutable Mutex rank_mutex_;
  std::map<std::pair<int, int>, std::unique_ptr<RankBufs>> rank_bufs_
      EBT_GUARDED_BY(rank_mutex_);

  mutable Mutex src_mutex_;
  // (rank, len, variant) -> (lane, device buffer)
  std::map<std::tuple<int, uint64_t, int>, std::pair<int, cu::CUdeviceptr>>
      dev_src_ EBT_GUARDED_BY(src_mutex_);

  mutable Mutex reg_mutex_;
  std::string reg_error_ EBT_GUARDED_BY(reg_mutex_);
  std::map<uintptr_t, RegEntry> registered_ EBT_GUARDED_BY(reg_mutex_);
  std::unordered_map<uintptr_t, uint64_t> in_transit_
      EBT_GUARDED_BY(reg_mutex_);
  uint64_t reg_window_bytes_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t window_bytes_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t pinned_bytes_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t pinned_peak_bytes_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t lru_clock_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t reg_hits_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t reg_misses_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t reg_evictions_ EBT_GUARDED_BY(reg_mutex_) = 0;
  uint64_t reg_staged_fallbacks_ EBT_GUARDED_BY(reg_mutex_) = 0;
};

}  // namespace ebt
