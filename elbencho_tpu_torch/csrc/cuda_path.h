/* Native storage <-> GPU transfer engine over the CUDA driver API: the
 * port's `--tpubackend pjrt` data path (the flag keeps its name for CLI and
 * result-tree parity with the original package).
 *
 * CudaPath ports the part of the original package's PjrtPath
 * (core/include/ebt/pjrt_path.h, core/src/pjrt_path.cpp) that the read and
 * write legs, the stripe tier, checkpoint restore, the N->M reshard, the
 * device fault policy, serving rotation, the DL-ingestion ledger and the
 * transfer-manager tier run, with no Python on the hot path. DevCopyFn
 * directions:
 *   0   host buffer -> device, chunked cuMemcpyHtoDAsync on the lane's H2D
 *       stream; completion deferred to the pre-reuse barrier (direction 2).
 *       Under a stripe plan the planner picks the block's lane; under a
 *       checkpoint plan every chunk is tagged with the worker's shard; with
 *       --tpustripe the block's chunks rotate over the lanes.
 *       With --verify the block is checked on the device instead: its chunks
 *       land in one device block buffer and the verify kernel (csrc/verify.cu)
 *       is launched once per block, synchronously. With the transfer-manager
 *       tier active (EBT_PJRT_XFER_MGR) the block gets a device buffer of
 *       its own instead of the landing buffer (see below); --verify still
 *       takes the verified path first.
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
 *   8   the stripe tier's slice-wide gather barrier (settleAllShards).
 *   9   checkpoint shard begin: tag the worker's following blocks.
 *   10  checkpoint all-resident barrier (settleAllShards).
 *   13  reshard unit begin: tag the worker's following storage reads.
 *   14  reshard move: one plan unit device to device (cuMemcpyPeerAsync
 *       between two devices, cuMemcpyDtoDAsync between two lanes of one
 *       device), per chunk on the destination lane's H2D stream, falling
 *       back per chunk to the host bounce (D2H into pinned scratch, then
 *       H2D) where the copy is refused or disabled (EBT_D2D_DISABLE).
 *   15  the all-resharded barrier (every move and read settled).
 *   11  ingest epoch begin: tag the worker's following blocks with the epoch.
 *   12  ingest all-resident barrier (settleAllShards).
 *   16  serving rotation begin: the calling thread (the engine's rotator)
 *       becomes the background class of generation `len`; `file_offset` is
 *       the lane bucket's byte/s budget.
 *   17  serving rotation swap: record the rotation, publish the fresh
 *       generation, free the previous one.
 * Any other direction returns 1 with a latched cause naming it.
 *
 * Device faults (--retry/--maxerrors). With a device error budget set
 * (setFaultPolicy), a failed copy is resubmitted from its host source onto
 * surviving lanes with bounded backoff, a lane whose errors reach the budget
 * is ejected, and every later placement (stripe planner, checkpoint lanes,
 * plain routing, reshard destinations) is replanned onto survivors. The
 * recovered bytes move to the survivor's counters, so the stripe and
 * checkpoint ledgers reconcile through an ejection. Ejection is per lane
 * (the selected-device index), as in the original's mask: two lanes may
 * share one device (--gpuids 0,0). On a card an asynchronous fault is
 * sticky for the device's primary context, so it takes down every lane of
 * that device; recovery can only land on a lane of another device. The
 * mock's EBT_MOCK_CUDA_DEV_FAIL_AT poisons one stream only.
 *
 * Stripe and checkpoint ledgers. A stripe plan (--stripe rr|contig) maps
 * each read block's file offset onto a lane; a checkpoint plan (--checkpoint)
 * supplies per-shard submitted/resident byte reconciliation, per-lane
 * resident bytes and "device N shard S: cause" attribution. Both are read
 * lock-free on the hot path, so they must be installed before the first
 * data copy. A pending carries its tags to its settle, where awaitRelease
 * counts it (settleStripe, settleCkpt). As in the original, a settled
 * device copy is not retained: "resident" means the bytes arrived and the
 * ledger counted them.
 *
 * Tiers. A copy from registered (pinned) host memory is an asynchronous DMA:
 * that is the "zero-copy" tier, under the original's field names
 * (zero_copy_count, tier zero_copy). A copy from pageable memory is staged by
 * the driver through its own pinned buffer and is host-synchronous for its
 * source: the "staged" tier. A failed registration drops that buffer (or
 * window) to the staged tier with its cause in regError(), as a failed DmaMap
 * does in the original.
 *
 * Transfer-manager tier (EBT_PJRT_XFER_MGR, the original's
 * submitH2DXferMgr, core/src/pjrt_path.cpp:2535). Opt-in and probed at
 * init: it is active only when the variable is set, --tpustripe is off
 * (a block buffer lives on one device) and every lane's device reports
 * memory-pool support and its default pool resolves; then one 8-byte zero
 * block goes through the tier and a barrier. Any failure downgrades the tier
 * with its cause in regError() and leaves no error behind. Per block: one
 * cuMemAllocAsync on the lane's H2D stream, the block's chunks copied into
 * it at their offsets on the same stream, one completion per chunk, then one
 * pending that carries the buffer and the block's only latency sample (t0 =
 * the block's start). The settle that retires that pending frees the buffer
 * with cuMemFreeAsync on the same stream; a block that fails mid-way parks
 * the buffer on its last enqueued chunk (or frees it at once when none was
 * enqueued), so the chunks already copying are waited out first. The pools'
 * release threshold is raised to UINT64_MAX at init, so a synchronise does
 * not hand the pool's memory back and each block reuses it; the pool holds
 * at most the blocks in flight, and teardown sets the threshold back to 0
 * and trims the pool. The tier counts its blocks (xferMgrCount), not
 * zero-copy chunks; a registered source is still held against eviction
 * while its copies run. Its pendings are not recoverable under the fault
 * policy (no survivor walk at submit or at settle), as the original's
 * manager pendings are not. A block of a restoring rotation generation
 * lands in the generation's memory (rotDest) and needs no block buffer; its
 * block pending is the one that counts as retained.
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
 * Serving rotation (--rotate) is the one tier that keeps a model resident.
 * The original retains each chunk's PJRT buffer; here a generation owns one
 * cuMemAlloc per (shard, placement lane), made at that shard's direction-9
 * begin from the checkpoint plan, and every chunk of the restoring
 * generation lands at its file offset inside it, never in the landing ring:
 * on the registered and the staged tier and on a recovery resubmit. A chunk
 * that lands on a lane the plan did not place it on (replanned after an
 * ejection, or recovered onto a survivor) gets a chunk-sized allocation of
 * its own in the same generation. The swap frees the displaced generation
 * (outside the lock), the next begin frees an aborted one, teardown frees
 * both. retained/released count data-carrying pendings, as the original's
 * buffers do, so both packages report the same numbers whatever the layout.
 *
 * DL ingestion (--ingest) keeps the original's per-epoch byte ledger: read
 * at entry, submitted at enqueue, resident or dropped at settle (a submit
 * failure drops the bytes it did not enqueue), the in-flight gauge and its
 * peak, batch coalescing. Its chunks land in the landing ring like any read.
 *
 * Streams: one H2D and one D2H stream per device lane, so the copy engines of
 * the two directions overlap. A host function blocks its stream while it
 * runs, so the trampoline takes one leaf lock and calls no driver API.
 *
 * Lock hierarchy (as in PjrtPath): reg_mutex_ > QueueShard::m > {err_mutex_,
 * src_mutex_, rank_mutex_, Lane::histo_m, Tracker::m}; stripe_mutex_,
 * ckpt_mutex_, fault_mutex_, reshard_mutex_, ingest_mutex_, rot_mutex_ and
 * bg_mutex_ are leaves that never nest with err_mutex_.
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
  // stripe: --tpustripe, a block's chunks rotate over the lanes
  CudaPath(const std::string& driver_path, uint64_t chunk_bytes,
           uint64_t block_size, bool stripe,
           const std::vector<int>& device_ids);
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
  // capability, not the transfer-manager tier (which bypasses the gate) and
  // not the EBT_PJRT_NO_READY diagnostic
  bool zeroCopyEngaged() const {
    return dma_ok_ && !xm_ok_ && !no_ready_diag_;
  }

  // ---- transfer-manager tier (EBT_PJRT_XFER_MGR, probed at init) ----
  bool xferMgrActive() const { return xm_ok_; }
  // blocks the hot path submitted through the tier (the init probe's
  // block is not counted)
  uint64_t xferMgrCount() const {
    return xfer_mgr_count_.load(std::memory_order_relaxed);
  }
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

  // ---- stripe tier (--stripe): the block-range planner ----
  // policy 0 = off, 1 = round-robin over units, 2 = contiguous runs; a unit
  // is unit_blocks consecutive blocks. 0 ok, 1 on a bad plan or a sealed
  // path.
  int setStripePlan(int policy, uint64_t total_blocks, uint64_t unit_blocks);
  // the lane of the block at file_offset, -1 when no plan is active
  int stripeDeviceFor(uint64_t file_offset) const;
  struct StripeStats {
    uint64_t units_submitted = 0;  // planner-routed blocks enqueued
    uint64_t units_awaited = 0;    // of those, settled
    uint64_t barrier_wait_ns = 0;  // direction-8 barriers' await time
    uint64_t barriers = 0;         // direction-8 invocations
  };
  StripeStats stripeStats() const;
  // direction 8: settle every pending transfer; 0 ok, 1 = a unit failed
  // ("device N unit U: cause" in stripeError())
  int stripeBarrier();
  std::string stripeError() const EBT_EXCLUDES(stripe_mutex_);

  // ---- checkpoint-restore ledger (--checkpoint) ----
  // one entry per (shard, lane) placement pair; 0 ok, 1 on a sealed path
  // or an entry naming an out-of-range shard or lane or zero bytes
  int setCkptPlan(int nshards, const std::vector<int>& entry_shard,
                  const std::vector<int>& entry_device,
                  const std::vector<uint64_t>& entry_bytes);
  // direction 9: tag worker_rank's following direction-0 blocks with
  // `shard` and re-arm its reconciliation; 1 = shard outside the plan
  int ckptBeginShard(int worker_rank, int64_t shard) EBT_EXCLUDES(ckpt_mutex_);
  int64_t ckptShardFor(int worker_rank) const EBT_EXCLUDES(ckpt_mutex_);
  struct CkptStats {
    uint64_t shards_total = 0;
    uint64_t shards_resident = 0;  // resident bytes == bytes x replicas
    uint64_t resident_wait_ns = 0;  // direction-10 barriers' await time
    uint64_t barriers = 0;          // direction-10 invocations
  };
  CkptStats ckptStats() const;
  // out[0] = bytes submitted under a shard tag, out[1] = bytes resident
  void ckptByteTotals(uint64_t* out) const;
  std::vector<uint64_t> ckptDevBytes() const;  // resident bytes per lane
  // direction 10: settle every pending transfer; 0 ok, 1 = a restore
  // transfer failed ("device N shard S: cause" in ckptError())
  int ckptBarrier();
  std::string ckptError() const EBT_EXCLUDES(ckpt_mutex_);

  // ---- device faults: retry, lane ejection, live replanning ----
  struct FaultStats {
    uint64_t dev_retry_attempts = 0;    // recovery resubmits tried
    uint64_t dev_retry_success = 0;     // copies recovered
    uint64_t dev_retry_backoff_ns = 0;  // time in recovery backoff waits
    uint64_t dev_errors = 0;            // lane-attributed failures seen
    uint64_t ejected_devices = 0;       // lanes ejected
    uint64_t replanned_units = 0;       // placements moved off ejected lanes
  };
  // device_error_budget: failures a lane may take before it is ejected (0 =
  // the policy is off); retry_max: resubmits beyond one walk over the
  // survivors; backoff_ms: the exponential backoff base. Read lock-free.
  void setFaultPolicy(int device_error_budget, int retry_max,
                      uint64_t backoff_ms);
  FaultStats faultStats() const;
  uint64_t ejectedMask() const {
    return ejected_mask_.load(std::memory_order_acquire);
  }
  // "device N: cause" of every ejection, '\n'-joined in order; N is the lane
  std::string ejectedDevices() const EBT_EXCLUDES(fault_mutex_);
  // force-eject a lane: 0 ok, 1 = out of range, already ejected, or the
  // last healthy lane
  int ejectDevice(int device_idx, const std::string& cause)
      EBT_EXCLUDES(fault_mutex_);
  // the engine's interrupt flag: backoff waits wake when it is set
  void setInterruptFlag(const std::atomic<bool>* flag) {
    interrupt_flag_.store(flag, std::memory_order_release);
  }

  // ---- N->M reshard plan and the device-to-device tier (--reshard) ----
  struct ReshardStats {
    uint64_t units_total = 0;
    uint64_t units_resident = 0;  // planned action-0 units
    uint64_t units_moved = 0;     // move units whose resident bytes are full
    uint64_t units_read = 0;      // read units whose resident bytes are full
    uint64_t d2d_submitted_bytes = 0;  // bytes entering the move tier
    uint64_t d2d_resident_bytes = 0;   // move bytes settled on the dst lane
    uint64_t d2d_moves = 0;       // chunk moves settled device to device
    uint64_t bounce_moves = 0;    // chunk moves settled via the host bounce
    uint64_t move_recovered = 0;  // failed moves recovered by a bounce
    uint64_t move_fallback_reads = 0;  // move units re-read from storage
    uint64_t reshard_read_bytes = 0;   // storage-read bytes under unit tags
    uint64_t resident_wait_ns = 0;     // direction-15 barriers' await time
    uint64_t barriers = 0;             // direction-15 invocations
  };
  // one entry per unit (action 0 resident / 1 move / 2 read, src lane, dst
  // lane, bytes); before the first data copy. 0 ok, 1 on a bad plan.
  int setReshardPlan(const std::vector<int>& unit_action,
                     const std::vector<int>& unit_src,
                     const std::vector<int>& unit_dst,
                     const std::vector<uint64_t>& unit_bytes);
  // stage every move unit's source on its src lane (cuMemAlloc, the
  // offset+salt pattern with salt 0xD2D): the prior restore onto N lanes.
  // Untimed set-up; idempotent. 0 ok, 1 with the cause in
  // firstTransferError().
  int reshardPreload() EBT_EXCLUDES(reshard_mutex_);
  // direction 13: tag worker_rank's following storage reads with `unit`
  int reshardBeginUnit(int worker_rank, int64_t unit)
      EBT_EXCLUDES(reshard_mutex_);
  int64_t reshardUnitFor(int worker_rank) const EBT_EXCLUDES(reshard_mutex_);
  // direction 14: move unit `unit`; 1 = no tier could land it (the engine
  // then reads the unit from storage)
  int reshardMove(int worker_rank, int64_t unit) EBT_EXCLUDES(reshard_mutex_);
  // direction 15: settle every move and every pending read; 1 = a reshard
  // transfer failed ("unit U src A dst B: cause" in reshardError())
  int reshardBarrier() EBT_EXCLUDES(reshard_mutex_);
  ReshardStats reshardStats() const;
  // out[0] = bytes submitted under unit tags, out[1] = bytes resident
  void reshardByteTotals(uint64_t* out) const;
  // out[(src*ndev + dst)*2] = settled chunk moves, [..+1] = their bytes, for
  // the first n pairs; returns the lane count
  int reshardPairMatrix(uint64_t* out, int n) const;
  std::string reshardError() const EBT_EXCLUDES(reshard_mutex_);
  // the driver has the device-to-device entries and EBT_D2D_DISABLE is off
  bool d2dSupported() const { return d2d_ok_; }
  // ordered pairs of distinct selected devices, and of those the pairs with
  // peer access enabled at init (cuCtxEnablePeerAccess)
  void peerAccess(int* enabled, int* pairs) const {
    *enabled = peer_enabled_;
    *pairs = peer_pairs_;
  }

  // ---- serving rotation (--rotate): the device side of the engine's
  // rotator thread ----
  // direction 16: the calling thread restores `generation` as the
  // background class, paced by the lane bucket at bg_rate_bps (0 =
  // unthrottled); an aborted generation's memory is freed first. 1 without
  // a checkpoint plan or with generation 0.
  int rotateBegin(int worker_rank, uint64_t generation, uint64_t bg_rate_bps)
      EBT_EXCLUDES(rot_mutex_, bg_mutex_);
  // direction 17: record the rotation from the checkpoint ledger, make the
  // fresh generation the active one, free the displaced one
  int rotateSwap(int worker_rank) EBT_EXCLUDES(rot_mutex_);
  struct RotationRecord {
    uint64_t generation = 0;
    uint64_t shards_total = 0;
    uint64_t shards_resident = 0;   // == shards_total on a clean rotation
    uint64_t bytes_submitted = 0;   // checkpoint-tagged bytes this rotation
    uint64_t bytes_resident = 0;    // must equal bytes_submitted
    uint64_t bg_bytes = 0;          // background H2D bytes this rotation
    uint64_t retained_buffers = 0;  // data-carrying pendings the fresh set
                                    // holds
    uint64_t released_buffers = 0;  // the previous generation's, freed
  };
  int rotationCount() const EBT_EXCLUDES(rot_mutex_);
  bool rotationRecord(int idx, RotationRecord* out) const
      EBT_EXCLUDES(rot_mutex_);
  // out[0..5] = published generation, restoring (0/1), lane bucket rate
  // (bytes/s), bg_lane_throttle_ns, bg_h2d_bytes, retained pendings of both
  // generations
  void rotationState(uint64_t* out) const EBT_EXCLUDES(rot_mutex_);
  // the lane bucket's ceiling (0 = unthrottled); each begin re-syncs it
  void setBgBudget(uint64_t bytes_per_s) {
    bg_rate_bps_.store(bytes_per_s, std::memory_order_relaxed);
  }
  // Test-only (like ejectDevice): copy [offset, offset + len) of `shard` as
  // the active generation holds it on the shard's replica-th placement lane
  // into host memory. Call between phases, never beside a swap. 0 ok, 1 = no
  // active generation, replica outside the plan or a range not covered.
  int rotationRead(int64_t shard, int replica, uint64_t offset,
                   uint64_t len, void* host) EBT_EXCLUDES(rot_mutex_);

  // ---- DL-ingestion ledger (--ingest) ----
  // before the first data copy; 1 on a sealed path or bad geometry
  int setIngestPlan(uint64_t record_size, int epochs);
  // direction 11: tag worker_rank's following blocks with `epoch`
  int ingestBeginEpoch(int worker_rank, int64_t epoch)
      EBT_EXCLUDES(ingest_mutex_);
  int64_t ingestEpochFor(int worker_rank) const EBT_EXCLUDES(ingest_mutex_);
  struct IngestStats {
    uint64_t read_bytes = 0;       // entered the device layer
    uint64_t submitted_bytes = 0;  // enqueued as pending copies
    uint64_t resident_bytes = 0;   // settled on a device
    uint64_t dropped_bytes = 0;    // failed at submit or settle
    uint64_t batch_coalesce_count = 0;  // blocks carrying > 1 record
    uint64_t prefetch_peak_bytes = 0;   // peak in-flight ingest bytes
    uint64_t resident_wait_ns = 0;      // direction-12 barriers' await time
    uint64_t barriers = 0;              // direction-12 invocations
  };
  IngestStats ingestStats() const;
  // out[0..3] = read/submitted/resident/dropped bytes of `epoch`
  bool ingestEpochBytes(int64_t epoch, uint64_t* out) const;
  int ingestEpochs() const { return ingest_epochs_; }
  // direction 12: settle every pending copy; 1 = an ingest copy failed
  // ("device N epoch E: cause" in ingestError())
  int ingestBarrier();
  std::string ingestError() const EBT_EXCLUDES(ingest_mutex_);
  // zero the counters for a fresh phase on the same plan
  void ingestRearm() EBT_EXCLUDES(ingest_mutex_);

  // the slice-wide settle sweep shared by directions 8 and 10 and by
  // teardown: every pending transfer of every buffer is awaited, under the
  // barriers' draining holds; 1 if any failed
  int settleAllShards();
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
    // a planner-routed block's chunk (failure attribution); the block's
    // first chunk also carries its unit, which units_awaited counts
    bool stripe = false;
    int64_t stripe_unit = -1;
    int64_t ckpt_shard = -1;  // every chunk of a restore block
    // reshard: the plan unit of a move or storage read, and the unit's
    // re-arm generation at enqueue (a settle of a superseded attempt does
    // not credit the re-armed unit)
    int64_t reshard_unit = -1;
    uint32_t reshard_gen = 0;
    // a device-to-device move: settled bytes credit the pair matrix and
    // d2d_resident, never the lane byte counters; d2d_src is the chunk's
    // preloaded source on src_lane (alive for the path's lifetime), from
    // which a failed move is recovered through the host bounce
    bool d2d = false;
    bool d2d_bounce = false;
    int src_lane = -1;
    cu::CUdeviceptr d2d_src = 0;
    char* owned_src = nullptr;  // bounce scratch, back to the pool at settle
    // the chunk's host source (read-leg copies): valid until this pending
    // settles, so a failed copy can be resubmitted to a survivor lane
    const char* src = nullptr;
    // a recovery's own copies: their settle neither recovers nor attributes
    bool no_recover = false;
    int64_t ingest_epoch = -1;  // every chunk of an ingest block
    // serving rotation: the generation this chunk was restored into (0 =
    // none), the lane the plan placed its shard on and its file offset, so
    // a recovery lands it in the same generation's memory
    uint64_t rot_gen = 0;
    int rot_lane = -1;
    uint64_t rot_off = 0;
    // transfer-manager tier: the block's last pending (xm_block) carries
    // its buffer and counts as the block's one retained buffer in a
    // rotation; xm_buf is freed (cuMemFreeAsync on `stream`) when this
    // pending settles
    bool xm_block = false;
    cu::CUdeviceptr xm_buf = 0;
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
    // the device's default memory pool (transfer-manager tier), resolved
    // once at init; its release threshold is raised while the path lives
    cu::CUmemoryPool pool = nullptr;
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
  // the lane of a block's chunk_i-th chunk: the block's own lane, or under
  // --tpustripe the lanes in turn from it
  int chunkLane(int li, int chunk_i) const {
    return stripe_ ? (li + chunk_i) % (int)lanes_.size() : li;
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
  // stripe_unit / ckpt_shard / reshard_unit >= 0 tag the pendings as they
  // enqueue
  void enqueue(void* buf, std::vector<Pending>& ps, int64_t stripe_unit = -1,
               int64_t ckpt_shard = -1, int64_t reshard_unit = -1,
               int64_t ingest_epoch = -1) EBT_EXCLUDES(reg_mutex_);
  // ledger bookkeeping at a pending's settle (awaitRelease); the cause is
  // read out of err_mutex_ before the ledger's leaf lock is taken
  void settleStripe(const Pending& p, int rc) EBT_EXCLUDES(stripe_mutex_);
  void latchStripeError(int device, int64_t unit, const std::string& cause)
      EBT_EXCLUDES(stripe_mutex_);
  void settleCkpt(const Pending& p, int rc) EBT_EXCLUDES(ckpt_mutex_);
  void latchCkptError(int device, int64_t shard, const std::string& cause)
      EBT_EXCLUDES(ckpt_mutex_);
  void settleIngest(const Pending& p, int rc) EBT_EXCLUDES(ingest_mutex_);
  void latchIngestError(int device, int64_t epoch, const std::string& cause)
      EBT_EXCLUDES(ingest_mutex_);
  void ingestCountSubmitted(int64_t epoch, uint64_t bytes);

  // ---- rotation internals ----
  // one device allocation of a generation: bytes [off, off + bytes) of
  // `shard`, on `lane`, standing in for the shard's copy on plan_lane
  struct RotBuf {
    int64_t shard = -1;
    int lane = 0;
    int plan_lane = 0;
    uint64_t off = 0;
    uint64_t bytes = 0;
    cu::CUdeviceptr ptr = 0;
  };
  struct RotGen {
    std::vector<RotBuf> bufs;
    uint64_t pendings = 0;  // data-carrying pendings settled into it
  };
  // charge one background block against the lane bucket (sleeps until the
  // budget allows; wakes on the interrupt flag)
  void bgLaneThrottle(uint64_t len) EBT_EXCLUDES(bg_mutex_);
  // direction 9 on the rotator's thread: allocate the shard's memory on
  // every lane the plan places it on. 0 ok, 1 with the cause latched.
  int rotAllocShard(int64_t shard) EBT_EXCLUDES(rot_mutex_);
  // where a chunk of generation `gen` lands: inside the shard's
  // allocation on `lane` when the plan put it there, else a chunk-sized
  // allocation of its own. 0 with the cause latched when none can be made
  // or `gen` is no longer the restoring generation.
  cu::CUdeviceptr rotDest(uint64_t gen, int64_t shard, int plan_lane,
                          int lane, uint64_t off, uint64_t n)
      EBT_EXCLUDES(rot_mutex_);
  cu::CUdeviceptr rotAlloc(int lane, uint64_t bytes);
  void rotFree(std::vector<RotBuf>& bufs);
  // a clean settle of a chunk of the restoring generation counts into it
  void rotRetain(const Pending& p) EBT_EXCLUDES(rot_mutex_);
  void rotReleaseAll() EBT_EXCLUDES(rot_mutex_);

  // ---- fault-policy internals ----
  bool faultPolicyActive() const {
    return fault_device_budget_.load(std::memory_order_relaxed) > 0;
  }
  // the mask is 64 bits wide: lanes beyond it are never ejected
  bool laneEjected(int idx) const {
    return idx >= 0 && idx < 64 &&
           (ejected_mask_.load(std::memory_order_acquire) >> idx & 1);
  }
  // The retry walk shared by the submit-time and settle-time recoveries:
  // healthy lanes after failed_lane in turn, at most lanes + retry_max
  // candidates, backoff before every attempt after the first, a bail-out on
  // interrupt. attempt_fn(cand) returns true on success; a declining
  // candidate is charged `cause` (or the first transfer error). Returns the
  // lane that succeeded, or -1.
  template <typename Fn>
  int walkSurvivors(int failed_lane, Fn&& attempt_fn,
                    const std::string* cause = nullptr) {
    const int ndev = (int)lanes_.size();
    const int extra = fault_retry_max_.load(std::memory_order_relaxed);
    int attempts = 0;
    for (int i = 1; i <= ndev + extra; i++) {
      const int cand = (failed_lane + i) % ndev;
      if (laneEjected(cand)) continue;
      attempts++;
      dev_retry_attempts_.fetch_add(1, std::memory_order_relaxed);
      if (attempts > 1 && !faultBackoffWait(attempts - 1)) return -1;
      if (attempt_fn(cand)) {
        dev_retry_success_.fetch_add(1, std::memory_order_relaxed);
        return cand;
      }
      recordDeviceError(cand, cause && !cause->empty() ? *cause
                                                       : firstTransferError());
    }
    return -1;
  }
  // the lane a placement on device_idx uses: itself while healthy, else a
  // fixed survivor (the survivors in ascending order, picked by
  // device_idx % their count); unchanged when every lane is ejected
  int survivorFor(int device_idx) const;
  void recordDeviceError(int device_idx, const std::string& cause)
      EBT_EXCLUDES(fault_mutex_);
  // settle-time recovery: resubmit p's host source synchronously onto
  // survivors; 0 = recovered (p.lane is the survivor, its bytes moved
  // there), 1 = not recoverable. Called under no lock.
  int recoverPending(Pending& p) EBT_EXCLUDES(fault_mutex_, err_mutex_);
  // the backoff before recovery attempt `attempt` (1-based); false when the
  // interrupt flag fired
  bool faultBackoffWait(int attempt);

  // ---- reshard internals ----
  void settleReshard(const Pending& p, int rc) EBT_EXCLUDES(reshard_mutex_);
  void latchReshardError(int64_t unit, int src, int dst,
                         const std::string& cause)
      EBT_EXCLUDES(reshard_mutex_);
  // one device-to-device chunk copy onto dst's landing buffer, on dst's H2D
  // stream (dst's context current)
  cu::CUresult d2dCopy(int src_lane, cu::CUdeviceptr src, int dst,
                       uint64_t dst_off, uint64_t n);
  // the two bounce legs: an awaited D2H fetch of src into scratch on the src
  // lane's D2H stream, then the H2D copy onto dst (completion left to the
  // caller, who keeps scratch alive until it settles). 0 ok.
  int bounceLegs(int src_lane, cu::CUdeviceptr src, char* scratch,
                 uint64_t len, int dst, uint64_t dst_off, const char* what,
                 Pending& out);
  // one bounce-tier chunk move, deferred into the reshard ledger. 0 ok.
  int bounceMoveChunk(int src_lane, cu::CUdeviceptr src, uint64_t len,
                      int dst, uint64_t dst_off, int64_t unit)
      EBT_EXCLUDES(reshard_mutex_);
  // settle-time recovery of a failed device-to-device move through the
  // bounce; 0 = recovered (counted as a bounce move)
  int recoverMovePending(Pending& p) EBT_EXCLUDES(reshard_mutex_);
  // settle every deferred move of one unit
  void settleReshardUnit(int64_t unit) EBT_EXCLUDES(reshard_mutex_);
  // pinned bounce scratch of chunk size from the pool made at preload;
  // with the pool empty the oldest deferred bounce move is settled first
  char* acquireScratch() EBT_EXCLUDES(reshard_mutex_);
  void releaseScratch(char* p) EBT_EXCLUDES(reshard_mutex_);
  uint64_t landingOffset(uint64_t off, uint64_t n) const {
    const uint64_t o = off % landing_cap_;
    return o + n <= landing_cap_ ? o : 0;
  }

  RankBufs& rankBufs(int worker_rank, int lane) EBT_EXCLUDES(rank_mutex_);
  bool ensureBuffer(int lane, cu::CUdeviceptr* p, uint64_t* cap,
                    uint64_t len);

  // rot_gen != 0: a chunk of that restoring generation, landing in its
  // memory (ckpt_shard, plan_lane and file_off say where)
  int submitH2D(int device_idx, const char* buf, uint64_t len,
                int64_t stripe_unit = -1, int64_t ckpt_shard = -1,
                int64_t reshard_unit = -1, int64_t ingest_epoch = -1,
                uint64_t rot_gen = 0, int plan_lane = -1,
                uint64_t file_off = 0);
  // before copies from [buf, buf + len): wait out a registration change on
  // the range, then report whether it is registered and, if so, hold it in
  // the shard's draining ledger against eviction until releaseHold
  bool holdForCopy(const char* buf, uint64_t len, Lane& lane,
                   QueueShard& shard) EBT_EXCLUDES(reg_mutex_);
  void releaseHold(const char* buf, uint64_t len, Lane& lane,
                   QueueShard& shard);
  // unpin ranges that left the registration cache (in_transit_), behind a
  // fence on every lane's H2D stream
  void unpinVictims(const std::vector<std::pair<uintptr_t, int>>& victims)
      EBT_EXCLUDES(reg_mutex_);
  int submitH2DVerified(int worker_rank, int device_idx, const char* buf,
                        uint64_t len, uint64_t file_off);
  // the transfer-manager tier's probe at init (sets xm_ok_ or downgrades
  // with the cause in regError())
  void initXferMgr();
  // one tier block: a device buffer of its own, chunks copied into it; the
  // tags as submitH2D's
  int submitH2DXferMgr(int device_idx, const char* buf, uint64_t len,
                       int64_t stripe_unit = -1, int64_t ckpt_shard = -1,
                       int64_t reshard_unit = -1, int64_t ingest_epoch = -1,
                       uint64_t rot_gen = 0, int plan_lane = -1,
                       uint64_t file_off = 0);
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
  bool stripe_ = false;  // --tpustripe
  bool no_ready_diag_ = false;
  bool no_latency_diag_ = false;
  bool dma_ok_ = false;
  bool xm_ok_ = false;  // transfer-manager tier probed and opted in
  std::atomic<uint64_t> xfer_mgr_count_{0};  // blocks submitted through it
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

  // stripe plan: the policy is read lock-free per block; the geometry is
  // written once by setStripePlan before the path is sealed
  std::atomic<int> stripe_policy_{0};
  uint64_t stripe_unit_blocks_ = 1;
  uint64_t stripe_units_per_dev_ = 0;  // contiguous runs: ceil(units / lanes)
  std::atomic<uint64_t> stripe_units_submitted_{0};
  std::atomic<uint64_t> stripe_units_awaited_{0};
  std::atomic<uint64_t> stripe_barrier_wait_ns_{0};
  std::atomic<uint64_t> stripe_barriers_{0};
  // leaf lock: the first "device N unit U: cause", set once
  mutable Mutex stripe_mutex_;
  std::string stripe_error_ EBT_GUARDED_BY(stripe_mutex_);

  // checkpoint plan: written once by setCkptPlan before the path is sealed;
  // the per-shard atomics are sized by it, so the hot path needs no lock
  std::atomic<int> ckpt_active_{0};
  uint64_t ckpt_nshards_ = 0;
  std::vector<uint64_t> ckpt_expected_bytes_;  // bytes x replica lanes
  std::unique_ptr<std::atomic<uint64_t>[]> ckpt_sub_bytes_;
  std::unique_ptr<std::atomic<uint64_t>[]> ckpt_res_bytes_;
  std::vector<std::unique_ptr<std::atomic<uint64_t>>> ckpt_dev_bytes_;
  std::atomic<uint64_t> ckpt_resident_wait_ns_{0};
  std::atomic<uint64_t> ckpt_barriers_{0};
  // leaf lock: the per-worker current shard and the first failure
  mutable Mutex ckpt_mutex_;
  std::unordered_map<int, int64_t> ckpt_cur_shard_ EBT_GUARDED_BY(ckpt_mutex_);
  std::string ckpt_error_ EBT_GUARDED_BY(ckpt_mutex_);

  // fault policy: atomics read lock-free per block; the mask is the
  // replanner's routing input
  std::atomic<int> fault_device_budget_{0};  // 0 = off
  std::atomic<int> fault_retry_max_{0};
  std::atomic<uint64_t> fault_backoff_ms_{10};
  std::atomic<uint64_t> ejected_mask_{0};
  std::atomic<uint64_t> dev_retry_attempts_{0};
  std::atomic<uint64_t> dev_retry_success_{0};
  std::atomic<uint64_t> dev_retry_backoff_ns_{0};
  std::atomic<uint64_t> dev_errors_{0};
  std::atomic<uint64_t> ejected_devices_{0};
  std::atomic<uint64_t> replanned_units_{0};
  std::atomic<const std::atomic<bool>*> interrupt_flag_{nullptr};
  // leaf lock: per-lane error counts and the ejection attributions
  mutable Mutex fault_mutex_;
  std::vector<uint64_t> lane_errors_ EBT_GUARDED_BY(fault_mutex_);
  std::string ejected_error_ EBT_GUARDED_BY(fault_mutex_);

  // reshard plan: written once by setReshardPlan before the path is sealed
  std::atomic<int> reshard_active_{0};
  uint64_t reshard_nunits_ = 0;
  std::vector<int> reshard_action_;
  std::vector<int> reshard_src_;
  std::vector<int> reshard_dst_;
  std::vector<uint64_t> reshard_unit_bytes_;
  std::unique_ptr<std::atomic<uint64_t>[]> reshard_sub_bytes_;
  std::unique_ptr<std::atomic<uint64_t>[]> reshard_res_bytes_;
  std::unique_ptr<std::atomic<uint32_t>[]> reshard_unit_gen_;
  std::unique_ptr<std::atomic<uint64_t>[]> reshard_pair_moves_;
  std::unique_ptr<std::atomic<uint64_t>[]> reshard_pair_bytes_;
  size_t reshard_pairs_n_ = 0;
  std::atomic<uint64_t> d2d_submitted_bytes_{0};
  std::atomic<uint64_t> d2d_resident_bytes_{0};
  std::atomic<uint64_t> d2d_moves_{0};
  std::atomic<uint64_t> bounce_moves_{0};
  std::atomic<uint64_t> move_recovered_{0};
  std::atomic<uint64_t> move_fallback_reads_{0};
  std::atomic<uint64_t> reshard_read_bytes_{0};
  std::atomic<uint64_t> reshard_resident_wait_ns_{0};
  std::atomic<uint64_t> reshard_barriers_{0};
  bool d2d_ok_ = false;
  int peer_enabled_ = 0, peer_pairs_ = 0;
  struct SrcBuf {
    int lane = 0;
    cu::CUdeviceptr ptr = 0;
    uint64_t bytes = 0;
  };
  // leaf lock: the per-worker unit table, the preloaded sources, the
  // deferred moves (they have no host buffer key), the bounce scratch pool
  // and the first failure. Released before every submit and await.
  mutable Mutex reshard_mutex_;
  std::unordered_map<int, int64_t> reshard_cur_unit_
      EBT_GUARDED_BY(reshard_mutex_);
  std::map<int64_t, SrcBuf> reshard_src_bufs_ EBT_GUARDED_BY(reshard_mutex_);
  std::vector<Pending> reshard_pending_ EBT_GUARDED_BY(reshard_mutex_);
  std::vector<char*> scratch_free_ EBT_GUARDED_BY(reshard_mutex_);
  std::vector<char*> scratch_all_ EBT_GUARDED_BY(reshard_mutex_);
  std::string reshard_error_ EBT_GUARDED_BY(reshard_mutex_);

  // serving rotation: the generations are published atomically so the hot
  // path reads them lock-free; the rotator thread marks itself background
  // (thread-local, set at rotateBegin, cleared at the swap)
  std::atomic<uint64_t> rot_generation_{0};   // last swapped generation
  std::atomic<uint64_t> rot_restore_gen_{0};  // being restored (0 = none)
  std::atomic<uint64_t> bg_rate_bps_{0};
  std::atomic<uint64_t> bg_lane_throttle_ns_{0};
  std::atomic<uint64_t> bg_h2d_bytes_{0};
  // leaf lock: the lane bucket (only the rotator charges it)
  mutable Mutex bg_mutex_;
  double bg_tokens_ EBT_GUARDED_BY(bg_mutex_) = 0;
  Clock::time_point bg_last_refill_ EBT_GUARDED_BY(bg_mutex_){};
  // the checkpoint plan's placement entries, kept for the per-shard
  // allocations (written once by setCkptPlan before the path is sealed)
  std::vector<int> ckpt_entry_shard_;
  std::vector<int> ckpt_entry_device_;
  std::vector<uint64_t> ckpt_entry_bytes_;
  // leaf lock: the two generations' memory, the records, the bg byte base
  mutable Mutex rot_mutex_;
  RotGen rot_active_ EBT_GUARDED_BY(rot_mutex_);
  RotGen rot_fresh_ EBT_GUARDED_BY(rot_mutex_);
  std::vector<RotationRecord> rot_records_ EBT_GUARDED_BY(rot_mutex_);
  uint64_t rot_bg_bytes_base_ EBT_GUARDED_BY(rot_mutex_) = 0;

  // DL-ingestion plan: written once by setIngestPlan before the path is
  // sealed; the per-epoch atomics are sized by it
  std::atomic<int> ingest_active_{0};
  uint64_t ingest_record_size_ = 0;
  int ingest_epochs_ = 0;
  std::unique_ptr<std::atomic<uint64_t>[]> ingest_read_bytes_;
  std::unique_ptr<std::atomic<uint64_t>[]> ingest_sub_bytes_;
  std::unique_ptr<std::atomic<uint64_t>[]> ingest_res_bytes_;
  std::unique_ptr<std::atomic<uint64_t>[]> ingest_drop_bytes_;
  std::atomic<uint64_t> ingest_batch_coalesce_{0};
  std::atomic<uint64_t> ingest_inflight_bytes_{0};
  std::atomic<uint64_t> ingest_inflight_peak_{0};
  std::atomic<uint64_t> ingest_resident_wait_ns_{0};
  std::atomic<uint64_t> ingest_barriers_{0};
  // leaf lock: the per-worker current epoch and the first failure
  mutable Mutex ingest_mutex_;
  std::unordered_map<int, int64_t> ingest_cur_epoch_
      EBT_GUARDED_BY(ingest_mutex_);
  std::string ingest_error_ EBT_GUARDED_BY(ingest_mutex_);

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
  // signalled whenever a registration change leaves in_transit_
  std::condition_variable reg_cv_;
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
