/* Native CUDA transfer engine. See cuda_path.h for the design and the parts
 * of the original package's PjrtPath (core/src/pjrt_path.cpp) it ports. */
#include "cuda_path.h"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <set>
#include <thread>

#include "ebt/engine.h"   // fillVerifyPattern / checkVerifyPattern
#include "ebt/rand.h"     // rank-seeded random write sources
#include "ebt/reactor.h"  // host-function landing bridge
#include "ebt/uring.h"    // unified fixed-buffer registration authority

namespace ebt {

namespace {

std::atomic<uint64_t> g_path_gen{0};
// the context this thread last made current, and for which path instance
thread_local cu::CUcontext t_ctx = nullptr;
thread_local uint64_t t_gen = 0;
// serving rotation: the generation the calling thread restores, and for
// which path instance (the engine's rotator marks itself at rotateBegin and
// clears it at the swap), so foreground blocks pay nothing for the
// background class
thread_local uint64_t t_rot_gen = 0;
thread_local uint64_t t_rot_path = 0;

bool envSet(const char* name) { return getenv(name) != nullptr; }

uint64_t usSince(std::chrono::steady_clock::time_point t0) {
  return (uint64_t)std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

}  // namespace

void CudaPath::latchXferError(const std::string& msg) {
  MutexLock lk(err_mutex_);
  if (xfer_error_.empty()) xfer_error_ = msg;
}

void CudaPath::latchRegError(const std::string& msg) {
  MutexLock lk(reg_mutex_);
  if (reg_error_.empty()) reg_error_ = msg;
}

bool CudaPath::check(const char* what, cu::CUresult rc) {
  if (rc == cu::CUDA_SUCCESS) return true;
  latchXferError(cu::errorText(api_, what, rc));
  return false;
}

bool CudaPath::makeCurrent(int lane_idx, bool force) {
  if (lanes_.empty()) return false;
  Lane& lane = laneFor(lane_idx);
  if (!force && t_ctx == lane.ctx && t_gen == gen_) return true;
  if (!check("cuCtxSetCurrent", api_.cuCtxSetCurrent(lane.ctx))) return false;
  t_ctx = lane.ctx;
  t_gen = gen_;
  return true;
}

CudaPath::CudaPath(const std::string& driver_path, uint64_t chunk_bytes,
                   uint64_t block_size, bool stripe,
                   const std::vector<int>& device_ids)
    : chunk_bytes_(chunk_bytes ? chunk_bytes : (2u << 20)),
      block_size_(block_size),
      gen_(++g_path_gen),
      stripe_(stripe) {
  // the verify pattern is u64-word based; a chunk boundary inside a word
  // would phase-shift every later chunk's expected pattern
  chunk_bytes_ &= ~7ull;
  if (!chunk_bytes_) chunk_bytes_ = 2u << 20;
  std::string err;
  if (!cu::loadApi(driver_path, &api_, &err)) {
    init_error_ = err;
    return;
  }
  cu::CUresult rc = api_.cuInit(0);
  if (rc) {
    init_error_ = cu::errorText(api_, "cuInit", rc);
    return;
  }
  int count = 0;
  rc = api_.cuDeviceGetCount(&count);
  if (rc) {
    init_error_ = cu::errorText(api_, "cuDeviceGetCount", rc);
    return;
  }
  if (count <= 0) {
    init_error_ = "CUDA driver has no devices";
    return;
  }
  std::vector<int> ids = device_ids;
  if (ids.empty())
    for (int i = 0; i < count; i++) ids.push_back(i);
  for (int id : ids) {
    if (id < 0 || id >= count) {
      init_error_ = "device id " + std::to_string(id) + " out of range (" +
                    std::to_string(count) + " addressable devices)";
      return;
    }
  }

  // one lane per selected device: its primary context (the one PyTorch's
  // runtime uses), an H2D and a D2H stream, its capabilities, its landing
  // buffer
  landing_cap_ = std::max(std::max<uint64_t>(block_size_, 8), chunk_bytes_);
  for (int id : ids) {
    lanes_.push_back(std::make_unique<Lane>());
    Lane& l = *lanes_.back();
    const int li = (int)lanes_.size() - 1;
    if ((rc = api_.cuDeviceGet(&l.dev, id))) {
      init_error_ = cu::errorText(api_, "cuDeviceGet", rc);
      return;
    }
    if ((rc = api_.cuDevicePrimaryCtxRetain(&l.ctx, l.dev))) {
      init_error_ = cu::errorText(api_, "cuDevicePrimaryCtxRetain", rc);
      return;
    }
    l.ctx_retained = true;
    if (!makeCurrent(li, true)) {
      init_error_ = firstTransferError();
      return;
    }
    int reg = 0, ro_reg = 0;
    const struct {
      const char* what;
      cu::CUresult rc;
    } steps[] = {
        {"cuStreamCreate",
         api_.cuStreamCreate(&l.h2d, cu::CU_STREAM_NON_BLOCKING)},
        {"cuStreamCreate",
         api_.cuStreamCreate(&l.d2h, cu::CU_STREAM_NON_BLOCKING)},
        {"cuDeviceGetAttribute",
         api_.cuDeviceGetAttribute(
             &l.sms, cu::CU_DEVICE_ATTRIBUTE_MULTIPROCESSOR_COUNT, l.dev)},
        {"cuDeviceGetAttribute",
         api_.cuDeviceGetAttribute(
             &reg, cu::CU_DEVICE_ATTRIBUTE_HOST_REGISTER_SUPPORTED, l.dev)},
        {"cuDeviceGetAttribute",
         api_.cuDeviceGetAttribute(
             &ro_reg,
             cu::CU_DEVICE_ATTRIBUTE_READ_ONLY_HOST_REGISTER_SUPPORTED,
             l.dev)},
        {"cuMemAlloc (landing buffer)",
         api_.cuMemAlloc(&l.landing, landing_cap_)},
    };
    for (const auto& s : steps) {
      if (s.rc) {
        init_error_ = cu::errorText(api_, s.what, s.rc);
        return;
      }
    }
    l.host_register = reg != 0;
    l.read_only_register = ro_reg != 0;
  }

  // EBT_PJRT_SINGLE_LANE=1 forces one queue shard (the original's A/B
  // control for the lane split); value-parsed, so "=0" keeps the default
  const char* sl_env = getenv("EBT_PJRT_SINGLE_LANE");
  single_lane_ = sl_env && *sl_env && std::strcmp(sl_env, "0") != 0;
  const int nshards = single_lane_ ? 1 : kQueueShards;
  for (int s = 0; s < nshards; s++)
    shards_.push_back(std::make_unique<QueueShard>());

  no_ready_diag_ = envSet("EBT_PJRT_NO_READY");
  no_latency_diag_ = envSet("EBT_PJRT_NO_LATENCY");
  onready_ok_ = !no_ready_diag_ && !no_latency_diag_;

  // registered-memory tier: every selected device must support
  // cuMemHostRegister and the kill switch must be off; then one
  // register/unregister round trip proves it, as the original probes DmaMap
  // (slot presence is not capability)
  dma_ok_ = !envSet("EBT_PJRT_NO_DMAMAP");
  for (auto& l : lanes_) {
    if (dma_ok_ && !l->host_register) {
      dma_ok_ = false;
      latchRegError(
          "device does not support cuMemHostRegister "
          "(CU_DEVICE_ATTRIBUTE_HOST_REGISTER_SUPPORTED is 0)");
    }
  }
  if (dma_ok_) {
    void* probe_page = nullptr;
    if (posix_memalign(&probe_page, 4096, 4096) == 0) {
      if (registerBuffer(probe_page, 4096) != 0)
        dma_ok_ = false;  // cause stays in reg_error_
      else
        deregisterBuffer(probe_page);
      free(probe_page);
    }
  }

  // device-to-device tier (the reshard moves): the driver's entries, and
  // EBT_D2D_DISABLE off (value-parsed: "=0" keeps the tier), as in the
  // original. Peer access is enabled once here between every two distinct
  // selected devices that allow it; a peer copy works without it too (the
  // driver stages it), so its state is reported, not required.
  {
    const char* d2d_env = getenv("EBT_D2D_DISABLE");
    const bool d2d_off =
        d2d_env && *d2d_env && std::strcmp(d2d_env, "0") != 0;
    d2d_ok_ = api_.d2d && !d2d_off;
  }
  if (api_.d2d) {
    std::set<std::pair<cu::CUdevice, cu::CUdevice>> seen;
    for (size_t i = 0; i < lanes_.size(); i++) {
      for (size_t j = 0; j < lanes_.size(); j++) {
        const cu::CUdevice a = lanes_[i]->dev, b = lanes_[j]->dev;
        if (a == b || !seen.insert({a, b}).second) continue;
        peer_pairs_++;
        int can = 0;
        if (api_.cuDeviceCanAccessPeer(&can, a, b) || !can) continue;
        if (!makeCurrent((int)i, false)) continue;
        cu::CUresult prc = api_.cuCtxEnablePeerAccess(lanes_[j]->ctx, 0);
        if (prc == cu::CUDA_SUCCESS ||
            prc == cu::CUDA_ERROR_PEER_ACCESS_ALREADY_ENABLED)
          peer_enabled_++;
      }
    }
  }

  // the opt-in transfer-manager tier, probed before the warm-up as in the
  // original (whose counter resets below also clear the probe's traffic)
  initXferMgr();

  // warm-up transfer per lane at construction (preparation), so the
  // measured phase starts hot; a driver that cannot move it fails init
  std::vector<char> probe(std::min<uint64_t>(chunk_bytes_, 1u << 20), 0);
  for (size_t d = 0; d < lanes_.size(); d++) {
    makeCurrent((int)d, false);
    if (submitH2D((int)d, probe.data(), probe.size()) == 0)
      settle(probe.data(), (int)d, false);
  }
  for (auto& lane : lanes_) {
    lane->bytes_to_hbm.store(0);
    lane->bytes_from_hbm.store(0);
    lane->submits.store(0);
    lane->awaits.store(0);
    lane->lock_wait_ns.store(0);
    MutexLock lk(lane->histo_m);
    lane->histo.reset();
  }
  MutexLock lk(err_mutex_);
  if (!xfer_error_.empty())
    init_error_ = "warmup transfer failed: " + xfer_error_;
}

CudaPath::~CudaPath() {
  if (lanes_.empty()) return;
  drainAll();
  rotReleaseAll();
  std::vector<uintptr_t> leftover;
  {
    MutexLock lk(reg_mutex_);
    for (auto& kv : registered_) leftover.push_back(kv.first);
  }
  for (uintptr_t p : leftover) deregisterBuffer((void*)p);
  for (size_t d = 0; d < lanes_.size(); d++) {
    Lane& l = *lanes_[d];
    if (!l.ctx_retained) continue;
    makeCurrent((int)d, true);
    if (l.h2d) api_.cuStreamSynchronize(l.h2d);
    if (l.d2h) api_.cuStreamSynchronize(l.d2h);
  }
  // every tier block buffer was freed at its settle (drainAll above) and
  // the streams are idle: the pools go back to the default threshold and
  // hand their memory back
  for (size_t d = 0; d < lanes_.size(); d++) {
    Lane& l = *lanes_[d];
    if (!l.pool) continue;
    makeCurrent((int)d, true);
    uint64_t threshold = 0;
    api_.cuMemPoolSetAttribute(l.pool, cu::CU_MEMPOOL_ATTR_RELEASE_THRESHOLD,
                               &threshold);
    api_.cuMemPoolTrimTo(l.pool, 0);
  }
  {
    MutexLock lk(rank_mutex_);
    for (auto& kv : rank_bufs_) {
      RankBufs& rb = *kv.second;
      makeCurrent(rb.lane, true);
      for (cu::CUdeviceptr p : {rb.verify, rb.staged, rb.gen, rb.result})
        if (p) api_.cuMemFree(p);
      if (rb.host) api_.cuMemFreeHost(rb.host);
    }
    rank_bufs_.clear();
  }
  {
    MutexLock lk(src_mutex_);
    for (auto& kv : dev_src_) {
      makeCurrent(kv.second.first, true);
      api_.cuMemFree(kv.second.second);
    }
    dev_src_.clear();
  }
  {
    MutexLock lk(reshard_mutex_);
    for (auto& kv : reshard_src_bufs_) {
      makeCurrent(kv.second.lane, true);
      api_.cuMemFree(kv.second.ptr);
    }
    reshard_src_bufs_.clear();
    for (char* p : scratch_all_) api_.cuMemFreeHost(p);
    scratch_all_.clear();
    scratch_free_.clear();
  }
  for (size_t d = 0; d < lanes_.size(); d++) {
    Lane& l = *lanes_[d];
    if (!l.ctx_retained) continue;
    makeCurrent((int)d, true);
    for (cu::CUdeviceptr p : {l.landing, l.verify_ws})
      if (p) api_.cuMemFree(p);
    if (l.h2d) api_.cuStreamDestroy(l.h2d);
    if (l.d2h) api_.cuStreamDestroy(l.d2h);
    api_.cuDevicePrimaryCtxRelease(l.dev);
  }
  // the context this thread had current may be gone now: forget it. The
  // driver library stays loaded: the runtime that shares it may still call
  // into it.
  t_ctx = nullptr;
  t_gen = 0;
}

// ---------------------------------------------------------------- completion

void CudaPath::hostFnTrampoline(void* arg) {
  // runs on the driver's callback thread with the stream blocked: one leaf
  // lock per histogram and tracker, no driver API call
  Tracker* t = static_cast<Tracker*>(arg);
  if (t->device >= 0) t->path->addDevLatency(t->device, usSince(t->t0));
  // capture the landing fd BEFORE flipping done: the waiter may delete the
  // tracker the moment done is visible
  const int reactor_fd = t->reactor_fd;
  {
    MutexLock lk(t->m);
    t->done = true;
    t->cv.notify_all();
  }
  reactorhub::signalFd(reactor_fd);
}

void CudaPath::addDevLatency(int device_idx, uint64_t us) {
  if (device_idx < 0 || (size_t)device_idx >= lanes_.size()) return;
  Lane& lane = *lanes_[device_idx];
  MutexLock lk(lane.histo_m);
  lane.histo.add(us);
}

void CudaPath::attachCompletion(Pending& p, int lane, cu::CUstream stream,
                                int device_idx, Clock::time_point t0) {
  p.stream = stream;
  p.lane = lane;
  // EBT_PJRT_NO_READY / EBT_PJRT_NO_LATENCY take no samples, as in the
  // original
  if (device_idx >= 0 && !no_latency_diag_ && !no_ready_diag_) {
    p.device = laneIndex(device_idx);
    p.t0 = t0;
  }
  if (onready_ok_.load(std::memory_order_relaxed)) {
    auto* t = new Tracker();
    t->path = this;
    t->device = p.device;
    t->t0 = p.t0;
    t->reactor_fd = reactorhub::currentFd();
    cu::CUresult rc = api_.cuLaunchHostFunc(stream, &hostFnTrampoline, t);
    if (rc == cu::CUDA_SUCCESS) {
      p.tracker = t;
      return;
    }
    delete t;
    if (rc != cu::CUDA_ERROR_NOT_SUPPORTED) {
      // completion can never be confirmed: the transfer counts as failed
      latchXferError(cu::errorText(api_, "completion (cuLaunchHostFunc)", rc));
      p.ready_failed = true;
      return;
    }
    // a driver without host functions: downgrade the advertised clock, as
    // the original does on a refused OnReady, and await events from here on
    onready_ok_.store(false, std::memory_order_relaxed);
  }
  cu::CUevent ev = nullptr;
  cu::CUresult rc = api_.cuEventCreate(&ev, cu::CU_EVENT_DISABLE_TIMING);
  if (rc == cu::CUDA_SUCCESS) {
    rc = api_.cuEventRecord(ev, stream);
    if (rc == cu::CUDA_SUCCESS) {
      p.event = ev;
      return;
    }
    api_.cuEventDestroy(ev);
    latchXferError(cu::errorText(api_, "completion (cuEventRecord)", rc));
  } else {
    latchXferError(cu::errorText(api_, "completion (cuEventCreate)", rc));
  }
  p.ready_failed = true;
}

int CudaPath::awaitRelease(Pending& p) {
  int rc = 0;
  if (p.tracker) {
    Tracker* t = p.tracker;
    cu::CUresult q = cu::CUDA_SUCCESS;
    bool dropped = false;
    {
      CondLock lk(t->m);
      while (!t->done) {
        // a sticky device error keeps the host function from ever running:
        // poll the stream while waiting, and give up on an error
        if (t->cv.wait_for(lk.native(), std::chrono::milliseconds(50)) !=
                std::cv_status::timeout ||
            t->done)
          continue;
        makeCurrent(p.lane, false);
        q = api_.cuStreamQuery(p.stream);
        if (q != cu::CUDA_SUCCESS && q != cu::CUDA_ERROR_NOT_READY) break;
        // an idle stream has run every host function enqueued on it: a
        // tracker still not done was dropped with a failed copy (the fault
        // was reported to another waiter), so it never will be
        if (q == cu::CUDA_SUCCESS && !t->done) {
          dropped = true;
          break;
        }
        q = cu::CUDA_SUCCESS;
      }
    }
    if (dropped) {
      latchXferError("transfer completion: the copy's completion was "
                     "dropped by a stream fault");
      rc = 1;  // the tracker leaks with its dropped host function
    } else if (q != cu::CUDA_SUCCESS) {
      // the tracker stays with the stream, which may still run it
      latchXferError(cu::errorText(api_, "transfer completion", q));
      rc = 1;
    } else {
      delete t;
    }
    p.tracker = nullptr;
  }
  if (p.event) {
    makeCurrent(p.lane, false);
    cu::CUresult e = api_.cuEventSynchronize(p.event);
    if (e) {
      latchXferError(cu::errorText(api_, "transfer completion", e));
      rc = 1;
    } else if (p.device >= 0) {
      addDevLatency(p.device, usSince(p.t0));  // await clock: an upper bound
    }
    api_.cuEventDestroy(p.event);
    p.event = nullptr;
  }
  if (p.ready_failed) {
    // the copy was enqueued but its completion is unconfirmable: quiesce
    // the stream so the engine never reuses memory it may still touch
    makeCurrent(p.lane, false);
    api_.cuStreamSynchronize(p.stream);
    p.ready_failed = false;
    rc = 1;
  }
  // a device-to-device move that failed in flight is moved again through
  // the host bounce from its still-resident source: the tier's clean
  // fallback, always on (not fault-policy machinery)
  if (rc && p.d2d && !p.no_recover && recoverMovePending(p) == 0) rc = 0;
  // settle-time recovery (--maxerrors): resubmit the chunk's host source to
  // a survivor lane; a recovered settle counts rc 0 with its bytes on the
  // survivor, so the stripe and checkpoint ledgers stay exact
  if (rc && !p.d2d && !p.no_recover && faultPolicyActive() &&
      recoverPending(p) == 0)
    rc = 0;
  if (rc && p.bytes && !p.d2d) {
    // undo the count made at enqueue (moves never enter the lane counters)
    Lane& lane = laneFor(p.lane);
    (p.d2h ? lane.bytes_from_hbm : lane.bytes_to_hbm)
        .fetch_sub(p.bytes, std::memory_order_relaxed);
  }
  if (p.owned_src) {
    releaseScratch(p.owned_src);
    p.owned_src = nullptr;
  }
  settleStripe(p, rc);
  settleCkpt(p, rc);
  settleReshard(p, rc);
  settleIngest(p, rc);
  // a rotation retains one buffer per data-carrying pending; a tier block
  // retains one, carried by its last pending (its chunks carry no rot_gen)
  if (rc == 0 && p.rot_gen && (p.bytes || p.xm_block)) rotRetain(p);
  if (p.xm_buf) {
    // stream-ordered behind every copy of the block: a failure path frees
    // it too (teardown-path call: its result is not an error to report)
    makeCurrent(p.lane, false);
    api_.cuMemFreeAsync(p.xm_buf, p.stream);
    p.xm_buf = 0;
  }
  return rc;
}

int CudaPath::syncStream(int lane, cu::CUstream stream) {
  Pending p;
  p.no_recover = true;  // a bare quiesce, not a copy: nothing to charge
  attachCompletion(p, lane, stream, -1, {});
  return awaitRelease(p);
}

void CudaPath::enqueue(void* buf, std::vector<Pending>& ps,
                       int64_t stripe_unit, int64_t ckpt_shard,
                       int64_t reshard_unit, int64_t ingest_epoch) {
  if (ps.empty()) return;
  QueueShard& shard = shardFor(buf);
  TimedMutexLock lk(shard.m, laneFor(ps.front().lane).lock_wait_ns);
  auto& q = shard.pending[(uint64_t)(uintptr_t)buf];
  bool first = true;
  for (Pending& p : ps) {
    // every chunk of a planner-routed block carries the stripe flag
    // (failure attribution); only the first carries the unit, and
    // units_submitted counts as that tag enqueues, so a submit that fails
    // before enqueuing anything never strands the reconciliation
    p.stripe = stripe_unit >= 0;
    p.stripe_unit = first ? stripe_unit : -1;
    if (first && stripe_unit >= 0)
      stripe_units_submitted_.fetch_add(1, std::memory_order_relaxed);
    first = false;
    // restore blocks: every chunk's bytes count as submitted under the
    // shard (byte-level reconciliation)
    p.ckpt_shard = ckpt_shard;
    if (ckpt_shard >= 0 && p.bytes && ckpt_sub_bytes_)
      ckpt_sub_bytes_[ckpt_shard].fetch_add(p.bytes,
                                            std::memory_order_relaxed);
    // reshard storage reads: bytes count as submitted per plan unit
    p.reshard_unit = reshard_unit;
    if (reshard_unit >= 0 && reshard_unit_gen_)
      p.reshard_gen =
          reshard_unit_gen_[reshard_unit].load(std::memory_order_acquire);
    if (reshard_unit >= 0 && p.bytes && reshard_sub_bytes_)
      reshard_sub_bytes_[reshard_unit].fetch_add(p.bytes,
                                                 std::memory_order_relaxed);
    // ingest blocks: every chunk's bytes count as submitted under the epoch
    // and ride the in-flight gauge until their settle
    p.ingest_epoch = ingest_epoch;
    if (ingest_epoch >= 0 && p.bytes && ingest_sub_bytes_)
      ingestCountSubmitted(ingest_epoch, p.bytes);
    Lane& lane = laneFor(p.lane);
    (p.d2h ? lane.bytes_from_hbm : lane.bytes_to_hbm)
        .fetch_add(p.bytes, std::memory_order_relaxed);
    q.push_back(p);
  }
}

void CudaPath::waitShardDrained(QueueShard& shard, uint64_t key) const {
  QueueShard& s = shard;
  CondLock lk(s.m);
  while (s.draining.find(key) != s.draining.end()) s.cv.wait(lk.native());
}

// Directions 2 (pre-reuse) and 7 (pre-write): settle every pending transfer
// of `buf`. The queue leaves `pending` before its awaits; the draining
// ledger keeps its span visible to window eviction until they complete.
int CudaPath::settle(void* buf, int device_idx, bool d2h_barrier) {
  std::vector<Pending> waiting;
  uint64_t span = 0;
  const uint64_t key = (uint64_t)(uintptr_t)buf;
  Lane& lane = laneFor(device_idx);
  QueueShard& shard = shardFor(buf);
  {
    TimedMutexLock lk(shard.m, lane.lock_wait_ns);
    auto it = shard.pending.find(key);
    if (it != shard.pending.end()) {
      waiting = std::move(it->second);
      shard.pending.erase(it);
      for (const Pending& p : waiting) span += p.bytes;
      shard.draining[key] += span ? span : 1;
    }
  }
  if (waiting.empty()) {
    // an empty queue is not quiescence while another settle of this
    // buffer still holds its draining span
    waitShardDrained(shard, key);
    return 0;
  }
  lane.awaits.fetch_add(1, std::memory_order_relaxed);
  if (d2h_barrier) {
    // overlap evidence before any await: fetches that already completed
    // cost the write loop nothing
    for (Pending& p : waiting) {
      if (!p.tracker || !p.d2h) continue;
      MutexLock lk(p.tracker->m);
      if (p.tracker->done)
        d2h_overlap_bytes_.fetch_add(p.bytes, std::memory_order_relaxed);
    }
  }
  auto t0 = Clock::now();
  int rc = 0;
  // await ALL before reporting: a failed copy must not leave its siblings
  // still touching the buffer the engine is about to reuse
  for (Pending& p : waiting)
    if (awaitRelease(p)) rc = 1;
  if (d2h_barrier)
    d2h_await_wait_ns_.fetch_add(
        (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
            Clock::now() - t0)
            .count(),
        std::memory_order_relaxed);
  {
    TimedMutexLock lk(shard.m, lane.lock_wait_ns);
    auto it = shard.draining.find(key);
    if (it != shard.draining.end()) {
      it->second -= std::min(it->second, span ? span : 1);
      if (!it->second) shard.draining.erase(it);
    }
    shard.cv.notify_all();
  }
  waitShardDrained(shard, key);
  return rc;
}

// ---------------------------------------------------------------- buffers

CudaPath::RankBufs& CudaPath::rankBufs(int worker_rank, int lane) {
  MutexLock lk(rank_mutex_);
  auto& slot = rank_bufs_[{worker_rank, lane}];
  if (!slot) {
    slot = std::make_unique<RankBufs>();
    slot->lane = lane;
  }
  return *slot;
}

bool CudaPath::ensureBuffer(int lane, cu::CUdeviceptr* p, uint64_t* cap,
                            uint64_t len) {
  if (*p && *cap >= len) return true;
  // first use by this rank (or a longer block than ever before): the only
  // allocation on a worker thread. A buffer being replaced may still be read
  // by the lane's streams, so they drain before it is freed.
  uint64_t want = std::max(std::max(len, block_size_), (uint64_t)8);
  if (*p) {
    Lane& l = laneFor(lane);
    if (syncStream(lane, l.h2d) || syncStream(lane, l.d2h)) return false;
    api_.cuMemFree(*p);
    *p = 0;
    *cap = 0;
  }
  if (!check("cuMemAlloc", api_.cuMemAlloc(p, want))) return false;
  *cap = want;
  return true;
}

// ---------------------------------------------------------------- read leg

int CudaPath::submitH2D(int device_idx, const char* buf, uint64_t len,
                        int64_t stripe_unit, int64_t ckpt_shard,
                        int64_t reshard_unit, int64_t ingest_epoch,
                        uint64_t rot_gen, int plan_lane, uint64_t file_off) {
  // One range lookup per block: every chunk shares the answer; the hold
  // (holdForCopy) sits in the shard's draining ledger until the enqueued
  // pendings take over, and it also covers the submit-time retries below.
  const int li = laneIndex(device_idx);
  Lane& lane = *lanes_[li];
  QueueShard& shard = shardFor(buf);
  const bool zc = holdForCopy(buf, len, lane, shard);
  std::vector<Pending> submitted;
  int rc = 0;
  int chunk_i = 0;
  uint64_t off = 0;  // after the loop: the bytes that were enqueued
  for (; off < len; chunk_i++) {
    const uint64_t n = std::min(chunk_bytes_, len - off);
    // the block's chunks land at their offsets in the lane's landing
    // buffer; a chunk of a restoring generation lands in that generation's
    // memory instead, at its file offset
    const uint64_t dst = off + n <= landing_cap_ ? off : 0;
    auto submitChunk = [&](int ci, Pending* out) -> bool {
      Lane& cl = *lanes_[ci];
      if (!makeCurrent(ci, false)) return false;
      cu::CUdeviceptr to = cl.landing + dst;
      if (rot_gen) {
        to = rotDest(rot_gen, ckpt_shard, plan_lane, ci, file_off + off, n);
        if (!to) return false;
        if (!makeCurrent(ci, false)) return false;
      }
      auto t0 = Clock::now();
      if (!check("cuMemcpyHtoDAsync",
                 api_.cuMemcpyHtoDAsync(to, buf + off, n, cl.h2d)))
        return false;
      if (zc) zero_copy_count_.fetch_add(1, std::memory_order_relaxed);
      Pending p;
      p.bytes = n;
      p.src = buf + off;  // the settle-time recovery's source
      p.rot_gen = rot_gen;
      p.rot_lane = plan_lane;
      p.rot_off = file_off + off;
      attachCompletion(p, ci, cl.h2d, ci, t0);
      *out = p;
      return true;
    };
    // --tpustripe: the block's chunks rotate over the lanes; an ejection
    // that landed after copy()'s routing still moves the chunk to a
    // survivor
    int ci = chunkLane(li, chunk_i);
    if (faultPolicyActive()) ci = survivorFor(ci);
    Pending p;
    bool ok = submitChunk(ci, &p);
    if (!ok && faultPolicyActive()) {
      // submit-time recovery: charge the lane (which may eject it), then
      // walk the survivors, the twin of recoverPending's walk
      recordDeviceError(ci, firstTransferError());
      ok = walkSurvivors(ci, [&](int cand) {
             return submitChunk(cand, &p);
           }) >= 0;
    }
    if (!ok) {
      rc = 1;
      break;
    }
    submitted.push_back(p);
    off += n;
  }
  if (lanes_.size() > 1) makeCurrent(li, false);
  // chunks copied before a failure may still be reading the buffer: they
  // are enqueued either way so the barrier waits them out
  enqueue((void*)buf, submitted, stripe_unit, ckpt_shard, reshard_unit,
          ingest_epoch);
  // the bytes a submit-time failure did not enqueue never reach a settle:
  // they are dropped here, so the epoch's read == resident + dropped closes
  if (rc != 0 && ingest_epoch >= 0 && ingest_drop_bytes_ && len > off)
    ingest_drop_bytes_[ingest_epoch].fetch_add(len - off,
                                               std::memory_order_relaxed);
  if (zc) releaseHold(buf, len, lane, shard);
  return rc;
}

bool CudaPath::holdForCopy(const char* buf, uint64_t len, Lane& lane,
                           QueueShard& shard) {
  // The driver decides per call whether a source is pinned. A range whose
  // registration is changing (in_transit_) may still be pinned in the
  // driver while the cache already counts it gone: a copy issued then would
  // be an asynchronous DMA from memory about to be unpinned, which faults
  // the context. So that change is waited out first. Then the registration
  // check and an in-flight hold are taken together under reg_mutex_, so a
  // window eviction cannot unregister the range between the check and the
  // copies. Under EBT_PJRT_NO_READY the tier is excluded, as in the
  // original.
  const auto t0 = Clock::now();
  CondLock rlk(reg_mutex_);
  lane.lock_wait_ns.fetch_add(
      (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
          Clock::now() - t0)
          .count(),
      std::memory_order_relaxed);
  while (rangeInTransitLocked((uintptr_t)buf, len))
    reg_cv_.wait(rlk.native());
  const bool zc =
      dma_ok_ && !no_ready_diag_ && bufferRegisteredLocked(buf, len);
  if (zc) {
    MutexLock slk(shard.m);
    shard.draining[(uint64_t)(uintptr_t)buf] += len ? len : 1;
  }
  return zc;
}

void CudaPath::releaseHold(const char* buf, uint64_t len, Lane& lane,
                           QueueShard& shard) {
  TimedMutexLock lk(shard.m, lane.lock_wait_ns);
  auto it = shard.draining.find((uint64_t)(uintptr_t)buf);
  if (it != shard.draining.end()) {
    it->second -= std::min(it->second, len ? len : 1);
    if (!it->second) shard.draining.erase(it);
  }
  shard.cv.notify_all();  // a barrier may be waiting out this hold
}

// ---------------------------------------------------------------- xfer-mgr

void CudaPath::initXferMgr() {
  if (!envSet("EBT_PJRT_XFER_MGR")) return;
  if (stripe_) {
    latchRegError("transfer-manager tier requested but --tpustripe keeps "
                  "the chunked path");
    return;
  }
  if (!api_.mempool) {
    latchRegError("transfer-manager tier requested but the driver lacks the "
                  "stream-ordered allocator (cuMemAllocAsync, "
                  "cuMemFreeAsync, cuDeviceGetDefaultMemPool, "
                  "cuMemPoolSetAttribute, cuMemPoolTrimTo)");
    return;
  }
  // each lane's pool is resolved once here, never per block
  for (size_t d = 0; d < lanes_.size(); d++) {
    Lane& l = *lanes_[d];
    int pools = 0;
    cu::CUresult rc = api_.cuDeviceGetAttribute(
        &pools, cu::CU_DEVICE_ATTRIBUTE_MEMORY_POOLS_SUPPORTED, l.dev);
    if (rc || !pools) {
      latchRegError("transfer-manager tier requested but device " +
                    std::to_string(d) +
                    " does not support memory pools "
                    "(CU_DEVICE_ATTRIBUTE_MEMORY_POOLS_SUPPORTED is 0)");
      return;
    }
    cu::CUmemoryPool pool = nullptr;
    if ((rc = api_.cuDeviceGetDefaultMemPool(&pool, l.dev))) {
      latchRegError("transfer-manager " +
                    cu::errorText(api_, "cuDeviceGetDefaultMemPool", rc));
      return;
    }
    // keep freed blocks in the pool across synchronises: each block then
    // reuses the pool's memory instead of paying a real allocation
    uint64_t threshold = UINT64_MAX;
    if ((rc = api_.cuMemPoolSetAttribute(
             pool, cu::CU_MEMPOOL_ATTR_RELEASE_THRESHOLD, &threshold))) {
      latchRegError("transfer-manager " +
                    cu::errorText(api_, "cuMemPoolSetAttribute", rc));
      return;
    }
    l.pool = pool;
  }
  xm_ok_ = true;  // provisionally, for the probe's own dispatch
  // zeros, like the warm-up: checksum harnesses exclude probe traffic
  char probe8[8] = {0};
  makeCurrent(0, false);
  const int prc = submitH2DXferMgr(0, probe8, sizeof probe8);
  // drain whatever the probe enqueued, failed or not: its copies read
  // probe8's stack memory
  const int brc = settle(probe8, 0, false);
  if (prc || brc) {
    xm_ok_ = false;
    std::string cause;
    {
      MutexLock lk(err_mutex_);
      cause.swap(xfer_error_);  // a downgrade, not an error
    }
    latchRegError("transfer-manager probe failed: " + cause);
  }
  // the counter counts hot-path blocks, with no probe base to subtract
  // (the probe's bytes and latency sample go with the warm-up's reset)
  xfer_mgr_count_.store(0, std::memory_order_relaxed);
}

int CudaPath::submitH2DXferMgr(int device_idx, const char* buf, uint64_t len,
                               int64_t stripe_unit, int64_t ckpt_shard,
                               int64_t reshard_unit, int64_t ingest_epoch,
                               uint64_t rot_gen, int plan_lane,
                               uint64_t file_off) {
  const int li = laneIndex(device_idx);
  Lane& lane = *lanes_[li];
  const auto t0 = Clock::now();  // the block's one latency sample
  // a registered source is read in place by the copies: hold it against
  // eviction until they are enqueued, as submitH2D does (the tier counts
  // blocks, not zero-copy chunks)
  QueueShard& shard = shardFor(buf);
  const bool held = holdForCopy(buf, len, lane, shard);
  int rc = 0;
  // a restoring generation's block lands in the generation's memory and
  // needs no block buffer of its own
  cu::CUdeviceptr block = 0;
  if (!rot_gen &&
      !check("transfer-manager cuMemAllocAsync",
             api_.cuMemAllocAsync(&block, std::max<uint64_t>(len, 8),
                                  lane.h2d)))
    rc = 1;
  std::vector<Pending> submitted;
  uint64_t off = 0;  // after the loop: the bytes that were enqueued
  while (rc == 0 && off < len) {
    const uint64_t n = std::min(chunk_bytes_, len - off);
    cu::CUdeviceptr to = block + off;
    if (rot_gen) {
      to = rotDest(rot_gen, ckpt_shard, plan_lane, li, file_off + off, n);
      if (!to || !makeCurrent(li, false)) {
        rc = 1;
        break;
      }
    }
    if (!check("transfer-manager cuMemcpyHtoDAsync",
               api_.cuMemcpyHtoDAsync(to, buf + off, n, lane.h2d))) {
      rc = 1;
      break;
    }
    // no host source: a tier chunk is not recoverable under the fault
    // policy, as the original's manager pendings are not
    Pending p;
    p.bytes = n;
    attachCompletion(p, li, lane.h2d, -1, t0);  // no sample per chunk
    submitted.push_back(p);
    off += n;
  }
  if (rc == 0) {
    Pending p;
    p.xm_block = true;
    p.xm_buf = block;  // freed at this pending's settle
    p.rot_gen = rot_gen;
    attachCompletion(p, li, lane.h2d, li, t0);
    submitted.push_back(p);
    xfer_mgr_count_.fetch_add(1, std::memory_order_relaxed);
  } else if (block) {
    // failed mid-block: the chunks already enqueued may still be copying
    // into the buffer, so it rides the last of them and is freed after
    // they are waited out; with none enqueued it is freed now, still
    // stream-ordered
    if (!submitted.empty())
      submitted.back().xm_buf = block;
    else
      api_.cuMemFreeAsync(block, lane.h2d);
  }
  enqueue((void*)buf, submitted, stripe_unit, ckpt_shard, reshard_unit,
          ingest_epoch);
  // the bytes a submit-time failure did not enqueue never reach a settle
  if (rc != 0 && ingest_epoch >= 0 && ingest_drop_bytes_ && len > off)
    ingest_drop_bytes_[ingest_epoch].fetch_add(len - off,
                                               std::memory_order_relaxed);
  if (held) releaseHold(buf, len, lane, shard);
  return rc;
}

// --verify: the block's chunks land in one device block buffer, the verify
// kernel checks the whole block with one launch on the lane's H2D stream
// (behind the copies), and its int64[3] result comes back once into pinned
// memory. A mismatch is refined to the exact byte from the device copy of
// the first bad word, as the original's verifyStagedChunk does.
int CudaPath::submitH2DVerified(int worker_rank, int device_idx,
                                const char* buf, uint64_t len,
                                uint64_t file_off) {
  const int li = laneIndex(device_idx);
  Lane& lane = *lanes_[li];
  const uint64_t n8 = len / 8 * 8;
  if (n8) {
    RankBufs& rb = rankBufs(worker_rank, li);
    if (!ensureBuffer(li, &rb.verify, &rb.verify_cap, n8)) return 1;
    if (!rb.result && !check("cuMemAlloc", api_.cuMemAlloc(&rb.result, 24)))
      return 1;
    if (!rb.host && !check("cuMemHostAlloc",
                           api_.cuMemHostAlloc((void**)&rb.host, 32, 0)))
      return 1;
    // the copies are awaited below, inside this call: the hold keeps a
    // window eviction from unpinning the source until then
    QueueShard& shard = shardFor(buf);
    const bool held = holdForCopy(buf, n8, lane, shard);
    std::vector<Pending> waits;
    int rc = 0;
    for (uint64_t off = 0; off < n8;) {
      const uint64_t n = std::min(chunk_bytes_, n8 - off);
      auto t0 = Clock::now();
      if (!check("verify cuMemcpyHtoDAsync",
                 api_.cuMemcpyHtoDAsync(rb.verify + off, buf + off, n,
                                        lane.h2d))) {
        rc = 1;
        break;
      }
      Pending p;
      attachCompletion(p, li, lane.h2d, li, t0);
      waits.push_back(p);
      off += n;
    }
    if (rc == 0) {
      int krc = verify_fn_((const void*)(uintptr_t)rb.verify, n8 / 4,
                           file_off + verify_salt_,
                           (void*)(uintptr_t)rb.result,
                           (void*)(uintptr_t)lane.verify_ws, lane.sms,
                           lane.h2d);
      if (krc) {
        latchXferError("verify kernel launch failed: CUDA error " +
                       std::to_string(krc));
        rc = 1;
      } else {
        verify_launches_.fetch_add(1, std::memory_order_relaxed);
        if (!check("verify result cuMemcpyDtoHAsync",
                   api_.cuMemcpyDtoHAsync(rb.host, rb.result, 24, lane.h2d)))
          rc = 1;
      }
    }
    for (Pending& p : waits)  // await ALL even after a failure
      if (awaitRelease(p)) rc = 1;
    if (syncStream(li, lane.h2d)) rc = 1;
    if (held) releaseHold(buf, n8, lane, shard);
    if (rc) return 1;
    if (rb.host[1] != 0) {
      const uint64_t first = (uint64_t)rb.host[2];
      const uint64_t word_off = file_off + 8 * first;
      uint64_t bad_byte = 0;
      if (check("verify word cuMemcpyDtoHAsync",
                api_.cuMemcpyDtoHAsync(&rb.host[3], rb.verify + 8 * first, 8,
                                       lane.h2d)) &&
          syncStream(li, lane.h2d) == 0) {
        const uint64_t got = (uint64_t)rb.host[3];
        const uint64_t expect = word_off + verify_salt_;
        for (int b = 0; b < 8; b++) {
          if (((got >> (8 * b)) & 0xFF) != ((expect >> (8 * b)) & 0xFF)) {
            bad_byte = b;
            break;
          }
        }
      }
      latchXferError("on-device data verification failed at file offset " +
                     std::to_string(word_off + bad_byte));
      return 2;
    }
  }
  if (len > n8) {
    // the sub-word tail is too small for the kernel: checked on the host
    uint64_t bad = checkVerifyPattern(buf + n8, len - n8, file_off + n8,
                                      verify_salt_);
    if (bad != UINT64_MAX) {
      latchXferError("data verification failed at file offset " +
                     std::to_string(bad));
      return 2;
    }
  }
  lane.bytes_to_hbm.fetch_add(len, std::memory_order_relaxed);
  return 0;
}

// ---------------------------------------------------------------- write leg

int CudaPath::roundTripH2D(int worker_rank, int device_idx, const char* buf,
                           uint64_t len) {
  // synchronous: verify is a correctness mode; the next direction-1 fetch
  // of this rank serves these bytes back. Under --tpustripe the chunks
  // rotate over the lanes, each into that lane's staged buffer at its
  // offset, and the fetch gathers them from the same lanes; the bytes
  // count on the rank's lane, as in the original.
  const int li = laneIndex(device_idx);
  RankBufs& rb = rankBufs(worker_rank, li);
  rb.staged_len = 0;
  const int nl = stripe_ ? std::min<int>((int)lanes_.size(),
                                         (int)((len + chunk_bytes_ - 1) /
                                               chunk_bytes_))
                         : 1;
  for (int k = 0; k < std::max(nl, 1); k++) {
    const int ci = chunkLane(li, k);
    RankBufs& rc_buf = rankBufs(worker_rank, ci);
    if (ci != li && !makeCurrent(ci, false)) return 1;
    if (!ensureBuffer(ci, &rc_buf.staged, &rc_buf.staged_cap, len)) return 1;
  }
  if (nl > 1) makeCurrent(li, false);
  std::vector<Pending> waits;
  int rc = 0;
  int chunk_i = 0;
  for (uint64_t off = 0; off < len; chunk_i++) {
    const uint64_t n = std::min(chunk_bytes_, len - off);
    const int ci = chunkLane(li, chunk_i);
    Lane& cl = *lanes_[ci];
    if (ci != li && !makeCurrent(ci, false)) {
      rc = 1;
      break;
    }
    auto t0 = Clock::now();
    if (!check("round-trip cuMemcpyHtoDAsync",
               api_.cuMemcpyHtoDAsync(rankBufs(worker_rank, ci).staged + off,
                                      buf + off, n, cl.h2d))) {
      rc = 1;
      break;
    }
    Pending p;
    attachCompletion(p, ci, cl.h2d, ci, t0);
    waits.push_back(p);
    off += n;
  }
  if (nl > 1) makeCurrent(li, false);
  for (Pending& p : waits)
    if (awaitRelease(p)) rc = 1;
  if (rc) return 1;
  rb.staged_len = len;
  lanes_[li]->bytes_to_hbm.fetch_add(len, std::memory_order_relaxed);
  return 0;
}

cu::CUdeviceptr CudaPath::deviceSource(int worker_rank, int device_idx,
                                       uint64_t len, int variant) {
  auto key = std::make_tuple(worker_rank, len, variant);
  {
    MutexLock lk(src_mutex_);
    auto it = dev_src_.find(key);
    if (it != dev_src_.end()) return it->second.second;
  }
  // A device-resident source of exactly `len` bytes, made on first use per
  // (rank, length, variant) with the original's rank-seeded random content,
  // so both packages write identical bytes (all-zero sources would hand
  // compressing storage trivially compressible writes).
  std::vector<char> host(len);
  {
    RandAlgoXoshiro rng(0x9E3779B97F4A7C15ULL ^ (uint64_t)(worker_rank + 1) ^
                        ((uint64_t)(variant + 1) << 32));
    rng.fillBuf(host.data(), host.size());
  }
  const int li = laneIndex(device_idx);
  Lane& lane = *lanes_[li];
  cu::CUdeviceptr p = 0;
  if (!check("write-source cuMemAlloc", api_.cuMemAlloc(&p, len))) return 0;
  if (!check("write-source cuMemcpyHtoDAsync",
             api_.cuMemcpyHtoDAsync(p, host.data(), len, lane.h2d)) ||
      syncStream(li, lane.h2d)) {
    syncStream(li, lane.h2d);
    api_.cuMemFree(p);
    return 0;
  }
  MutexLock lk(src_mutex_);
  auto [it, inserted] = dev_src_.emplace(key, std::make_pair(li, p));
  if (!inserted) api_.cuMemFree(p);  // lost a race; keep the winner
  return it->second.second;
}

int CudaPath::fetchDeviceSource(int worker_rank, int device_idx, char* buf,
                                uint64_t len, bool deferred) {
  // chunk-sized fetches from ROTATING sources, so the written stream does
  // not repeat one chunk's bytes; a tail chunk has its own (rank, n) class
  const uint64_t chunk = std::min(chunk_bytes_, len);
  const int li = laneIndex(device_idx);
  Lane& lane = *lanes_[li];
  std::vector<Pending> fetches;
  int rc = 0;
  int i = 0;
  for (uint64_t off = 0; off < len; i++) {
    const uint64_t n = std::min(chunk, len - off);
    cu::CUdeviceptr src = deviceSource(worker_rank, device_idx, n,
                                       i % kSrcVariants);
    if (!src) {
      rc = 1;
      break;
    }
    auto t0 = Clock::now();
    if (!check("cuMemcpyDtoHAsync",
               api_.cuMemcpyDtoHAsync(buf + off, src, n, lane.d2h))) {
      rc = 1;
      break;
    }
    Pending p;
    p.d2h = true;
    p.bytes = deferred ? n : 0;  // counted at enqueue
    attachCompletion(p, li, lane.d2h, li, t0);
    fetches.push_back(p);
    off += n;
  }
  if (deferred) {
    // fetches submitted before a failure are still writing into buf: they
    // are enqueued either way so the barriers wait them out
    enqueue(buf, fetches);
    if (rc == 0) d2h_deferred_count_.fetch_add(1, std::memory_order_relaxed);
    return rc;
  }
  for (Pending& p : fetches)  // await ALL even after a failure
    if (awaitRelease(p)) rc = 1;
  if (rc) return 1;
  lane.bytes_from_hbm.fetch_add(len, std::memory_order_relaxed);
  return 0;
}

// Verified writes: the fill kernel (B3) writes the block's pattern into the
// rank's device buffer and it is fetched to the host buffer, both on the
// lane's D2H stream (so the next block's fill waits for this fetch). The
// base is a kernel argument; the sub-word tail is generated on the host.
int CudaPath::generateD2H(int worker_rank, int device_idx, char* buf,
                          uint64_t len, uint64_t file_off, bool deferred) {
  const int li = laneIndex(device_idx);
  Lane& lane = *lanes_[li];
  const uint64_t n8 = len / 8 * 8;
  std::vector<Pending> ps;
  int rc = 0;
  if (n8) {
    RankBufs& rb = rankBufs(worker_rank, li);
    if (!ensureBuffer(li, &rb.gen, &rb.gen_cap, n8)) return 1;
    auto t0 = Clock::now();
    int krc = fill_fn_((void*)(uintptr_t)rb.gen, n8 / 8,
                       file_off + verify_salt_, lane.d2h);
    if (krc) {
      latchXferError("fill kernel launch failed: CUDA error " +
                     std::to_string(krc));
      return 1;
    }
    fill_launches_.fetch_add(1, std::memory_order_relaxed);
    if (!check("write-gen cuMemcpyDtoHAsync",
               api_.cuMemcpyDtoHAsync(buf, rb.gen, n8, lane.d2h))) {
      rc = 1;
      syncStream(li, lane.d2h);
    } else {
      Pending p;
      p.d2h = true;
      p.bytes = deferred ? len : 0;  // counted at enqueue
      attachCompletion(p, li, lane.d2h, li, t0);
      ps.push_back(p);
    }
  }
  if (rc == 0 && len > n8)
    fillVerifyPattern(buf + n8, len - n8, file_off + n8, verify_salt_);
  if (deferred) {
    enqueue(buf, ps);
    if (rc == 0) d2h_deferred_count_.fetch_add(1, std::memory_order_relaxed);
    return rc;
  }
  for (Pending& p : ps)
    if (awaitRelease(p)) rc = 1;
  if (rc) return 1;
  lane.bytes_from_hbm.fetch_add(len, std::memory_order_relaxed);
  return 0;
}

int CudaPath::serveD2H(int worker_rank, int device_idx, char* buf,
                       uint64_t len, uint64_t file_off) {
  const bool deferred = d2h_depth_.load(std::memory_order_relaxed) > 1;
  if (write_gen_on_)
    return generateD2H(worker_rank, device_idx, buf, len, file_off, deferred);
  // round-trip mode: serve back the block this rank just staged; never
  // deferred (verify writes are a correctness mode)
  const int li = laneIndex(device_idx);
  RankBufs& rb = rankBufs(worker_rank, li);
  if (len && rb.staged_len == len) {
    std::vector<Pending> fetches;
    int rc = 0;
    int chunk_i = 0;
    for (uint64_t off = 0; off < len; chunk_i++) {
      const uint64_t n = std::min(chunk_bytes_, len - off);
      const int ci = chunkLane(li, chunk_i);
      Lane& cl = *lanes_[ci];
      if (ci != li && !makeCurrent(ci, false)) {
        rc = 1;
        break;
      }
      auto t0 = Clock::now();
      if (!check("round-trip cuMemcpyDtoHAsync",
                 api_.cuMemcpyDtoHAsync(
                     buf + off, rankBufs(worker_rank, ci).staged + off, n,
                     cl.d2h))) {
        rc = 1;
        break;
      }
      Pending p;
      p.d2h = true;
      // latency attributed to the serving rank's lane, as in the original
      attachCompletion(p, ci, cl.d2h, li, t0);
      fetches.push_back(p);
      off += n;
    }
    if (stripe_ && lanes_.size() > 1) makeCurrent(li, false);
    for (Pending& p : fetches)
      if (awaitRelease(p)) rc = 1;
    if (rc) return 1;
    lanes_[li]->bytes_from_hbm.fetch_add(len, std::memory_order_relaxed);
    return 0;
  }
  return fetchDeviceSource(worker_rank, device_idx, buf, len, deferred);
}

// ---------------------------------------------------------------- kernels

std::string CudaPath::enableVerify(uint64_t salt,
                                   const std::string& kernel_lib) {
  if (!ok()) return init_error_;
  if (sealed_.load(std::memory_order_acquire))
    return "verify must be enabled before the first data transfer";
  void* fn = nullptr;
  void* ws_fn = nullptr;
  std::string err;
  if (!cu::loadKernel(kernel_lib, "ebt_verify_u32", &fn, &err) ||
      !cu::loadKernel(kernel_lib, "ebt_verify_workspace_bytes", &ws_fn, &err))
    return err;
  auto ws_bytes = (cu::VerifyWorkspaceBytesFn)ws_fn;
  // one workspace per lane (the kernel runs on the lane's H2D stream, whose
  // launches run in order), made and zeroed once
  for (size_t d = 0; d < lanes_.size(); d++) {
    Lane& l = *lanes_[d];
    if (l.verify_ws) continue;
    makeCurrent((int)d, true);
    const uint64_t bytes = ws_bytes(l.sms);
    cu::CUresult rc = api_.cuMemAlloc(&l.verify_ws, bytes);
    if (rc) return cu::errorText(api_, "verify workspace cuMemAlloc", rc);
    rc = api_.cuMemsetD8Async(l.verify_ws, 0, bytes, l.h2d);
    if (rc == cu::CUDA_SUCCESS) rc = api_.cuStreamSynchronize(l.h2d);
    if (rc) return cu::errorText(api_, "verify workspace cuMemsetD8Async", rc);
  }
  verify_fn_ = (cu::VerifyU32Fn)fn;
  verify_salt_ = salt;
  verify_on_ = true;
  return "";
}

std::string CudaPath::enableWriteGen(uint64_t salt,
                                     const std::string& kernel_lib) {
  if (!ok()) return init_error_;
  if (sealed_.load(std::memory_order_acquire))
    return "write generation must be enabled before the first data transfer";
  void* fn = nullptr;
  std::string err;
  if (!cu::loadKernel(kernel_lib, "ebt_fill_u64", &fn, &err)) return err;
  fill_fn_ = (cu::FillU64Fn)fn;
  verify_salt_ = salt;
  write_gen_on_ = true;
  return "";
}

void CudaPath::kernelLaunches(uint64_t out[2]) {
  out[0] = verify_launches_.load(std::memory_order_relaxed);
  out[1] = fill_launches_.load(std::memory_order_relaxed);
}

void CudaPath::resetKernelLaunches() {
  verify_launches_.store(0, std::memory_order_relaxed);
  fill_launches_.store(0, std::memory_order_relaxed);
}

// ---------------------------------------------------------------- dispatch

int CudaPath::copy(int worker_rank, int device_idx, int direction, void* buf,
                   uint64_t len, uint64_t file_offset) {
  if (!ok()) return 1;
  // the kernel entries are set without a lock, which is safe only because
  // every enable precedes the first data transfer: data directions seal
  // (the stripe, checkpoint and reshard plans are sealed by the same
  // store: they are read lock-free below; barriers 8/10/15 and the begins
  // 9/13 do not seal, the reshard move 14 does)
  if (direction == 0 || direction == 1 || direction == 3 || direction == 14)
    sealed_.store(true, std::memory_order_release);
  // the stripe planner owns direction-0 block->lane placement, decided
  // before the lane counters below so they follow the lane the bytes target
  bool striped = false;
  if (direction == 0 && stripe_policy_.load(std::memory_order_acquire) != 0) {
    device_idx = stripeDeviceFor(file_offset);
    striped = true;
  }
  // the lane the plan chose, before any replanning: a rotation chunk lands
  // in its shard's memory for this lane, wherever it is copied
  const int plan_lane = laneIndex(device_idx);
  // live replanning (fault policy on): a direction-0 placement on an
  // ejected lane, whether from the stripe planner, the checkpoint manifest
  // or the rank routing, moves to a fixed survivor; replanned_units counts
  // each such block
  if (direction == 0 && faultPolicyActive()) {
    const int planned = laneIndex(device_idx);
    device_idx = survivorFor(planned);
    if (device_idx != planned)
      replanned_units_.fetch_add(1, std::memory_order_relaxed);
  }
  const int li = laneIndex(device_idx);
  if (!makeCurrent(li, false)) return 1;
  if (direction == 0 || direction == 1 || direction == 3)
    lanes_[li]->submits.fetch_add(1, std::memory_order_relaxed);
  switch (direction) {
    case 0: {
      // checkpoint restore: the engine owns placement (device_idx is the
      // shard's manifest lane); the ledger tags this worker's blocks with
      // the shard it registered via direction 9
      const int64_t cs = ckpt_active_.load(std::memory_order_acquire)
                             ? ckptShardFor(worker_rank)
                             : -1;
      // reshard: storage reads (read units, failed-move fallbacks) are
      // tagged with the unit the worker registered via direction 13
      const int64_t ru = reshard_active_.load(std::memory_order_acquire)
                             ? reshardUnitFor(worker_rank)
                             : -1;
      // ingest: the block counts as read under the epoch the worker
      // registered via direction 11 whatever the submit and settle do, so
      // read == resident + dropped can close
      const int64_t ie = ingest_active_.load(std::memory_order_acquire)
                             ? ingestEpochFor(worker_rank)
                             : -1;
      if (ie >= 0 && ingest_read_bytes_) {
        ingest_read_bytes_[ie].fetch_add(len, std::memory_order_relaxed);
        if (ingest_record_size_ && len > ingest_record_size_)
          ingest_batch_coalesce_.fetch_add(1, std::memory_order_relaxed);
      }
      // serving rotation: the rotator's blocks are the background class,
      // paced by the lane bucket before they touch a lane
      const uint64_t rot_gen = t_rot_path == gen_ ? t_rot_gen : 0;
      if (rot_gen) {
        bgLaneThrottle(len);
        bg_h2d_bytes_.fetch_add(len, std::memory_order_relaxed);
      }
      if (verify_on_) {
        // a synchronous correctness mode: placement still honours the
        // stripe plan (the block is checked on the lane that received it),
        // but no deferred units exist to count; the checkpoint ledger
        // accounts the block inline
        const int vrc = submitH2DVerified(worker_rank, li, (const char*)buf,
                                          len, file_offset);
        // the config refuses --verify with --ingest and --rotate; the epoch
        // ledger still accounts the block for any caller composition
        if (ie >= 0 && ingest_sub_bytes_) {
          ingest_sub_bytes_[ie].fetch_add(len, std::memory_order_relaxed);
          (vrc == 0 ? ingest_res_bytes_ : ingest_drop_bytes_)[ie].fetch_add(
              len, std::memory_order_relaxed);
          if (vrc != 0) latchIngestError(li, ie, firstTransferError());
        }
        if (cs >= 0 && ckpt_sub_bytes_) {
          ckpt_sub_bytes_[cs].fetch_add(len, std::memory_order_relaxed);
          if (vrc == 0) {
            ckpt_res_bytes_[cs].fetch_add(len, std::memory_order_relaxed);
            ckpt_dev_bytes_[(size_t)li % ckpt_dev_bytes_.size()]->fetch_add(
                len, std::memory_order_relaxed);
          } else {
            latchCkptError(li, cs, firstTransferError());
          }
        }
        // the config refuses --verify with --reshard; the unit ledger still
        // accounts the block for any caller composition
        if (ru >= 0 && reshard_sub_bytes_) {
          reshard_sub_bytes_[ru].fetch_add(len, std::memory_order_relaxed);
          if (vrc == 0) {
            reshard_res_bytes_[ru].fetch_add(len, std::memory_order_relaxed);
            reshard_read_bytes_.fetch_add(len, std::memory_order_relaxed);
          } else {
            latchReshardError(ru, -1, li, firstTransferError());
          }
        }
        return vrc;
      }
      const int64_t su =
          striped ? (int64_t)(file_offset / block_size_) : -1;
      if (rot_gen && cs < 0) {
        latchXferError("rotation block outside a checkpoint shard (no "
                       "direction-9 begin on this thread)");
        return 1;
      }
      // the opt-in transfer-manager tier (one device buffer per block; never
      // active under --tpustripe) or the chunked landing-ring path
      const int src_rc =
          xm_ok_ ? submitH2DXferMgr(li, (const char*)buf, len, su, cs, ru, ie,
                                    rot_gen, plan_lane, file_offset)
                 : submitH2D(li, (const char*)buf, len, su, cs, ru, ie,
                             rot_gen, plan_lane, file_offset);
      // a submit-time failure never reaches a barrier's settle, so the
      // per-device attribution is latched here
      if (src_rc != 0 && striped)
        latchStripeError(li, su, firstTransferError());
      if (src_rc != 0 && cs >= 0)
        latchCkptError(li, cs, firstTransferError());
      if (src_rc != 0 && ru >= 0)
        latchReshardError(ru, -1, li, firstTransferError());
      if (src_rc != 0 && ie >= 0)
        latchIngestError(li, ie, firstTransferError());
      return src_rc;
    }
    case 1:
      return serveD2H(worker_rank, li, (char*)buf, len, file_offset);
    case 2:
      return settle(buf, li, /*d2h_barrier=*/false);
    case 3:
      return roundTripH2D(worker_rank, li, (const char*)buf, len);
    case 4:
      // a failed registration is a clean per-buffer fall to the staged
      // tier (cause in regError()), never a worker error
      registerBuffer(buf, len);
      return 0;
    case 5:
      // len > 0: unpin every cached window inside [buf, buf+len) (engine
      // cleanup before munmap); len == 0: the exact-base lifetime pin
      if (len)
        deregisterRange(buf, len);
      else
        deregisterBuffer(buf);
      return 0;
    case 6:
      registerWindow(buf, len);
      return 0;
    case 7:
      return settle(buf, li, /*d2h_barrier=*/true);
    case 8:
      // the stripe tier's slice-wide gather barrier
      return stripeBarrier();
    case 9:
      // checkpoint shard begin: len carries the manifest shard index
      return ckptBeginShard(worker_rank, (int64_t)len);
    case 10:
      // checkpoint all-resident barrier (the restore's measured seal)
      return ckptBarrier();
    case 11:
      // ingest epoch begin: len carries the epoch index
      return ingestBeginEpoch(worker_rank, (int64_t)len);
    case 12:
      // ingest all-resident barrier (the phase's measured seal)
      return ingestBarrier();
    case 13:
      // reshard unit begin: len carries the plan unit
      return reshardBeginUnit(worker_rank, (int64_t)len);
    case 14:
      // reshard move: len carries the plan unit, which names src, dst and
      // bytes
      return reshardMove(worker_rank, (int64_t)len);
    case 15:
      // the all-resharded barrier (the RESHARD phase's measured seal)
      return reshardBarrier();
    case 16:
      // serving rotation begin: len carries the fresh generation,
      // file_offset the current background byte/s budget
      return rotateBegin(worker_rank, len, file_offset);
    case 17:
      // serving rotation swap (after the direction-10 barrier)
      return rotateSwap(worker_rank);
    default:
      latchXferError("device-copy direction " + std::to_string(direction) +
                     " is not handled by the CUDA engine");
      return 1;
  }
}

int CudaPath::copyTrampoline(void* ctx, int worker_rank, int device_idx,
                             int direction, void* buf, uint64_t len,
                             uint64_t file_offset) {
  return static_cast<CudaPath*>(ctx)->copy(worker_rank, device_idx, direction,
                                           buf, len, file_offset);
}

// ---------------------------------------------------------------- counters

void CudaPath::stats(uint64_t* bytes_to_hbm, uint64_t* bytes_from_hbm) const {
  uint64_t to = 0, from = 0;
  for (const auto& lane : lanes_) {
    to += lane->bytes_to_hbm.load(std::memory_order_relaxed);
    from += lane->bytes_from_hbm.load(std::memory_order_relaxed);
  }
  if (bytes_to_hbm) *bytes_to_hbm = to;
  if (bytes_from_hbm) *bytes_from_hbm = from;
}

std::string CudaPath::firstTransferError() const {
  MutexLock lk(err_mutex_);
  return xfer_error_;
}

void CudaPath::resetDeviceLatency() {
  for (auto& lane : lanes_) {
    MutexLock lk(lane->histo_m);
    lane->histo.reset();
  }
}

bool CudaPath::deviceLatency(int device_idx, LatencyHistogram* out) const {
  if (device_idx < 0 || (size_t)device_idx >= lanes_.size()) return false;
  Lane& lane = *lanes_[device_idx];
  MutexLock lk(lane.histo_m);
  *out = lane.histo;
  return true;
}

bool CudaPath::laneStats(int lane_idx, LaneStats* out) const {
  if (lane_idx < 0 || (size_t)lane_idx >= lanes_.size()) return false;
  const Lane& lane = *lanes_[lane_idx];
  out->submits = lane.submits.load(std::memory_order_relaxed);
  out->awaits = lane.awaits.load(std::memory_order_relaxed);
  out->lock_wait_ns = lane.lock_wait_ns.load(std::memory_order_relaxed);
  out->bytes_to_hbm = lane.bytes_to_hbm.load(std::memory_order_relaxed);
  out->bytes_from_hbm = lane.bytes_from_hbm.load(std::memory_order_relaxed);
  return true;
}

void CudaPath::d2hStats(uint64_t out[3]) const {
  out[0] = d2h_deferred_count_.load(std::memory_order_relaxed);
  out[1] = d2h_await_wait_ns_.load(std::memory_order_relaxed);
  out[2] = d2h_overlap_bytes_.load(std::memory_order_relaxed);
}

void CudaPath::drainAll() {
  std::vector<Pending> moves;
  {
    MutexLock lk(reshard_mutex_);
    moves.swap(reshard_pending_);
  }
  for (Pending& p : moves) awaitRelease(p);
  settleAllShards();
}

int CudaPath::settleAllShards() {
  // per shard: move the queues out under the shard lock, await outside it,
  // then release the draining spans (the barriers' discipline): a
  // per-buffer barrier that finds its queue gone waits out these holds
  // before the engine reuses the buffer. Failure attribution lands per
  // pending via settleStripe/settleCkpt inside awaitRelease.
  int rc = 0;
  for (auto& shard : shards_) {
    std::unordered_map<uint64_t, std::vector<Pending>> all;
    std::unordered_map<uint64_t, uint64_t> spans;
    {
      MutexLock lk(shard->m);
      all.swap(shard->pending);
      for (auto& kv : all) {
        uint64_t span = 0;
        for (const Pending& p : kv.second) span += p.bytes;
        spans[kv.first] = span ? span : 1;
        shard->draining[kv.first] += spans[kv.first];
      }
    }
    for (auto& kv : all)
      for (Pending& p : kv.second)
        if (awaitRelease(p)) rc = 1;
    MutexLock lk(shard->m);
    for (auto& kv : spans) {
      auto it = shard->draining.find(kv.first);
      if (it == shard->draining.end()) continue;
      it->second -= std::min(it->second, kv.second);
      if (!it->second) shard->draining.erase(it);
    }
    shard->cv.notify_all();
  }
  return rc;
}

// ---------------------------------------------------------------- stripe tier

void CudaPath::settleStripe(const Pending& p, int rc) {
  if (p.stripe_unit >= 0)
    stripe_units_awaited_.fetch_add(1, std::memory_order_relaxed);
  // only planner-routed copies attribute to a device (a d2h fetch failing
  // while a plan is active is not a stripe failure)
  if (rc == 0 || !p.stripe) return;
  latchStripeError(p.lane, p.stripe_unit, firstTransferError());
}

void CudaPath::latchStripeError(int device, int64_t unit,
                                const std::string& cause) {
  std::string msg = "device " + std::to_string(device);
  if (unit >= 0) msg += " unit " + std::to_string(unit);
  msg += ": " + (cause.empty() ? std::string("transfer failed") : cause);
  MutexLock lk(stripe_mutex_);
  if (stripe_error_.empty()) stripe_error_ = msg;
}

std::string CudaPath::stripeError() const {
  MutexLock lk(stripe_mutex_);
  return stripe_error_;
}

int CudaPath::setStripePlan(int policy, uint64_t total_blocks,
                            uint64_t unit_blocks) {
  if (!ok() || policy < 0 || policy > 2) return 1;
  if (sealed_.load(std::memory_order_acquire)) return 1;
  if (policy != 0 && (total_blocks == 0 || unit_blocks == 0 || !block_size_))
    return 1;
  stripe_unit_blocks_ = unit_blocks ? unit_blocks : 1;
  const uint64_t units =
      (total_blocks + stripe_unit_blocks_ - 1) / stripe_unit_blocks_;
  const uint64_t nlanes = lanes_.size();
  stripe_units_per_dev_ = (units + nlanes - 1) / nlanes;
  stripe_policy_.store(policy, std::memory_order_release);
  return 0;
}

int CudaPath::stripeDeviceFor(uint64_t file_offset) const {
  // acquire pairs with setStripePlan's release: a reader that sees the
  // policy also sees the geometry
  const int policy = stripe_policy_.load(std::memory_order_acquire);
  if (policy == 0) return -1;
  const uint64_t block = block_size_ ? file_offset / block_size_ : 0;
  const uint64_t unit = block / stripe_unit_blocks_;
  const uint64_t nlanes = lanes_.size();
  if (policy == 1) return (int)(unit % nlanes);
  // contiguous runs: lane d owns units [d*per_dev, (d+1)*per_dev); the
  // tail clamps to the last lane
  const uint64_t d = stripe_units_per_dev_ ? unit / stripe_units_per_dev_ : 0;
  return (int)std::min<uint64_t>(d, nlanes - 1);
}

CudaPath::StripeStats CudaPath::stripeStats() const {
  StripeStats s;
  s.units_submitted = stripe_units_submitted_.load(std::memory_order_relaxed);
  s.units_awaited = stripe_units_awaited_.load(std::memory_order_relaxed);
  s.barrier_wait_ns = stripe_barrier_wait_ns_.load(std::memory_order_relaxed);
  s.barriers = stripe_barriers_.load(std::memory_order_relaxed);
  return s;
}

int CudaPath::stripeBarrier() {
  auto t0 = Clock::now();
  const int rc = settleAllShards();
  stripe_barrier_wait_ns_.fetch_add(
      (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
          Clock::now() - t0)
          .count(),
      std::memory_order_relaxed);
  stripe_barriers_.fetch_add(1, std::memory_order_relaxed);
  return rc;
}

// ---------------------------------------------------------------- checkpoint

void CudaPath::settleCkpt(const Pending& p, int rc) {
  if (p.ckpt_shard < 0 || !ckpt_sub_bytes_) return;
  if (rc == 0) {
    if (p.bytes) {
      ckpt_res_bytes_[p.ckpt_shard].fetch_add(p.bytes,
                                              std::memory_order_relaxed);
      ckpt_dev_bytes_[(size_t)(p.lane < 0 ? 0 : p.lane) %
                      ckpt_dev_bytes_.size()]
          ->fetch_add(p.bytes, std::memory_order_relaxed);
    }
    return;
  }
  latchCkptError(p.lane, p.ckpt_shard, firstTransferError());
}

void CudaPath::latchCkptError(int device, int64_t shard,
                              const std::string& cause) {
  std::string msg = "device " + std::to_string(device);
  if (shard >= 0) msg += " shard " + std::to_string(shard);
  msg += ": " +
         (cause.empty() ? std::string("restore transfer failed") : cause);
  MutexLock lk(ckpt_mutex_);
  if (ckpt_error_.empty()) ckpt_error_ = msg;
}

std::string CudaPath::ckptError() const {
  MutexLock lk(ckpt_mutex_);
  return ckpt_error_;
}

int CudaPath::setCkptPlan(int nshards, const std::vector<int>& entry_shard,
                          const std::vector<int>& entry_device,
                          const std::vector<uint64_t>& entry_bytes) {
  if (!ok() || nshards <= 0) return 1;
  if (sealed_.load(std::memory_order_acquire)) return 1;
  if (entry_shard.empty() || entry_shard.size() != entry_device.size() ||
      entry_shard.size() != entry_bytes.size())
    return 1;
  std::vector<uint64_t> expected((size_t)nshards, 0);
  for (size_t i = 0; i < entry_shard.size(); i++) {
    const int s = entry_shard[i];
    const int d = entry_device[i];
    if (s < 0 || s >= nshards || d < 0 || d >= (int)lanes_.size() ||
        entry_bytes[i] == 0)
      return 1;
    expected[(size_t)s] += entry_bytes[i];
  }
  ckpt_nshards_ = (uint64_t)nshards;
  ckpt_expected_bytes_ = std::move(expected);
  ckpt_entry_shard_ = entry_shard;
  ckpt_entry_device_ = entry_device;
  ckpt_entry_bytes_ = entry_bytes;
  ckpt_sub_bytes_.reset(new std::atomic<uint64_t>[(size_t)nshards]);
  ckpt_res_bytes_.reset(new std::atomic<uint64_t>[(size_t)nshards]);
  for (int s = 0; s < nshards; s++) {
    ckpt_sub_bytes_[s].store(0, std::memory_order_relaxed);
    ckpt_res_bytes_[s].store(0, std::memory_order_relaxed);
  }
  ckpt_dev_bytes_.clear();
  for (size_t d = 0; d < lanes_.size(); d++)
    ckpt_dev_bytes_.emplace_back(new std::atomic<uint64_t>(0));
  ckpt_active_.store(1, std::memory_order_release);
  return 0;
}

int CudaPath::ckptBeginShard(int worker_rank, int64_t shard) {
  if (!ckpt_active_.load(std::memory_order_acquire)) return 1;
  if (shard < 0 || (uint64_t)shard >= ckpt_nshards_) return 1;
  // a begin marks a fresh restore of this shard: re-arm its counters so
  // repeated restore phases reconcile the latest one (the previous phase's
  // all-resident barrier settled everything it had in flight)
  ckpt_sub_bytes_[shard].store(0, std::memory_order_relaxed);
  ckpt_res_bytes_[shard].store(0, std::memory_order_relaxed);
  {
    MutexLock lk(ckpt_mutex_);
    ckpt_cur_shard_[worker_rank] = shard;
  }
  // the rotator restoring a generation: the shard's memory in that
  // generation is made now, once per placement lane
  if (t_rot_path == gen_ && t_rot_gen &&
      t_rot_gen == rot_restore_gen_.load(std::memory_order_acquire))
    return rotAllocShard(shard);
  return 0;
}

int64_t CudaPath::ckptShardFor(int worker_rank) const {
  MutexLock lk(ckpt_mutex_);
  auto it = ckpt_cur_shard_.find(worker_rank);
  return it == ckpt_cur_shard_.end() ? -1 : it->second;
}

CudaPath::CkptStats CudaPath::ckptStats() const {
  CkptStats s;
  s.shards_total = ckpt_nshards_;
  for (uint64_t i = 0; i < ckpt_nshards_; i++)
    if (ckpt_expected_bytes_[i] &&
        ckpt_res_bytes_[i].load(std::memory_order_relaxed) ==
            ckpt_expected_bytes_[i])
      s.shards_resident++;
  s.resident_wait_ns = ckpt_resident_wait_ns_.load(std::memory_order_relaxed);
  s.barriers = ckpt_barriers_.load(std::memory_order_relaxed);
  return s;
}

void CudaPath::ckptByteTotals(uint64_t* out) const {
  out[0] = out[1] = 0;
  for (uint64_t i = 0; i < ckpt_nshards_; i++) {
    out[0] += ckpt_sub_bytes_[i].load(std::memory_order_relaxed);
    out[1] += ckpt_res_bytes_[i].load(std::memory_order_relaxed);
  }
}

std::vector<uint64_t> CudaPath::ckptDevBytes() const {
  std::vector<uint64_t> out;
  out.reserve(ckpt_dev_bytes_.size());
  for (const auto& a : ckpt_dev_bytes_)
    out.push_back(a->load(std::memory_order_relaxed));
  return out;
}

int CudaPath::ckptBarrier() {
  // run by each restore worker after its last shard, inside the measured
  // phase: the phase clock is time-to-all-devices-resident
  auto t0 = Clock::now();
  const int rc = settleAllShards();
  ckpt_resident_wait_ns_.fetch_add(
      (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
          Clock::now() - t0)
          .count(),
      std::memory_order_relaxed);
  ckpt_barriers_.fetch_add(1, std::memory_order_relaxed);
  return rc;
}

// ---------------------------------------------------------------- faults

void CudaPath::setFaultPolicy(int device_error_budget, int retry_max,
                              uint64_t backoff_ms) {
  fault_device_budget_.store(device_error_budget < 0 ? 0 : device_error_budget,
                             std::memory_order_relaxed);
  fault_retry_max_.store(retry_max < 0 ? 0 : retry_max,
                         std::memory_order_relaxed);
  fault_backoff_ms_.store(backoff_ms, std::memory_order_relaxed);
}

CudaPath::FaultStats CudaPath::faultStats() const {
  FaultStats s;
  s.dev_retry_attempts = dev_retry_attempts_.load(std::memory_order_relaxed);
  s.dev_retry_success = dev_retry_success_.load(std::memory_order_relaxed);
  s.dev_retry_backoff_ns =
      dev_retry_backoff_ns_.load(std::memory_order_relaxed);
  s.dev_errors = dev_errors_.load(std::memory_order_relaxed);
  s.ejected_devices = ejected_devices_.load(std::memory_order_relaxed);
  s.replanned_units = replanned_units_.load(std::memory_order_relaxed);
  return s;
}

std::string CudaPath::ejectedDevices() const {
  MutexLock lk(fault_mutex_);
  return ejected_error_;
}

int CudaPath::survivorFor(int device_idx) const {
  const uint64_t mask = ejected_mask_.load(std::memory_order_acquire);
  const int ndev = (int)lanes_.size();
  const int idx = (device_idx < 0 ? 0 : device_idx) % ndev;
  if (!mask || !laneEjected(idx)) return idx;
  // the same planned lane always lands on the same survivor, so the
  // barriers reconcile against a stable post-ejection plan
  int nsurv = 0;
  for (int i = 0; i < ndev && i < 64; i++)
    if (!(mask >> i & 1)) nsurv++;
  if (!nsurv) return idx;  // everything ejected: let the submit fail
  const int want = idx % nsurv;
  for (int i = 0, seen = 0; i < ndev && i < 64; i++) {
    if (mask >> i & 1) continue;
    if (seen++ == want) return i;
  }
  return idx;
}

int CudaPath::ejectDevice(int device_idx, const std::string& cause) {
  const int ndev = (int)lanes_.size();
  if (device_idx < 0 || device_idx >= ndev || device_idx >= 64) return 1;
  const uint64_t bit = 1ull << device_idx;
  const uint64_t all = ndev >= 64 ? ~0ull : ((1ull << ndev) - 1);
  uint64_t mask = ejected_mask_.load(std::memory_order_acquire);
  for (;;) {
    if (mask & bit) return 1;  // already ejected
    // never eject the last healthy lane: the engine's error budget decides
    // the phase then
    if (((~mask & all) & ~bit) == 0) return 1;
    if (ejected_mask_.compare_exchange_weak(mask, mask | bit,
                                            std::memory_order_acq_rel))
      break;
  }
  ejected_devices_.fetch_add(1, std::memory_order_relaxed);
  const std::string msg =
      "device " + std::to_string(device_idx) + ": " +
      (cause.empty() ? std::string("transfer failed") : cause);
  {
    MutexLock lk(fault_mutex_);
    if (!ejected_error_.empty()) ejected_error_ += "\n";
    ejected_error_ += msg;
  }
  fprintf(stderr,
          "[ebt] ejecting %s; replanning remaining work onto survivors\n",
          msg.c_str());
  return 0;
}

void CudaPath::recordDeviceError(int device_idx, const std::string& cause) {
  if (!faultPolicyActive()) return;
  const int ndev = (int)lanes_.size();
  const int idx = (device_idx < 0 ? 0 : device_idx) % ndev;
  dev_errors_.fetch_add(1, std::memory_order_relaxed);
  const uint64_t budget =
      (uint64_t)fault_device_budget_.load(std::memory_order_relaxed);
  bool eject = false;
  {
    MutexLock lk(fault_mutex_);
    if (lane_errors_.size() < (size_t)ndev) lane_errors_.resize(ndev, 0);
    if (++lane_errors_[idx] >= budget && !laneEjected(idx)) eject = true;
  }
  if (eject) ejectDevice(idx, cause);  // takes fault_mutex_ itself
}

bool CudaPath::faultBackoffWait(int attempt) {
  const uint64_t base = fault_backoff_ms_.load(std::memory_order_relaxed);
  if (!base) return true;
  const int shift = attempt > 10 ? 10 : attempt - 1;
  const uint64_t wait_ms = std::min<uint64_t>(base << shift, 2000);
  const auto t0 = Clock::now();
  const auto deadline = t0 + std::chrono::milliseconds(wait_ms);
  bool ok = true;
  // bounded sleeps polling the engine's interrupt flag (a thread with a
  // reactor sleeps on its interrupt eventfd): an interrupted phase wakes
  // the recovery promptly; it holds no lock and no registration hold here
  for (;;) {
    const std::atomic<bool>* flag =
        interrupt_flag_.load(std::memory_order_acquire);
    if (flag && flag->load(std::memory_order_relaxed)) {
      ok = false;
      break;
    }
    const auto now = Clock::now();
    if (now >= deadline) break;
    reactorhub::interruptibleSleepNs(std::min<uint64_t>(
        (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
            deadline - now)
            .count(),
        500'000'000ull));
  }
  dev_retry_backoff_ns_.fetch_add(
      (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
          Clock::now() - t0)
          .count(),
      std::memory_order_relaxed);
  return ok;
}

// Settle-time recovery. The failed copy's lane is charged first (which may
// eject it), then its host source is copied again, synchronously, onto the
// survivors in turn. The source is valid: the engine does not reuse the
// buffer before this settle returns. On a card, an asynchronous fault is
// sticky for the device's primary context, so every lane of the faulted
// device fails from then on and a recovery can land only on a lane of
// another device; the mock's per-stream fault (EBT_MOCK_CUDA_DEV_FAIL_AT)
// takes down one lane only.
int CudaPath::recoverPending(Pending& p) {
  if (!faultPolicyActive()) return 1;
  recordDeviceError(p.lane, firstTransferError());
  if (!p.src || p.d2h || !p.bytes) return 1;  // not recoverable
  // the resubmits read the source in place: wait out a registration change
  // on its range and hold it against eviction until they are awaited, as a
  // first submit does
  Lane& failed = laneFor(p.lane);
  QueueShard& shard = shardFor(p.src);
  const bool held = holdForCopy(p.src, p.bytes, failed, shard);
  std::string cause;
  const int winner = walkSurvivors(
      p.lane,
      [&](int cand) -> bool {
        cause.clear();
        if (!makeCurrent(cand, false)) return false;
        Lane& cl = *lanes_[cand];
        // a chunk of a restoring generation is recovered into that
        // generation's memory on the survivor, never into the landing ring
        cu::CUdeviceptr to = cl.landing;
        if (p.rot_gen) {
          to = rotDest(p.rot_gen, p.ckpt_shard, p.rot_lane, cand, p.rot_off,
                       p.bytes);
          if (!to || !makeCurrent(cand, false)) {
            cause = firstTransferError();
            return false;
          }
        }
        const auto t0 = Clock::now();
        const cu::CUresult rc =
            api_.cuMemcpyHtoDAsync(to, p.src, p.bytes, cl.h2d);
        if (rc) {
          // a diagnostic, not a fresh root cause: not latched
          cause = cu::errorText(api_, "recovery cuMemcpyHtoDAsync", rc);
          return false;
        }
        Pending wait;
        wait.no_recover = true;  // the resubmit's settle must not recurse
        attachCompletion(wait, cand, cl.h2d, cand, t0);
        return awaitRelease(wait) == 0;
      },
      &cause);
  if (held) releaseHold(p.src, p.bytes, failed, shard);
  if (winner < 0) return 1;
  // the bytes move from the failed lane to the survivor, so per-lane sums
  // and the checkpoint per-lane evidence stay exact
  failed.bytes_to_hbm.fetch_sub(p.bytes, std::memory_order_relaxed);
  lanes_[winner]->bytes_to_hbm.fetch_add(p.bytes, std::memory_order_relaxed);
  p.lane = winner;
  return 0;
}

// ---------------------------------------------------------------- rotation

// The twin of the engine's storage-side bucket (Engine::bgThrottle): the
// same refill, burst cap and deficit sleep, charged at the lanes.
void CudaPath::bgLaneThrottle(uint64_t len) {
  uint64_t rate = bg_rate_bps_.load(std::memory_order_relaxed);
  if (!rate || !len) return;
  const auto t0 = Clock::now();
  bool waited = false;
  for (;;) {
    double deficit_s = 0;
    {
      MutexLock lk(bg_mutex_);
      const auto now = Clock::now();
      const double elapsed_s =
          (double)std::chrono::duration_cast<std::chrono::nanoseconds>(
              now - bg_last_refill_)
              .count() /
          1e9;
      bg_last_refill_ = now;
      rate = bg_rate_bps_.load(std::memory_order_relaxed);
      if (!rate) break;
      // burst cap: a quarter second of budget, never below the charge at
      // hand (an oversized block must still be able to pass)
      const double cap = std::max({(double)rate / 4.0, (double)len, 1.0});
      bg_tokens_ = std::min(bg_tokens_ + elapsed_s * (double)rate, cap);
      if (bg_tokens_ >= (double)len) {
        bg_tokens_ -= (double)len;
        break;
      }
      deficit_s = ((double)len - bg_tokens_) / (double)rate;
    }
    const std::atomic<bool>* flag =
        interrupt_flag_.load(std::memory_order_acquire);
    if (flag && flag->load(std::memory_order_relaxed)) break;
    waited = true;
    std::this_thread::sleep_for(std::chrono::nanoseconds(
        std::min<uint64_t>((uint64_t)(deficit_s * 1e9) + 1, 10'000'000)));
  }
  if (waited)
    bg_lane_throttle_ns_.fetch_add(
        (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
            Clock::now() - t0)
            .count(),
        std::memory_order_relaxed);
}

cu::CUdeviceptr CudaPath::rotAlloc(int lane, uint64_t bytes) {
  cu::CUdeviceptr p = 0;
  if (!makeCurrent(lane, false)) return 0;
  const cu::CUresult rc = api_.cuMemAlloc(&p, std::max<uint64_t>(bytes, 8));
  if (rc) {
    latchXferError(cu::errorText(api_, "rotation cuMemAlloc", rc) + " (" +
                   std::to_string(bytes) + " bytes on device " +
                   std::to_string(lane) + ")");
    return 0;
  }
  return p;
}

void CudaPath::rotFree(std::vector<RotBuf>& bufs) {
  // every copy into these was settled before they left their generation
  // (the engine settles the rotator's buffers before a begin, and a swap
  // frees a generation restored one rotation earlier)
  for (RotBuf& b : bufs) {
    if (!b.ptr) continue;
    makeCurrent(b.lane, false);
    api_.cuMemFree(b.ptr);
    b.ptr = 0;
  }
  bufs.clear();
}

int CudaPath::rotAllocShard(int64_t shard) {
  std::vector<RotBuf> made;
  int failed_lane = -1;
  for (size_t i = 0; i < ckpt_entry_shard_.size() && failed_lane < 0; i++) {
    if (ckpt_entry_shard_[i] != shard) continue;
    const int lane = ckpt_entry_device_[i];
    {
      MutexLock lk(rot_mutex_);
      bool have = false;
      for (const RotBuf& b : rot_fresh_.bufs)
        have = have || (b.shard == shard && b.lane == lane &&
                        b.plan_lane == lane && b.off == 0);
      if (have) continue;
    }
    RotBuf b;
    b.shard = shard;
    b.lane = b.plan_lane = lane;
    b.bytes = ckpt_entry_bytes_[i];
    b.ptr = rotAlloc(lane, b.bytes);
    if (b.ptr)
      made.push_back(b);
    else
      failed_lane = lane;
  }
  if (failed_lane >= 0)
    latchCkptError(failed_lane, shard, firstTransferError());
  // what was made belongs to the generation either way: the next begin or
  // the teardown frees it
  MutexLock lk(rot_mutex_);
  for (const RotBuf& b : made) rot_fresh_.bufs.push_back(b);
  return failed_lane >= 0 ? 1 : 0;
}

cu::CUdeviceptr CudaPath::rotDest(uint64_t gen, int64_t shard, int plan_lane,
                                  int lane, uint64_t off, uint64_t n) {
  bool current = false;
  {
    MutexLock lk(rot_mutex_);
    current = gen == rot_restore_gen_.load(std::memory_order_acquire);
    for (const RotBuf& b : rot_fresh_.bufs)
      if (current && b.shard == shard && b.lane == lane &&
          b.plan_lane == plan_lane && b.off <= off &&
          off + n <= b.off + b.bytes)
        return b.ptr + (off - b.off);
  }
  if (!current) {
    // a chunk of a superseded generation never lands anywhere
    latchXferError("rotation generation " + std::to_string(gen) +
                   " is no longer being restored");
    return 0;
  }
  // replanned or recovered onto a lane the plan did not place the shard on:
  // the chunk gets memory of its own in the generation
  RotBuf b;
  b.shard = shard;
  b.lane = lane;
  b.plan_lane = plan_lane;
  b.off = off;
  b.bytes = n;
  b.ptr = rotAlloc(lane, n);
  if (!b.ptr) return 0;
  MutexLock lk(rot_mutex_);
  rot_fresh_.bufs.push_back(b);
  return b.ptr;
}

void CudaPath::rotRetain(const Pending& p) {
  MutexLock lk(rot_mutex_);
  // a late settle of a superseded restore does not count
  if (p.rot_gen == rot_restore_gen_.load(std::memory_order_relaxed))
    rot_fresh_.pendings++;
}

void CudaPath::rotReleaseAll() {
  std::vector<RotBuf> all;
  {
    MutexLock lk(rot_mutex_);
    all.swap(rot_active_.bufs);
    for (const RotBuf& b : rot_fresh_.bufs) all.push_back(b);
    rot_fresh_.bufs.clear();
    rot_active_.pendings = rot_fresh_.pendings = 0;
  }
  rotFree(all);
}

int CudaPath::rotateBegin(int worker_rank, uint64_t generation,
                          uint64_t bg_rate_bps) {
  (void)worker_rank;
  if (!ok() || !ckpt_active_.load(std::memory_order_acquire)) return 1;
  if (!generation) return 1;
  // an aborted earlier restore (no swap) left its memory in the fresh set:
  // it is freed (outside the lock) before this generation allocates
  std::vector<RotBuf> stale;
  {
    MutexLock lk(rot_mutex_);
    stale.swap(rot_fresh_.bufs);
    rot_fresh_.pendings = 0;
    rot_bg_bytes_base_ = bg_h2d_bytes_.load(std::memory_order_relaxed);
  }
  rotFree(stale);
  {
    // re-sync the lane bucket to the engine's (possibly adapted) budget; a
    // rotation starts with an empty bucket, not banked burst
    MutexLock blk(bg_mutex_);
    bg_rate_bps_.store(bg_rate_bps, std::memory_order_relaxed);
    bg_tokens_ = 0;
    bg_last_refill_ = Clock::now();
  }
  rot_restore_gen_.store(generation, std::memory_order_release);
  t_rot_gen = generation;
  t_rot_path = gen_;
  return 0;
}

int CudaPath::rotateSwap(int worker_rank) {
  (void)worker_rank;
  const uint64_t gen = rot_restore_gen_.load(std::memory_order_acquire);
  if (!ok() || !gen) return 1;
  // the direction-9 begins re-armed every shard's counters this rotation,
  // so the checkpoint ledger's totals are this rotation's restore
  RotationRecord rec;
  rec.generation = gen;
  const CkptStats cs = ckptStats();
  rec.shards_total = cs.shards_total;
  rec.shards_resident = cs.shards_resident;
  uint64_t totals[2];
  ckptByteTotals(totals);
  rec.bytes_submitted = totals[0];
  rec.bytes_resident = totals[1];
  std::vector<RotBuf> old;
  {
    MutexLock lk(rot_mutex_);
    rec.bg_bytes =
        bg_h2d_bytes_.load(std::memory_order_relaxed) - rot_bg_bytes_base_;
    rec.retained_buffers = rot_fresh_.pendings;
    rec.released_buffers = rot_active_.pendings;
    // the swap: the fresh generation becomes the serving one; the old one
    // is freed below, outside the lock
    old.swap(rot_active_.bufs);
    rot_active_.bufs.swap(rot_fresh_.bufs);
    rot_active_.pendings = rot_fresh_.pendings;
    rot_fresh_.pendings = 0;
    rot_records_.push_back(rec);
  }
  rot_generation_.store(gen, std::memory_order_release);
  rot_restore_gen_.store(0, std::memory_order_release);
  t_rot_gen = 0;
  rotFree(old);
  return 0;
}

int CudaPath::rotationCount() const {
  MutexLock lk(rot_mutex_);
  return (int)rot_records_.size();
}

bool CudaPath::rotationRecord(int idx, RotationRecord* out) const {
  MutexLock lk(rot_mutex_);
  if (idx < 0 || (size_t)idx >= rot_records_.size()) return false;
  *out = rot_records_[(size_t)idx];
  return true;
}

void CudaPath::rotationState(uint64_t* out) const {
  out[0] = rot_generation_.load(std::memory_order_relaxed);
  out[1] = rot_restore_gen_.load(std::memory_order_relaxed) ? 1 : 0;
  out[2] = bg_rate_bps_.load(std::memory_order_relaxed);
  out[3] = bg_lane_throttle_ns_.load(std::memory_order_relaxed);
  out[4] = bg_h2d_bytes_.load(std::memory_order_relaxed);
  MutexLock lk(rot_mutex_);
  out[5] = rot_active_.pendings + rot_fresh_.pendings;
}

int CudaPath::rotationRead(int64_t shard, int replica, uint64_t offset,
                           uint64_t len, void* host) {
  int lane = -1;
  for (size_t i = 0, r = 0; i < ckpt_entry_shard_.size(); i++) {
    if (ckpt_entry_shard_[i] != shard) continue;
    if ((int)r++ == replica) lane = ckpt_entry_device_[i];
  }
  if (lane < 0) return 1;
  std::vector<RotBuf> bufs;
  {
    MutexLock lk(rot_mutex_);
    for (const RotBuf& b : rot_active_.bufs)
      if (b.shard == shard && b.plan_lane == lane) bufs.push_back(b);
  }
  if (bufs.empty()) return 1;
  // the shard's allocation first, then the chunk allocations made after it
  // (a chunk replanned or recovered elsewhere), which hold the newer bytes
  std::vector<bool> covered(len, false);
  size_t ncovered = 0;
  for (const RotBuf& b : bufs) {
    const uint64_t lo = std::max(offset, b.off);
    const uint64_t hi = std::min(offset + len, b.off + b.bytes);
    if (lo >= hi) continue;
    if (!makeCurrent(b.lane, false)) return 1;
    Lane& l = *lanes_[(size_t)b.lane];
    if (!check("rotation read-back cuMemcpyDtoHAsync",
               api_.cuMemcpyDtoHAsync((char*)host + (lo - offset),
                                      b.ptr + (lo - b.off), hi - lo, l.d2h)) ||
        syncStream(b.lane, l.d2h))
      return 1;
    for (uint64_t i = lo - offset; i < hi - offset; i++)
      if (!covered[i]) {
        covered[i] = true;
        ncovered++;
      }
  }
  return ncovered == len ? 0 : 1;
}

// ---------------------------------------------------------------- ingest

void CudaPath::settleIngest(const Pending& p, int rc) {
  if (p.ingest_epoch < 0 || !ingest_res_bytes_ || !p.bytes) return;
  // the bytes leave the in-flight gauge either way
  ingest_inflight_bytes_.fetch_sub(p.bytes, std::memory_order_relaxed);
  if (rc == 0) {
    ingest_res_bytes_[p.ingest_epoch].fetch_add(p.bytes,
                                                std::memory_order_relaxed);
    return;
  }
  ingest_drop_bytes_[p.ingest_epoch].fetch_add(p.bytes,
                                               std::memory_order_relaxed);
  latchIngestError(p.lane, p.ingest_epoch, firstTransferError());
}

void CudaPath::ingestCountSubmitted(int64_t epoch, uint64_t bytes) {
  ingest_sub_bytes_[epoch].fetch_add(bytes, std::memory_order_relaxed);
  const uint64_t cur =
      ingest_inflight_bytes_.fetch_add(bytes, std::memory_order_relaxed) +
      bytes;
  uint64_t peak = ingest_inflight_peak_.load(std::memory_order_relaxed);
  while (cur > peak && !ingest_inflight_peak_.compare_exchange_weak(
                           peak, cur, std::memory_order_relaxed)) {
  }
}

void CudaPath::latchIngestError(int device, int64_t epoch,
                                const std::string& cause) {
  std::string msg = "device " + std::to_string(device);
  if (epoch >= 0) msg += " epoch " + std::to_string(epoch);
  msg += ": " +
         (cause.empty() ? std::string("ingest transfer failed") : cause);
  MutexLock lk(ingest_mutex_);
  if (ingest_error_.empty()) ingest_error_ = msg;
}

std::string CudaPath::ingestError() const {
  MutexLock lk(ingest_mutex_);
  return ingest_error_;
}

int CudaPath::setIngestPlan(uint64_t record_size, int epochs) {
  if (!ok() || !record_size || epochs <= 0) return 1;
  if (sealed_.load(std::memory_order_acquire)) return 1;
  ingest_record_size_ = record_size;
  ingest_epochs_ = epochs;
  for (auto* a : {&ingest_read_bytes_, &ingest_sub_bytes_, &ingest_res_bytes_,
                  &ingest_drop_bytes_}) {
    a->reset(new std::atomic<uint64_t>[(size_t)epochs]);
    for (int e = 0; e < epochs; e++)
      (*a)[e].store(0, std::memory_order_relaxed);
  }
  ingest_active_.store(1, std::memory_order_release);
  return 0;
}

int CudaPath::ingestBeginEpoch(int worker_rank, int64_t epoch) {
  if (!ingest_active_.load(std::memory_order_acquire)) return 1;
  if (epoch < 0 || epoch >= (int64_t)ingest_epochs_) return 1;
  MutexLock lk(ingest_mutex_);
  ingest_cur_epoch_[worker_rank] = epoch;
  return 0;
}

int64_t CudaPath::ingestEpochFor(int worker_rank) const {
  MutexLock lk(ingest_mutex_);
  auto it = ingest_cur_epoch_.find(worker_rank);
  return it == ingest_cur_epoch_.end() ? -1 : it->second;
}

CudaPath::IngestStats CudaPath::ingestStats() const {
  IngestStats s;
  for (int e = 0; e < ingest_epochs_; e++) {
    s.read_bytes += ingest_read_bytes_[e].load(std::memory_order_relaxed);
    s.submitted_bytes += ingest_sub_bytes_[e].load(std::memory_order_relaxed);
    s.resident_bytes += ingest_res_bytes_[e].load(std::memory_order_relaxed);
    s.dropped_bytes += ingest_drop_bytes_[e].load(std::memory_order_relaxed);
  }
  s.batch_coalesce_count =
      ingest_batch_coalesce_.load(std::memory_order_relaxed);
  s.prefetch_peak_bytes =
      ingest_inflight_peak_.load(std::memory_order_relaxed);
  s.resident_wait_ns =
      ingest_resident_wait_ns_.load(std::memory_order_relaxed);
  s.barriers = ingest_barriers_.load(std::memory_order_relaxed);
  return s;
}

bool CudaPath::ingestEpochBytes(int64_t epoch, uint64_t* out) const {
  if (epoch < 0 || epoch >= (int64_t)ingest_epochs_ || !ingest_read_bytes_)
    return false;
  out[0] = ingest_read_bytes_[epoch].load(std::memory_order_relaxed);
  out[1] = ingest_sub_bytes_[epoch].load(std::memory_order_relaxed);
  out[2] = ingest_res_bytes_[epoch].load(std::memory_order_relaxed);
  out[3] = ingest_drop_bytes_[epoch].load(std::memory_order_relaxed);
  return true;
}

int CudaPath::ingestBarrier() {
  // run by each ingest worker after its last epoch, inside the measured
  // phase; per-epoch residency is read from the atomics the settles keep
  auto t0 = Clock::now();
  const int rc = settleAllShards();
  ingest_resident_wait_ns_.fetch_add(
      (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
          Clock::now() - t0)
          .count(),
      std::memory_order_relaxed);
  ingest_barriers_.fetch_add(1, std::memory_order_relaxed);
  return rc;
}

void CudaPath::ingestRearm() {
  // between phases: the previous phase's barrier settled every pending, so
  // no settle can decrement a gauge zeroed here
  for (int e = 0; e < ingest_epochs_; e++) {
    ingest_read_bytes_[e].store(0, std::memory_order_relaxed);
    ingest_sub_bytes_[e].store(0, std::memory_order_relaxed);
    ingest_res_bytes_[e].store(0, std::memory_order_relaxed);
    ingest_drop_bytes_[e].store(0, std::memory_order_relaxed);
  }
  for (auto* a : {&ingest_batch_coalesce_, &ingest_inflight_bytes_,
                  &ingest_inflight_peak_, &ingest_resident_wait_ns_,
                  &ingest_barriers_})
    a->store(0, std::memory_order_relaxed);
  MutexLock lk(ingest_mutex_);
  ingest_error_.clear();
  ingest_cur_epoch_.clear();
}

// ---------------------------------------------------------------- reshard

void CudaPath::settleReshard(const Pending& p, int rc) {
  if (p.reshard_unit < 0 || !reshard_sub_bytes_ ||
      (uint64_t)p.reshard_unit >= reshard_nunits_)
    return;
  if (rc == 0) {
    if (!p.bytes) return;
    {
      // the credit and a re-arm's zero plus generation bump exclude each
      // other: a chunk of a superseded move attempt does not credit the
      // unit its storage fallback reconciles from zero
      MutexLock lk(reshard_mutex_);
      if (p.reshard_gen ==
          reshard_unit_gen_[p.reshard_unit].load(std::memory_order_relaxed))
        reshard_res_bytes_[p.reshard_unit].fetch_add(
            p.bytes, std::memory_order_relaxed);
    }
    if (p.d2d) {
      d2d_resident_bytes_.fetch_add(p.bytes, std::memory_order_relaxed);
      (p.d2d_bounce ? bounce_moves_ : d2d_moves_)
          .fetch_add(1, std::memory_order_relaxed);
      const int ndev = (int)lanes_.size();
      const int s = p.src_lane >= 0 ? p.src_lane % ndev : 0;
      const int d = p.lane >= 0 ? p.lane % ndev : 0;
      const size_t idx = (size_t)s * (size_t)ndev + (size_t)d;
      if (idx < reshard_pairs_n_) {
        reshard_pair_moves_[idx].fetch_add(1, std::memory_order_relaxed);
        reshard_pair_bytes_[idx].fetch_add(p.bytes,
                                           std::memory_order_relaxed);
      }
    } else {
      reshard_read_bytes_.fetch_add(p.bytes, std::memory_order_relaxed);
    }
    return;
  }
  // a failed move is charged to its destination lane (where the bytes did
  // not land); the cause is read out of err_mutex_ first
  const std::string cause = firstTransferError();
  if (p.d2d && faultPolicyActive()) recordDeviceError(p.lane, cause);
  latchReshardError(p.reshard_unit, p.d2d ? p.src_lane : -1, p.lane, cause);
}

void CudaPath::latchReshardError(int64_t unit, int src, int dst,
                                 const std::string& cause) {
  std::string msg = "unit " + std::to_string(unit);
  if (src >= 0) msg += " src " + std::to_string(src);
  msg += " dst " + std::to_string(dst);
  msg += ": " +
         (cause.empty() ? std::string("reshard transfer failed") : cause);
  MutexLock lk(reshard_mutex_);
  if (reshard_error_.empty()) reshard_error_ = msg;
}

std::string CudaPath::reshardError() const {
  MutexLock lk(reshard_mutex_);
  return reshard_error_;
}

int CudaPath::setReshardPlan(const std::vector<int>& unit_action,
                             const std::vector<int>& unit_src,
                             const std::vector<int>& unit_dst,
                             const std::vector<uint64_t>& unit_bytes) {
  if (!ok()) return 1;
  if (sealed_.load(std::memory_order_acquire)) return 1;
  const size_t n = unit_action.size();
  if (!n || unit_src.size() != n || unit_dst.size() != n ||
      unit_bytes.size() != n)
    return 1;
  const int ndev = (int)lanes_.size();
  for (size_t i = 0; i < n; i++) {
    if (unit_action[i] < 0 || unit_action[i] > 2) return 1;
    if (unit_dst[i] < 0 || unit_dst[i] >= ndev) return 1;
    if (unit_action[i] == 1 && (unit_src[i] < 0 || unit_src[i] >= ndev))
      return 1;
    if (unit_bytes[i] == 0) return 1;
  }
  reshard_nunits_ = (uint64_t)n;
  reshard_action_ = unit_action;
  reshard_src_ = unit_src;
  reshard_dst_ = unit_dst;
  reshard_unit_bytes_ = unit_bytes;
  reshard_sub_bytes_.reset(new std::atomic<uint64_t>[n]);
  reshard_res_bytes_.reset(new std::atomic<uint64_t>[n]);
  reshard_unit_gen_.reset(new std::atomic<uint32_t>[n]);
  for (size_t i = 0; i < n; i++) {
    reshard_sub_bytes_[i].store(0, std::memory_order_relaxed);
    reshard_res_bytes_[i].store(0, std::memory_order_relaxed);
    reshard_unit_gen_[i].store(0, std::memory_order_relaxed);
  }
  reshard_pairs_n_ = (size_t)ndev * (size_t)ndev;
  reshard_pair_moves_.reset(new std::atomic<uint64_t>[reshard_pairs_n_]);
  reshard_pair_bytes_.reset(new std::atomic<uint64_t>[reshard_pairs_n_]);
  for (size_t i = 0; i < reshard_pairs_n_; i++) {
    reshard_pair_moves_[i].store(0, std::memory_order_relaxed);
    reshard_pair_bytes_[i].store(0, std::memory_order_relaxed);
  }
  reshard_active_.store(1, std::memory_order_release);
  return 0;
}

int CudaPath::reshardPreload() {
  // The pre-state "the checkpoint was restored onto N lanes": every move
  // unit's bytes in one device buffer on its src lane, with the
  // deterministic offset+salt pattern (salt 0xD2D) the original stages, so
  // both tiers and both packages move identical bytes. Untimed set-up at
  // prepare; the buffers and the bounce scratch pool live until teardown.
  if (!reshard_active_.load(std::memory_order_acquire)) return 1;
  {
    MutexLock lk(reshard_mutex_);
    if (!reshard_src_bufs_.empty() || !scratch_all_.empty()) return 0;
  }
  std::map<int64_t, SrcBuf> staged;
  std::vector<char*> scratch;
  auto release = [&] {
    for (auto& kv : staged) {
      makeCurrent(kv.second.lane, false);
      api_.cuMemFree(kv.second.ptr);
    }
    for (char* p : scratch) api_.cuMemFreeHost(p);
  };
  bool any_move = false;
  for (uint64_t u = 0; u < reshard_nunits_; u++)
    any_move = any_move || reshard_action_[u] == 1;
  if (!any_move) return 0;
  // the pinned scratch pool: the preload's host staging, then the bounce
  // tier's (a chunk each; never allocated on the hot path)
  constexpr int kBounceScratch = 8;
  for (int i = 0; i < kBounceScratch; i++) {
    void* h = nullptr;
    makeCurrent(0, false);
    if (!check("reshard scratch cuMemHostAlloc",
               api_.cuMemHostAlloc(&h, chunk_bytes_, 0))) {
      release();
      return 1;
    }
    scratch.push_back((char*)h);
  }
  char* host = scratch[0];
  for (uint64_t u = 0; u < reshard_nunits_; u++) {
    if (reshard_action_[u] != 1) continue;
    const int lane = reshard_src_[u];
    const uint64_t len = reshard_unit_bytes_[u];
    if (!makeCurrent(lane, false)) {
      release();
      return 1;
    }
    SrcBuf sb;
    sb.lane = lane;
    sb.bytes = len;
    if (!check("reshard preload cuMemAlloc", api_.cuMemAlloc(&sb.ptr, len))) {
      release();
      return 1;
    }
    staged[(int64_t)u] = sb;
    Lane& l = *lanes_[lane];
    for (uint64_t off = 0; off < len;) {
      const uint64_t n = std::min(chunk_bytes_, len - off);
      fillVerifyPattern(host, n, u * len + off, 0xD2D);
      if (!check("reshard preload cuMemcpyHtoDAsync",
                 api_.cuMemcpyHtoDAsync(sb.ptr + off, host, n, l.h2d)) ||
          syncStream(lane, l.h2d)) {
        syncStream(lane, l.h2d);
        release();
        return 1;
      }
      off += n;
    }
  }
  MutexLock lk(reshard_mutex_);
  reshard_src_bufs_.swap(staged);
  scratch_all_ = scratch;
  scratch_free_ = scratch;
  return 0;
}

int CudaPath::reshardBeginUnit(int worker_rank, int64_t unit) {
  if (!reshard_active_.load(std::memory_order_acquire)) return 1;
  if (unit < 0 || (uint64_t)unit >= reshard_nunits_) return 1;
  // a begin on a move unit: the engine reads it from storage after the
  // move tier failed
  if (reshard_action_[unit] == 1)
    move_fallback_reads_.fetch_add(1, std::memory_order_relaxed);
  // a fresh placement attempt re-arms the unit's reconciliation
  reshard_sub_bytes_[unit].store(0, std::memory_order_relaxed);
  reshard_res_bytes_[unit].store(0, std::memory_order_relaxed);
  MutexLock lk(reshard_mutex_);
  reshard_cur_unit_[worker_rank] = unit;
  return 0;
}

int64_t CudaPath::reshardUnitFor(int worker_rank) const {
  MutexLock lk(reshard_mutex_);
  auto it = reshard_cur_unit_.find(worker_rank);
  return it == reshard_cur_unit_.end() ? -1 : it->second;
}

void CudaPath::settleReshardUnit(int64_t unit) {
  std::vector<Pending> mine;
  {
    MutexLock lk(reshard_mutex_);
    for (auto it = reshard_pending_.begin(); it != reshard_pending_.end();) {
      if (it->reshard_unit == unit) {
        mine.push_back(*it);
        it = reshard_pending_.erase(it);
      } else {
        ++it;
      }
    }
  }
  for (Pending& p : mine) awaitRelease(p);
}

char* CudaPath::acquireScratch() {
  for (;;) {
    Pending oldest;
    {
      MutexLock lk(reshard_mutex_);
      if (!scratch_free_.empty()) {
        char* p = scratch_free_.back();
        scratch_free_.pop_back();
        return p;
      }
      auto it = std::find_if(reshard_pending_.begin(), reshard_pending_.end(),
                             [](const Pending& q) { return q.owned_src; });
      if (it == reshard_pending_.end()) break;
      oldest = *it;
      reshard_pending_.erase(it);
    }
    awaitRelease(oldest);  // its settle returns the scratch to the pool
  }
  // every scratch is held by a bounce leg in progress on another thread:
  // one more for the pool
  void* h = nullptr;
  if (!check("bounce scratch cuMemHostAlloc",
             api_.cuMemHostAlloc(&h, chunk_bytes_, 0)))
    return nullptr;
  MutexLock lk(reshard_mutex_);
  scratch_all_.push_back((char*)h);
  return (char*)h;
}

void CudaPath::releaseScratch(char* p) {
  MutexLock lk(reshard_mutex_);
  scratch_free_.push_back(p);
}

cu::CUresult CudaPath::d2dCopy(int src_lane, cu::CUdeviceptr src, int dst,
                               uint64_t dst_off, uint64_t n) {
  Lane& dl = *lanes_[dst];
  const Lane& sl = *lanes_[src_lane];
  // two lanes of one device share its primary context: a device-local copy
  if (sl.dev == dl.dev)
    return api_.cuMemcpyDtoDAsync(dl.landing + dst_off, src, n, dl.h2d);
  return api_.cuMemcpyPeerAsync(dl.landing + dst_off, dl.ctx, src, sl.ctx, n,
                                dl.h2d);
}

int CudaPath::bounceLegs(int src_lane, cu::CUdeviceptr src, char* scratch,
                         uint64_t len, int dst, uint64_t dst_off,
                         const char* what, Pending& out) {
  if (!makeCurrent(src_lane, false)) return 1;
  Lane& sl = *lanes_[src_lane];
  if (!check((std::string(what) + " cuMemcpyDtoHAsync").c_str(),
             api_.cuMemcpyDtoHAsync(scratch, src, len, sl.d2h)) ||
      syncStream(src_lane, sl.d2h))
    return 1;
  if (!makeCurrent(dst, false)) return 1;
  Lane& dl = *lanes_[dst];
  if (!check((std::string(what) + " cuMemcpyHtoDAsync").c_str(),
             api_.cuMemcpyHtoDAsync(dl.landing + dst_off, scratch, len,
                                    dl.h2d)))
    return 1;
  out.bytes = len;
  out.lane = dst;
  return 0;
}

int CudaPath::bounceMoveChunk(int src_lane, cu::CUdeviceptr src, uint64_t len,
                              int dst, uint64_t dst_off, int64_t unit) {
  char* scratch = acquireScratch();
  if (!scratch) return 1;
  const auto t0 = Clock::now();  // the bounce's whole cost
  Pending p;
  if (bounceLegs(src_lane, src, scratch, len, dst, dst_off, "bounce move",
                 p)) {
    releaseScratch(scratch);
    return 1;
  }
  p.d2d = true;
  p.d2d_bounce = true;
  p.src_lane = src_lane;
  p.reshard_unit = unit;
  p.reshard_gen = reshard_unit_gen_[unit].load(std::memory_order_acquire);
  p.owned_src = scratch;  // the H2D leg reads it until the settle
  attachCompletion(p, dst, lanes_[dst]->h2d, dst, t0);
  MutexLock lk(reshard_mutex_);
  reshard_pending_.push_back(p);
  return 0;
}

int CudaPath::recoverMovePending(Pending& p) {
  // the source is the preloaded unit buffer, alive for the path's
  // lifetime, so a failed move is copied again through the bounce
  if (!p.d2d || p.d2d_bounce || !p.d2d_src || !p.bytes) return 1;
  char* scratch = acquireScratch();
  if (!scratch) return 1;
  const int dst = laneIndex(p.lane);
  Pending wait;
  int rc = bounceLegs(p.src_lane, p.d2d_src, scratch, p.bytes, dst, 0,
                      "move recovery", wait);
  if (rc == 0) {
    // a bare wait: the original pending carries the accounting
    wait.bytes = 0;
    wait.no_recover = true;
    attachCompletion(wait, dst, lanes_[dst]->h2d, -1, {});
    rc = awaitRelease(wait);
  }
  releaseScratch(scratch);
  if (rc) return 1;
  p.d2d_bounce = true;  // settleReshard counts it as a bounce move
  move_recovered_.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

int CudaPath::reshardMove(int worker_rank, int64_t unit) {
  (void)worker_rank;
  if (!reshard_active_.load(std::memory_order_acquire)) return 1;
  if (unit < 0 || (uint64_t)unit >= reshard_nunits_) return 1;
  if (reshard_action_[unit] != 1) return 1;
  SrcBuf sb;
  {
    MutexLock lk(reshard_mutex_);
    auto it = reshard_src_bufs_.find(unit);
    // no staged source (the preload was skipped or failed): the engine
    // reads the unit from storage
    if (it == reshard_src_bufs_.end()) return 1;
    sb = it->second;
  }
  const int src = reshard_src_[unit];
  int dst = reshard_dst_[unit];
  // live replanning: a move onto an ejected destination goes to a survivor
  if (faultPolicyActive()) {
    const int planned = dst;
    dst = survivorFor(dst);
    if (dst != planned)
      replanned_units_.fetch_add(1, std::memory_order_relaxed);
  }
  Lane& dl = *lanes_[dst];
  dl.submits.fetch_add(1, std::memory_order_relaxed);
  int rc = 0;
  for (uint64_t off = 0; off < sb.bytes;) {
    const uint64_t n = std::min(chunk_bytes_, sb.bytes - off);
    const uint64_t dst_off = landingOffset(off, n);
    // one submit per chunk before the tier is chosen: a chunk that falls
    // back to the bounce still reconciles d2d_submitted == d2d_resident
    reshard_sub_bytes_[unit].fetch_add(n, std::memory_order_relaxed);
    d2d_submitted_bytes_.fetch_add(n, std::memory_order_relaxed);
    bool moved = false;
    if (d2d_ok_ && makeCurrent(dst, false)) {
      const auto t0 = Clock::now();
      const cu::CUresult crc = d2dCopy(src, sb.ptr + off, dst, dst_off, n);
      if (crc) {
        // refused at submit: this chunk falls back to the bounce below
        latchXferError(cu::errorText(
            api_,
            lanes_[src]->dev == dl.dev ? "cuMemcpyDtoDAsync"
                                       : "cuMemcpyPeerAsync",
            crc));
        if (faultPolicyActive()) recordDeviceError(dst, firstTransferError());
      } else {
        Pending p;
        p.bytes = n;
        p.d2d = true;
        p.src_lane = src;
        p.d2d_src = sb.ptr + off;
        p.reshard_unit = unit;
        p.reshard_gen =
            reshard_unit_gen_[unit].load(std::memory_order_acquire);
        attachCompletion(p, dst, dl.h2d, dst, t0);
        MutexLock lk(reshard_mutex_);
        reshard_pending_.push_back(p);
        moved = true;
      }
    }
    if (!moved &&
        bounceMoveChunk(src, sb.ptr + off, n, dst, dst_off, unit) == 0)
      moved = true;
    if (!moved) {
      rc = 1;
      break;
    }
    off += n;
  }
  if (rc) {
    // quiesce the unit's enqueued chunks, then zero its ledger so the
    // engine's storage fallback reconciles it from a clean slate; the
    // generation bump makes a late settle of this attempt credit nothing
    settleReshardUnit(unit);
    MutexLock lk(reshard_mutex_);
    reshard_unit_gen_[unit].fetch_add(1, std::memory_order_relaxed);
    reshard_sub_bytes_[unit].store(0, std::memory_order_relaxed);
    reshard_res_bytes_[unit].store(0, std::memory_order_relaxed);
  }
  return rc;
}

int CudaPath::reshardBarrier() {
  // every deferred move and every pending storage read: the phase clock is
  // the time until all is resharded
  const auto t0 = Clock::now();
  std::vector<Pending> moves;
  {
    MutexLock lk(reshard_mutex_);
    moves.swap(reshard_pending_);
  }
  int rc = 0;
  for (Pending& p : moves)
    if (awaitRelease(p)) rc = 1;
  if (settleAllShards()) rc = 1;
  reshard_resident_wait_ns_.fetch_add(
      (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
          Clock::now() - t0)
          .count(),
      std::memory_order_relaxed);
  reshard_barriers_.fetch_add(1, std::memory_order_relaxed);
  return rc;
}

CudaPath::ReshardStats CudaPath::reshardStats() const {
  ReshardStats s;
  s.units_total = reshard_nunits_;
  for (uint64_t u = 0; u < reshard_nunits_; u++) {
    const bool full = reshard_res_bytes_[u].load(std::memory_order_relaxed) ==
                      reshard_unit_bytes_[u];
    if (reshard_action_[u] == 0)
      s.units_resident++;
    else if (reshard_action_[u] == 1 && full)
      s.units_moved++;
    else if (reshard_action_[u] == 2 && full)
      s.units_read++;
  }
  s.d2d_submitted_bytes = d2d_submitted_bytes_.load(std::memory_order_relaxed);
  s.d2d_resident_bytes = d2d_resident_bytes_.load(std::memory_order_relaxed);
  s.d2d_moves = d2d_moves_.load(std::memory_order_relaxed);
  s.bounce_moves = bounce_moves_.load(std::memory_order_relaxed);
  s.move_recovered = move_recovered_.load(std::memory_order_relaxed);
  s.move_fallback_reads = move_fallback_reads_.load(std::memory_order_relaxed);
  s.reshard_read_bytes = reshard_read_bytes_.load(std::memory_order_relaxed);
  s.resident_wait_ns =
      reshard_resident_wait_ns_.load(std::memory_order_relaxed);
  s.barriers = reshard_barriers_.load(std::memory_order_relaxed);
  return s;
}

void CudaPath::reshardByteTotals(uint64_t* out) const {
  out[0] = out[1] = 0;
  for (uint64_t u = 0; u < reshard_nunits_; u++) {
    out[0] += reshard_sub_bytes_[u].load(std::memory_order_relaxed);
    out[1] += reshard_res_bytes_[u].load(std::memory_order_relaxed);
  }
}

int CudaPath::reshardPairMatrix(uint64_t* out, int n) const {
  const int ndev = (int)lanes_.size();
  for (int i = 0; i < n && i < ndev * ndev; i++) {
    const bool have = (size_t)i < reshard_pairs_n_;
    out[(size_t)i * 2] =
        have ? reshard_pair_moves_[i].load(std::memory_order_relaxed) : 0;
    out[(size_t)i * 2 + 1] =
        have ? reshard_pair_bytes_[i].load(std::memory_order_relaxed) : 0;
  }
  return ndev;
}

// ---------------------------------------------------------------- registration

int CudaPath::hostRegister(void* buf, uint64_t len, bool window,
                           bool reserved) {
  if (t_gen != gen_) makeCurrent(0, true);  // a thread the path never saw
  // windows are the engine's read-only file mappings: the driver maps them
  // read-only for the device, where it can (it refuses a plain registration
  // of a read-only mapping)
  unsigned flags = cu::CU_MEMHOSTREGISTER_PORTABLE;
  if (window && laneFor(0).read_only_register)
    flags |= cu::CU_MEMHOSTREGISTER_READ_ONLY;
  cu::CUresult rc = api_.cuMemHostRegister(buf, len, flags);
  if (rc) {
    // a clean per-range fall to the staged tier, never a worker error
    std::string msg = cu::errorText(api_, "cuMemHostRegister", rc);
    MutexLock lk(reg_mutex_);
    in_transit_.erase((uintptr_t)buf);
    reg_cv_.notify_all();
    if (reserved) {  // return the caller's budget reservation
      window_bytes_ -= len;
      pinned_bytes_ -= len;
    }
    // staged_fallbacks is window-cache evidence; lifetime-pin failures only
    // latch the cause
    if (window) reg_staged_fallbacks_++;
    if (reg_error_.empty()) reg_error_ = msg;
    return 1;
  }
  // the fresh pin also claims an io_uring fixed-buffer slot (one pin serving
  // both DMA sides); best-effort, as in the original
  int uring_idx = UringReg::instance().claim(buf, len, /*dma_shared=*/true);
  MutexLock lk(reg_mutex_);
  in_transit_.erase((uintptr_t)buf);
  reg_cv_.notify_all();
  RegEntry& e = registered_[(uintptr_t)buf];
  e.len = len;
  e.lru_seq = ++lru_clock_;
  e.window = window;
  e.uring_idx = uring_idx;
  if (!reserved) {
    if (window) window_bytes_ += len;
    pinned_bytes_ += len;
  }
  if (pinned_bytes_ > pinned_peak_bytes_) pinned_peak_bytes_ = pinned_bytes_;
  return 0;
}

void CudaPath::hostUnregister(void* buf) {
  if (t_gen != gen_) makeCurrent(0, true);
  cu::CUresult rc = api_.cuMemHostUnregister(buf);
  if (rc) latchRegError(cu::errorText(api_, "cuMemHostUnregister", rc));
}

int CudaPath::registerBuffer(void* buf, uint64_t len) {
  if (lanes_.empty() || !buf || !len) return 1;
  if (!dma_ok_) {
    latchRegError("registered-memory tier unavailable");
    return 1;
  }
  {
    // re-registering a live range is idempotent; growing one is not
    // supported (the pinned range is the original length)
    MutexLock lk(reg_mutex_);
    auto it = registered_.find((uintptr_t)buf);
    if (it != registered_.end()) {
      if (it->second.len >= len) return 0;
      if (reg_error_.empty())
        reg_error_ = "re-registration of live range with larger length (" +
                     std::to_string(len) + " > " +
                     std::to_string(it->second.len) +
                     " registered bytes); deregister first";
      return 1;
    }
    // another thread's registration of this range is still in the driver
    if (rangeInTransitLocked((uintptr_t)buf, len)) return 1;
    in_transit_[(uintptr_t)buf] = len;
  }
  return hostRegister(buf, len, /*window=*/false, /*reserved=*/false);
}

int CudaPath::deregisterBuffer(void* buf) {
  int uring_idx = -1;
  {
    MutexLock lk(reg_mutex_);
    auto it = registered_.find((uintptr_t)buf);
    if (it == registered_.end()) return 0;  // never registered (fallback)
    if (it->second.window) window_bytes_ -= it->second.len;
    pinned_bytes_ -= it->second.len;
    in_transit_[it->first] = it->second.len;
    uring_idx = it->second.uring_idx;
    registered_.erase(it);
  }
  UringReg::instance().release(uring_idx);
  hostUnregister(buf);
  MutexLock lk(reg_mutex_);
  in_transit_.erase((uintptr_t)buf);
  reg_cv_.notify_all();
  return 0;
}

void CudaPath::setRegWindow(uint64_t bytes) {
  MutexLock lk(reg_mutex_);
  reg_window_bytes_ = bytes;
}

void CudaPath::inflightSpans(
    std::vector<std::pair<uint64_t, uint64_t>>* out) const {
  // a pending queue for buffer B spans [B, B + sum(chunk bytes)); one walk
  // of the shards, locked one at a time (safe under reg_mutex_)
  out->clear();
  for (const auto& shard : shards_) {
    MutexLock lk(shard->m);
    for (const auto& kv : shard->pending) {
      uint64_t qbytes = 0;
      for (const Pending& p : kv.second) qbytes += p.bytes;
      out->emplace_back(kv.first, qbytes ? qbytes : 1);
    }
    for (const auto& kv : shard->draining)
      out->emplace_back(kv.first, kv.second ? kv.second : 1);
  }
}

bool CudaPath::rangeInTransitLocked(uintptr_t base, uint64_t len) const {
  for (const auto& kv : in_transit_)
    if (kv.first < base + len && base < kv.first + kv.second) return true;
  return false;
}

int CudaPath::registerWindow(void* buf, uint64_t len) {
  if (lanes_.empty() || !buf || !len) return 1;
  if (!dma_ok_) {
    latchRegError("registered-memory tier unavailable");
    return 1;
  }
  uintptr_t p = (uintptr_t)buf;
  std::vector<std::pair<uintptr_t, int>> victims;  // (base, uring slot)
  bool fits = true;
  {
    MutexLock lk(reg_mutex_);
    // covered by a live range (window or lifetime pin): cache hit
    auto it = registered_.upper_bound(p);
    if (it != registered_.begin()) {
      --it;
      if (p >= it->first && p + len <= it->first + it->second.len) {
        reg_hits_++;
        it->second.lru_seq = ++lru_clock_;
        return 0;
      }
    }
    reg_misses_++;
    // a range overlapping a live entry without being covered by it must
    // never be registered (the driver refuses it as already registered)
    for (const auto& kv : registered_) {
      if (kv.first < p + len && p < kv.first + kv.second.len) {
        reg_staged_fallbacks_++;
        if (reg_error_.empty())
          reg_error_ = "window request of " + std::to_string(len) +
                       " bytes overlaps a live registration of " +
                       std::to_string(kv.second.len) +
                       " bytes without being covered by it; "
                       "deregister first";
        return 1;
      }
    }
    if (rangeInTransitLocked(p, len)) {
      reg_staged_fallbacks_++;  // transient: one staged block
      return 1;
    }
    if (reg_window_bytes_ && len > reg_window_bytes_) {
      reg_staged_fallbacks_++;  // budget pressure is operation, not a fault
      return 1;
    }
    // evict least-recently-registered windows with nothing in flight until
    // the new one fits (an unregister mid-DMA would pull memory the copy
    // engine is reading); victims collected before a bail-out are still
    // unregistered below
    std::vector<std::pair<uint64_t, uint64_t>> inflight;
    bool have_inflight = false;
    auto span_busy = [&](uintptr_t base, uint64_t blen) {
      for (const auto& [b, n] : inflight)
        if (b < base + blen && base < b + n) return true;
      return false;
    };
    while (reg_window_bytes_ && window_bytes_ + len > reg_window_bytes_) {
      if (!have_inflight) {
        inflightSpans(&inflight);
        have_inflight = true;
      }
      auto best = registered_.end();
      for (auto vi = registered_.begin(); vi != registered_.end(); ++vi) {
        if (!vi->second.window) continue;
        if (best != registered_.end() &&
            vi->second.lru_seq >= best->second.lru_seq)
          continue;
        if (span_busy(vi->first, vi->second.len)) continue;
        if (UringReg::instance().rangeBusy((void*)vi->first, vi->second.len))
          continue;
        best = vi;
      }
      if (best == registered_.end()) {
        reg_staged_fallbacks_++;
        fits = false;
        break;
      }
      window_bytes_ -= best->second.len;
      pinned_bytes_ -= best->second.len;
      reg_evictions_++;
      victims.emplace_back(best->first, best->second.uring_idx);
      in_transit_[best->first] = best->second.len;
      registered_.erase(best);
    }
    if (fits) {
      // reserve the budget before dropping the lock for the driver call
      window_bytes_ += len;
      pinned_bytes_ += len;
      in_transit_[p] = len;
    }
  }
  unpinVictims(victims);
  if (!fits) return 1;
  return hostRegister(buf, len, /*window=*/true, /*reserved=*/true);
}

void CudaPath::deregisterRange(void* buf, uint64_t len) {
  uintptr_t base = (uintptr_t)buf;
  std::vector<std::pair<uintptr_t, int>> victims;
  {
    MutexLock lk(reg_mutex_);
    for (auto it = registered_.begin(); it != registered_.end();) {
      if (it->first < base + len && base < it->first + it->second.len) {
        if (it->second.window) window_bytes_ -= it->second.len;
        pinned_bytes_ -= it->second.len;
        victims.emplace_back(it->first, it->second.uring_idx);
        in_transit_[it->first] = it->second.len;
        it = registered_.erase(it);
      } else {
        ++it;
      }
    }
  }
  unpinVictims(victims);
}

void CudaPath::unpinVictims(
    const std::vector<std::pair<uintptr_t, int>>& victims) {
  if (victims.empty()) return;
  // A fence first: every copy enqueued on any lane before the victims left
  // the cache has completed before their pages are unpinned, whatever the
  // in-flight ledger saw (copies issued after that see the ranges in
  // transit and wait, holdForCopy).
  for (size_t l = 0; l < lanes_.size(); l++) {
    if (!makeCurrent((int)l, false)) continue;
    syncStream((int)l, lanes_[l]->h2d);
  }
  for (const auto& [v, uidx] : victims) {
    hostUnregister((void*)v);
    UringReg::instance().release(uidx);
    MutexLock lk(reg_mutex_);
    in_transit_.erase(v);
    reg_cv_.notify_all();
  }
}

CudaPath::RegCacheStats CudaPath::regCacheStats() const {
  MutexLock lk(reg_mutex_);
  RegCacheStats s;
  s.hits = reg_hits_;
  s.misses = reg_misses_;
  s.evictions = reg_evictions_;
  s.pinned_bytes = pinned_bytes_;
  s.pinned_peak_bytes = pinned_peak_bytes_;
  s.staged_fallbacks = reg_staged_fallbacks_;
  return s;
}

std::string CudaPath::regError() const {
  MutexLock lk(reg_mutex_);
  return reg_error_;
}

bool CudaPath::bufferRegisteredLocked(const void* p, uint64_t len) const {
  if (registered_.empty()) return false;
  uintptr_t pos = (uintptr_t)p;
  const uintptr_t end = (uintptr_t)p + len;
  auto it = registered_.upper_bound(pos);
  if (it == registered_.begin()) return false;
  --it;
  // coverage may come from several contiguous entries (a block crossing a
  // span-grid boundary is backed by two adjacent windows)
  while (it != registered_.end() && it->first <= pos) {
    if (it->first + it->second.len >= end) return true;
    pos = it->first + it->second.len;
    ++it;
  }
  return false;
}

}  // namespace ebt
