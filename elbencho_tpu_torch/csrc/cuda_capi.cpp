/* C exports of the native CUDA transfer engine (cuda_path.h), the port's
 * counterpart of the ebt_pjrt_* family in core/src/capi.cpp that its Python
 * layer (cuda/native.py) uses. Built into the port's libebtcore.so beside
 * the engine, so the engine's singletons (reactor hub, UringReg authority)
 * are shared. The Python layer creates the path, then hands
 * ebt_cuda_copy_fn() and the handle to ebt_engine_set_dev_callback: after
 * that no Python runs per block. */
#include <cstring>
#include <string>
#include <vector>

#include "cuda_path.h"
#include "ebt/engine.h"

using ebt::CudaPath;

namespace {

CudaPath* P(void* p) { return static_cast<CudaPath*>(p); }

void copyOut(const std::string& s, char* buf, int len) {
  if (!buf || len <= 0) return;
  std::strncpy(buf, s.c_str(), len - 1);
  buf[len - 1] = '\0';
}

}  // namespace

extern "C" {

// device_ids (length n_device_ids, may be 0) selects CUDA device ordinals
// (--gpuids); stripe != 0 rotates each block's chunks over the lanes
// (--tpustripe). Returns nullptr on failure with the reason in errbuf.
void* ebt_cuda_create(const char* driver_path, uint64_t chunk_bytes,
                      uint64_t block_size, int stripe, const int* device_ids,
                      int n_device_ids, char* errbuf, int errlen) {
  std::vector<int> ids(device_ids, device_ids + n_device_ids);
  auto* p =
      new CudaPath(driver_path, chunk_bytes, block_size, stripe != 0, ids);
  if (!p->ok()) {
    copyOut(p->error(), errbuf, errlen);
    delete p;
    return nullptr;
  }
  return p;
}

void ebt_cuda_destroy(void* p) { delete P(p); }

// The DevCopyFn to pass to ebt_engine_set_dev_callback (ctx = the handle).
ebt::DevCopyFn ebt_cuda_copy_fn() { return &CudaPath::copyTrampoline; }

int ebt_cuda_num_devices(void* p) { return P(p)->numDevices(); }

void ebt_cuda_drain(void* p) { P(p)->drainAll(); }

void ebt_cuda_stats(void* p, uint64_t* to_hbm, uint64_t* from_hbm) {
  P(p)->stats(to_hbm, from_hbm);
}

void ebt_cuda_last_error(void* p, char* buf, int len) {
  copyOut(P(p)->firstTransferError(), buf, len);
}

// ---- registered-buffer tier (cuMemHostRegister). The engine drives the
// lifecycle itself through DevCopyFn directions 4/5/6 when dev_register is
// set; these are for the Python layer's tier gate, diagnostics and tests.

int ebt_cuda_dma_supported(void* p) { return P(p)->dmaSupported() ? 1 : 0; }

int ebt_cuda_zero_copy_engaged(void* p) {
  return P(p)->zeroCopyEngaged() ? 1 : 0;
}

// 0 = registered; nonzero = staged fallback (cause via ebt_cuda_reg_error)
int ebt_cuda_register(void* p, void* buf, uint64_t len) {
  return P(p)->registerBuffer(buf, len);
}

int ebt_cuda_deregister(void* p, void* buf) {
  return P(p)->deregisterBuffer(buf);
}

int ebt_cuda_register_window(void* p, void* buf, uint64_t len) {
  return P(p)->registerWindow(buf, len);
}

void ebt_cuda_set_reg_window(void* p, uint64_t bytes) {
  P(p)->setRegWindow(bytes);
}

// out[6] = {hits, misses, evictions, pinned_bytes, pinned_peak_bytes,
// staged_fallbacks}
void ebt_cuda_reg_cache_stats(void* p, uint64_t* out) {
  CudaPath::RegCacheStats s = P(p)->regCacheStats();
  out[0] = s.hits;
  out[1] = s.misses;
  out[2] = s.evictions;
  out[3] = s.pinned_bytes;
  out[4] = s.pinned_peak_bytes;
  out[5] = s.staged_fallbacks;
}

// the first registration failure: a clean staged fallback, never a
// transfer error (kept apart from ebt_cuda_last_error)
void ebt_cuda_reg_error(void* p, char* buf, int len) {
  copyOut(P(p)->regError(), buf, len);
}

uint64_t ebt_cuda_zero_copy_count(void* p) { return P(p)->zeroCopyCount(); }

// ---- the transfer-manager tier (EBT_PJRT_XFER_MGR): probed at init; the
// counter counts the hot path's blocks (the probe's is reset)

int ebt_cuda_xfer_mgr(void* p) { return P(p)->xferMgrActive() ? 1 : 0; }

uint64_t ebt_cuda_xfer_mgr_count(void* p) { return P(p)->xferMgrCount(); }

// ---- lanes and latency

int ebt_cuda_num_lanes(void* p) { return P(p)->numDevices(); }

// out[5] = {submits, awaits, lock_wait_ns, bytes_to_hbm, bytes_from_hbm};
// 0 ok, -1 for an out-of-range lane
int ebt_cuda_lane_stats(void* p, int lane, uint64_t* out) {
  CudaPath::LaneStats s;
  if (!P(p)->laneStats(lane, &s)) return -1;
  out[0] = s.submits;
  out[1] = s.awaits;
  out[2] = s.lock_wait_ns;
  out[3] = s.bytes_to_hbm;
  out[4] = s.bytes_from_hbm;
  return 0;
}

int ebt_cuda_single_lane(void* p) { return P(p)->singleLane() ? 1 : 0; }

// buckets holds ebt_histo_num_buckets() entries, meta {count, sum, min,
// max}; 0 ok, -1 for an out-of-range device index
int ebt_cuda_dev_histo(void* p, int device, uint64_t* buckets,
                       uint64_t* meta) {
  ebt::LatencyHistogram histo;
  if (!P(p)->deviceLatency(device, &histo)) return -1;
  histo.exportState(buckets, &meta[0], &meta[1], &meta[2], &meta[3]);
  return 0;
}

void ebt_cuda_reset_dev_histos(void* p) { P(p)->resetDeviceLatency(); }

// 1 = host-function completion stamps ("onready"), 0 = await upper bounds
int ebt_cuda_onready_clock(void* p) { return P(p)->onReadyClock() ? 1 : 0; }

// ---- stripe tier (--stripe), the twins of the ebt_pjrt_stripe_* exports

// policy 0 = off, 1 = round-robin, 2 = contiguous runs; unit_blocks the
// placement granularity in blocks. Before the first data copy; 0 ok.
int ebt_cuda_set_stripe_plan(void* p, int policy, uint64_t total_blocks,
                             uint64_t unit_blocks) {
  return P(p)->setStripePlan(policy, total_blocks, unit_blocks);
}

// the lane the planner maps file_offset to, -1 without a plan
int ebt_cuda_stripe_device_for(void* p, uint64_t file_offset) {
  return P(p)->stripeDeviceFor(file_offset);
}

// out[4] = {units_submitted, units_awaited, barrier_wait_ns, barriers};
// per-lane fill bytes ride ebt_cuda_lane_stats out[3]
void ebt_cuda_stripe_stats(void* p, uint64_t* out) {
  CudaPath::StripeStats s = P(p)->stripeStats();
  out[0] = s.units_submitted;
  out[1] = s.units_awaited;
  out[2] = s.barrier_wait_ns;
  out[3] = s.barriers;
}

// the direction-8 gather barrier, run explicitly; 0 ok
int ebt_cuda_stripe_barrier(void* p) { return P(p)->stripeBarrier(); }

// "device N unit U: cause" of the first failed unit; empty if none
void ebt_cuda_stripe_error(void* p, char* buf, int len) {
  copyOut(P(p)->stripeError(), buf, len);
}

// ---- checkpoint-restore ledger (--checkpoint), the twins of the
// ebt_pjrt_ckpt_* exports

// parallel arrays of nentries (shard, lane, bytes) placement pairs; before
// the first data copy. 0 ok, 1 on a sealed path or a bad entry.
int ebt_cuda_set_ckpt_plan(void* p, int nshards, const int* entry_shard,
                           const int* entry_device,
                           const uint64_t* entry_bytes, int nentries) {
  if (nentries <= 0 || !entry_shard || !entry_device || !entry_bytes)
    return 1;
  std::vector<int> shards(entry_shard, entry_shard + nentries);
  std::vector<int> devs(entry_device, entry_device + nentries);
  std::vector<uint64_t> bytes(entry_bytes, entry_bytes + nentries);
  return P(p)->setCkptPlan(nshards, shards, devs, bytes);
}

// out[4] = {shards_total, shards_resident, resident_wait_ns, barriers}
void ebt_cuda_ckpt_stats(void* p, uint64_t* out) {
  CudaPath::CkptStats s = P(p)->ckptStats();
  out[0] = s.shards_total;
  out[1] = s.shards_resident;
  out[2] = s.resident_wait_ns;
  out[3] = s.barriers;
}

// out[2] = {bytes submitted under a shard tag, bytes resident}
void ebt_cuda_ckpt_byte_totals(void* p, uint64_t* out) {
  P(p)->ckptByteTotals(out);
}

// fills up to n resident-byte counts, one per lane; returns the lane count
int ebt_cuda_ckpt_dev_bytes(void* p, uint64_t* out, int n) {
  std::vector<uint64_t> v = P(p)->ckptDevBytes();
  for (int i = 0; i < n && i < (int)v.size(); i++) out[i] = v[i];
  return (int)v.size();
}

// the direction-10 all-resident barrier, run explicitly; 0 ok
int ebt_cuda_ckpt_barrier(void* p) { return P(p)->ckptBarrier(); }

// "device N shard S: cause" of the first failed restore copy; empty if none
void ebt_cuda_ckpt_error(void* p, char* buf, int len) {
  copyOut(P(p)->ckptError(), buf, len);
}

// ---- device faults (--retry/--maxerrors), the twins of the
// ebt_pjrt_* fault exports

// budget failures eject a lane (0 disables the policy), retry_max bounds the
// resubmits beyond one walk over the survivors, backoff_ms is the
// exponential backoff base
void ebt_cuda_set_fault_policy(void* p, int device_error_budget,
                               int retry_max, uint64_t backoff_ms) {
  P(p)->setFaultPolicy(device_error_budget, retry_max, backoff_ms);
}

// out[6] = {dev_retry_attempts, dev_retry_success, dev_retry_backoff_ns,
// dev_errors, ejected_devices, replanned_units}; session-cumulative
void ebt_cuda_fault_stats(void* p, uint64_t* out) {
  CudaPath::FaultStats s = P(p)->faultStats();
  out[0] = s.dev_retry_attempts;
  out[1] = s.dev_retry_success;
  out[2] = s.dev_retry_backoff_ns;
  out[3] = s.dev_errors;
  out[4] = s.ejected_devices;
  out[5] = s.replanned_units;
}

// "device N: cause" of every ejection, '\n'-joined (empty when none)
void ebt_cuda_ejected(void* p, char* buf, int len) {
  copyOut(P(p)->ejectedDevices(), buf, len);
}

// bit i = lane i ejected
uint64_t ebt_cuda_ejected_mask(void* p) { return P(p)->ejectedMask(); }

// force-eject a lane: 0 ok, 1 = out of range, already ejected, or the last
// healthy lane
int ebt_cuda_eject_device(void* p, int device, const char* cause) {
  return P(p)->ejectDevice(device, cause ? std::string(cause) : std::string());
}

// the engine's interrupt flag (ebt_engine_interrupt_flag): recovery backoff
// waits wake when it is set
void ebt_cuda_set_interrupt_flag(void* p, const void* flag) {
  P(p)->setInterruptFlag(static_cast<const std::atomic<bool>*>(flag));
}

// ---- N->M reshard (--reshard), the twins of the ebt_pjrt_reshard_*
// exports

// parallel arrays of nunits (action 0 resident / 1 move / 2 read, src lane,
// dst lane, bytes); before the first data copy. 0 ok.
int ebt_cuda_set_reshard_plan(void* p, const int* actions, const int* srcs,
                              const int* dsts, const uint64_t* bytes,
                              int nunits) {
  if (nunits <= 0 || !actions || !srcs || !dsts || !bytes) return 1;
  return P(p)->setReshardPlan(std::vector<int>(actions, actions + nunits),
                              std::vector<int>(srcs, srcs + nunits),
                              std::vector<int>(dsts, dsts + nunits),
                              std::vector<uint64_t>(bytes, bytes + nunits));
}

// stage the move units' sources on their src lanes (untimed set-up,
// idempotent). 0 ok.
int ebt_cuda_reshard_preload(void* p) { return P(p)->reshardPreload(); }

// out[13] = {units_total, units_resident, units_moved, units_read,
// d2d_submitted_bytes, d2d_resident_bytes, d2d_moves, bounce_moves,
// move_recovered, move_fallback_reads, reshard_read_bytes,
// resident_wait_ns, barriers}
void ebt_cuda_reshard_stats(void* p, uint64_t* out) {
  CudaPath::ReshardStats s = P(p)->reshardStats();
  out[0] = s.units_total;
  out[1] = s.units_resident;
  out[2] = s.units_moved;
  out[3] = s.units_read;
  out[4] = s.d2d_submitted_bytes;
  out[5] = s.d2d_resident_bytes;
  out[6] = s.d2d_moves;
  out[7] = s.bounce_moves;
  out[8] = s.move_recovered;
  out[9] = s.move_fallback_reads;
  out[10] = s.reshard_read_bytes;
  out[11] = s.resident_wait_ns;
  out[12] = s.barriers;
}

// out[2] = {bytes submitted under unit tags, bytes resident}
void ebt_cuda_reshard_byte_totals(void* p, uint64_t* out) {
  P(p)->reshardByteTotals(out);
}

// the src->dst pair matrix, row-major: out[i*2] = settled chunk moves and
// out[i*2+1] = their bytes for pair i = src*ndev + dst < npairs; returns
// ndev
int ebt_cuda_reshard_pair_matrix(void* p, uint64_t* out, int npairs) {
  return P(p)->reshardPairMatrix(out, npairs);
}

// the direction-15 barrier, run explicitly; 0 ok
int ebt_cuda_reshard_barrier(void* p) { return P(p)->reshardBarrier(); }

// "unit U src A dst B: cause" of the first failure; empty if none
void ebt_cuda_reshard_error(void* p, char* buf, int len) {
  copyOut(P(p)->reshardError(), buf, len);
}

// 1 when the driver has the device-to-device entries and EBT_D2D_DISABLE
// is off
int ebt_cuda_d2d_supported(void* p) { return P(p)->d2dSupported() ? 1 : 0; }

// out[2] = {ordered pairs of distinct selected devices with peer access
// enabled, all such pairs}
void ebt_cuda_peer_access(void* p, int* out) {
  P(p)->peerAccess(&out[0], &out[1]);
}

// ---- serving rotation (--rotate), the twins of the ebt_pjrt_rotation_*
// exports

// the lane bucket's byte/s ceiling (0 = unthrottled)
void ebt_cuda_set_bg_budget(void* p, uint64_t bytes_per_s) {
  P(p)->setBgBudget(bytes_per_s);
}

// out[6] = {published generation, restoring, lane bucket rate,
// bg_lane_throttle_ns, bg_h2d_bytes, retained pendings of both generations}
void ebt_cuda_rotation_state(void* p, uint64_t* out) {
  P(p)->rotationState(out);
}

int ebt_cuda_rotation_count(void* p) { return P(p)->rotationCount(); }

// out[8] = {generation, shards_total, shards_resident, bytes_submitted,
// bytes_resident, bg_bytes, retained_buffers, released_buffers}; 0 ok
int ebt_cuda_rotation_record(void* p, int idx, uint64_t* out) {
  CudaPath::RotationRecord r;
  if (!P(p)->rotationRecord(idx, &r)) return 1;
  out[0] = r.generation;
  out[1] = r.shards_total;
  out[2] = r.shards_resident;
  out[3] = r.bytes_submitted;
  out[4] = r.bytes_resident;
  out[5] = r.bg_bytes;
  out[6] = r.retained_buffers;
  out[7] = r.released_buffers;
  return 0;
}

// test-only: [offset, offset + len) of `shard` as the active generation
// holds it on the shard's replica-th placement lane, into host; 0 ok
int ebt_cuda_rotation_read(void* p, int64_t shard, int replica,
                           uint64_t offset, uint64_t len, void* host) {
  return P(p)->rotationRead(shard, replica, offset, len, host);
}

// ---- DL-ingestion ledger (--ingest), the twins of the ebt_pjrt_ingest_*
// exports

int ebt_cuda_set_ingest_plan(void* p, uint64_t record_size, int epochs) {
  return P(p)->setIngestPlan(record_size, epochs);
}

// out[8] = {read, submitted, resident, dropped bytes, batch_coalesce_count,
// prefetch_peak_bytes, resident_wait_ns, barriers}
void ebt_cuda_ingest_stats(void* p, uint64_t* out) {
  CudaPath::IngestStats s = P(p)->ingestStats();
  out[0] = s.read_bytes;
  out[1] = s.submitted_bytes;
  out[2] = s.resident_bytes;
  out[3] = s.dropped_bytes;
  out[4] = s.batch_coalesce_count;
  out[5] = s.prefetch_peak_bytes;
  out[6] = s.resident_wait_ns;
  out[7] = s.barriers;
}

// out[4] = read/submitted/resident/dropped bytes of `epoch`; 0 ok
int ebt_cuda_ingest_epoch_bytes(void* p, int64_t epoch, uint64_t* out) {
  return P(p)->ingestEpochBytes(epoch, out) ? 0 : 1;
}

int ebt_cuda_ingest_epochs(void* p) { return P(p)->ingestEpochs(); }

// the direction-12 barrier, run explicitly; 0 ok
int ebt_cuda_ingest_barrier(void* p) { return P(p)->ingestBarrier(); }

// "device N epoch E: cause" of the first failure; empty if none
void ebt_cuda_ingest_error(void* p, char* buf, int len) {
  copyOut(P(p)->ingestError(), buf, len);
}

void ebt_cuda_ingest_rearm(void* p) { P(p)->ingestRearm(); }

// ---- write leg and kernels

void ebt_cuda_set_d2h_depth(void* p, int depth) { P(p)->setD2HDepth(depth); }

// out[3] = {deferred blocks, barrier wait ns, overlapped bytes}
void ebt_cuda_d2h_stats(void* p, uint64_t* out) { P(p)->d2hStats(out); }

// kernel_lib: the library exporting the kernels' C entries (built from
// csrc/*.cu, or the mock). 0 ok, else 1 with the cause in errbuf.
int ebt_cuda_enable_verify(void* p, uint64_t salt, const char* kernel_lib,
                           char* errbuf, int errlen) {
  std::string err = P(p)->enableVerify(salt, kernel_lib);
  copyOut(err, errbuf, errlen);
  return err.empty() ? 0 : 1;
}

int ebt_cuda_enable_write_gen(void* p, uint64_t salt, const char* kernel_lib,
                              char* errbuf, int errlen) {
  std::string err = P(p)->enableWriteGen(salt, kernel_lib);
  copyOut(err, errbuf, errlen);
  return err.empty() ? 0 : 1;
}

// out[2] = {verify kernel launches, fill kernel launches} of every path in
// the process since the last reset
void ebt_cuda_kernel_launches(uint64_t* out) {
  CudaPath::kernelLaunches(out);
}

void ebt_cuda_reset_kernel_launches() { CudaPath::resetKernelLaunches(); }

}  // extern "C"
