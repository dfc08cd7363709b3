// The port's span log: where the device path and the coordinator spend a
// reader thread's time, as {name, thread, start, end, arg} records on
// CLOCK_MONOTONIC, one fixed-capacity ring per recording thread.
//
// Off (the default) a span site costs one relaxed atomic load and records
// nothing. enable() allocates every ring at once and reads an anchor pair
// (CLOCK_REALTIME, CLOCK_MONOTONIC) that maps the records onto the realtime
// clock torch.profiler stamps its host events with; an enable() of the
// capacity already allocated empties the rings and reuses them. A recording
// thread claims a free ring with an atomic exchange on its first record,
// writes only its own ring (no lock, no allocation) and gives it back when
// it exits. A full ring (or a thread that found no free ring) counts the
// record as dropped and never blocks. drain() copies every record not yet drained into the
// caller's buffer; drains must not run concurrently with each other or with
// enable() (the Python layer serialises them), recording threads may.
//
// The names and outcome codes are mirrored by elbencho_tpu_torch/spans.py.
#pragma once

#include <atomic>
#include <cstdint>

namespace ebt {
namespace spans {

enum Name : uint16_t {
  kH2DBlock = 1,      // a direction-0 CudaPath::copy, entry to return
  kH2DCopy = 2,       // the cuMemcpyHtoDAsync chunk loop of one block
  kVerifyWait = 3,    // verify launch through result fetch and stream sync
  kRegWindow = 4,     // CudaPath::registerWindow, entry to return
  kRegPin = 5,        // the cuMemHostRegister call
  kRegUnpin = 6,      // the cuMemHostUnregister call
  kBarrierReuse = 7,  // direction 2: settle a buffer before its reuse
  kCoordPhase = 8,    // Python: Coordinator._run_phase
  kCoordWait = 9,     // Python: the live-stats wait of a phase
  kCoordResults = 10, // Python: phase results, aggregation and printing
};

// kRegWindow's code: how the window request ended
enum RegOutcome : uint16_t {
  kRegHit = 0,              // covered by a live registration
  kRegRegistered = 1,       // pinned a new window
  kRegFallbackOverlap = 2,  // overlaps a live range it is not inside
  kRegFallbackInTransit = 3,  // the range's registration is changing
  kRegFallbackBudget = 4,   // larger than the whole --regwindow budget
  kRegFallbackNoVictim = 5, // no idle window left to evict
  kRegFallbackRefused = 6,  // the driver refused the pin
  kRegUnavailable = 7,      // no registered tier (or an empty request)
};

// kH2DCopy's code: the tier of the block's source. kPageable: the driver
// stages each chunk inside the copy call; kRegistered: the copies DMA from
// the registered source itself; kStaged (verified copies only): each chunk
// is copied into the rank's own pinned slots, which the copies DMA from
enum CopyTier : uint16_t { kPageable = 0, kRegistered = 1, kStaged = 2 };

struct Record {
  uint16_t name;
  uint16_t code;  // outcome, tier, or 1 where the call failed; else 0
  uint32_t tid;   // the recording thread's kernel thread id
  uint64_t t0_ns; // CLOCK_MONOTONIC
  uint64_t t1_ns;
  uint64_t arg;   // bytes, or the phase for the coordinator's spans
};
static_assert(sizeof(Record) == 32, "drained as four u64 words");

extern std::atomic<bool> g_on;

inline bool on() { return g_on.load(std::memory_order_relaxed); }

uint64_t nowNs();
void record(uint16_t name, uint16_t code, uint64_t t0_ns, uint64_t t1_ns,
            uint64_t arg);

// 0 on success, 1 when the rings cannot be allocated (the log stays off)
int enable(uint64_t capacity_per_thread);
void disable();
// copies up to max_records undrained records into out; returns how many
uint64_t drain(Record* out, uint64_t max_records);

struct State {
  uint64_t enabled;
  uint64_t capacity;  // records per thread
  uint64_t dropped;   // since the last enable
  uint64_t anchor_realtime_ns;
  uint64_t anchor_monotonic_ns;
  uint64_t threads;   // rings owned by a live recording thread
};
State state();

// One span on the calling thread: opened only when the log is on (and
// `when` holds), recorded when it closes.
class Scope {
 public:
  explicit Scope(uint16_t name, uint64_t arg = 0, bool when = true)
      : name_(name), arg_(arg), t0_(when && on() ? nowNs() : 0) {}
  ~Scope() {
    if (t0_) record(name_, code_, t0_, nowNs(), arg_);
  }
  Scope(const Scope&) = delete;
  Scope& operator=(const Scope&) = delete;
  void code(uint16_t c) { code_ = c; }

 private:
  uint16_t name_;
  uint16_t code_ = 0;
  uint64_t arg_;
  uint64_t t0_;
};

}  // namespace spans
}  // namespace ebt
