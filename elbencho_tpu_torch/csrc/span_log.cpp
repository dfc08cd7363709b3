// The port's span log (span_log.h): per-thread single-producer rings, one
// generation per capacity asked of enable().
#include "span_log.h"

#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdlib>
#include <new>

namespace ebt {
namespace spans {

std::atomic<bool> g_on{false};

namespace {

// rings per generation: one per recording thread (engine workers, the
// coordinator's thread); a thread beyond the last one drops its records
constexpr uint32_t kRings = 64;

// One thread's ring: the owner writes at tail, the drainer reads from head.
// A cache line of its own, so two threads' tails never share one. A ring
// has one owner at a time; a thread that exits gives its ring back, and the
// next thread to claim it appends behind what the last one left.
struct alignas(64) Ring {
  std::atomic<uint64_t> head{0};
  std::atomic<uint64_t> tail{0};
  std::atomic<bool> owned{false};
  Record* recs = nullptr;
};

// Everything one enable() of a new capacity allocates. An enable() of the
// same capacity restarts the current generation in place. A generation
// that is replaced is never freed: a thread that read it may still be
// writing into it, so enable() keeps it reachable through `prev`.
struct Gen {
  uint64_t cap = 0;
  Ring rings[kRings];
  Record* store = nullptr;
  std::atomic<uint32_t> epoch{0};  // enable()s of this generation
  std::atomic<uint64_t> dropped{0};
  uint64_t anchor_rt = 0;
  uint64_t anchor_mono = 0;
  Gen* prev = nullptr;
};

std::atomic<Gen*> g_gen{nullptr};

// A thread's claim on a ring of one generation, given back when it exits.
struct Slot {
  Gen* gen = nullptr;
  Ring* ring = nullptr;
  uint32_t epoch = 0;  // the generation's epoch when a claim last failed
  uint32_t tid = 0;
  ~Slot() {
    if (ring) ring->owned.store(false, std::memory_order_release);
  }
};
thread_local Slot t_slot;

// the first free ring of `g`, or nullptr when every ring has an owner
Ring* claim(Gen* g) {
  for (uint32_t i = 0; i < kRings; i++)
    if (!g->rings[i].owned.load(std::memory_order_relaxed) &&
        !g->rings[i].owned.exchange(true, std::memory_order_acq_rel))
      return &g->rings[i];
  return nullptr;
}

uint64_t clockNs(clockid_t id) {
  timespec ts;
  clock_gettime(id, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// the tightest of a few back-to-back reads: the realtime stamp against the
// middle of the two monotonic stamps around it
void readAnchor(Gen* g) {
  uint64_t best = UINT64_MAX;
  for (int i = 0; i < 8; i++) {
    const uint64_t m0 = clockNs(CLOCK_MONOTONIC);
    const uint64_t rt = clockNs(CLOCK_REALTIME);
    const uint64_t m1 = clockNs(CLOCK_MONOTONIC);
    if (m1 - m0 < best) {
      best = m1 - m0;
      g->anchor_rt = rt;
      g->anchor_mono = m0 + (m1 - m0) / 2;
    }
  }
}

}  // namespace

uint64_t nowNs() { return clockNs(CLOCK_MONOTONIC); }

void record(uint16_t name, uint16_t code, uint64_t t0_ns, uint64_t t1_ns,
            uint64_t arg) {
  Gen* g = g_gen.load(std::memory_order_acquire);
  if (!g) return;
  Slot& s = t_slot;
  if (s.gen != g) {  // first record of this thread in this generation
    s.gen = g;
    s.ring = claim(g);
    s.epoch = g->epoch.load(std::memory_order_relaxed);
    if (!s.tid) s.tid = (uint32_t)syscall(SYS_gettid);
  }
  Ring* r = s.ring;
  if (!r) {  // no ring was free: try again once per enable()
    const uint32_t e = g->epoch.load(std::memory_order_relaxed);
    if (e != s.epoch) {
      s.epoch = e;
      r = s.ring = claim(g);
    }
  }
  if (!r) {
    g->dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  const uint64_t t = r->tail.load(std::memory_order_relaxed);
  if (t - r->head.load(std::memory_order_acquire) >= g->cap) {
    g->dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  Record& rec = r->recs[t % g->cap];
  rec.name = name;
  rec.code = code;
  rec.tid = s.tid;
  rec.t0_ns = t0_ns;
  rec.t1_ns = t1_ns;
  rec.arg = arg;
  r->tail.store(t + 1, std::memory_order_release);
}

int enable(uint64_t capacity_per_thread) {
  if (!capacity_per_thread) return 1;
  Gen* cur = g_gen.load(std::memory_order_acquire);
  if (cur && cur->cap == capacity_per_thread) {
    // the same capacity: empty every ring and start again in place, each
    // thread keeping its ring (a record in flight lands after the restart)
    for (Ring& r : cur->rings)
      r.head.store(r.tail.load(std::memory_order_acquire),
                   std::memory_order_release);
    cur->dropped.store(0, std::memory_order_relaxed);
    cur->epoch.fetch_add(1, std::memory_order_relaxed);
    readAnchor(cur);
    g_on.store(true, std::memory_order_release);
    return 0;
  }
  Gen* g = new (std::nothrow) Gen;
  if (!g) return 1;
  // calloc: pages a ring never writes are never touched
  g->store = static_cast<Record*>(
      std::calloc(kRings * capacity_per_thread, sizeof(Record)));
  if (!g->store) {
    delete g;
    return 1;
  }
  g->cap = capacity_per_thread;
  for (uint32_t i = 0; i < kRings; i++)
    g->rings[i].recs = g->store + (uint64_t)i * capacity_per_thread;
  readAnchor(g);
  g->prev = cur;
  g_gen.store(g, std::memory_order_release);
  g_on.store(true, std::memory_order_release);
  return 0;
}

void disable() { g_on.store(false, std::memory_order_release); }

uint64_t drain(Record* out, uint64_t max_records) {
  Gen* g = g_gen.load(std::memory_order_acquire);
  if (!g || !out) return 0;
  uint64_t n = 0;
  for (uint32_t i = 0; i < kRings && n < max_records; i++) {
    Ring& r = g->rings[i];
    uint64_t h = r.head.load(std::memory_order_relaxed);
    const uint64_t t = r.tail.load(std::memory_order_acquire);
    for (; h < t && n < max_records; h++) out[n++] = r.recs[h % g->cap];
    r.head.store(h, std::memory_order_release);
  }
  return n;
}

State state() {
  State s{};
  s.enabled = on() ? 1 : 0;
  Gen* g = g_gen.load(std::memory_order_acquire);
  if (!g) return s;
  s.capacity = g->cap;
  s.dropped = g->dropped.load(std::memory_order_relaxed);
  s.anchor_realtime_ns = g->anchor_rt;
  s.anchor_monotonic_ns = g->anchor_mono;
  for (const Ring& r : g->rings)
    s.threads += r.owned.load(std::memory_order_relaxed) ? 1 : 0;
  return s;
}

}  // namespace spans
}  // namespace ebt
