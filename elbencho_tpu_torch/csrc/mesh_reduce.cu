// Exact column sums of u64 counter rows (the mesh stats reduction) for
// Hopper (sm_90a).
//
// Replaces the original package's jitted cross-device reductions in
// elbencho_tpu/parallel/mesh.py: MeshStatsReducer._build (:95-99), the
// column sum of one counter row per device that XLA lowers to a psum over
// the mesh, and the cross-rank totals of sharded_ingest_step (:53-70). The
// TPU runs x64-free, so the original carries each u64 as four 16-bit limbs
// in u32 lanes and recombines them on the host; CUDA has u64 arithmetic, so
// each column is summed directly mod 2^64 (values of 2^63 and above ride
// in int64 storage with the same bits).
//
// The callers gather the rows onto one device first (one row per device,
// copied peer to peer), so the kernel sums a single row-major u64[n][k]
// array: one warp per column, each lane striding over the rows, a warp
// shuffle for the total, lane 0 writes it. No workspace, no atomics, the
// output needs no fill.
//
// Bound: a launch. The rows are a few hundred bytes (one row of 5 counters
// per device, or 4 fields per rank); the kernel's time is its launch and
// one memory round trip. ebt_launch_floor launches an empty kernel of the
// same block shape, so that floor can be timed beside it.
//
// The C entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const u64* __restrict__ rows, u64 n_rows, u64 k,
                u64* __restrict__ out) {
    const u64 col = (u64)blockIdx.x * kWarps + threadIdx.x / 32;
    if (col >= k) return;  // per warp: the whole warp leaves together
    const unsigned lane = threadIdx.x % 32;
    u64 s = 0;
    for (u64 r = lane; r < n_rows; r += 32) s += __ldg(rows + r * k + col);
    for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(kFull, s, off);
    }
    if (lane == 0) out[col] = s;
}

__global__ void __launch_bounds__(kThreads) launch_floor_kernel() {}

}  // namespace

// rows: device pointer to row-major u64[n_rows][k] (int64 storage).
// out: device u64[k] <- the column sums mod 2^64; written whole.
// stream: the cudaStream_t to launch on.
extern "C" int ebt_sum_rows_u64(const void* rows, uint64_t n_rows,
                                uint64_t k, void* out, void* stream) {
    if (k == 0) return (int)cudaSuccess;
    const u64 grid = (k + kWarps - 1) / kWarps;
    if (grid > 0x7fffffffull) return (int)cudaErrorInvalidValue;
    sum_rows_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const u64*)rows, n_rows, k, (u64*)out);
    return (int)cudaGetLastError();
}

// One launch of an empty kernel with sum_rows_kernel's block shape on the
// caller's stream: the floor under any launch of this card.
extern "C" int ebt_launch_floor(void* stream) {
    launch_floor_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
