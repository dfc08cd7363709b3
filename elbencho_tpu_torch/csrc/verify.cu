// On-device --verify pattern check for Hopper (sm_90a).
//
// Replaces the original package's Pallas TPU kernel _verify_kernel
// (elbencho_tpu/ops/pallas_verify.py, driven by _verify_call and the entry
// point verify_block_pallas) and, through the same launch, its jitted
// device program integrity.verify_block_u32 (elbencho_tpu/ops/integrity.py):
// one pass over a staged block yields the count of bad u32 lanes (the Pallas
// kernel's result), the count of bad u64 words and the index of the first
// bad word (verify_block_u32's result).
//
// Pattern (core/src/engine.cpp fillVerifyPattern): little-endian u64 word i
// of a block equals base + 8*i mod 2^64, base = file offset + salt. Lane 2i
// is the word's low half, lane 2i+1 its high half; an odd trailing lane is
// compared as a low half only, as the Pallas kernel's lane semantics give.
//
// Bound: bytes. The kernel reads the block once and does a few integer
// operations per byte, far below what the SMs execute per byte of HBM
// bandwidth. At the staged path's 4 MiB block the bound is about 1.25 us,
// less than a launch's fixed cost, so the design keeps bytes in flight and
// keeps every fixed cost per launch small:
// - Each thread has kUnroll independent 16-byte loads (ld.global.nc.v2.u64)
//   in flight before it uses the first. The expected word base + 8*w is
//   computed in registers; nothing expected is ever stored. A start that
//   is 8 mod 16 and an odd word count take a scalar head and tail word.
// - The grid is sized to the work: one CTA per 16 KiB (kThreads x kUnroll
//   vectors), capped at one wave of kCtasPerSm CTAs per SM that stride over
//   the rest. A 4 MiB block is 256 CTAs with one pass each; 256 MiB is one
//   wave that loops.
// - The cross-CTA reduction needs no contended atomics and no initialised
//   output: each CTA stores {lanes, words, first} to its own slot of a
//   workspace the caller owns per stream, fences, and takes a ticket with
//   one atomicAdd. The last CTA folds the slots, writes the whole int64[3]
//   result and sets the ticket back to 0 for the next launch on the stream.
// - The SM count is passed in by the caller, who queries it once per
//   device: the C entry point makes no device query per call.
// The staged --verify path launches this once per block, not per chunk, and
// reads the result once per block (cuda/backend.py).
//
// Not used: TMA bulk copies into a shared-memory ring. The vector loads
// (kUnroll x 16 B x 1024 threads in flight per SM) reach about 90% of the
// bytes bound at 256 MiB on an H100 SXM (chip_smoke.py, PERF.md), which
// leaves a ring little to gain and adds its barriers to every launch.
//
// The C entry point launches on the caller's stream, allocates nothing and
// does not synchronise; it returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread
constexpr int kCtasPerSm = 4;   // the grid's cap: one wave
constexpr u64 kPassVecs = (u64)kThreads * kUnroll;  // 16 KiB per CTA pass
constexpr unsigned kFull = 0xffffffffu;

struct Acc {
    u64 lanes;  // bad u32 lanes
    u64 words;  // bad u64 words
    u64 first;  // first bad word, n_words when none
};

__device__ __forceinline__ void check_word(u64 got, u64 w, u64 base,
                                           Acc& a) {
    const u64 x = got ^ (base + 8ull * w);
    a.lanes += ((uint32_t)x != 0u) + ((uint32_t)(x >> 32) != 0u);
    if (x != 0ull) {
        ++a.words;
        a.first = min(a.first, w);
    }
}

// The CTA's total, valid in thread 0.
__device__ __forceinline__ Acc cta_reduce(Acc a) {
    __shared__ u64 s_lanes[kWarps];
    __shared__ u64 s_words[kWarps];
    __shared__ u64 s_first[kWarps];
    for (int off = 16; off > 0; off >>= 1) {
        a.lanes += __shfl_down_sync(kFull, a.lanes, off);
        a.words += __shfl_down_sync(kFull, a.words, off);
        a.first = min(a.first, __shfl_down_sync(kFull, a.first, off));
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
        s_lanes[warp] = a.lanes;
        s_words[warp] = a.words;
        s_first[warp] = a.first;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int i = 1; i < kWarps; ++i) {
            a.lanes += s_lanes[i];
            a.words += s_words[i];
            a.first = min(a.first, s_first[i]);
        }
    }
    return a;
}

// ws: 3 * n_slots u64 partials (lanes, words, first; one slot per CTA)
// followed by the u32 ticket, which is 0 between launches.
__global__ void __launch_bounds__(kThreads)
verify_u32_kernel(const uint32_t* __restrict__ data, u64 n_lanes, u64 base,
                  long long* __restrict__ out, u64* __restrict__ ws,
                  unsigned n_slots) {
    const u64 n_words = n_lanes / 2;
    const u64* __restrict__ words = reinterpret_cast<const u64*>(data);
    // one scalar word first when the data starts 8 bytes past a 16-byte
    // boundary; then whole 16-byte vectors; then at most one scalar word
    const u64 head = (n_words && ((uintptr_t)data & 8u)) ? 1 : 0;
    const u64 n_vecs = (n_words - head) / 2;
    const u64 tail = head + 2 * n_vecs;
    const ulonglong2* __restrict__ vecs =
        reinterpret_cast<const ulonglong2*>(words + head);

    Acc a{0, 0, n_words};
    const u64 stride = (u64)gridDim.x * kPassVecs;
    for (u64 p = (u64)blockIdx.x * kPassVecs + threadIdx.x; p < n_vecs;
         p += stride) {
        ulonglong2 v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const u64 i = p + (u64)k * kThreads;
            v[k] = i < n_vecs ? __ldg(vecs + i) : make_ulonglong2(0, 0);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const u64 i = p + (u64)k * kThreads;
            if (i < n_vecs) {
                const u64 w = head + 2 * i;
                check_word(v[k].x, w, base, a);
                check_word(v[k].y, w + 1, base, a);
            }
        }
    }
    if (blockIdx.x == 0) {
        if (threadIdx.x == 0 && head) check_word(__ldg(words), 0, base, a);
        if (threadIdx.x == 1 && tail < n_words) {
            check_word(__ldg(words + tail), tail, base, a);
        }
        if (threadIdx.x == 2 && (n_lanes & 1ull)) {
            const uint32_t expect = (uint32_t)(base + 8ull * n_words);
            a.lanes += __ldg(data + n_lanes - 1) != expect;
        }
    }

    a = cta_reduce(a);
    unsigned* ticket = reinterpret_cast<unsigned*>(ws + 3ull * n_slots);
    __shared__ bool s_last;
    if (threadIdx.x == 0) {
        ws[blockIdx.x] = a.lanes;
        ws[n_slots + blockIdx.x] = a.words;
        ws[2ull * n_slots + blockIdx.x] = a.first;
        __threadfence();  // the slot is visible before the ticket is taken
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // the last CTA: every other CTA's slot is written; read them from L2
    Acc t{0, 0, n_words};
    for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads) {
        t.lanes += __ldcg(ws + i);
        t.words += __ldcg(ws + n_slots + i);
        t.first = min(t.first, __ldcg(ws + 2ull * n_slots + i));
    }
    t = cta_reduce(t);
    if (threadIdx.x == 0) {
        out[0] = (long long)t.lanes;
        out[1] = (long long)t.words;
        out[2] = (long long)t.first;
        *ticket = 0u;  // launches on one stream run in order
    }
}

}  // namespace

// Bytes of the workspace a stream needs on a device with `sms` SMs: the
// caller allocates it once per (device, stream) and zeroes it once.
extern "C" uint64_t ebt_verify_workspace_bytes(int sms) {
    return (uint64_t)(sms < 1 ? 1 : sms) * kCtasPerSm * 3 * 8 + 8;
}

// data: device pointer to n_lanes u32 lanes, 8-byte aligned.
// out: device int64[3] <- {bad lanes, bad words, first bad word (n_lanes / 2
//      when clean)}; written whole by the launch, needs no prior fill.
// workspace: ebt_verify_workspace_bytes(sms) bytes, zeroed once, used by
//      one stream only.
// sms: the device's SM count. stream: the cudaStream_t to launch on.
extern "C" int ebt_verify_u32(const void* data, uint64_t n_lanes,
                              uint64_t base, void* out, void* workspace,
                              int sms, void* stream) {
    if (sms < 1) return (int)cudaErrorInvalidValue;
    const unsigned n_slots = (unsigned)sms * kCtasPerSm;
    const u64 work = (n_lanes / 4 + kPassVecs - 1) / kPassVecs;
    const unsigned grid =
        (unsigned)(work < 1 ? 1 : (work < n_slots ? work : n_slots));
    verify_u32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)data, n_lanes, base, (long long*)out, (u64*)workspace,
        n_slots);
    return (int)cudaGetLastError();
}
