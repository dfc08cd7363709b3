// Fused verify + checksum of staged blocks (the ingest step) for Hopper
// (sm_90a).
//
// Replaces the original package's jitted device programs
// integrity.checksum_block_u32 and integrity.ingest_verify_step
// (elbencho_tpu/ops/integrity.py:65 and :74-86) and, batched over ranks,
// the vmapped per-rank step of parallel/mesh.py sharded_ingest_step
// (:46-55). One pass over each rank's block yields all four fields of the
// step:
//   ok_bytes        uint32(n_lanes * 4) when no word is bad, else 0;
//   bad_words       u64 words that differ from the offset+salt pattern;
//   first_bad_word  the first such word, n_lanes / 2 when the block is clean;
//   checksum        the sum of the block's u32 lanes mod 2^32.
// Pattern (core/src/engine.cpp fillVerifyPattern): little-endian u64 word i
// of a block equals base + 8*i mod 2^64, base = file offset + salt; each
// rank has its own base. The lane count is even (the original reshapes the
// lanes to (-1, 2)); the C entry refuses an odd one.
//
// Bound: bytes. Each block is read once, with a few integer operations per
// byte. The design is verify.cu's:
// - Each thread has kUnroll independent 16-byte loads in flight before it
//   uses the first; the expected word is computed in registers, and the
//   checksum takes both halves of each loaded word in a u64 accumulator, so
//   it costs no second pass. A rank whose block starts 8 mod 16 takes a
//   scalar head word, an odd word count a scalar tail word.
// - The grid is 2-D: blockIdx.y is the rank, blockIdx.x strides over the
//   rank's block. Per rank, one CTA per 16 KiB of work, and all ranks
//   together capped at one wave of kCtasPerSm CTAs per SM (at least one CTA
//   per rank), so one launch covers a whole batch of ranks.
// - Per rank, each CTA stores its partials to its own workspace slot,
//   fences and takes the rank's ticket; the rank's last CTA folds the
//   slots, writes the rank's int64[4] result and sets the ticket back to 0
//   for the next launch on the stream. No output fill, no atomics on the
//   result. Rank r's slots and ticket sit at a place that depends on r and
//   the SM count only, so a smaller batch after a larger one on the same
//   workspace finds its tickets at 0.
// The C entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

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
constexpr u64 kMaxRanks = 65535;  // gridDim.y

struct Acc {
    u64 bad;    // bad u64 words
    u64 first;  // first bad word, n_words when none
    u64 csum;   // sum of u32 lanes, reduced mod 2^32 at the end
};

__device__ __forceinline__ void take_word(u64 got, u64 w, u64 base,
                                          Acc& a) {
    a.csum += (got & 0xffffffffull) + (got >> 32);
    if (got != base + 8ull * w) {
        ++a.bad;
        a.first = min(a.first, w);
    }
}

// The CTA's total, valid in thread 0.
__device__ __forceinline__ Acc cta_reduce(Acc a) {
    __shared__ u64 s_bad[kWarps];
    __shared__ u64 s_first[kWarps];
    __shared__ u64 s_csum[kWarps];
    for (int off = 16; off > 0; off >>= 1) {
        a.bad += __shfl_down_sync(kFull, a.bad, off);
        a.first = min(a.first, __shfl_down_sync(kFull, a.first, off));
        a.csum += __shfl_down_sync(kFull, a.csum, off);
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
        s_bad[warp] = a.bad;
        s_first[warp] = a.first;
        s_csum[warp] = a.csum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int i = 1; i < kWarps; ++i) {
            a.bad += s_bad[i];
            a.first = min(a.first, s_first[i]);
            a.csum += s_csum[i];
        }
    }
    return a;
}

// data: rank r's lanes start at data + r * stride_lanes.
// ws: one region of rank_ws_words(n_slots) u64 per rank: 3 * n_slots
// partials (bad, first, csum; one slot per CTA of the rank), then the
// rank's ticket in the low half of one more word, 0 between launches.
__host__ __device__ constexpr u64 rank_ws_words(u64 n_slots) {
    return 3 * n_slots + 1;
}

__global__ void __launch_bounds__(kThreads)
ingest_verify_kernel(const uint32_t* __restrict__ data, u64 n_lanes,
                     u64 stride_lanes, const long long* __restrict__ bases,
                     long long* __restrict__ out, u64* __restrict__ ws,
                     unsigned n_slots) {
    const unsigned r = blockIdx.y;
    const uint32_t* lanes = data + (u64)r * stride_lanes;
    const u64 base = (u64)bases[r];
    const u64 n_words = n_lanes / 2;
    const u64* __restrict__ words = reinterpret_cast<const u64*>(lanes);
    const u64 head = (n_words && ((uintptr_t)lanes & 8u)) ? 1 : 0;
    const u64 n_vecs = (n_words - head) / 2;
    const u64 tail = head + 2 * n_vecs;
    const ulonglong2* __restrict__ vecs =
        reinterpret_cast<const ulonglong2*>(words + head);

    Acc a{0, n_words, 0};
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
                take_word(v[k].x, w, base, a);
                take_word(v[k].y, w + 1, base, a);
            }
        }
    }
    if (blockIdx.x == 0) {
        if (threadIdx.x == 0 && head) take_word(__ldg(words), 0, base, a);
        if (threadIdx.x == 1 && tail < n_words) {
            take_word(__ldg(words + tail), tail, base, a);
        }
    }

    a = cta_reduce(a);
    u64* slots = ws + (u64)r * rank_ws_words(n_slots);
    unsigned* ticket = reinterpret_cast<unsigned*>(slots + 3ull * n_slots);
    __shared__ bool s_last;
    if (threadIdx.x == 0) {
        slots[blockIdx.x] = a.bad;
        slots[n_slots + blockIdx.x] = a.first;
        slots[2ull * n_slots + blockIdx.x] = a.csum;
        __threadfence();  // the slot is visible before the ticket is taken
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // the rank's last CTA: every other CTA's slot is written; read from L2
    Acc t{0, n_words, 0};
    for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads) {
        t.bad += __ldcg(slots + i);
        t.first = min(t.first, __ldcg(slots + n_slots + i));
        t.csum += __ldcg(slots + 2ull * n_slots + i);
    }
    t = cta_reduce(t);
    if (threadIdx.x == 0) {
        long long* o = out + 4ull * r;
        o[0] = t.bad ? 0ll : (long long)(uint32_t)(n_lanes * 4ull);
        o[1] = (long long)t.bad;
        o[2] = (long long)t.first;
        o[3] = (long long)(t.csum & 0xffffffffull);
        *ticket = 0u;  // launches on one stream run in order
    }
}

}  // namespace

// Bytes of the workspace a stream needs for batches of up to n_ranks ranks
// on a device with `sms` SMs: the caller allocates it once per (device,
// stream), zeroes it once, and makes a larger one for a larger batch.
extern "C" uint64_t ebt_ingest_workspace_bytes(int sms, uint64_t n_ranks) {
    const u64 slots = (u64)(sms < 1 ? 1 : sms) * kCtasPerSm;
    const u64 ranks = n_ranks < 1 ? 1 : n_ranks;
    return ranks * rank_ws_words(slots) * 8;
}

// data: device pointer to rank 0's n_lanes u32 lanes, 8-byte aligned; rank r
//      starts rank_stride_lanes lanes later (an even count). n_lanes is even.
// bases: device int64[n_ranks], the u64 bits of each rank's offset + salt.
// out: device int64[n_ranks][4] <- {ok_bytes, bad_words, first_bad_word,
//      checksum}; written whole by the launch, needs no prior fill.
// workspace: ebt_ingest_workspace_bytes(sms, n) bytes for some n >= n_ranks,
//      zeroed once, used by one stream only.
// sms: the device's SM count. stream: the cudaStream_t to launch on.
extern "C" int ebt_ingest_verify_u32(const void* data, uint64_t n_lanes,
                                     uint64_t n_ranks,
                                     uint64_t rank_stride_lanes,
                                     const void* bases, void* out,
                                     void* workspace, int sms, void* stream) {
    if (sms < 1 || n_ranks < 1 || n_ranks > kMaxRanks || (n_lanes & 1ull) ||
        (rank_stride_lanes & 1ull)) {
        return (int)cudaErrorInvalidValue;
    }
    const unsigned n_slots = (unsigned)sms * kCtasPerSm;
    const u64 work = (n_lanes / 4 + kPassVecs - 1) / kPassVecs;
    const u64 share = n_slots / n_ranks;
    const u64 cap = share < 1 ? 1 : share;
    const unsigned gx = (unsigned)(work < 1 ? 1 : (work < cap ? work : cap));
    const dim3 grid(gx, (unsigned)n_ranks);
    ingest_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)data, n_lanes, rank_stride_lanes,
        (const long long*)bases, (long long*)out, (u64*)workspace, n_slots);
    return (int)cudaGetLastError();
}
