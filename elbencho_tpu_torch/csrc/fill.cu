// On-device generation of the --verify pattern for Hopper (sm_90a).
//
// Replaces the original package's device program integrity.fill_block_u32
// (elbencho_tpu/ops/integrity.py, exported by tpu/native.py
// export_fill_programs and run by PjrtPath::generateD2H): verified writes
// source a block whose pattern was born in device memory.
//
// Pattern (core/src/engine.cpp fillVerifyPattern): little-endian u64 word i
// of a block equals base + 8*i mod 2^64, base = file offset + salt. The
// kernel writes n_words such words; the unsigned wrap past 2^64 is the
// pattern's own.
//
// Bound: bytes. The kernel reads nothing and writes each output byte once,
// with one add per word, so its least time is the bytes written over the
// device memory rate. The design keeps it simple and store-bound:
// - each thread issues kUnroll independent 16-byte stores (two words each),
//   neighbouring threads on neighbouring addresses;
// - a start that is 8 mod 16 takes one scalar head word, an odd remainder
//   one scalar tail word;
// - the grid is sized to the work (one CTA per kThreads x kUnroll vectors,
//   16 KiB), so the entry makes no device query per call.
//
// The C entry launches on the caller's stream, allocates nothing and does
// not synchronise; it returns cudaGetLastError() so a refused launch is
// reported to the caller (the ctypes wrapper, or the native engine, which
// launches it on its lane's D2H stream).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr u64 kCtaVecs = (u64)kThreads * kUnroll;

__global__ void __launch_bounds__(kThreads)
fill_u64_kernel(u64* __restrict__ dst, u64 n_words, u64 base) {
    const u64 head = (n_words && ((uintptr_t)dst & 8u)) ? 1 : 0;
    const u64 n_vecs = (n_words - head) / 2;
    const u64 tail = head + 2 * n_vecs;
    ulonglong2* __restrict__ vecs = reinterpret_cast<ulonglong2*>(dst + head);
    const u64 first = (u64)blockIdx.x * kCtaVecs + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
        const u64 i = first + (u64)k * kThreads;
        if (i < n_vecs) {
            const u64 w = base + 8ull * (head + 2 * i);
            vecs[i] = make_ulonglong2(w, w + 8ull);
        }
    }
    if (blockIdx.x == 0) {
        if (threadIdx.x == 0 && head) dst[0] = base;
        if (threadIdx.x == 1 && tail < n_words) dst[tail] = base + 8ull * tail;
    }
}

}  // namespace

// dst: device pointer to n_words u64 words, 8-byte aligned. Word i <- base +
// 8*i. stream: the cudaStream_t (or driver CUstream) to launch on.
extern "C" int ebt_fill_u64(void* dst, uint64_t n_words, uint64_t base,
                            void* stream) {
    if ((uintptr_t)dst & 7u) return (int)cudaErrorInvalidValue;
    if (!n_words) return (int)cudaSuccess;
    const u64 grid = (n_words / 2 + kCtaVecs - 1) / kCtaVecs;
    fill_u64_kernel<<<(unsigned)(grid < 1 ? 1 : grid), kThreads, 0,
                      (cudaStream_t)stream>>>((u64*)dst, n_words, base);
    return (int)cudaGetLastError();
}
