// Standalone probe: host <-> device copy throughput through the CUDA driver
// API, with no engine, framework or Python around it. The port's counterpart
// of the original package's core/tools/pjrt_probe.cpp.
//
// It dlopens the driver named by EBT_CUDA_DRIVER, else libcuda.so.1, through
// the engine's own loader (cuda_api.cpp), so it runs against the mock driver
// (build/torch_core/libebtcudamock.so) as well as the real one. Built on
// first use by elbencho_tpu_torch.engine.build_probe() into
// build/torch_core/cuda_probe (g++ -O2 -std=c++17 cuda_probe.cpp
// cuda_api.cpp -ldl).
//
// Run: build/torch_core/cuda_probe [total_mib] [chunk_mib] [depth]
//                                  [burn_mib] [nbufs] [confirm_arrival]
//                                  [mode]
//
// mode "h2d" (default): chunk-sized cuMemcpyHtoDAsync from `nbufs` distinct
// pageable host sources onto device 0, `depth` chunks in flight, each
// chunk's arrival confirmed by an event before its device slot is reused
// (confirm_arrival 0: no event per chunk, one synchronise at the end: the
// rate at which the driver takes the sources). Mode "d2h": min(nbufs, 16)
// device-resident sources (staged untimed) fetched with cuMemcpyDtoHAsync
// into distinct pageable host destinations, each fetch confirmed. Both move
// pageable memory, the staged tier's topology. The in-session ceilings of a
// live path (CudaPath::rawH2DCeiling / rawD2HCeiling) are the denominators
// a phase is graded against; this probe is a diagnostic.
//
// burn_mib (default 64) copies that many bytes at the same depth before the
// timed loop, so the link and the driver's staging buffers are warm.
//
// The last line of standard output is one JSON object: native_h2d_mib_s
// (or native_d2h_mib_s), chunk_mib, depth, nbufs and, for h2d,
// confirm_arrival, the keys of the original probe.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#include "cuda_api.h"

namespace {

ebt::cu::Api g_api;

void check(const char* what, ebt::cu::CUresult rc) {
  if (rc == ebt::cu::CUDA_SUCCESS) return;
  fprintf(stderr, "%s\n", ebt::cu::errorText(g_api, what, rc).c_str());
  exit(1);
}

}  // namespace

int main(int argc, char** argv) {
  using ebt::cu::CUdeviceptr;
  using ebt::cu::CUevent;
  const uint64_t total = (argc > 1 ? strtoull(argv[1], nullptr, 10) : 256)
                         << 20;
  const uint64_t chunk = (argc > 2 ? strtoull(argv[2], nullptr, 10) : 2)
                         << 20;
  size_t depth = argc > 3 ? strtoul(argv[3], nullptr, 10) : 8;
  const uint64_t burn = (argc > 4 ? strtoull(argv[4], nullptr, 10) : 64)
                        << 20;
  size_t nbufs = argc > 5 ? strtoul(argv[5], nullptr, 10) : 1;
  const bool confirm = argc > 6 ? strtoul(argv[6], nullptr, 10) != 0 : true;
  const bool d2h = argc > 7 && strcmp(argv[7], "d2h") == 0;
  if (depth == 0) depth = 1;
  if (nbufs == 0) nbufs = 1;
  if (chunk == 0 || total < chunk) {
    fprintf(stderr, "total_mib must be at least chunk_mib (> 0)\n");
    return 1;
  }

  const char* env = getenv("EBT_CUDA_DRIVER");
  const std::string driver = env && *env ? env : "libcuda.so.1";
  std::string err;
  if (!ebt::cu::loadApi(driver, &g_api, &err)) {
    fprintf(stderr, "%s\n", err.c_str());
    return 1;
  }
  check("cuInit", g_api.cuInit(0));
  int count = 0;
  check("cuDeviceGetCount", g_api.cuDeviceGetCount(&count));
  if (count <= 0) {
    fprintf(stderr, "CUDA driver has no devices\n");
    return 1;
  }
  ebt::cu::CUdevice dev = 0;
  ebt::cu::CUcontext ctx = nullptr;
  ebt::cu::CUstream stream = nullptr;
  check("cuDeviceGet", g_api.cuDeviceGet(&dev, 0));
  check("cuDevicePrimaryCtxRetain", g_api.cuDevicePrimaryCtxRetain(&ctx, dev));
  check("cuCtxSetCurrent", g_api.cuCtxSetCurrent(ctx));
  check("cuStreamCreate",
        g_api.cuStreamCreate(&stream, ebt::cu::CU_STREAM_NON_BLOCKING));
  fprintf(stderr, "driver %s, %d device(s)\n", driver.c_str(), count);

  std::vector<std::vector<uint8_t>> hosts(nbufs);
  std::mt19937_64 rng(42);
  for (auto& host : hosts) {
    host.resize(chunk);
    for (size_t i = 0; i + 8 <= chunk; i += 8) {
      const uint64_t v = rng();
      memcpy(host.data() + i, &v, 8);
    }
  }
  size_t next_buf = 0;
  auto nextSrc = [&]() -> const void* {
    return hosts[next_buf++ % nbufs].data();
  };

  CUdeviceptr slots = 0;  // one device slot per chunk in flight
  check("cuMemAlloc", g_api.cuMemAlloc(&slots, depth * chunk));
  std::vector<CUevent> evs(depth);
  for (auto& ev : evs)
    check("cuEventCreate",
          g_api.cuEventCreate(&ev, ebt::cu::CU_EVENT_DISABLE_TIMING));

  // n copies through the ring of slots; with confirm, an event behind each
  // copy is synchronised before its slot is reused
  auto h2dLoop = [&](uint64_t n, bool confirm_each) {
    for (uint64_t i = 0; i < n; i++) {
      const size_t slot = i % depth;
      if (confirm_each && i >= depth)
        check("arrival (cuEventSynchronize)",
              g_api.cuEventSynchronize(evs[slot]));
      check("cuMemcpyHtoDAsync",
            g_api.cuMemcpyHtoDAsync(slots + slot * chunk, nextSrc(), chunk,
                                    stream));
      if (confirm_each)
        check("cuEventRecord", g_api.cuEventRecord(evs[slot], stream));
    }
    check("cuStreamSynchronize", g_api.cuStreamSynchronize(stream));
  };

  // warm-up (the first copy sets up the driver's staging), then the burn at
  // the timed loop's depth, both confirmed
  h2dLoop(1, true);
  h2dLoop(burn / chunk, true);

  if (d2h) {
    const size_t nsrc = nbufs < 16 ? nbufs : 16;
    std::vector<CUdeviceptr> srcs(nsrc);
    for (auto& s : srcs) {
      check("d2h stage cuMemAlloc", g_api.cuMemAlloc(&s, chunk));
      check("d2h stage cuMemcpyHtoDAsync",
            g_api.cuMemcpyHtoDAsync(s, nextSrc(), chunk, stream));
    }
    check("d2h stage cuStreamSynchronize", g_api.cuStreamSynchronize(stream));
    const size_t ndst = depth + 1 > 4 ? depth + 1 : 4;
    std::vector<std::vector<uint8_t>> dsts(ndst, std::vector<uint8_t>(chunk));
    const uint64_t nf = total / chunk;
    const auto t0 = std::chrono::steady_clock::now();
    for (uint64_t i = 0; i < nf; i++) {
      const size_t slot = i % depth;
      if (i >= depth)
        check("d2h fetch (cuEventSynchronize)",
              g_api.cuEventSynchronize(evs[slot]));
      check("cuMemcpyDtoHAsync",
            g_api.cuMemcpyDtoHAsync(dsts[i % ndst].data(), srcs[i % nsrc],
                                    chunk, stream));
      check("cuEventRecord", g_api.cuEventRecord(evs[slot], stream));
    }
    check("cuStreamSynchronize", g_api.cuStreamSynchronize(stream));
    const double secs = std::chrono::duration<double>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
    printf(
        "{\"native_d2h_mib_s\": %.1f, \"chunk_mib\": %llu, \"depth\": %zu, "
        "\"nbufs\": %zu}\n",
        ((double)(nf * chunk) / (1 << 20)) / secs,
        (unsigned long long)(chunk >> 20), depth, nsrc);
    for (CUdeviceptr s : srcs) g_api.cuMemFree(s);
  } else {
    const uint64_t n = total / chunk;
    const auto t0 = std::chrono::steady_clock::now();
    h2dLoop(n, confirm);
    const double secs = std::chrono::duration<double>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
    printf(
        "{\"native_h2d_mib_s\": %.1f, \"chunk_mib\": %llu, \"depth\": %zu, "
        "\"nbufs\": %zu, \"confirm_arrival\": %s}\n",
        ((double)(n * chunk) / (1 << 20)) / secs,
        (unsigned long long)(chunk >> 20), depth, nbufs,
        confirm ? "true" : "false");
  }
  for (CUevent ev : evs) g_api.cuEventDestroy(ev);
  g_api.cuMemFree(slots);
  g_api.cuStreamDestroy(stream);
  g_api.cuDevicePrimaryCtxRelease(dev);
  return 0;
}
