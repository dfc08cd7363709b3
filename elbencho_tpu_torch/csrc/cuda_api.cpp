/* Driver-library loader for the native CUDA transfer engine: the function
 * table of cuda_api.h, resolved by dlsym. See cuda_api.h. */
#include "cuda_api.h"

#include <dlfcn.h>

namespace ebt {
namespace cu {

bool loadApi(const std::string& path, Api* api, std::string* err) {
  void* dl = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!dl) {
    *err = "dlopen " + path + " failed: " + dlerror();
    return false;
  }
  // every entry is required: the engine calls each of them on its paths,
  // and a null slot would only crash later, far from the cause
  const struct {
    const char* name;
    void** slot;
  } entries[] = {
      {"cuGetErrorString", (void**)&api->cuGetErrorString},
      {"cuInit", (void**)&api->cuInit},
      {"cuDeviceGetCount", (void**)&api->cuDeviceGetCount},
      {"cuDeviceGet", (void**)&api->cuDeviceGet},
      {"cuDeviceGetAttribute", (void**)&api->cuDeviceGetAttribute},
      {"cuDevicePrimaryCtxRetain", (void**)&api->cuDevicePrimaryCtxRetain},
      {"cuDevicePrimaryCtxRelease_v2",
       (void**)&api->cuDevicePrimaryCtxRelease},
      {"cuCtxSetCurrent", (void**)&api->cuCtxSetCurrent},
      {"cuStreamCreate", (void**)&api->cuStreamCreate},
      {"cuStreamDestroy_v2", (void**)&api->cuStreamDestroy},
      {"cuStreamSynchronize", (void**)&api->cuStreamSynchronize},
      {"cuStreamQuery", (void**)&api->cuStreamQuery},
      {"cuEventCreate", (void**)&api->cuEventCreate},
      {"cuEventDestroy_v2", (void**)&api->cuEventDestroy},
      {"cuEventRecord", (void**)&api->cuEventRecord},
      {"cuEventSynchronize", (void**)&api->cuEventSynchronize},
      {"cuLaunchHostFunc", (void**)&api->cuLaunchHostFunc},
      {"cuMemAlloc_v2", (void**)&api->cuMemAlloc},
      {"cuMemFree_v2", (void**)&api->cuMemFree},
      {"cuMemcpyHtoDAsync_v2", (void**)&api->cuMemcpyHtoDAsync},
      {"cuMemcpyDtoHAsync_v2", (void**)&api->cuMemcpyDtoHAsync},
      {"cuMemsetD8Async", (void**)&api->cuMemsetD8Async},
      {"cuMemHostRegister_v2", (void**)&api->cuMemHostRegister},
      {"cuMemHostUnregister", (void**)&api->cuMemHostUnregister},
      {"cuMemHostAlloc", (void**)&api->cuMemHostAlloc},
      {"cuMemFreeHost", (void**)&api->cuMemFreeHost},
  };
  for (const auto& e : entries) {
    *e.slot = dlsym(dl, e.name);
    if (!*e.slot) {
      *err = "CUDA driver " + path + " is missing required API function " +
             e.name;
      return false;
    }
  }
  const struct {
    const char* name;
    void** slot;
  } d2d_entries[] = {
      {"cuMemcpyPeerAsync", (void**)&api->cuMemcpyPeerAsync},
      {"cuMemcpyDtoDAsync_v2", (void**)&api->cuMemcpyDtoDAsync},
      {"cuDeviceCanAccessPeer", (void**)&api->cuDeviceCanAccessPeer},
      {"cuCtxEnablePeerAccess", (void**)&api->cuCtxEnablePeerAccess},
  };
  api->d2d = true;
  for (const auto& e : d2d_entries) {
    *e.slot = dlsym(dl, e.name);
    if (!*e.slot) api->d2d = false;
  }
  const struct {
    const char* name;
    void** slot;
  } pool_entries[] = {
      {"cuMemAllocAsync", (void**)&api->cuMemAllocAsync},
      {"cuMemFreeAsync", (void**)&api->cuMemFreeAsync},
      {"cuDeviceGetDefaultMemPool", (void**)&api->cuDeviceGetDefaultMemPool},
      {"cuMemPoolSetAttribute", (void**)&api->cuMemPoolSetAttribute},
      {"cuMemPoolTrimTo", (void**)&api->cuMemPoolTrimTo},
  };
  api->mempool = true;
  for (const auto& e : pool_entries) {
    *e.slot = dlsym(dl, e.name);
    if (!*e.slot) api->mempool = false;
  }
  return true;
}

std::string errorText(const Api& api, const char* what, CUresult rc) {
  const char* msg = nullptr;
  if (api.cuGetErrorString) api.cuGetErrorString(rc, &msg);
  return std::string(what) + ": CUDA error " + std::to_string(rc) +
         (msg ? std::string(" (") + msg + ")" : std::string());
}

bool loadKernel(const std::string& path, const char* name, void** fn,
                std::string* err) {
  void* dl = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!dl) {
    *err = "dlopen " + path + " failed: " + dlerror();
    return false;
  }
  *fn = dlsym(dl, name);
  if (!*fn) {
    *err = "kernel library " + path + " is missing " + name;
    return false;
  }
  return true;
}

}  // namespace cu
}  // namespace ebt
