// The current device's properties that the launches size their grids by,
// asked of the runtime once a device and cached.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace {

//: devices whose properties are cached
constexpr int kMaxDevices = 64;

// value(dev) for the current device (at least 1), computed at its first
// call on that device and kept in cache[kMaxDevices] (0: not yet).
template <class F>
int cached_per_device(int* cache, F value) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cache[dev]) return cache[dev];
  const int v = std::max(value(dev), 1);
  if (dev < kMaxDevices) cache[dev] = v;
  return v;
}

// SMs of the current device.
inline int sm_count() {
  static int cache[kMaxDevices] = {};
  return cached_per_device(cache, [](int dev) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  });
}

}  // namespace
