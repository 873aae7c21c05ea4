// What the launchers need to know of the card they launch on, looked up
// once per device.

#pragma once

#include <cuda_runtime.h>

namespace nerfacc {

constexpr int kMaxDevices = 64;

// The current device and its number of streaming multiprocessors. The
// count is cached per device; a race between two first calls stores the
// same value twice.
inline cudaError_t current_device_sms(int* device, int* sms) {
  static int cached[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[*device] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *device);
    if (err != cudaSuccess) return err;
    cached[*device] = n;
  }
  *sms = cached[*device];
  return cudaSuccess;
}

}  // namespace nerfacc
