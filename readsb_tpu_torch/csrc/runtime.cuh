// What every kernel library exports beside its entry point: the text of a
// CUDA error code, for the Python wrapper's exception, and rtpu_init.
//
// A library is made ready once per device: readsb_tpu_torch/ops/kernels.py
// calls its rtpu_init and table setters with that device current, the first
// time a tensor on it reaches the library, and launches with the tensor's
// device current.  Tables (__device__ symbols) and function attributes are
// per device in CUDA; a host value that prepare fills is kept per device.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* rtpu_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace rtpu {

// *device = the current device, then prepare(*device): function attributes,
// the SM count, occupancy checks.  Returns the first CUDA error.
template <class Prepare>
int init(int* device, Prepare prepare) {
    cudaError_t e = cudaGetDevice(device);
    if (e == cudaSuccess) e = prepare(*device);
    return static_cast<int>(e);
}

}  // namespace rtpu
