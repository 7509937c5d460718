// What every kernel library exports beside its entry point: the text of a
// CUDA error code, for the Python wrapper's exception, and rtpu_init.
//
// A library's tables and function attributes belong to the device that was
// current when it was loaded: each library's rtpu_init reports that device
// (readsb_tpu_torch/ops/kernels.py records it and refuses tensors on any
// other) and does, once, what its launches need of it.

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
