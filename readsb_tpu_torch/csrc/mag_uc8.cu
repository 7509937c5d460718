// UC8 words -> uint16 magnitudes for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/pallas_kernels.py::mag_uc8_pallas (:999; kernel
// body _uc8_kernel :88).  Contract (readsb_tpu_torch/ops/kernels.py):
//
//   words  uint16[n]  one interleaved uc8 I/Q pair per sample (I low byte)
//   out    uint16[n]  magnitudes, equal to the 64k LUT on every pair; any n
//
// Bound on the H100: memory, 4 B per sample (2 in, 2 out) against ~8
// operations.  Design: a fused elementwise pass; each thread converts 8
// samples from one 16-byte load and writes one 16-byte store, grid-stride,
// with few enough blocks that the 256-entry fi^2 table (built per block in
// shared memory, uc8_mag.cuh) is amortised.  The expression is evaluated
// with round-to-nearest intrinsics, and the card's sqrt is correctly
// rounded, so the TPU kernel's _cr_sqrt correction (:58) has no
// counterpart here.  A ragged tail, or buffers that are not 16-byte
// aligned, take the scalar loop.

#include "uc8_mag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of the 132 SMs

__device__ __forceinline__ uint32_t mag_pair(uint32_t two_words, const float* sq) {
    return uc8_mag(two_words & 0xffffu, sq) | (uc8_mag(two_words >> 16, sq) << 16);
}

__global__ void __launch_bounds__(kThreads) mag_uc8_kernel(
    const uint16_t* __restrict__ words, uint16_t* __restrict__ out, int64_t n, int64_t nvec) {
    __shared__ float sq[256];
    load_sq_table(sq);
    __syncthreads();
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const uint4* in4 = reinterpret_cast<const uint4*>(words);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (int64_t g = tid; g < nvec; g += stride) {
        const uint4 v = in4[g];
        uint4 r;
        r.x = mag_pair(v.x, sq);
        r.y = mag_pair(v.y, sq);
        r.z = mag_pair(v.z, sq);
        r.w = mag_pair(v.w, sq);
        out4[g] = r;
    }
    for (int64_t i = nvec * 8 + tid; i < n; i += stride) {
        out[i] = static_cast<uint16_t>(uc8_mag(words[i], sq));
    }
}

}  // namespace

extern "C" int rtpu_init(int* device) {
    return rtpu::init(device, [](int) { return cudaSuccess; });
}

// Any n >= 1.  Returns cudaGetLastError().
extern "C" int mag_uc8(const void* words, long long n, void* out, void* stream) {
    const bool aligned =
        (reinterpret_cast<uintptr_t>(words) % 16 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const int64_t nvec = aligned ? n / 8 : 0;
    const int64_t work = nvec > 0 ? nvec : n;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    mag_uc8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(words), static_cast<uint16_t*>(out), n, nvec);
    return static_cast<int>(cudaGetLastError());
}
