// Per-candidate bit extraction + CRC-24 syndromes for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/pallas_kernels.py::extract_syndromes_pallas
// (:579; kernel body _extract_kernel :514).  Contract
// (readsb_tpu_torch/ops/kernels.py::extract_syndromes):
//
//   rows     int32[K,128]  candidate win rows (ops/demod.py::win_rows)
//   offsets  int32[K]      candidate scan offsets
//   out      int32[K,128]  lanes 0:5 syn112, 5:10 syn56, 10:80 message bytes
//                          (phase-major, 14 per phase), 80:83 correlation
//                          bits, 83:128 zero
//
// Bound on the H100: memory.  The function moves 1028 B per candidate
// (a 512 B row and a 4 B offset in, a 512 B row out) against ~5 x 112
// bit picks and XORs.  Design:
//   * a block takes 32 candidates; their rows are staged into shared memory
//     with coalesced loads (row stride 129 words, so the per-candidate
//     column reads below hit distinct banks) and written back the same way;
//   * one warp per phase (5 warps), one lane per candidate: the slicer
//     schedule and the per-bit syndromes are indexed by the loop counter
//     alone, so every lane of a warp reads the same __constant__ word;
//   * the window alignment by offset & 255 is a word rotation (s >> 5) plus
//     a logical funnel shift (s & 31) on uint32;
//   * each syndrome is the XOR of the per-bit syndromes of the set bits
//     (crc.single_bit_syndromes), so no float product is involved.
// K is any size; the last block masks its ragged edge.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCand = 32;     // candidates per block
constexpr int kPhases = 5;    // try_phase 4..8
constexpr int kBits = 112;
constexpr int kLanes = 128;
constexpr int kStride = 129;  // padded shared-memory row stride
constexpr int kPlaneWords = 19;
constexpr int kCorrBase = 95;

__constant__ int32_t c_tap[kPhases * kBits];  // (plane << 9) | sample offset
__constant__ uint32_t c_syn112[kBits];
__constant__ uint32_t c_syn56[56];

__global__ void __launch_bounds__(kCand * kPhases) extract_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ offsets,
    int64_t k, int32_t* __restrict__ out) {
    __shared__ uint32_t in_sh[kCand * kStride];
    __shared__ int32_t out_sh[kCand * kStride];
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCand;
    for (int j = threadIdx.x; j < kCand * kLanes; j += blockDim.x) {
        const int c = j >> 7, l = j & 127;
        const int64_t g = c0 + c;
        in_sh[c * kStride + l] = g < k ? static_cast<uint32_t>(rows[g * kLanes + l]) : 0u;
        out_sh[c * kStride + l] = 0;
    }
    __syncthreads();

    const int ph = threadIdx.x >> 5;  // phase index: warp-uniform
    const int c = threadIdx.x & 31;   // candidate within the block
    const int64_t g = c0 + c;
    const uint32_t s = (g < k ? static_cast<uint32_t>(offsets[g]) : 0u) & 255u;
    const int wrot = static_cast<int>(s >> 5);
    const unsigned sb = s & 31u;
    const uint32_t* r = in_sh + c * kStride;
    int32_t* o = out_sh + c * kStride;

    uint32_t syn112 = 0, syn56 = 0, byte = 0;
    for (int b = 0; b < kBits; ++b) {
        const int tap = c_tap[ph * kBits + b];
        const int q = tap & 511;
        const int wi = (tap >> 9) * kPlaneWords + wrot + (q >> 5);
        const uint32_t word = __funnelshift_r(r[wi], r[wi + 1], sb);
        const uint32_t bit = (word >> (q & 31)) & 1u;
        if (bit) {
            syn112 ^= c_syn112[b];
            if (b < 56) syn56 ^= c_syn56[b];
        }
        byte = (byte << 1) | bit;
        if ((b & 7) == 7) {
            o[10 + ph * 14 + (b >> 3)] = static_cast<int32_t>(byte);
            byte = 0;
        }
    }
    o[ph] = static_cast<int32_t>(syn112);
    o[5 + ph] = static_cast<int32_t>(syn56);
    if (ph < 3) {  // correlation lane ph of the candidate sample
        o[80 + ph] = static_cast<int32_t>((r[kCorrBase + ph * 8 + wrot] >> sb) & 1u);
    }
    __syncthreads();

    for (int j = threadIdx.x; j < kCand * kLanes; j += blockDim.x) {
        const int cc = j >> 7, l = j & 127;
        const int64_t gg = c0 + cc;
        if (gg < k) out[gg * kLanes + l] = out_sh[cc * kStride + l];
    }
}

}  // namespace

extern "C" const char* rtpu_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Host pointers: tap int32[560], syn112 uint32[112], syn56 uint32[56]
// (readsb_tpu_torch/ops/kernels.py::extract_tables_np).  Call once per process.
extern "C" int extract_syndromes_set_tables(const void* tap, const void* syn112,
                                            const void* syn56) {
    cudaError_t e = cudaMemcpyToSymbol(c_tap, tap, sizeof(int32_t) * kPhases * kBits);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_syn112, syn112, sizeof(uint32_t) * kBits);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_syn56, syn56, sizeof(uint32_t) * 56);
    return static_cast<int>(e);
}

extern "C" int extract_syndromes(const void* rows, const void* offsets, long long k,
                                 void* out, void* stream) {
    const unsigned grid = static_cast<unsigned>((k + kCand - 1) / kCand);
    extract_kernel<<<grid, kCand * kPhases, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(offsets),
        static_cast<int64_t>(k), static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
