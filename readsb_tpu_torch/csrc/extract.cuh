// Per-(candidate, phase) bit extraction + CRC-24 syndromes for Hopper
// (sm_90a): the loop shared by the kernels that slice candidates.
//
// The TPU kernels extract_syndromes_pallas, extract_classify_v3_pallas and
// fused_demod_tiles (readsb_tpu/ops/pallas_kernels.py :579, :847 and
// readsb_tpu/ops/fused.py :304) share one extraction datapath (_extract_kernel
// :514); so do extract_syndromes.cu, extract_classify_v3.cu and
// fused_demod.cu, which differ only in where a candidate's aligned window
// words come from:
//
//   Fetch::word(plane, j)  the 32 sign bits of slicer plane `plane` at samples
//                          [offset + 32 j, offset + 32 j + 32), bit i = sample i
//
// One thread walks the 112 bits of one phase: the tap schedule and the
// per-bit syndromes are indexed by the loop counter alone, so every lane
// of a warp that works on one phase reads the same __constant__ word.
// Each syndrome is the XOR of the per-bit syndromes of the set bits
// (crc.single_bit_syndromes), so no float product is involved.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace extract {

constexpr int kPhases = 5;  // try_phase 4..8
constexpr int kBits = 112;
constexpr int kLanes = 128;      // lanes of an output row
constexpr int kUsedLanes = 83;   // 0:5 syn112, 5:10 syn56, 10:80 bytes, 80:83 corr
constexpr int kMsgBase = 10;
constexpr int kMsgBytes = 14;
constexpr int kCorrLane = 80;

__constant__ int32_t c_tap[kPhases * kBits];  // (plane << 9) | sample offset
__constant__ uint32_t c_syn112[kBits];
__constant__ uint32_t c_syn56[56];

// What the gate's classification needs of one (candidate, phase).
struct Phase {
    uint32_t syn112, syn56;
    uint32_t byte0;   // first message byte: df = byte0 >> 3
    uint32_t low7;    // OR of message bytes 0..6 (0 <=> all zero)
};

// Slice phase `ph` of one candidate.  Writes lanes ph (syn112), 5 + ph
// (syn56) and 10 + 14 ph .. 10 + 14 ph + 13 (message bytes) of the
// candidate's output row `o`, and returns what classification reads.
template <class Fetch>
__device__ __forceinline__ Phase phase(int ph, const Fetch& fetch, int32_t* o) {
    Phase r{0u, 0u, 0u, 0u};
    uint32_t byte = 0;
    for (int b = 0; b < kBits; ++b) {
        const int tap = c_tap[ph * kBits + b];
        const int q = tap & 511;
        const uint32_t bit = (fetch.word(tap >> 9, q >> 5) >> (q & 31)) & 1u;
        if (bit) {
            r.syn112 ^= c_syn112[b];
            if (b < 56) r.syn56 ^= c_syn56[b];
        }
        byte = (byte << 1) | bit;
        if ((b & 7) == 7) {
            o[kMsgBase + ph * kMsgBytes + (b >> 3)] = static_cast<int32_t>(byte);
            if (b == 7) r.byte0 = byte;
            if (b < 56) r.low7 |= byte;
            byte = 0;
        }
    }
    o[ph] = static_cast<int32_t>(r.syn112);
    o[kPhases + ph] = static_cast<int32_t>(r.syn56);
    return r;
}

// Host pointers: tap int32[560], syn112 uint32[112], syn56 uint32[56]
// (readsb_tpu_torch/ops/kernels.py::extract_tables_np).  Call once per
// process and library, before the first launch.
inline int set_tables(const void* tap, const void* syn112, const void* syn56) {
    cudaError_t e = cudaMemcpyToSymbol(c_tap, tap, sizeof(int32_t) * kPhases * kBits);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_syn112, syn112, sizeof(uint32_t) * kBits);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_syn56, syn56, sizeof(uint32_t) * 56);
    return static_cast<int>(e);
}

// A candidate's window inside its win row (ops/demod.py::win_rows) staged
// in shared memory: five planes x 19 words from lane 0, three correlation
// bitplanes x 8 words from lane 95; aligned by offset & 255.
struct WinRowFetch {
    static constexpr int kPlaneWords = 19;
    static constexpr int kCorrBase = 95;
    const uint32_t* r;  // the candidate's row
    int wrot;           // (offset & 255) >> 5
    unsigned sb;        // offset & 31

    __device__ __forceinline__ WinRowFetch(const uint32_t* row, uint32_t offset)
        : r(row), wrot(static_cast<int>((offset & 255u) >> 5)), sb(offset & 31u) {}

    __device__ __forceinline__ uint32_t word(int plane, int j) const {
        const int wi = plane * kPlaneWords + wrot + j;
        return __funnelshift_r(r[wi], r[wi + 1], sb);
    }
    // correlation lane c (A, B, C) at the candidate sample
    __device__ __forceinline__ int32_t corr(int c) const {
        return static_cast<int32_t>((r[kCorrBase + c * 8 + wrot] >> sb) & 1u);
    }
};

// The block shape of the kernels that slice gathered win rows
// (extract_syndromes.cu, extract_classify_v3.cu): a block takes 32
// candidates; their rows are staged into shared memory with coalesced
// loads (row stride 129 words, so the per-candidate column reads hit
// distinct banks) and written back the same way; one warp per phase
// (5 warps), one lane per candidate.  `post(ph, phase, o)` runs once per
// (candidate, phase) after the slice and may write further lanes of the
// candidate's output row.  K is any size; the last block masks its
// ragged edge.
constexpr int kCand = 32;     // candidates per block
constexpr int kStride = 129;  // padded shared-memory row stride

struct NoPost {
    __device__ __forceinline__ void operator()(int, const Phase&, int32_t*) const {}
};

template <class Post>
__global__ void __launch_bounds__(kCand * kPhases) rows_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ offsets,
    int64_t k, int32_t* __restrict__ out, Post post) {
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
    const WinRowFetch fetch(in_sh + c * kStride,
                            g < k ? static_cast<uint32_t>(offsets[g]) : 0u);
    int32_t* o = out_sh + c * kStride;
    const Phase r = phase(ph, fetch, o);
    if (ph < 3) o[kCorrLane + ph] = fetch.corr(ph);
    post(ph, r, o);
    __syncthreads();

    for (int j = threadIdx.x; j < kCand * kLanes; j += blockDim.x) {
        const int cc = j >> 7, l = j & 127;
        const int64_t gg = c0 + cc;
        if (gg < k) out[gg * kLanes + l] = out_sh[cc * kStride + l];
    }
}

template <class Post>
int launch_rows(const void* rows, const void* offsets, long long k, void* out,
                const Post& post, void* stream) {
    const unsigned grid = static_cast<unsigned>((k + kCand - 1) / kCand);
    rows_kernel<Post><<<grid, kCand * kPhases, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(offsets),
        static_cast<int64_t>(k), static_cast<int32_t*>(out), post);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace extract
