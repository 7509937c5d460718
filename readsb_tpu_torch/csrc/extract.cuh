// Per-candidate bit extraction + CRC-24 syndromes for Hopper (sm_90a):
// the code shared by the kernels that slice candidates.
//
// The TPU kernels extract_syndromes_pallas, extract_classify_v3_pallas,
// extract_classify_pallas and fused_demod_tiles (readsb_tpu/ops/
// pallas_kernels.py :579, :847, :928 and readsb_tpu/ops/fused.py :304)
// share one function (_extract_kernel :514).  Here one datapath serves all
// four: a lane per candidate aligns the 45 window words that the taps reach
// (align_window) and slices its five phases with the tap schedule fixed at
// compile time (extract_taps.cuh) and syndromes by bytes (slice_all).
// cand_rows is the block kernel of gathered win rows (extract_syndromes.cu,
// extract_classify_v3.cu, extract_classify.cu); fused_demod.cu aligns its
// windows from plane words in shared memory.  A syndrome is the XOR of the
// syndromes of the message's bytes (crc.single_bit_syndromes, grouped by
// byte), so no float product is involved.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "extract_taps.cuh"
#include "runtime.cuh"

namespace extract {

constexpr int kPhases = 5;  // try_phase 4..8
constexpr int kLanes = 128;      // lanes of an output row
constexpr int kUsedLanes = 83;   // 0:5 syn112, 5:10 syn56, 10:80 bytes, 80:83 corr
constexpr int kMsgBase = 10;
constexpr int kMsgBytes = 14;
constexpr int kCorrLane = 80;
constexpr int kPlanes = 5;        // slicer sign planes
constexpr int kWinPlaneWords = 19;  // words per plane in a win row (ops/demod.py::win_rows)
constexpr int kWinCorrBase = 95;    // first correlation-bitplane word of a win row

// syn_bytes[pos][byte]: the syndrome of a 112-bit message that holds `byte`
// at byte `pos` and zeros elsewhere (global memory; cand_rows stages it)
__device__ uint32_t g_syn_bytes[kMsgBytes * 256];

// What the gate's classification needs of one (candidate, phase).
struct Phase {
    uint32_t syn112, syn56;
    uint32_t byte0;   // first message byte: df = byte0 >> 3
    uint32_t low7;    // OR of message bytes 0..6 (0 <=> all zero)
};

// Host pointer: syn_bytes uint32[14, 256] (readsb_tpu_torch/ops/kernels.py::
// syndrome_bytes_np).  Call once per process and library, before the first
// launch.
inline int set_tables(const void* syn_bytes) {
    return static_cast<int>(
        cudaMemcpyToSymbol(g_syn_bytes, syn_bytes, sizeof(uint32_t) * kMsgBytes * 256));
}


// ---------------------------------------------------------------------------
// The lane-per-candidate datapath.

constexpr int kWinWords = 9;  // aligned window words per plane the taps reach

template <int P, int B>
struct Tap {
    static constexpr int tap = kTaps[P][B];
    static constexpr int word = (tap >> 9) * kWinWords + ((tap & 511) >> 5);
    static constexpr int shift = tap & 31;
    static_assert(((tap & 511) >> 5) < kWinWords, "a tap past the aligned window");
};

using Window = uint32_t[kPlanes * kWinWords];

// w[p * 9 + j] = the 32 sign bits of plane p at samples [32 j, 32 j + 32)
// past the candidate (bit i = sample i), from the unaligned plane words
// src[p * stride + j], j = 0..9, that hold the candidate at bit sb.
__device__ __forceinline__ void align_window(Window& w, const uint32_t* src, int stride,
                                             unsigned sb) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
        const uint32_t* q = src + p * stride;
        uint32_t lo = q[0];
#pragma unroll
        for (int j = 0; j < kWinWords; ++j) {
            const uint32_t hi = q[j + 1];
            w[p * kWinWords + j] = __funnelshift_r(lo, hi, sb);
            lo = hi;
        }
    }
}

// Bit B of phase P, at its place in its message byte (MSB first).
template <int P, int B>
__device__ __forceinline__ uint32_t pick(const Window& w) {
    constexpr int s = Tap<P, B>::shift, k = 7 - (B & 7);
    const uint32_t x = w[Tap<P, B>::word];
    if constexpr (s >= k) {
        return (x >> (s - k)) & (1u << k);
    } else {
        return (x << (k - s)) & (1u << k);
    }
}

template <int P, int I, int... J>
__device__ __forceinline__ uint32_t byte_of(const Window& w, std::integer_sequence<int, J...>) {
    return (pick<P, 8 * I + J>(w) | ...);
}

template <int P, int... I>
__device__ __forceinline__ void bytes_of(const Window& w, uint32_t (&b)[kMsgBytes],
                                         std::integer_sequence<int, I...>) {
    ((b[I] = byte_of<P, I>(w, std::make_integer_sequence<int, 8>{})), ...);
}

// Phase P of one candidate: lanes P, 5 + P and 10 + 14 P .. 23 + 14 P of
// its output row `o` (tbl: the byte-syndrome table, shared or global).
template <int P>
__device__ __forceinline__ Phase slice(const Window& w, const uint32_t* tbl, int32_t* o) {
    uint32_t b[kMsgBytes];
    bytes_of<P>(w, b, std::make_integer_sequence<int, kMsgBytes>{});
    Phase r{0u, 0u, b[0], 0u};
#pragma unroll
    for (int i = 0; i < kMsgBytes; ++i) {
        r.syn112 ^= tbl[i * 256 + b[i]];
        o[kMsgBase + P * kMsgBytes + i] = static_cast<int32_t>(b[i]);
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        r.syn56 ^= tbl[(i + 7) * 256 + b[i]];
        r.low7 |= b[i];
    }
    o[P] = static_cast<int32_t>(r.syn112);
    o[kPhases + P] = static_cast<int32_t>(r.syn56);
    return r;
}

// Lanes 0:80 of one candidate's output row; corr (bit c = correlation c
// fired at the candidate) fills lanes 80:83.
__device__ __forceinline__ void slice_all(const Window& w, uint32_t corr, const uint32_t* tbl,
                                          int32_t* o, Phase (&r)[kPhases]) {
    r[0] = slice<0>(w, tbl, o);
    r[1] = slice<1>(w, tbl, o);
    r[2] = slice<2>(w, tbl, o);
    r[3] = slice<3>(w, tbl, o);
    r[4] = slice<4>(w, tbl, o);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[kCorrLane + c] = static_cast<int32_t>((corr >> c) & 1u);
}


// ---------------------------------------------------------------------------
// cand_rows: the kernel of gathered win rows (extract_syndromes.cu,
// extract_classify_v3.cu, extract_classify.cu).
//
// Bound on the H100: memory, 1028 B per candidate.  Design:
//   * one lane per candidate, all five phases; a warp takes 32 candidates
//     at a time, blocks of kWarps warps stride over the groups (two blocks
//     per SM), so the 14 KB byte-syndrome table is staged in shared memory
//     once per block, and so are the post step's tables where they fit
//     (Post::stage);
//   * the warp stages its 32 rows, 16-byte coalesced loads (one row per
//     step), into slots of 31 chunks: an odd chunk stride, so the lanes'
//     16-byte accesses to their own rows hit distinct banks; the 32 bytes
//     past lane 119 are never read;
//   * a lane aligns the 9 window words per plane that the taps reach
//     (45 words, __funnelshift_r) into registers once;
//   * every bit pick is a shift and a mask by immediates: the tap schedule
//     is a template argument (extract_taps.cuh), one instantiation per
//     phase, so no register array is indexed at run time;
//   * syn112 is the XOR of 14 byte-table entries and syn56 of 7: the byte
//     at position i of a 56-bit message lies as far from its end as byte
//     i + 7 of a 112-bit one, so both use the same table;
//   * the output row is written into the lane's slot, and leaves with
//     16-byte stores, one row per step; the chunks past the used lanes are
//     written as zeros straight from registers.
// `post(phases, o)` runs once per candidate after its five slices and may
// write lanes of the output row up to Post::kLanes.

constexpr int kWarps = 6;             // warps per block
constexpr int kRowChunks = 30;        // 16-byte chunks of a win row that are read
constexpr int kSlotChunks = 31;       // staged row stride: odd
constexpr size_t kRowsShared =
    sizeof(uint32_t) * kMsgBytes * 256 + sizeof(uint4) * kWarps * 32 * kSlotChunks;

struct NoPost {
    static constexpr int kLanes = kUsedLanes;
    static constexpr size_t kSharedMax = 0;
    size_t shared_bytes() const { return 0; }
    __device__ __forceinline__ NoPost stage(uint4*) const { return *this; }
    __device__ __forceinline__ void operator()(const Phase (&)[kPhases], int32_t*) const {}
};

template <class Post>
__global__ void __launch_bounds__(kWarps * 32, 2) cand_rows(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ offsets, int64_t k,
    int32_t* __restrict__ out, const Post post_args) {
    extern __shared__ uint4 smem[];
    constexpr int kTableChunks = kMsgBytes * 256 / 4;
    constexpr int kOutChunks = (Post::kLanes + 3) / 4;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t* tbl = reinterpret_cast<const uint32_t*>(smem);
    uint4* slots = smem + kTableChunks + warp * 32 * kSlotChunks;  // this warp's 32 rows
    for (int i = threadIdx.x; i < kTableChunks; i += blockDim.x)
        smem[i] = reinterpret_cast<const uint4*>(g_syn_bytes)[i];
    const Post post = post_args.stage(smem + kTableChunks + kWarps * 32 * kSlotChunks);
    __syncthreads();

    const uint4* rows4 = reinterpret_cast<const uint4*>(rows);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int64_t groups = (k + 31) / 32;
    for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + warp; g < groups;
         g += static_cast<int64_t>(gridDim.x) * kWarps) {
        const int64_t c0 = g * 32;
        if (lane < kRowChunks) {
#pragma unroll 8
            for (int r = 0; r < 32; ++r)
                slots[r * kSlotChunks + lane] = c0 + r < k ? __ldg(rows4 + (c0 + r) * 32 + lane) : zero;
        }
        const uint32_t off = c0 + lane < k ? static_cast<uint32_t>(__ldg(offsets + c0 + lane)) : 0u;
        __syncwarp();

        // this lane's candidate, aligned by offset & 255
        const uint32_t* row = reinterpret_cast<const uint32_t*>(slots + lane * kSlotChunks);
        const int wrot = static_cast<int>((off & 255u) >> 5);
        const unsigned sb = off & 31u;
        Window w;
        align_window(w, row + wrot, kWinPlaneWords, sb);
        uint32_t corr = 0u;
#pragma unroll
        for (int c = 0; c < 3; ++c) corr |= ((row[kWinCorrBase + c * 8 + wrot] >> sb) & 1u) << c;
        __syncwarp();  // every row is read: the slots take the output rows

        int32_t* o = reinterpret_cast<int32_t*>(slots + lane * kSlotChunks);
        Phase ph[kPhases];
        slice_all(w, corr, tbl, o, ph);
        post(ph, o);
#pragma unroll
        for (int l = Post::kLanes; l < 4 * kOutChunks; ++l) o[l] = 0;
        __syncwarp();

#pragma unroll 8
        for (int r = 0; r < 32; ++r) {
            if (c0 + r < k)
                out4[(c0 + r) * 32 + lane] = lane < kOutChunks ? slots[r * kSlotChunks + lane] : zero;
        }
        __syncwarp();  // the slots are read before the next group is staged
    }
}

inline int g_sms = 0;  // SMs of the library's device (prepare)

// Once per library, on its device: the SM count and cand_rows' shared
// memory above 48 KB.
template <class Post>
cudaError_t prepare(int device) {
    cudaError_t e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(cand_rows<Post>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kRowsShared + Post::kSharedMax));
    return e;
}

// The launch on one stream, after prepare<Post>.  Returns the first CUDA error.
template <class Post>
int launch_rows(const void* rows, const void* offsets, long long k, void* out,
                const Post& post, void* stream) {
    const long long blocks = (k + 32 * kWarps - 1) / (32 * kWarps);
    const long long most = 2LL * g_sms;
    cand_rows<Post><<<static_cast<unsigned>(blocks < most ? blocks : most), kWarps * 32,
                      kRowsShared + post.shared_bytes(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(offsets),
        static_cast<int64_t>(k), static_cast<int32_t*>(out), post);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace extract
