// Per-candidate extraction + gate classification for Hopper (sm_90a), by
// the plan-order datapath: one warp per candidate.
//
// Replaces readsb_tpu/ops/pallas_kernels.py::extract_classify_pallas
// (:928; kernel body _extract_kernel_v2 :710, plan
// readsb_tpu/ops/demod.py::_extract_plan :173).  Contract
// (readsb_tpu_torch/ops/kernels.py::extract_classify): the inputs and the
// int32[K,128] output of extract_classify_v3.cu, bit for bit, plus
//
//   plan  int32[576]  the 560 emission lanes of _extract_plan in plan
//                     order, one word each: aligned window word (6 bits) |
//                     bit shift << 6 | message bit << 11 | phase << 18;
//                     16 padding words with phase 7
//
// The two TPU kernels compute one function by two datapaths (v3: unpack
// every window bit, one product; this one: 560 static (word, shift) picks
// in plan order).  On this card the two differ in how the work is cut:
// extract_classify_v3.cu gives a candidate to a lane and a phase to a
// warp; this kernel gives a candidate to a warp.
//
// Bound on the H100: memory, 1028 B per candidate.  Design:
//   * the warp reads its 512 B row coalesced, 4 words per lane, and keeps
//     it in registers: no staging of the input in shared memory;
//   * the window is aligned by offset & 255 with shuffles (word rotation)
//     and __funnelshift_r (bit shift): lane a holds aligned words a and
//     32 + a of the 55;
//   * the 560 emission lanes are walked 32 at a time (18 rounds): one
//     shuffle pair fetches the lane's word, the shift picks its bit;
//   * a set bit XORs its per-bit syndromes into the lane's accumulator of
//     its phase and ORs its weight into the message byte in a per-warp
//     output row in shared memory; __reduce_xor_sync folds the
//     accumulators across the warp;
//   * lanes 0..4 classify one phase each (classify.cuh), and the row is
//     written back coalesced;
//   * warps stride over the candidates, so the plan and the per-bit
//     syndromes are loaded into shared memory once per block.

#include "classify.cuh"
#include "extract.cuh"

namespace {

constexpr int kWarps = 8;        // candidates in flight per block
constexpr int kPlanWords = 576;  // 18 rounds x 32 lanes
constexpr int kRounds = kPlanWords / 32;
constexpr int kMaxBlocks = 132 * 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32) warp_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ offsets, int64_t k,
    const int32_t* __restrict__ plan, classify::Tables tables, int32_t* __restrict__ out) {
    __shared__ int32_t plan_sh[kPlanWords];
    __shared__ uint32_t syn112_sh[extract::kBits];
    __shared__ uint32_t syn56_sh[56];
    __shared__ int32_t out_sh[kWarps][extract::kLanes];
    for (int j = threadIdx.x; j < kPlanWords; j += blockDim.x) plan_sh[j] = plan[j];
    for (int j = threadIdx.x; j < extract::kBits; j += blockDim.x) {
        syn112_sh[j] = extract::c_syn112[j];
        if (j < 56) syn56_sh[j] = extract::c_syn56[j];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t* o = out_sh[warp];
    for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + warp; g < k;
         g += static_cast<int64_t>(gridDim.x) * kWarps) {
        const int32_t* row = rows + g * extract::kLanes;
        const uint32_t v0 = static_cast<uint32_t>(row[lane]);
        const uint32_t v1 = static_cast<uint32_t>(row[32 + lane]);
        const uint32_t v2 = static_cast<uint32_t>(row[64 + lane]);
        const uint32_t v3 = static_cast<uint32_t>(row[96 + lane]);
        const uint32_t s = static_cast<uint32_t>(offsets[g]) & 255u;
        const int wrot = static_cast<int>(s >> 5);
        const unsigned sb = s & 31u;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[lane + 32 * i] = 0;

        // word idx of the row, idx chosen per lane; every lane takes part
        auto row_word = [&](int idx) {
            const int src = idx & 31, reg = idx >> 5;
            const uint32_t a = __shfl_sync(kFull, v0, src), b = __shfl_sync(kFull, v1, src);
            const uint32_t c = __shfl_sync(kFull, v2, src), d = __shfl_sync(kFull, v3, src);
            return reg == 0 ? a : reg == 1 ? b : reg == 2 ? c : d;
        };
        // aligned window word a = plane * 11 + j of the 55
        auto aligned = [&](int a) {
            const int p = a / 11;
            const int i = p * extract::kWinPlaneWords + wrot + (a - p * 11);
            const uint32_t lo = row_word(i), hi = row_word(i + 1);
            return __funnelshift_r(lo, hi, sb);
        };
        const uint32_t sw0 = aligned(lane);
        const uint32_t sw1 = aligned(lane + 32 < 55 ? lane + 32 : 54);
        __syncwarp();

        uint32_t acc112[extract::kPhases] = {0u, 0u, 0u, 0u, 0u};
        uint32_t acc56[extract::kPhases] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll 2
        for (int rd = 0; rd < kRounds; ++rd) {
            const int ent = plan_sh[rd * 32 + lane];
            const int w = ent & 63, sh = (ent >> 6) & 31, b = (ent >> 11) & 127, p = ent >> 18;
            const uint32_t x0 = __shfl_sync(kFull, sw0, w & 31);
            const uint32_t x1 = __shfl_sync(kFull, sw1, w & 31);
            const uint32_t bit = ((w < 32 ? x0 : x1) >> sh) & 1u;
            if (bit && p < extract::kPhases) {
                const uint32_t s112 = syn112_sh[b];
                const uint32_t s56 = b < 56 ? syn56_sh[b] : 0u;
#pragma unroll
                for (int q = 0; q < extract::kPhases; ++q) {
                    if (p == q) {
                        acc112[q] ^= s112;
                        acc56[q] ^= s56;
                    }
                }
                atomicOr(o + extract::kMsgBase + p * extract::kMsgBytes + (b >> 3), 128 >> (b & 7));
            }
        }
#pragma unroll
        for (int q = 0; q < extract::kPhases; ++q) {
            acc112[q] = __reduce_xor_sync(kFull, acc112[q]);
            acc56[q] = __reduce_xor_sync(kFull, acc56[q]);
        }
        uint32_t corr[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
            corr[c] = (row_word(extract::kWinCorrBase + c * 8 + wrot) >> sb) & 1u;
        __syncwarp();  // the message bytes are complete

        if (lane < extract::kPhases) {
            extract::Phase r{0u, 0u, 0u, 0u};
#pragma unroll
            for (int q = 0; q < extract::kPhases; ++q) {
                if (lane == q) {
                    r.syn112 = acc112[q];
                    r.syn56 = acc56[q];
                }
            }
            const int32_t* m = o + extract::kMsgBase + lane * extract::kMsgBytes;
            r.byte0 = static_cast<uint32_t>(m[0]);
#pragma unroll
            for (int i = 0; i < 7; ++i) r.low7 |= static_cast<uint32_t>(m[i]);
            o[lane] = static_cast<int32_t>(r.syn112);
            o[extract::kPhases + lane] = static_cast<int32_t>(r.syn56);
            o[classify::kFlagLane + lane] = classify::flags(tables, r);
        } else if (lane < extract::kPhases + 3) {
            const int c = lane - extract::kPhases;
            o[extract::kCorrLane + c] =
                static_cast<int32_t>(c == 0 ? corr[0] : c == 1 ? corr[1] : corr[2]);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i)
            out[g * extract::kLanes + lane + 32 * i] = o[lane + 32 * i];
        __syncwarp();
    }
}

}  // namespace

extern "C" const char* rtpu_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int rtpu_extract_set_tables(const void* tap, const void* syn112,
                                       const void* syn56, const void* syn_bytes) {
    return extract::set_tables(tap, syn112, syn56, syn_bytes);
}

extern "C" int extract_classify(const void* rows, const void* offsets, long long k,
                                const void* known, int n_known,
                                const void* t112, int n112,
                                const void* t56, int n56, const void* dfd,
                                const void* plan, void* out, void* stream) {
    const classify::Tables tables{
        static_cast<const int32_t*>(known), n_known,
        static_cast<const int32_t*>(t112), n112,
        static_cast<const int32_t*>(t56), n56,
        static_cast<const int32_t*>(dfd),
    };
    const long long want = (k + kWarps - 1) / kWarps;
    const unsigned grid = static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
    warp_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(offsets),
        static_cast<int64_t>(k), static_cast<const int32_t*>(plan), tables,
        static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
