// Dense scan for Hopper (sm_90a): the body shared by the two dense-scan
// kernels, templated on how a stored sample becomes a magnitude.
//
// The TPU kernels dense_scan_uc8_pallas and dense_scan_pallas
// (readsb_tpu/ops/pallas_kernels.py :400 and :335) share one body,
// _dense_body (:264), and differ only in the loader; so do these:
//
//   Uc8Loader  uint16 word = one interleaved uc8 I/Q pair (I low byte),
//              converted in the kernel (uc8_mag.cuh); a sample past the
//              end reads as word 0, which is a full-scale magnitude
//   MagLoader  uint16 magnitude, used as it is; a sample past the end
//              reads as magnitude 0
//
// Contract (readsb_tpu_torch/ops/kernels.py):
//
//   in      uint16[n]  samples, n % 1024 == 0
//   corr    int8[n]    bit0..2 correlation A/B/C fired, bit3 candidate
//   pwords  int32[5, n/32]  slicer sign planes; bit j of word w = sample 32w+j
//   cs_hi   int32[n]   inclusive prefix sum of (mag^2 >> 16), wraparound
//   cs_lo   int32[n]   inclusive prefix sum of (mag^2 & 0xffff), wraparound
//
// Bound on the H100: memory.  The function moves 11.625 B per sample
// (2 in; 1 + 0.625 + 8 out) against ~80 integer/float operations, far
// below the card's ~20 operations per byte.  Design:
//   * one thread per sample, 1024 samples per block; the block loads its
//     1024 + 19 lookahead samples as magnitudes once, into shared memory;
//   * sign planes are packed with __ballot_sync over a warp's 32
//     consecutive samples, written straight into the (5, n/32) layout;
//   * blocks run in no order, so the prefix sums are a reduce-then-scan:
//     pass 1 sums mag^2 per block, pass 2 scans the block totals, pass 3
//     (the main pass) scans within the block and adds the block's offset.
//     Sums are uint32 and wrap, which keeps window differences exact.
// Pass 1 reads the samples a second time (2 B/sample more than the bound).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "uc8_mag.cuh"

namespace dense {

constexpr int kBlock = 1024;  // samples (= threads) per block
constexpr int kHalo = 19;     // correlations read up to sample + 18
constexpr int kScanThreads = 1024;

struct Uc8Loader {
    static constexpr bool kNeedsTable = true;
    __device__ __forceinline__ static uint32_t mag(uint32_t w, const float* sq) {
        return uc8_mag(w, sq);
    }
};

struct MagLoader {
    static constexpr bool kNeedsTable = false;
    __device__ __forceinline__ static uint32_t mag(uint32_t w, const float*) { return w; }
};

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        uint32_t u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
    }
    return v;
}

// Block-wide inclusive scan of two values (blockDim.x == 1024).
__device__ inline void block_inclusive_scan2(uint32_t& a, uint32_t& b, uint32_t (*tot)[32]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    a = warp_inclusive_scan(a);
    b = warp_inclusive_scan(b);
    if (lane == 31) {
        tot[0][warp] = a;
        tot[1][warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
        uint32_t ta = tot[0][lane], tb = tot[1][lane];
        uint32_t ia = warp_inclusive_scan(ta), ib = warp_inclusive_scan(tb);
        tot[0][lane] = ia - ta;  // exclusive
        tot[1][lane] = ib - tb;
    }
    __syncthreads();
    a += tot[0][warp];
    b += tot[1][warp];
}

// Pass 1: per-block sums of mag^2 >> 16 and mag^2 & 0xffff.
template <class Loader>
__global__ void __launch_bounds__(kBlock) block_sums(
    const uint16_t* __restrict__ in, uint32_t* __restrict__ sums, int64_t nblk) {
    __shared__ float sq[256];
    __shared__ uint32_t tot[2][32];
    if constexpr (Loader::kNeedsTable) {
        load_sq_table(sq);
        __syncthreads();
    }
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    const uint32_t m = Loader::mag(in[i], sq);
    const uint32_t s = m * m;
    uint32_t hi = s >> 16, lo = s & 0xffffu;
    block_inclusive_scan2(hi, lo, tot);
    if (threadIdx.x == kBlock - 1) {
        sums[blockIdx.x] = hi;
        sums[nblk + blockIdx.x] = lo;
    }
}

// Pass 2: exclusive scan of the nblk block totals, in place (one block).
__global__ void __launch_bounds__(kScanThreads) scan_totals(uint32_t* __restrict__ sums, int64_t nblk) {
    __shared__ uint32_t tot[2][32];
    const int64_t per = (nblk + kScanThreads - 1) / kScanThreads;
    const int64_t j0 = threadIdx.x * per;
    const int64_t j1 = j0 + per < nblk ? j0 + per : nblk;
    uint32_t a = 0, b = 0;
    for (int64_t j = j0; j < j1; ++j) {
        a += sums[j];
        b += sums[nblk + j];
    }
    uint32_t ia = a, ib = b;
    block_inclusive_scan2(ia, ib, tot);
    uint32_t ea = ia - a, eb = ib - b;  // exclusive prefix of this thread's chunk
    for (int64_t j = j0; j < j1; ++j) {
        uint32_t va = sums[j], vb = sums[nblk + j];
        sums[j] = ea;
        sums[nblk + j] = eb;
        ea += va;
        eb += vb;
    }
}

// Pass 3: correlations, sign planes and the prefix sums.
template <class Loader>
__global__ void __launch_bounds__(kBlock) dense_main(
    const uint16_t* __restrict__ in, int64_t n, int thr,
    const uint32_t* __restrict__ offs, int64_t nblk,
    int8_t* __restrict__ corr, int32_t* __restrict__ pwords,
    int32_t* __restrict__ cs_hi, int32_t* __restrict__ cs_lo) {
    __shared__ float sq[256];
    __shared__ int32_t m[kBlock + kHalo];
    __shared__ uint32_t tot[2][32];
    if constexpr (Loader::kNeedsTable) {
        load_sq_table(sq);
        __syncthreads();
    }
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
    for (int j = threadIdx.x; j < kBlock + kHalo; j += kBlock) {
        const int64_t g = base + j;
        m[j] = static_cast<int32_t>(Loader::mag(g < n ? in[g] : 0u, sq));
    }
    __syncthreads();

    const int t = threadIdx.x;
    const int32_t* p = m + t;
    // preamble pre-check + 3 correlations (demod_2400.c:311-378)
    const bool pre = (p[1] > p[7]) & (p[12] > p[14]) & (p[12] > p[15]);
    const int32_t ref = ((p[5] + p[8] + p[16] + p[17] + p[18]) * thr) >> 5;
    const int32_t d23 = p[2] - p[3];
    const int32_t s14 = p[1] + p[4];
    const int32_t d1011 = p[10] - p[11];
    const int32_t common = s14 - d23 + p[9] + p[12];
    const bool ca = (common - d1011) >= ref;
    const bool cb = (common + d1011) >= ref;
    const bool cc = (s14 + 2 * d23 + d1011 + p[12]) >= ref;
    const bool cand = pre & (ca | cb | cc);
    corr[base + t] = static_cast<int8_t>(ca | (cb << 1) | (cc << 2) | (cand << 3));

    // slicer sign planes (demod_2400.c:74-93), one ballot per plane
    const int32_t s0 = p[0], s1 = p[1], s2 = p[2], s3 = p[3];
    const unsigned b0 = __ballot_sync(0xffffffffu, (18 * s0 - 15 * s1 - 3 * s2) > 0);
    const unsigned b1 = __ballot_sync(0xffffffffu, (14 * s0 - 5 * s1 - 9 * s2) > 0);
    const unsigned b2 = __ballot_sync(0xffffffffu, (16 * s0 + 5 * s1 - 20 * s2) > 0);
    const unsigned b3 = __ballot_sync(0xffffffffu, (7 * s0 + 11 * s1 - 18 * s2) > 0);
    const unsigned b4 = __ballot_sync(0xffffffffu, (4 * s0 + 15 * s1 - 20 * s2 + s3) > 0);
    const int lane = t & 31;
    if (lane < 5) {
        const unsigned v = lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2 : lane == 3 ? b3 : b4;
        pwords[lane * (n >> 5) + ((base + t) >> 5)] = static_cast<int32_t>(v);
    }

    // split prefix sums of mag^2
    const uint32_t sqm = static_cast<uint32_t>(s0) * static_cast<uint32_t>(s0);
    uint32_t hi = sqm >> 16, lo = sqm & 0xffffu;
    block_inclusive_scan2(hi, lo, tot);
    cs_hi[base + t] = static_cast<int32_t>(hi + offs[blockIdx.x]);
    cs_lo[base + t] = static_cast<int32_t>(lo + offs[nblk + blockIdx.x]);
}

// The three passes on one stream.  n % 1024 == 0; scratch holds
// 2 * n / 1024 uint32 block totals.  Returns cudaGetLastError().
template <class Loader>
int launch(const void* in, long long n, int threshold, void* corr, void* pwords,
           void* cs_hi, void* cs_lo, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t nblk = n / kBlock;
    auto* w = static_cast<const uint16_t*>(in);
    auto* sums = static_cast<uint32_t*>(scratch);
    block_sums<Loader><<<static_cast<unsigned>(nblk), kBlock, 0, s>>>(w, sums, nblk);
    scan_totals<<<1, kScanThreads, 0, s>>>(sums, nblk);
    dense_main<Loader><<<static_cast<unsigned>(nblk), kBlock, 0, s>>>(
        w, n, threshold, sums, nblk, static_cast<int8_t*>(corr),
        static_cast<int32_t*>(pwords), static_cast<int32_t*>(cs_hi),
        static_cast<int32_t*>(cs_lo));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace dense
