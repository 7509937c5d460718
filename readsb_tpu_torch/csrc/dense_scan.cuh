// Dense scan for Hopper (sm_90a): the one kernel behind the two dense-scan
// entry points, templated on how a stored sample becomes a magnitude.
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
// fused_demod.cu's blocks run the same body on their sub-tiles: the
// per-thread math (load_thread, scan_samples), the staged prefix-sum
// stores and the look-back are device functions here for that reason.
//
// Contract (readsb_tpu_torch/ops/kernels.py):
//
//   in       uint16[n]  samples, n % 8192 == 0, 16-byte aligned
//   corr     int8[n]    bit0..2 correlation A/B/C fired, bit3 candidate
//   pwords   int32[5, n/32]  slicer sign planes; bit j of word w = sample 32w+j
//   cs_hi    int32[n]   inclusive prefix sum of (mag^2 >> 16), wraparound
//   cs_lo    int32[n]   inclusive prefix sum of (mag^2 & 0xffff), wraparound
//   scratch  uint32[kHead + 6 * n / 8192]  tile ticket, flags and sums
//
// Bound on the H100: memory.  The function moves 11.625 B per sample
// (2 in; 1 + 0.625 + 8 out) against ~85 integer/float operations, below
// the card's ~20 operations per byte.  Design: one pass over the input.
//   * One kernel after a cudaMemsetAsync of the ticket and the flags
//     (4 B per tile).  A block of 256 threads takes a tile of 8192 samples
//     from an atomic ticket, so tiles start in order: a tile that waits on
//     its predecessors never waits on a block that has not started.
//   * The prefix sums are a single-pass scan with decoupled look-back
//     (Merrill and Garland, 2016): a tile publishes its aggregate, warp 0
//     sums its predecessors' aggregates back to the nearest published
//     inclusive prefix, 32 tiles per step, then the tile publishes its own
//     prefix.  Sums are uint32 and wrap, so the order of the additions
//     cannot change a bit.
//   * The tile and its 19-sample halo (32 staged) are read once with
//     16-byte loads, converted as they arrive, and kept in shared memory
//     as uint16, swizzled (sw_mag) so that the 16-byte reads below hit
//     distinct banks.
//   * Each thread owns 32 consecutive samples.  It reads its 32 + 19
//     samples into registers and computes, serially, their correlation
//     bytes, its five plane words (no ballot) and its two sums; the sums
//     are scanned across the warp and the block.
//   * corr, cs_hi and cs_lo leave through a swizzled (sw_out) staging
//     buffer in shared memory as coalesced 16-byte stores; a thread
//     writes its own plane words (coalesced across the warp).
//   * The uc8 fi^2 table is made once per process on the host
//     (ops/convert.py::sq_table_np) and copied to the device when the
//     library is loaded (set_sq_table); a block copies its 1 KB to shared
//     memory and builds nothing.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "uc8_mag.cuh"

namespace dense {

constexpr int kThreads = 256;
constexpr int kPer = 32;                    // samples per thread
constexpr int kTile = kThreads * kPer;      // 8192 samples per tile (one block)
constexpr int kHalo = 19;                   // correlations read up to sample + 18
constexpr int kTileChunks = kTile / 8;      // 16-byte chunks of 8 uint16 samples
constexpr int kHaloChunks = 4;              // 32 samples staged past the tile
constexpr int kMagChunks = kTileChunks + 8; // sw_mag stays inside groups of 8 chunks
constexpr int kOutChunks = kTile / 4;       // 16-byte chunks of 4 int32 outputs
constexpr size_t kSharedBytes = 16 * (kMagChunks + kOutChunks);
constexpr int kHead = 32;                   // scratch words before the flags; [0] = ticket
constexpr uint32_t kAggregate = 1, kPrefix = 2;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 256, "the fi^2 table is copied one entry per thread");

__device__ float g_sq[256];  // fi^2, convert.c:45-50

// Host pointer: float32[256] (readsb_tpu_torch/ops/convert.py::sq_table_np).
// Call once per process and library, before the first launch.
inline int set_sq_table(const void* sq) {
    return static_cast<int>(cudaMemcpyToSymbol(g_sq, sq, sizeof(float) * 256));
}

struct Uc8Loader {
    static constexpr bool kTable = true;
    // two samples, one per 16-bit half
    __device__ __forceinline__ static uint32_t pair(uint32_t w, const float* sq) {
        return uc8_mag(w & 0xffffu, sq) | (uc8_mag(w >> 16, sq) << 16);
    }
};

struct MagLoader {
    static constexpr bool kTable = false;
    __device__ __forceinline__ static uint32_t pair(uint32_t w, const float*) { return w; }
};

template <class Loader>
__device__ __forceinline__ uint4 convert(const uint4 v, const float* sq) {
    return make_uint4(Loader::pair(v.x, sq), Loader::pair(v.y, sq), Loader::pair(v.z, sq),
                      Loader::pair(v.w, sq));
}

// 16-byte chunk c of a buffer in shared memory -> its slot.  A warp's
// 16-byte accesses run as four phases of 8 lanes, conflict-free when the
// 8 slots fall in distinct groups of 4 banks.  sw_mag serves lanes that
// read chunks 4t + k (k < 7) and blocks that write chunks in order;
// sw_out serves lanes that write chunks 8t + k or 2t + k.
__device__ __forceinline__ int sw_mag(int c) { return c ^ ((c >> 3) & 3); }
__device__ __forceinline__ int sw_out(int c) { return c ^ ((c >> 3) & 7); }

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// 1 if x > 0, else 0, for |x| < 2^31
__device__ __forceinline__ uint32_t positive(int32_t x) {
    return static_cast<uint32_t>(-x) >> 31;
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t u = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += u;
    }
    return v;
}

// Samples 32u .. 32u + 55 of a staged tile into 28 registers, two per word,
// low half first (16-byte reads of chunks 4u .. 4u + 6).
__device__ __forceinline__ void load_thread(const uint4* mag4, int u, uint32_t (&m2)[28]) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
        const uint4 r = mag4[sw_mag(4 * u + k)];
        m2[4 * k] = r.x;
        m2[4 * k + 1] = r.y;
        m2[4 * k + 2] = r.z;
        m2[4 * k + 3] = r.w;
    }
}

__device__ __forceinline__ int32_t mag_at(const uint32_t (&m2)[28], int s) {
    return static_cast<int32_t>((s & 1) ? m2[s >> 1] >> 16 : m2[s >> 1] & 0xffffu);
}

// The dense math of one thread's 32 samples (load_thread's registers):
// per sample j, emit(j, ca, cb, cc, cand) with the three correlations and
// the candidate bit; the five sign-plane words (bit j = sample j); the sums
// of mag^2 >> 16 and mag^2 & 0xffff.
template <class Emit>
__device__ __forceinline__ void scan_samples(const uint32_t (&m2)[28], int thr, uint32_t (&pl)[5],
                                             uint32_t& hi, uint32_t& lo, Emit&& emit) {
#pragma unroll
    for (int q = 0; q < 5; ++q) pl[q] = 0u;
    hi = 0u;
    lo = 0u;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        int32_t p[kHalo];
#pragma unroll
        for (int d = 0; d < kHalo; ++d) p[d] = mag_at(m2, j + d);
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
        emit(j, ca, cb, cc, pre & (ca | cb | cc));
        // slicer sign planes (demod_2400.c:74-93): x > 0 is the sign bit of
        // -x (|x| < 2^21), so no predicate is packed into the plane word
        const int32_t s0 = p[0], s1 = p[1], s2 = p[2], s3 = p[3];
        pl[0] |= positive(18 * s0 - 15 * s1 - 3 * s2) << j;
        pl[1] |= positive(14 * s0 - 5 * s1 - 9 * s2) << j;
        pl[2] |= positive(16 * s0 + 5 * s1 - 20 * s2) << j;
        pl[3] |= positive(7 * s0 + 11 * s1 - 18 * s2) << j;
        pl[4] |= positive(4 * s0 + 15 * s1 - 20 * s2 + s3) << j;
        const uint32_t sqm = static_cast<uint32_t>(s0) * static_cast<uint32_t>(s0);
        hi += sqm >> 16;
        lo += sqm & 0xffffu;
    }
}

// The block's two inclusive prefix sums of its 8192 samples (thread t owns
// samples 32t .. 32t + 31 in m2; oh / ol: the sums before them) through the
// swizzled staging buffer out4, as coalesced 16-byte stores to hi[0:8192]
// and lo[0:8192].  Every thread calls it; out4 is free on entry and on exit.
__device__ __forceinline__ void store_prefix_sums(uint4* out4, const uint32_t (&m2)[28],
                                                  uint32_t oh, uint32_t ol,
                                                  int32_t* hi, int32_t* lo) {
    const int t = threadIdx.x;
    auto stage = [&](uint32_t run, bool high) {
#pragma unroll
        for (int k = 0; k < kPer / 4; ++k) {
            uint32_t o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint32_t s = static_cast<uint32_t>(mag_at(m2, 4 * k + i));
                run += high ? (s * s) >> 16 : (s * s) & 0xffffu;
                o[i] = run;
            }
            out4[sw_out(8 * t + k)] = make_uint4(o[0], o[1], o[2], o[3]);
        }
    };
    auto flush = [&](int32_t* dst) {
        uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
        for (int i = 0; i < kOutChunks / kThreads; ++i) {
            const int c = t + i * kThreads;
            d4[c] = out4[sw_out(c)];
        }
    };
    __syncthreads();  // out4 is free
    stage(oh, true);
    __syncthreads();
    flush(hi);
    __syncthreads();
    stage(ol, false);
    __syncthreads();
    flush(lo);
    __syncthreads();
}

// Warp 0: the (hi, lo) sums of tiles [0, tile), from the predecessors'
// published aggregates back to the nearest inclusive prefix.
__device__ __forceinline__ uint2 look_back(const uint32_t* flags, const uint2* agg,
                                           const uint2* prefix, int64_t tile) {
    const int lane = threadIdx.x & 31;
    uint32_t eh = 0, el = 0;
    for (int64_t end = tile;; end -= 32) {
        const int64_t j = end - 1 - lane;  // lane 0 is the nearest predecessor
        uint32_t f = kPrefix;              // before tile 0: a prefix of 0
        uint2 v = make_uint2(0u, 0u);
        if (j >= 0) {
            // a predecessor publishes within microseconds; one that never
            // does is a fault, and a trap ends the launch with an error
            for (uint32_t spins = 0; (f = ld_acquire(flags + j)) == 0u;)
                if (++spins == (1u << 24)) __trap();
            v = __ldcg(f == kPrefix ? prefix + j : agg + j);
        }
        const unsigned pm = __ballot_sync(kFull, f == kPrefix);
        const int stop = pm ? __ffs(pm) - 1 : 31;  // lanes 0..stop are summed
        if (lane > stop) v = make_uint2(0u, 0u);
        eh += __reduce_add_sync(kFull, v.x);
        el += __reduce_add_sync(kFull, v.y);
        if (pm) return make_uint2(eh, el);
    }
}

// Warp 0 of tile `tile`: publish its sums (th, tl), look back, publish its
// inclusive prefix.  Returns the sums of tiles [0, tile).
__device__ __forceinline__ uint2 publish_and_look_back(uint32_t* flags, uint2* agg, uint2* prefix,
                                                       int64_t tile, uint32_t th, uint32_t tl) {
    const int lane = threadIdx.x & 31;
    if (tile == 0) {
        if (lane == 0) {
            __stcg(prefix, make_uint2(th, tl));
            st_release(flags, kPrefix);
        }
        return make_uint2(0u, 0u);
    }
    if (lane == 0) {
        __stcg(agg + tile, make_uint2(th, tl));
        st_release(flags + tile, kAggregate);
    }
    const uint2 ex = look_back(flags, agg, prefix, tile);
    if (lane == 0) {
        __stcg(prefix + tile, make_uint2(ex.x + th, ex.y + tl));
        st_release(flags + tile, kPrefix);
    }
    return ex;
}

template <class Loader>
__global__ void __launch_bounds__(kThreads, 3) dense_tile(
    const uint16_t* __restrict__ in, int64_t n, int thr, uint32_t* __restrict__ scratch,
    int8_t* __restrict__ corr, int32_t* __restrict__ pwords,
    int32_t* __restrict__ cs_hi, int32_t* __restrict__ cs_lo) {
    extern __shared__ uint4 smem[];
    uint4* mag4 = smem;               // [kMagChunks] magnitudes, chunk c at sw_mag(c)
    uint4* out4 = smem + kMagChunks;  // [kOutChunks] outputs, chunk c at sw_out(c)
    __shared__ float sq[256];
    __shared__ uint32_t wsum[2][kThreads / 32];
    __shared__ uint32_t tile_sh, ex_sh[2];

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int64_t ntiles = n / kTile;
    uint32_t* flags = scratch + kHead;
    uint2* agg = reinterpret_cast<uint2*>(scratch + kHead + ntiles + (ntiles & 1));
    uint2* prefix = agg + ntiles;

    if (t == 0) tile_sh = atomicAdd(scratch, 1u);
    if constexpr (Loader::kTable) sq[t] = g_sq[t];
    __syncthreads();
    const int64_t tile = tile_sh;
    const int64_t base = tile * kTile;

    // ---- stage the tile and its halo as magnitudes ---------------------------
    const uint4* in4 = reinterpret_cast<const uint4*>(in + base);
    uint4 v[kTileChunks / kThreads];
#pragma unroll
    for (int i = 0; i < kTileChunks / kThreads; ++i) v[i] = __ldg(in4 + t + i * kThreads);
    uint4 h = make_uint4(0u, 0u, 0u, 0u);  // past the end: word 0
    if (t < kHaloChunks && base + kTile < n) h = __ldg(in4 + kTileChunks + t);
#pragma unroll
    for (int i = 0; i < kTileChunks / kThreads; ++i)
        mag4[sw_mag(t + i * kThreads)] = convert<Loader>(v[i], sq);
    if (t < kHaloChunks) mag4[sw_mag(kTileChunks + t)] = convert<Loader>(h, sq);
    __syncthreads();

    // ---- this thread's 32 samples and their 19-sample lookahead -----------------
    uint32_t m2[28];
    load_thread(mag4, t, m2);
    uint32_t cw[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};  // correlation bytes
    uint32_t pl[5];
    uint32_t hi, lo;
    scan_samples(m2, thr, pl, hi, lo, [&](int j, bool ca, bool cb, bool cc, bool cand) {
        cw[j >> 2] |= static_cast<uint32_t>(ca | (cb << 1) | (cc << 2) | (cand << 3)) << (8 * (j & 3));
    });

    const int64_t nw = n >> 5;
#pragma unroll
    for (int q = 0; q < 5; ++q) pwords[q * nw + base / 32 + t] = static_cast<int32_t>(pl[q]);
    out4[sw_out(2 * t)] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
    out4[sw_out(2 * t + 1)] = make_uint4(cw[4], cw[5], cw[6], cw[7]);

    // ---- offsets within the tile; the tile's sums ------------------------------
    const uint32_t ih = warp_inclusive_scan(hi), il = warp_inclusive_scan(lo);
    if (lane == 31) {
        wsum[0][warp] = ih;
        wsum[1][warp] = il;
    }
    __syncthreads();
    uint32_t oh = ih - hi, ol = il - lo, th = 0u, tl = 0u;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
        const uint32_t a = wsum[0][i], b = wsum[1][i];
        if (i < warp) {
            oh += a;
            ol += b;
        }
        th += a;
        tl += b;
    }
    uint4* corr4 = reinterpret_cast<uint4*>(corr + base);
#pragma unroll
    for (int i = 0; i < kTile / 16 / kThreads; ++i) {
        const int c = t + i * kThreads;
        corr4[c] = out4[sw_out(c)];
    }

    // ---- the tile's offset: publish, look back, publish ------------------------
    if (warp == 0) {
        const uint2 ex = publish_and_look_back(flags, agg, prefix, tile, th, tl);
        if (lane == 0) {
            ex_sh[0] = ex.x;
            ex_sh[1] = ex.y;
        }
    }
    __syncthreads();  // the tile's offset is known; the corr staging is read
    oh += ex_sh[0];
    ol += ex_sh[1];

    // ---- the two prefix sums, one staging round each ---------------------------
    store_prefix_sums(out4, m2, oh, ol, cs_hi + base, cs_lo + base);
}

// Once per library, on its device: dense_tile's shared memory above 48 KB.
template <class Loader>
cudaError_t prepare() {
    return cudaFuncSetAttribute(dense_tile<Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kSharedBytes));
}

// The memset of the ticket and the flags, then the kernel, on one stream
// (after prepare<Loader>).
// Returns the first CUDA error.
template <class Loader>
int launch(const void* in, long long n, int threshold, void* corr, void* pwords,
           void* cs_hi, void* cs_lo, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long ntiles = n / kTile;
    const cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * (kHead + ntiles), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    dense_tile<Loader><<<static_cast<unsigned>(ntiles), kThreads, kSharedBytes, s>>>(
        static_cast<const uint16_t*>(in), static_cast<int64_t>(n), threshold,
        static_cast<uint32_t*>(scratch), static_cast<int8_t*>(corr),
        static_cast<int32_t*>(pwords), static_cast<int32_t*>(cs_hi),
        static_cast<int32_t*>(cs_lo));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace dense
