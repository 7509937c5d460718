// Dense scan -> in-tile compaction -> extraction in one kernel per
// 65536-sample tile, for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/fused.py::fused_demod_tiles (:304; kernel body
// _fused_body :91).  Contract (readsb_tpu_torch/ops/fused.py):
//
//   mag      uint16[n]          magnitudes of T = n / 65536 tiles, n = 65536 T
//                               or 65536 T + 1024 (the last tile's halo)
//   comb     int32[T*cap,128]   per row the lanes of extract_syndromes
//   offsets  int32[T*cap]       tile_base + offset of a live row, else the
//                               tile's end (the list is nondecreasing)
//   live     uint8[T*cap]       1 for the first min(count, cap) candidates of
//                               the tile whose rank within their 128-sample
//                               row is below l_row
//   meta     int32[T,3]         candidates in the tile, most in a
//                               256-sample block, most in a 128-sample row
//   cs_hi/lo int32[n]           the split mag^2 prefix sums of dense_scan.cuh
//
// A row that is not live holds the extraction at the tile's offset 0, as
// in the TPU kernel.  A candidate is a sample with the pre-check and any
// correlation set, below scan_limit and, with seg_stride > 0, with
// (pos % seg_stride) < seg_valid.
//
// Bound on the H100: memory (2 B/sample in, 8 B/sample of prefix sums and
// 516 B per row out), but the kernel is built for something else: the
// staged route's intermediates (correlation bits, plane words, win rows,
// gathered rows) never reach device memory, and its ~300 launches become
// three.  What the TPU kernel computes is kept, not how: its one-hot
// gather products, triangular-product prefixes and per-row select loops
// answer constraints this card does not have.  Design:
//   * one block of 1024 threads per tile, walking the tile and its
//     1024-sample halo in 65 chunks of 1024 samples, one thread per sample,
//     with the arithmetic of dense_scan.cuh; a sample past the end reads 0;
//   * sign planes and correlation bits are ballot-packed into shared
//     memory only (5 x 2080 + 3 x 2048 words), so the block asks for
//     dynamic shared memory above 48 KB;
//   * chunks are walked in order, so a candidate's rank in its tile is a
//     running count plus a ballot/popc prefix over the chunk's 32 warps;
//     rank < cap writes the offset; the same per-warp counts give the
//     128-sample row and 256-sample block maxima;
//   * extraction (extract.cuh) reads its window straight from the
//     shared-memory plane words at (offset >> 5): no win rows, no gather;
//     192 rows at a time (6 groups of 32 candidates x 5 phase warps) are
//     staged in shared memory and written back coalesced;
//   * blocks run in no order, so the prefix sums are a reduce-then-scan:
//     block_sums and scan_totals (below) run first in the same entry
//     point, and each chunk adds its 1024-sample block's offset.

#include "dense_scan.cuh"
#include "extract.cuh"

// The reduce-then-scan passes of the prefix sums, and the block scan that
// the tile kernel shares with them, beside dense_scan.cuh's single pass.
namespace dense {

constexpr int kBlock = 1024;  // samples (= threads) per block
constexpr int kScanThreads = 1024;

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
__global__ void __launch_bounds__(kBlock) block_sums(
    const uint16_t* __restrict__ in, uint32_t* __restrict__ sums, int64_t nblk) {
    __shared__ uint32_t tot[2][32];
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    const uint32_t m = in[i];
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

}  // namespace dense

namespace {

constexpr int kTile = 65536;
constexpr int kChunks = kTile / dense::kBlock;       // 64, plus one halo chunk
constexpr int kTileWords = kTile / 32;               // 2048
constexpr int kPlaneWords = kTileWords + 32;         // tile + halo
constexpr int kGroupRows = 192;                      // rows extracted per round
constexpr int kOutStride = extract::kUsedLanes;      // 83: odd, so no bank conflicts
constexpr size_t kSharedBytes =
    sizeof(uint32_t) * (5 * kPlaneWords + 3 * kTileWords) + sizeof(int32_t) * kGroupRows * kOutStride;

// A candidate's window in the tile's shared-memory plane words.
struct TileFetch {
    const uint32_t* pw;  // [5][kPlaneWords]
    int w0;              // offset >> 5
    unsigned sb;         // offset & 31
    __device__ __forceinline__ uint32_t word(int plane, int j) const {
        const uint32_t* p = pw + plane * kPlaneWords + w0 + j;
        return __funnelshift_r(p[0], p[1], sb);
    }
};

__global__ void __launch_bounds__(dense::kBlock) fused_tile(
    const uint16_t* __restrict__ in, int64_t n, int thr, int cap, int l_row,
    int seg_stride, int seg_valid, int scan_limit,
    const uint32_t* __restrict__ offs, int64_t nblk,
    int32_t* __restrict__ comb, int32_t* __restrict__ offsets, uint8_t* __restrict__ live,
    int32_t* __restrict__ meta, int32_t* __restrict__ cs_hi, int32_t* __restrict__ cs_lo) {
    extern __shared__ uint32_t dyn[];
    uint32_t* pw = dyn;                                   // [5][kPlaneWords]
    uint32_t* cw = pw + 5 * kPlaneWords;                  // [3][kTileWords]
    int32_t* out_sh = reinterpret_cast<int32_t*>(cw + 3 * kTileWords);
    __shared__ int32_t m[dense::kBlock + dense::kHalo];
    __shared__ uint32_t tot[2][32];
    __shared__ int wcnt[32];

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int64_t tile = blockIdx.x;
    const int64_t tile_base = tile * kTile;
    const int64_t row0 = tile * cap;  // first output row of the tile
    int run = 0;                      // candidates of the tile before this chunk
    int max_blk = 0, max_row = 0;     // kept by thread 0

    // ---- 1 + 2: dense math and compaction, chunk by chunk ---------------------
    for (int ch = 0; ch <= kChunks; ++ch) {
        const int64_t base = tile_base + static_cast<int64_t>(ch) * dense::kBlock;
        for (int j = t; j < dense::kBlock + dense::kHalo; j += dense::kBlock) {
            const int64_t g = base + j;
            m[j] = g < n ? static_cast<int32_t>(in[g]) : 0;
        }
        __syncthreads();
        const int32_t* p = m + t;
        // slicer sign planes (demod_2400.c:74-93), one ballot per plane
        const int32_t s0 = p[0], s1 = p[1], s2 = p[2], s3 = p[3];
        const unsigned b0 = __ballot_sync(0xffffffffu, (18 * s0 - 15 * s1 - 3 * s2) > 0);
        const unsigned b1 = __ballot_sync(0xffffffffu, (14 * s0 - 5 * s1 - 9 * s2) > 0);
        const unsigned b2 = __ballot_sync(0xffffffffu, (16 * s0 + 5 * s1 - 20 * s2) > 0);
        const unsigned b3 = __ballot_sync(0xffffffffu, (7 * s0 + 11 * s1 - 18 * s2) > 0);
        const unsigned b4 = __ballot_sync(0xffffffffu, (4 * s0 + 15 * s1 - 20 * s2 + s3) > 0);
        if (lane < 5) {
            const unsigned v = lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2 : lane == 3 ? b3 : b4;
            pw[lane * kPlaneWords + ch * 32 + warp] = v;
        }
        // block-uniform: the halo chunk gives plane words and, where the
        // buffer carries the last tile's halo, that chunk's prefix sums
        const bool scan = ch < kChunks;
        bool cand = false;
        unsigned cmask = 0u;
        if (scan) {
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
            const unsigned wa = __ballot_sync(0xffffffffu, ca);
            const unsigned wb = __ballot_sync(0xffffffffu, cb);
            const unsigned wc = __ballot_sync(0xffffffffu, cc);
            if (lane >= 5 && lane < 8) {
                const unsigned v = lane == 5 ? wa : lane == 6 ? wb : wc;
                cw[(lane - 5) * kTileWords + ch * 32 + warp] = v;
            }
            const int pos = static_cast<int>(base) + t;
            cand = pre & (ca | cb | cc) & (pos < scan_limit);
            if (seg_stride > 0) cand &= (pos % seg_stride) < seg_valid;
            cmask = __ballot_sync(0xffffffffu, cand);
            if (lane == 0) wcnt[warp] = __popc(cmask);
        }
        if (scan || (tile == gridDim.x - 1 && base < n)) {
            // split prefix sums of mag^2 (the syncs inside publish wcnt too)
            const uint32_t sqm = static_cast<uint32_t>(s0) * static_cast<uint32_t>(s0);
            uint32_t hi = sqm >> 16, lo = sqm & 0xffffu;
            dense::block_inclusive_scan2(hi, lo, tot);
            const int64_t blk = base / dense::kBlock;
            cs_hi[base + t] = static_cast<int32_t>(hi + offs[blk]);
            cs_lo[base + t] = static_cast<int32_t>(lo + offs[nblk + blk]);
        }
        if (scan) {
            // rank of a candidate: running count + warps before + lanes before
            int before = 0, row_before = 0, total = 0;
#pragma unroll
            for (int w = 0; w < 32; ++w) {
                const int c = wcnt[w];
                if (w < warp) before += c;
                if (w < (warp & ~3)) row_before += c;  // a 128-sample row is 4 warps
                total += c;
            }
            if (cand) {
                const int in_warp = __popc(cmask & ((1u << lane) - 1u));
                const int rank = run + before + in_warp;
                if (rank < cap) {
                    const bool lv = (before - row_before + in_warp) < l_row;
                    offsets[row0 + rank] =
                        static_cast<int32_t>(lv ? base + t : tile_base + kTile);
                    live[row0 + rank] = lv ? 1 : 0;
                }
            }
            if (t == 0) {
#pragma unroll
                for (int w = 0; w < 32; w += 4) {
                    const int r = wcnt[w] + wcnt[w + 1] + wcnt[w + 2] + wcnt[w + 3];
                    max_row = r > max_row ? r : max_row;
                }
#pragma unroll
                for (int w = 0; w < 32; w += 8) {
                    int b = 0;
                    for (int i = 0; i < 8; ++i) b += wcnt[w + i];
                    max_blk = b > max_blk ? b : max_blk;
                }
            }
            run += total;
        }
        __syncthreads();  // m, tot and wcnt are rewritten by the next chunk
    }

    if (t == 0) {
        meta[tile * 3 + 0] = run;
        meta[tile * 3 + 1] = max_blk;
        meta[tile * 3 + 2] = max_row;
    }
    for (int r = (run < cap ? run : cap) + t; r < cap; r += dense::kBlock) {
        offsets[row0 + r] = static_cast<int32_t>(tile_base + kTile);
        live[row0 + r] = 0;
    }
    __syncthreads();  // the tile's offsets are read back below

    // ---- 3: extraction of the cap rows from the shared plane words -------------
    const int grp = warp / extract::kPhases, ph = warp - grp * extract::kPhases;
    const int32_t dead = static_cast<int32_t>(tile_base + kTile);
    for (int r0 = 0; r0 < cap; r0 += kGroupRows) {
        const int r = r0 + grp * 32 + lane;
        if (grp * 32 < kGroupRows && r < cap) {
            const int32_t og = offsets[row0 + r];
            const int ol = og == dead ? 0 : static_cast<int>(og - tile_base);
            const TileFetch fetch{pw, ol >> 5, static_cast<unsigned>(ol & 31)};
            int32_t* o = out_sh + (grp * 32 + lane) * kOutStride;
            extract::phase(ph, fetch, o);
            if (ph < 3) {
                o[extract::kCorrLane + ph] = static_cast<int32_t>(
                    (cw[ph * kTileWords + fetch.w0] >> fetch.sb) & 1u);
            }
        }
        __syncthreads();
        const int rows_here = cap - r0 < kGroupRows ? cap - r0 : kGroupRows;
        for (int j = t; j < rows_here * extract::kLanes; j += dense::kBlock) {
            const int rr = j >> 7, l = j & 127;
            comb[(row0 + r0 + rr) * extract::kLanes + l] =
                l < kOutStride ? out_sh[rr * kOutStride + l] : 0;
        }
        __syncthreads();
    }
}

}  // namespace

// rtpu_cuda_error_string comes with dense_scan.cuh (uc8_mag.cuh).

extern "C" int rtpu_extract_set_tables(const void* tap, const void* syn112,
                                       const void* syn56, const void* syn_bytes) {
    return extract::set_tables(tap, syn112, syn56, syn_bytes);
}

// The prefix-sum passes and the tile kernel on one stream.  n = 65536 T or
// 65536 T + 1024, n < 2^31; seg_stride == 0 means no channel layout; scratch holds
// 2 * n / 1024 uint32 block totals.  Returns the first CUDA error.
extern "C" int fused_demod(const void* mag, long long n, int threshold, int cap, int l_row,
                           int seg_stride, int seg_valid, int scan_limit,
                           void* comb, void* offsets, void* live, void* meta,
                           void* cs_hi, void* cs_lo, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t nblk = n / dense::kBlock;
    auto* in = static_cast<const uint16_t*>(mag);
    auto* sums = static_cast<uint32_t*>(scratch);
    cudaError_t e = cudaFuncSetAttribute(
        fused_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSharedBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    dense::block_sums<<<static_cast<unsigned>(nblk), dense::kBlock, 0, s>>>(
        in, sums, nblk);
    dense::scan_totals<<<1, dense::kScanThreads, 0, s>>>(sums, nblk);
    fused_tile<<<static_cast<unsigned>(n / kTile), dense::kBlock, kSharedBytes, s>>>(
        in, static_cast<int64_t>(n), threshold, cap, l_row, seg_stride, seg_valid, scan_limit,
        sums, nblk, static_cast<int32_t*>(comb), static_cast<int32_t*>(offsets),
        static_cast<uint8_t*>(live), static_cast<int32_t*>(meta),
        static_cast<int32_t*>(cs_hi), static_cast<int32_t*>(cs_lo));
    return static_cast<int>(cudaGetLastError());
}
