// Dense scan -> compaction -> extraction per 65536-sample tile, one cluster
// of eight blocks per tile, for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/fused.py::fused_demod_tiles (:304; kernel body
// _fused_body :91).  Contract (readsb_tpu_torch/ops/fused.py):
//
//   mag      uint16[n]          magnitudes of T = n / 65536 tiles, n = 65536 T
//                               or 65536 T + 1024 (the last tile's halo),
//                               16-byte aligned
//   comb     int32[T*cap,128]   per row the lanes of extract_syndromes
//   offsets  int32[T*cap]       tile_base + offset of a live row, else the
//                               tile's end (the list is nondecreasing)
//   live     uint8[T*cap]       1 for the first min(count, cap) candidates of
//                               the tile whose rank within their 128-sample
//                               row is below l_row
//   meta     int32[T,3]         candidates in the tile, most in a
//                               256-sample block, most in a 128-sample row
//   cs_hi/lo int32[n]           the split mag^2 prefix sums of dense_scan.cuh
//   scratch  uint32[kHead + 6 * n / 8192]  ticket, flags and sums
//
// A row that is not live holds the extraction at the tile's offset 0, as
// in the TPU kernel.  A candidate is a sample with the pre-check and any
// correlation set, below scan_limit and, with seg_stride > 0, with
// (pos % seg_stride) < seg_valid.
//
// Bound on the H100: memory (2 B/sample in, 8 B/sample of prefix sums and
// 516 B per row out).  The staged route's intermediates (correlation bits,
// plane words, win rows, gathered rows) never reach device memory.  What
// the TPU kernel computes is kept, not how: its one-hot gather products,
// triangular-product prefixes and per-row select loops answer constraints
// this card does not have.  Design:
//   * A tile is a cluster of 8 blocks of 256 threads; block (rank) r takes
//     the 8192-sample sub-tile 8 t + r with dense_scan.cuh's body: the
//     sub-tile and 384 samples past it staged once with 16-byte loads,
//     32 samples per thread, sign planes formed as sign bits.  So 8 T
//     blocks, and no block walks a tile alone.  Three are resident per SM
//     (73 KB of shared memory and at most 80 registers each; ptxas spills a
//     few bytes to get there), so one block's stores overlap another's
//     arithmetic; at two per SM (128 registers) it was slower on the card.
//   * The 14 KB byte-syndrome table is copied with cp.async while the
//     sub-tile loads.  The staged samples' buffer then holds the candidate
//     list, and the sums' staging buffer the sliced rows.
//   * Planes and correlation bits stay in the block's shared memory.  A
//     window reaches 10 plane words past its sub-tile (the taps of
//     extract_taps.cuh reach sample 287, plus a 31-bit shift); ten threads
//     form those words from the staged samples, so no block reads its
//     neighbour's planes.
//   * Compaction: a block counts its candidates per thread, per 128-sample
//     row (4 threads) and per 256-sample block (8 threads), all local, and
//     lists its candidates in rank order with their live bit.  After a
//     cluster barrier a block reads the lower ranks' counts through
//     distributed shared memory: the sum is its first row.  Rank 0 writes
//     meta.
//   * Extraction of live rows only, by extract.cuh's lane-per-candidate
//     datapath: a 45-word window aligned from the shared planes, the taps
//     fixed at compile time, syndromes by bytes; warps 0-2 slice and stage
//     the rows (odd stride), then write them coalesced.  Every other row of
//     a tile is the extraction at the tile's offset 0: rank 0 slices it once
//     (five warps, a phase each) before the barrier, the other ranks copy
//     it through distributed shared memory, and warps 3-7 write it with
//     16-byte stores to the block's dead rows and its share of the rows
//     from min(count, cap) to cap.
//   * Prefix sums in the same pass by dense_scan.cuh's decoupled look-back
//     over sub-tiles.  Rank 0 takes the tile from an atomic ticket and the
//     cluster shares it, so sub-tile 8 t + r looks back only on blocks of
//     its own cluster (co-scheduled) and of earlier tickets (started); a
//     block publishes its aggregate before any barrier.  With the 1024-
//     sample halo in the buffer the last sub-tile also scans the halo.
//   * One cudaMemsetAsync of the ticket and flags, then one cluster launch.
//   * No block exits while a peer may read its shared memory: the kernel
//     ends on a cluster barrier.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "dense_scan.cuh"
#include "extract.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRanks = 8;                         // blocks per tile (cluster)
constexpr int kTile = kRanks * dense::kTile;      // 65536 samples
constexpr int kSub = dense::kTile;                // 8192 samples per block
constexpr int kThreads = dense::kThreads;         // 256
constexpr int kWords = kSub / 32;                 // 256 plane words per sub-tile
constexpr int kHaloWords = 10;                    // plane words a window reads past it
constexpr int kPW = kWords + kHaloWords + 2;      // plane stride (keeps the dead row aligned)
constexpr int kStageChunks = dense::kTileChunks + 48;  // 8576 samples: halo words + 19
constexpr int kDenseChunks = kStageChunks + dense::kOutChunks;
constexpr int kTableChunks = extract::kMsgBytes * 256 / 4;
constexpr int kSliceWarps = 3;                    // warps 0-2 slice, 3-7 copy dead rows
constexpr int kOutStride = extract::kUsedLanes;   // 83: odd, so no bank conflicts
constexpr unsigned kLive = 1u << 15;              // list entry: offset | live << 15
constexpr size_t kSharedBytes =
    16 * (kTableChunks + kDenseChunks) + 4 * (5 * kPW + 3 * kWords) + 4 * extract::kLanes;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kStageChunks % 8 == 0, "sw_mag stays inside groups of 8 chunks");
static_assert(4 * (kWords + kHaloWords - 1) + 7 <= kStageChunks, "halo words past the stage");
static_assert((kPW * 5 + 3 * kWords) % 4 == 0, "the dead row is 16-byte aligned");
static_assert(2 * kSub <= 16 * kStageChunks, "the list fits where the tile was staged");
static_assert(kSliceWarps * 32 * kOutStride * 4 <= 16 * dense::kOutChunks,
              "the sliced rows fit where the sums were staged");

__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads, 3) fused_tile(
    const uint16_t* __restrict__ in, int64_t n, int thr, int cap, int l_row,
    int seg_stride, int seg_valid, int scan_limit, uint32_t* __restrict__ scratch,
    int32_t* __restrict__ comb, int32_t* __restrict__ offsets, uint8_t* __restrict__ live,
    int32_t* __restrict__ meta, int32_t* __restrict__ cs_hi, int32_t* __restrict__ cs_lo) {
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ uint4 smem[];
    uint4* tbl4 = smem;  // the byte-syndrome table, copied while the tile loads
    const uint32_t* tbl = reinterpret_cast<const uint32_t*>(tbl4);
    // the dense phase: staged magnitudes and the output staging of the sums;
    // once the samples are in registers the first holds the candidate list
    // and once the sums are out the second the slicing warps' output rows
    uint4* mag4 = smem + kTableChunks;
    uint4* out4 = mag4 + kStageChunks;
    uint16_t* list = reinterpret_cast<uint16_t*>(mag4);              // [kSub] candidates
    int32_t* rows_sh = reinterpret_cast<int32_t*>(out4);
    uint32_t* pw = reinterpret_cast<uint32_t*>(out4 + dense::kOutChunks);  // [5][kPW] planes
    uint32_t* cr = pw + 5 * kPW;                                      // [3][kWords] corr
    int32_t* dead = reinterpret_cast<int32_t*>(cr + 3 * kWords);     // [128] the dead row
    __shared__ uint32_t wsum[3][kThreads / 32];
    __shared__ int wmax[2][kThreads / 32];
    __shared__ uint32_t tile_sh, ex_sh[2];
    __shared__ int stat_sh[3];  // this block's candidates, most per block, most per row
    __shared__ int first_sh, count_sh;

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int rank = static_cast<int>(cluster.block_rank());
    const int64_t nsub = n / kSub;
    uint32_t* flags = scratch + dense::kHead;
    uint2* agg = reinterpret_cast<uint2*>(scratch + dense::kHead + nsub + (nsub & 1));
    uint2* prefix = agg + nsub;

    if (rank == 0 && t == 0) tile_sh = atomicAdd(scratch, 1u);
    cluster.sync();
    if (rank != 0 && t == 0) tile_sh = *cluster.map_shared_rank(&tile_sh, 0u);
    __syncthreads();
    const int64_t tile = tile_sh;
    const int64_t sub = tile * kRanks + rank;
    const int64_t base = sub * kSub;
    const int64_t row0 = tile * cap;  // the tile's first output row
    const int32_t tile_end = static_cast<int32_t>((tile + 1) * kTile);

    // ---- stage the sub-tile and 384 samples past it (0 past n) ----------------
    for (int i = t; i < kTableChunks; i += kThreads)
        __pipeline_memcpy_async(tbl4 + i, reinterpret_cast<const uint4*>(extract::g_syn_bytes) + i, 16);
    __pipeline_commit();
    {
        const uint4* in4 = reinterpret_cast<const uint4*>(in + base);
        const int64_t avail = (n - base) / 8;  // n % 8 == 0
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        uint4 v[dense::kTileChunks / kThreads];
#pragma unroll
        for (int i = 0; i < dense::kTileChunks / kThreads; ++i) v[i] = __ldg(in4 + t + i * kThreads);
        const int c_extra = dense::kTileChunks + t;
        uint4 h = zero;
        if (c_extra < kStageChunks && c_extra < avail) h = __ldg(in4 + c_extra);
#pragma unroll
        for (int i = 0; i < dense::kTileChunks / kThreads; ++i) mag4[dense::sw_mag(t + i * kThreads)] = v[i];
        if (c_extra < kStageChunks) mag4[dense::sw_mag(c_extra)] = h;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // ---- dense math: planes, correlation bits, candidates, sums ----------------
    if (t < kHaloWords) {  // the plane words past the sub-tile
        uint32_t m2[28], pl[5], hi, lo;
        dense::load_thread(mag4, kWords + t, m2);
        dense::scan_samples(m2, thr, pl, hi, lo, [](int, bool, bool, bool, bool) {});
#pragma unroll
        for (int q = 0; q < 5; ++q) pw[q * kPW + kWords + t] = pl[q];
    }
    uint32_t m2[28];
    dense::load_thread(mag4, t, m2);
    uint32_t pl[5], hi, lo, ca = 0u, cb = 0u, cc = 0u, cm = 0u;
    dense::scan_samples(m2, thr, pl, hi, lo, [&](int j, bool a, bool b, bool c, bool cand) {
        ca |= static_cast<uint32_t>(a) << j;
        cb |= static_cast<uint32_t>(b) << j;
        cc |= static_cast<uint32_t>(c) << j;
        cm |= static_cast<uint32_t>(cand) << j;
    });
#pragma unroll
    for (int q = 0; q < 5; ++q) pw[q * kPW + t] = pl[q];
    cr[t] = ca;
    cr[kWords + t] = cb;
    cr[2 * kWords + t] = cc;

    // candidates below scan_limit and inside a channel's valid samples
    const int64_t pos0 = base + 32 * t;
    if (pos0 + 32 > scan_limit)
        cm &= pos0 >= scan_limit ? 0u : (1u << (scan_limit - pos0)) - 1u;
    if (seg_stride > 0) {
        uint32_t keep = 0u;
        int r = static_cast<int>(pos0 % seg_stride);  // then stepped, not divided
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            keep |= static_cast<uint32_t>(r < seg_valid) << j;
            r = r + 1 == seg_stride ? 0 : r + 1;
        }
        cm &= keep;
    }

    // counts: per thread, per 128-sample row (4 threads), per 256-sample
    // block (8 threads), and this thread's rank base within the sub-tile
    const uint32_t cnt = __popc(cm);
    uint32_t row_inc = cnt;
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
        const uint32_t u = __shfl_up_sync(kFull, row_inc, d, 4);
        if ((lane & 3) >= d) row_inc += u;
    }
    const uint32_t row_tot = __shfl_sync(kFull, row_inc, 3, 4);
    const uint32_t blk_tot = row_tot + __shfl_xor_sync(kFull, row_tot, 4);
    const int row_max = static_cast<int>(__reduce_max_sync(kFull, row_tot));
    const int blk_max = static_cast<int>(__reduce_max_sync(kFull, blk_tot));
    const uint32_t ih = dense::warp_inclusive_scan(hi), il = dense::warp_inclusive_scan(lo);
    const uint32_t ic = dense::warp_inclusive_scan(cnt);
    if (lane == 31) {
        wsum[0][warp] = ih;
        wsum[1][warp] = il;
        wsum[2][warp] = ic;
        wmax[0][warp] = blk_max;
        wmax[1][warp] = row_max;
    }
    __syncthreads();  // planes, corr bits and the warps' sums are in shared memory
    uint32_t oh = ih - hi, ol = il - lo, oc = ic - cnt, th = 0u, tl = 0u, tc = 0u;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
        const uint32_t a = wsum[0][i], b = wsum[1][i], c = wsum[2][i];
        if (i < warp) {
            oh += a;
            ol += b;
            oc += c;
        }
        th += a;
        tl += b;
        tc += c;
    }

    if (warp == 0) {
        // the aggregate is published before any cluster barrier below
        const uint2 ex = dense::publish_and_look_back(flags, agg, prefix, sub, th, tl);
        if (lane == 0) {
            ex_sh[0] = ex.x;
            ex_sh[1] = ex.y;
            int mb = 0, mr = 0;
#pragma unroll
            for (int i = 0; i < kThreads / 32; ++i) {
                mb = wmax[0][i] > mb ? wmax[0][i] : mb;
                mr = wmax[1][i] > mr ? wmax[1][i] : mr;
            }
            stat_sh[0] = static_cast<int>(tc);
            stat_sh[1] = mb;
            stat_sh[2] = mr;
        }
    } else if (rank == 0 && warp <= extract::kPhases) {
        // the tile's dead row: the extraction at its offset 0, warps 1-5 a
        // phase each, warp 6 the correlation bits and the zero lanes
        if (lane == 0) {
            extract::Window w;
            extract::align_window(w, pw, kPW, 0u);
            switch (warp) {
                case 1: extract::slice<0>(w, tbl, dead); break;
                case 2: extract::slice<1>(w, tbl, dead); break;
                case 3: extract::slice<2>(w, tbl, dead); break;
                case 4: extract::slice<3>(w, tbl, dead); break;
                default: extract::slice<4>(w, tbl, dead); break;
            }
        }
    } else if (rank == 0 && warp == extract::kPhases + 1) {
        for (int l = extract::kCorrLane + lane; l < extract::kLanes; l += 32)
            dead[l] = l < extract::kUsedLanes
                          ? static_cast<int32_t>((cr[(l - extract::kCorrLane) * kWords] & 1u))
                          : 0;
    }

    // this sub-tile's candidates in rank order: offset | live << 15
    {
        uint32_t m = cm;
        uint32_t i = oc, in_row = row_inc - cnt;
        while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1u;
            list[i++] = static_cast<uint16_t>((32 * t + j) | (in_row < static_cast<uint32_t>(l_row) ? kLive : 0u));
            ++in_row;
        }
    }
    cluster.sync();  // counts, the dead row and the lists are published

    // ---- the tile: first row of this block, meta, the dead row -----------------
    if (t < kRanks) {
        const int* peer = cluster.map_shared_rank(&stat_sh[0], static_cast<unsigned>(t));
        const int c = peer[0];
        const int below = __reduce_add_sync(0xffu, t < rank ? c : 0);
        const int total = __reduce_add_sync(0xffu, c);
        const int mb = __reduce_max_sync(0xffu, peer[1]);
        const int mr = __reduce_max_sync(0xffu, peer[2]);
        if (t == 0) {
            first_sh = below;
            count_sh = total;
            if (rank == 0) {
                meta[tile * 3 + 0] = total;
                meta[tile * 3 + 1] = mb;
                meta[tile * 3 + 2] = mr;
            }
        }
    }
    if (rank != 0 && t < extract::kLanes) dead[t] = cluster.map_shared_rank(dead + 0, 0u)[t];

    // ---- the two prefix sums (the stage buffer is free after this) -------------
    dense::store_prefix_sums(out4, m2, oh + ex_sh[0], ol + ex_sh[1], cs_hi + base, cs_lo + base);

    // ---- rows: live ones sliced, the others copies of the dead row -------------
    const int first = first_sh;
    const int total = count_sh;
    const int cnt_here = static_cast<int>(stat_sh[0]);
    const int nrows = cap - first < cnt_here ? (cap - first > 0 ? cap - first : 0) : cnt_here;
    if (warp < kSliceWarps) {
        int32_t* o = rows_sh + (warp * 32 + lane) * kOutStride;
        for (int g0 = warp * 32; g0 < nrows; g0 += kSliceWarps * 32) {
            const int i = g0 + lane;
            const uint32_t e = i < nrows ? list[i] : 0u;
            const bool lv = (e & kLive) != 0u;
            const int ol_s = static_cast<int>(e & (kLive - 1u));
            if (lv) {
                const int w0 = ol_s >> 5;
                const unsigned sb = ol_s & 31;
                extract::Window w;
                extract::align_window(w, pw + w0, kPW, sb);
                const uint32_t corr = ((cr[w0] >> sb) & 1u) | (((cr[kWords + w0] >> sb) & 1u) << 1)
                                    | (((cr[2 * kWords + w0] >> sb) & 1u) << 2);
                extract::Phase ph[extract::kPhases];
                extract::slice_all(w, corr, tbl, o, ph);
            }
            if (i < nrows) {
                const int64_t row = row0 + first + i;
                offsets[row] = lv ? static_cast<int32_t>(base + ol_s) : tile_end;
                live[row] = lv ? 1 : 0;
            }
            __syncwarp();
            for (unsigned m = __ballot_sync(kFull, lv); m; m &= m - 1u) {
                const int r = __ffs(m) - 1;
                int32_t* dst = comb + (row0 + first + g0 + r) * extract::kLanes;
                const int32_t* src = rows_sh + (warp * 32 + r) * kOutStride;
#pragma unroll
                for (int k = 0; k < extract::kLanes / 32; ++k) {
                    const int l = lane + 32 * k;
                    dst[l] = l < kOutStride ? src[l] : 0;
                }
            }
            __syncwarp();
        }
    } else {
        const uint4 d4 = reinterpret_cast<const uint4*>(dead)[lane];
        const int wd = warp - kSliceWarps;
        for (int i = wd; i < nrows; i += kThreads / 32 - kSliceWarps) {
            if (!(list[i] & kLive))
                reinterpret_cast<uint4*>(comb + (row0 + first + i) * extract::kLanes)[lane] = d4;
        }
        // rows past the tile's candidates: row j goes to rank j % 8
        const int past = total < cap ? total : cap;
        const int step = kRanks * (kThreads / 32 - kSliceWarps);
        for (int j = past + ((rank - past % kRanks + kRanks) % kRanks) + kRanks * wd; j < cap;
             j += step) {
            reinterpret_cast<uint4*>(comb + (row0 + j) * extract::kLanes)[lane] = d4;
            if (lane == 0) {
                offsets[row0 + j] = tile_end;
                live[row0 + j] = 0;
            }
        }
    }

    // ---- the last tile's 1024-sample halo: its prefix sums ---------------------
    if (sub == nsub - 1 && n > nsub * kSub) {
        const int64_t h0 = nsub * kSub + 4 * t;  // 256 threads x 4 samples
        uint32_t sh[4], sl[4], a = 0u, b = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t s = in[h0 + i];
            a += (s * s) >> 16;
            b += (s * s) & 0xffffu;
            sh[i] = a;
            sl[i] = b;
        }
        const uint32_t wa = dense::warp_inclusive_scan(a), wb = dense::warp_inclusive_scan(b);
        __syncthreads();  // wsum is free
        if (lane == 31) {
            wsum[0][warp] = wa;
            wsum[1][warp] = wb;
        }
        __syncthreads();
        uint32_t ea = wa - a + ex_sh[0] + th, eb = wb - b + ex_sh[1] + tl;
        for (int i = 0; i < warp; ++i) {
            ea += wsum[0][i];
            eb += wsum[1][i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            cs_hi[h0 + i] = static_cast<int32_t>(ea + sh[i]);
            cs_lo[h0 + i] = static_cast<int32_t>(eb + sl[i]);
        }
    }
    cluster.sync();  // no block leaves while a peer may read its shared memory
}

}  // namespace

extern "C" int rtpu_init(int* device) {
    return rtpu::init(device, [](int) {
        cudaError_t e = cudaFuncSetAttribute(fused_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kSharedBytes));
        if (e != cudaSuccess) return e;
        // a cluster of eight blocks must fit the card at this shared-memory size
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(kRanks, 1, 1);
        cfg.blockDim = dim3(kThreads, 1, 1);
        cfg.dynamicSmemBytes = kSharedBytes;
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, fused_tile, &cfg);
        if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
        return e;
    });
}

extern "C" int rtpu_extract_set_tables(const void* syn_bytes) {
    return extract::set_tables(syn_bytes);
}

// The memset of the ticket and the flags, then the cluster launch, on one
// stream (after rtpu_init).  n = 65536 T or 65536 T + 1024, n < 2^31;
// seg_stride == 0 means no channel layout.  Returns the first CUDA error.
extern "C" int fused_demod(const void* mag, long long n, int threshold, int cap, int l_row,
                           int seg_stride, int seg_valid, int scan_limit,
                           void* comb, void* offsets, void* live, void* meta,
                           void* cs_hi, void* cs_lo, void* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long nsub = n / kSub;
    cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * (dense::kHead + nsub), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_tile<<<static_cast<unsigned>(nsub), kThreads, kSharedBytes, s>>>(
        static_cast<const uint16_t*>(mag), static_cast<int64_t>(n), threshold, cap, l_row,
        seg_stride, seg_valid, scan_limit, static_cast<uint32_t*>(scratch),
        static_cast<int32_t*>(comb), static_cast<int32_t*>(offsets),
        static_cast<uint8_t*>(live), static_cast<int32_t*>(meta),
        static_cast<int32_t*>(cs_hi), static_cast<int32_t*>(cs_lo));
    return static_cast<int>(cudaGetLastError());
}
