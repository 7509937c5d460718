// Per-phase gate classification for Hopper (sm_90a): the flag word that
// the TPU kernels extract_classify_v3_pallas and extract_classify_pallas
// put in lanes 83:88 (readsb_tpu/ops/pallas_kernels.py::_classify_block
// :762), the post step of extract.cuh's cand_rows for extract_classify_v3.cu
// and extract_classify.cu.
//
//   1  in_t112  syn112 in the nfix-bit error table of 112-bit messages
//   2  in_t56   syn56 in the error table of 56-bit messages
//   4  in_tbl   CRC residual in the known-ICAO table
//   8  fix_ok   1-bit-damaged DF17: df in (1, 25, 21, 19, 16) and syn112
//               equal to that df's delta syndrome
//  16  zero7    message bytes 0..6 all zero
//
// The TPU kernel compares each value against every table entry, which is
// free on its vector unit.  Here the threads of a warp hold different
// keys, so each searches the sorted tables (ascending, sentinel-padded at
// the end).  A lane holds its candidate's five phases at once, so it runs
// the five searches of a table in lock-step: the steps depend on the
// table's length only, so a warp does not diverge, and every step has five
// independent loads in flight.  The tables that fit beside cand_rows' own
// shared memory with two blocks per SM (kSharedMax) are staged there per
// block; the others (nfix = 2: 3,840 and 1,408 entries; large known
// tables) are read through L1 from global memory.

#pragma once

#include <cstdint>

#include "extract.cuh"

namespace classify {

constexpr int kFlagLane = 83;
constexpr int kDfd = 12;  // words of Tables::dfd

struct Tables {
    const int32_t* known;  // sorted known-ICAO addresses, padded with 0x1000000
    int n_known;
    const int32_t* t112;   // sorted syndromes, padded with 0x2000000
    int n112;
    const int32_t* t56;
    int n56;
    // int32[12]: 0..4 DF17-fixable delta syndromes, 5..9 their df values,
    // 10 = nfix > 0, 11 = fix_df and nfix > 0
    const int32_t* dfd;
};

// Bit i set where x[i] is in the sorted table t[0:n], n >= 1.  Each key's
// lower bound is narrowed by halving with a select, not a branch (Khuong
// and Morin, 2017): ceil(log2 n) steps of one load each, the same count
// for every key and lane.
__device__ __forceinline__ uint32_t contains5(const int32_t* t, int n,
                                              const int32_t (&x)[extract::kPhases]) {
    int at[extract::kPhases] = {0, 0, 0, 0, 0};
    for (int len = n; len > 1;) {
        const int half = len >> 1;
#pragma unroll
        for (int i = 0; i < extract::kPhases; ++i) at[i] = t[at[i] + half - 1] < x[i] ? at[i] + half : at[i];
        len -= half;
    }
    uint32_t found = 0u;
#pragma unroll
    for (int i = 0; i < extract::kPhases; ++i) {
        // the lower bound is at[i] or at[i] + 1
        const int lb = at[i] + (t[at[i]] < x[i] ? 1 : 0);
        found |= static_cast<uint32_t>(lb < n && t[lb] == x[i]) << i;
    }
    return found;
}

// extract::cand_rows's post step: lanes 83:88 of the candidate's output row.
struct Post {
    static constexpr int kLanes = kFlagLane + extract::kPhases;
    static constexpr size_t kSharedMax = 6144;  // 2 x (109,568 + 6,144 + 1,024) = 228 KB
    Tables t;
    int staged;  // bit 0: t112, bit 1: t56, bit 2: known are staged per block

    // The tables as the launch hands them over: dfd always staged, then
    // t112, t56 and known, each where it still fits in kSharedMax.
    static Post make(const Tables& t) {
        Post p{t, 0};
        size_t words = kDfd;
        const int sizes[3] = {t.n112, t.n56, t.n_known};
        for (int i = 0; i < 3; ++i) {
            if (4 * (words + sizes[i]) <= kSharedMax) {
                words += sizes[i];
                p.staged |= 1 << i;
            }
        }
        return p;
    }

    size_t shared_bytes() const {
        size_t words = kDfd;
        if (staged & 1) words += t.n112;
        if (staged & 2) words += t.n56;
        if (staged & 4) words += t.n_known;
        return (4 * words + 15) / 16 * 16;
    }

    // Copy the staged tables into the block's shared memory at `sh` (every
    // thread takes part; the caller synchronises) and point at them.
    __device__ __forceinline__ Post stage(uint4* sh) const {
        Post p = *this;
        int32_t* d = reinterpret_cast<int32_t*>(sh);
        auto copy = [&](const int32_t*& table, int n) {
            for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = __ldg(table + i);
            table = d;
            d += n;
        };
        copy(p.t.dfd, kDfd);
        if (staged & 1) copy(p.t.t112, p.t.n112);
        if (staged & 2) copy(p.t.t56, p.t.n56);
        if (staged & 4) copy(p.t.known, p.t.n_known);
        return p;
    }

    __device__ __forceinline__ void operator()(const extract::Phase (&r)[extract::kPhases],
                                               int32_t* o) const {
        int32_t s112[extract::kPhases], s56[extract::kPhases], resid[extract::kPhases];
#pragma unroll
        for (int i = 0; i < extract::kPhases; ++i) {
            s112[i] = static_cast<int32_t>(r[i].syn112);
            s56[i] = static_cast<int32_t>(r[i].syn56);
            resid[i] = ((r[i].byte0 >> 3) >= 16 ? s112[i] : s56[i]) & 0xFFFFFF;
        }
        const bool have_tab = t.dfd[10] != 0;
        const bool have_fix = t.dfd[11] != 0;
        const uint32_t in_t112 = have_tab ? contains5(t.t112, t.n112, s112) : 0u;
        const uint32_t in_t56 = have_tab ? contains5(t.t56, t.n56, s56) : 0u;
        const uint32_t in_tbl = contains5(t.known, t.n_known, resid);
#pragma unroll
        for (int i = 0; i < extract::kPhases; ++i) {
            const int32_t df = static_cast<int32_t>(r[i].byte0 >> 3);
            bool fix_ok = false;
            if (have_fix) {
#pragma unroll
                for (int f = 0; f < 5; ++f) fix_ok |= (df == t.dfd[5 + f]) && (s112[i] == t.dfd[f]);
            }
            o[kFlagLane + i] = static_cast<int32_t>((in_t112 >> i) & 1u)
                             | static_cast<int32_t>(((in_t56 >> i) & 1u) << 1)
                             | static_cast<int32_t>(((in_tbl >> i) & 1u) << 2)
                             | (static_cast<int32_t>(fix_ok) << 3)
                             | (static_cast<int32_t>(r[i].low7 == 0u) << 4);
        }
    }
};

// The C entry point of both classifying libraries: rows int32[K,128],
// offsets int32[K], the known table and gate_tables_np's t112 / t56 / dfd,
// out int32[K,128].  After prepare<Post>.  Returns the first CUDA error.
inline int launch(const void* rows, const void* offsets, long long k, const void* known,
                  int n_known, const void* t112, int n112, const void* t56, int n56,
                  const void* dfd, void* out, void* stream) {
    const Post post = Post::make({
        static_cast<const int32_t*>(known), n_known,
        static_cast<const int32_t*>(t112), n112,
        static_cast<const int32_t*>(t56), n56,
        static_cast<const int32_t*>(dfd),
    });
    return extract::launch_rows(rows, offsets, k, out, post, stream);
}

}  // namespace classify
