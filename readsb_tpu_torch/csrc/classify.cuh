// Per-phase gate classification for Hopper (sm_90a): the flag word that
// the TPU kernels extract_classify_v3_pallas and extract_classify_pallas
// put in lanes 83:88 (readsb_tpu/ops/pallas_kernels.py::_classify_block
// :762), shared by extract_classify_v3.cu and extract_classify.cu.
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
// keys, so each does a binary search in global memory: the tables are
// sorted ascending (sentinel-padded at the end) and small enough (<= 32 KB
// for nfix = 2) to stay in L1/L2.  __constant__ memory would serialize the
// divergent reads.

#pragma once

#include <cstdint>

#include "extract.cuh"

namespace classify {

constexpr int kFlagLane = 83;

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

__device__ __forceinline__ bool contains(const int32_t* __restrict__ t, int n, int32_t x) {
    int lo = 0, hi = n;  // first index with t[i] >= x
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(t + mid) < x) lo = mid + 1; else hi = mid;
    }
    return lo < n && __ldg(t + lo) == x;
}

__device__ __forceinline__ int32_t flags(const Tables& t, const extract::Phase& r) {
    const int32_t s112 = static_cast<int32_t>(r.syn112);
    const int32_t s56 = static_cast<int32_t>(r.syn56);
    const int32_t df = static_cast<int32_t>(r.byte0 >> 3);
    const bool have_tab = __ldg(t.dfd + 10) != 0;
    const bool have_fix = __ldg(t.dfd + 11) != 0;
    const bool in_t112 = have_tab && contains(t.t112, t.n112, s112);
    const bool in_t56 = have_tab && contains(t.t56, t.n56, s56);
    const int32_t resid = (df >= 16 ? s112 : s56) & 0xFFFFFF;
    const bool in_tbl = contains(t.known, t.n_known, resid);
    bool fix_ok = false;
    if (have_fix) {
#pragma unroll
        for (int i = 0; i < 5; ++i)
            fix_ok |= (df == __ldg(t.dfd + 5 + i)) && (s112 == __ldg(t.dfd + i));
    }
    const bool zero7 = r.low7 == 0u;
    return static_cast<int32_t>(in_t112) | (static_cast<int32_t>(in_t56) << 1)
         | (static_cast<int32_t>(in_tbl) << 2) | (static_cast<int32_t>(fix_ok) << 3)
         | (static_cast<int32_t>(zero7) << 4);
}

// extract::cand_rows's post step: lane 83 + ph of the candidate's output row.
struct Post {
    static constexpr int kLanes = kFlagLane + extract::kPhases;
    Tables t;
    __device__ __forceinline__ void operator()(int ph, const extract::Phase& r,
                                               int32_t* o) const {
        o[kFlagLane + ph] = flags(t, r);
    }
};

}  // namespace classify
