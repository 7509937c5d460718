// Per-candidate extraction fused with the gate's per-phase classification
// for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/pallas_kernels.py::extract_classify_v3_pallas
// (:847; kernel body _extract_kernel_v3 :803, classifier _classify_block
// :762).  Contract (readsb_tpu_torch/ops/kernels.py::extract_classify_v3):
//
//   rows     int32[K,128]  candidate win rows (ops/demod.py::win_rows)
//   offsets  int32[K]      candidate scan offsets
//   known    int32[T]      sorted known-ICAO addresses, sentinel-padded
//   t112/t56/dfd           the static tables of ops/gate.py::gate_tables_np
//   out      int32[K,128]  lanes 0:83 as extract_syndromes, 83:88 the
//                          per-phase flag word (classify.cuh), 88:128 zero
//
// Bound on the H100: memory, 1028 B per candidate as extract_syndromes;
// the tables are read from shared memory or cache.  The TPU kernel is its
// v1 extraction plus a classification block, and so is this one:
// extract.cuh's cand_rows (one lane per candidate, all five phases) with
// classify::Post after the five slices.  There a lane already holds the
// phases' syn112, syn56 and first message bytes in registers, so the flag
// words cost three lock-step searches of five keys (<= 12 steps each at
// nfix = 2) and no memory traffic of their own.

#include "classify.cuh"

extern "C" int rtpu_init(int* device) {
    return rtpu::init(device, extract::prepare<classify::Post>);
}

extern "C" int rtpu_extract_set_tables(const void* syn_bytes) {
    return extract::set_tables(syn_bytes);
}

extern "C" int extract_classify_v3(const void* rows, const void* offsets, long long k,
                                   const void* known, int n_known,
                                   const void* t112, int n112,
                                   const void* t56, int n56, const void* dfd,
                                   void* out, void* stream) {
    return classify::launch(rows, offsets, k, known, n_known, t112, n112, t56, n56, dfd, out,
                            stream);
}
