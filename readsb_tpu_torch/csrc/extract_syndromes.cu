// Per-candidate bit extraction + CRC-24 syndromes for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/pallas_kernels.py::extract_syndromes_pallas
// (:579; kernel body _extract_kernel :514).  Contract
// (readsb_tpu_torch/ops/kernels.py::extract_syndromes):
//
//   rows     int32[K,128]  candidate win rows (ops/demod.py::win_rows)
//   offsets  int32[K]      candidate scan offsets
//   out      int32[K,128]  lanes 0:5 syn112, 5:10 syn56, 10:80 message bytes
//                          (phase-major, 14 per phase), 80:83 correlation
//                          bits, 83:128 zero
//
// Bound on the H100: memory.  The function moves 1028 B per candidate
// (a 512 B row and a 4 B offset in, a 512 B row out) against ~5 x 112
// bit picks and 5 x 21 table reads.  The design is extract.cuh's cand_rows
// (one lane per candidate and all five phases, rows staged per warp with
// 16-byte accesses, the tap schedule fixed at compile time, syndromes by
// bytes) with nothing after the slice.  The window alignment by
// offset & 255 is a word offset (s >> 5) plus a funnel shift (s & 31).

#include "extract.cuh"

extern "C" int rtpu_init(int* device) {
    return rtpu::init(device, extract::prepare<extract::NoPost>);
}

extern "C" int rtpu_extract_set_tables(const void* syn_bytes) {
    return extract::set_tables(syn_bytes);
}

extern "C" int extract_syndromes(const void* rows, const void* offsets, long long k,
                                 void* out, void* stream) {
    return extract::launch_rows(rows, offsets, k, out, extract::NoPost{}, stream);
}
