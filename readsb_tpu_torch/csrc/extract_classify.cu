// Per-candidate extraction + gate classification for Hopper (sm_90a), the
// function of the plan-order datapath.
//
// Replaces readsb_tpu/ops/pallas_kernels.py::extract_classify_pallas
// (:928; kernel body _extract_kernel_v2 :710, plan
// readsb_tpu/ops/demod.py::_extract_plan :173).  Contract
// (readsb_tpu_torch/ops/kernels.py::extract_classify): the inputs and the
// int32[K,128] output of extract_classify_v3.cu, bit for bit.
//
// The two TPU kernels compute one function by two datapaths (v3: unpack
// every window bit, one product; this one: 560 static (word, shift) picks
// in plan order, the emission lanes grouped by (plane, word) so that the
// TPU's lanes take one window word each).  Both orders pick the same 560
// (phase, bit) -> (plane, sample) taps (tests/test_torch_classify.py holds
// the plan to csrc/extract_taps.cuh), and on this card the order of the
// picks is free: a lane holds its candidate's whole window in registers,
// and each pick is a shift and a mask by immediates in either order.  So
// this kernel is extract_classify_v3's: extract.cuh's cand_rows, one lane
// per candidate, with classify::Post.  It keeps its own library and entry
// point, as the TPU kernel is a function of its own.
//
// Bound on the H100: memory, 1028 B per candidate.

#include "classify.cuh"

extern "C" int rtpu_init(int* device) {
    return rtpu::init(device, extract::prepare<classify::Post>);
}

extern "C" int rtpu_extract_set_tables(const void* syn_bytes) {
    return extract::set_tables(syn_bytes);
}

extern "C" int extract_classify(const void* rows, const void* offsets, long long k,
                                const void* known, int n_known,
                                const void* t112, int n112,
                                const void* t56, int n56, const void* dfd,
                                void* out, void* stream) {
    return classify::launch(rows, offsets, k, known, n_known, t112, n112, t56, n56, dfd, out,
                            stream);
}
