// Fused UC8 convert + dense scan for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/pallas_kernels.py::dense_scan_uc8_pallas (:400;
// kernel bodies _dense_scan_uc8_kernel :247, _uc8_mag_i32 :232,
// _dense_body :264).  The body, its bound and its design are in
// dense_scan.cuh; this file instantiates it with the UC8 loader: the
// input is uint16 words, one interleaved uc8 I/Q pair per sample, and the
// magnitude array never exists in device memory.  Samples past n read as
// word 0, a full-scale magnitude.

#include "dense_scan.cuh"

extern "C" int rtpu_init(int* device) {
    return rtpu::init(device, [](int) { return dense::prepare<dense::Uc8Loader>(); });
}

// The fi^2 table, float32[256]; once per device, before the first launch there.
extern "C" int rtpu_dense_set_table(const void* sq) { return dense::set_sq_table(sq); }

// n % 8192 == 0 (the wrapper asks for n % 65536 == 0); scratch holds
// dense::kHead + 6 * n / 8192 uint32.  Returns the first CUDA error.
extern "C" int dense_scan_uc8(const void* words, long long n, int threshold,
                              void* corr, void* pwords, void* cs_hi, void* cs_lo,
                              void* scratch, void* stream) {
    return dense::launch<dense::Uc8Loader>(words, n, threshold, corr, pwords, cs_hi, cs_lo,
                                           scratch, stream);
}
