// Dense scan of uint16 magnitudes for Hopper (sm_90a).
//
// Replaces readsb_tpu/ops/pallas_kernels.py::dense_scan_pallas (:335;
// kernel bodies _dense_scan_kernel :217, _dense_body :264).  The body, its
// bound (memory: 11.625 B per sample) and its design are in
// dense_scan.cuh; this file instantiates it with the magnitude loader:
// the input is the uint16 magnitude array of the magnitude route (sc16,
// sc16q11, ungated and Mode A/C streams).  Samples past n read as
// magnitude 0, the Pallas kernel's zero halo row.

#include "dense_scan.cuh"

// n % 8192 == 0 (the wrapper asks for n % 65536 == 0); scratch holds
// dense::kHead + 6 * n / 8192 uint32.  Returns the first CUDA error.
extern "C" int rtpu_init(int* device) {
    return rtpu::init(device, [](int) { return dense::prepare<dense::MagLoader>(); });
}

extern "C" int dense_scan(const void* mag, long long n, int threshold,
                          void* corr, void* pwords, void* cs_hi, void* cs_lo,
                          void* scratch, void* stream) {
    return dense::launch<dense::MagLoader>(mag, n, threshold, corr, pwords, cs_hi, cs_lo,
                                           scratch, stream);
}
