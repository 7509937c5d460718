// UC8 I/Q pair -> uint16 magnitude, bit-exact with the reference's 64k LUT
// (convert.c:35-62; readsb_tpu_torch/ops/convert.uc8_lut_np).
//
// The magnitude is the reference's float32 expression evaluated with
// round-to-nearest intrinsics (__fadd_rn / __fmul_rn / __fsqrt_rn), so no
// FMA contraction or approximate sqrt can change a bit.  The fi^2 table is
// built on the device from the double-precision quotient.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "runtime.cuh"

// fi^2 with fi = f32((i - 127.5) / 127.5), as convert.c:45-50 builds it
__device__ inline void load_sq_table(float* sq) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
        float fi = __double2float_rn((static_cast<double>(i) - 127.5) / 127.5);
        sq[i] = __fmul_rn(fi, fi);
    }
}

// w = I | Q << 8; sq = the table above
__device__ __forceinline__ uint32_t uc8_mag(uint32_t w, const float* sq) {
    float s = __fadd_rn(sq[w & 255u], sq[w >> 8]);
    s = fminf(s, 1.0f);
    float m = __fadd_rn(__fmul_rn(__fsqrt_rn(s), 65535.0f), 0.5f);
    return static_cast<uint32_t>(m);  // truncation; m in [0.5, 65535.5]
}
