// The 8-point pattern and its SSD, shared by the band kernel (disparity_band.cu)
// and the full-search kernel (disparity_full.cu) through ssd_row.cuh, so that
// one (x, xr) pair scores bit-identically in both kernels.
#pragma once

#include <cuda_runtime.h>

namespace ssd8_detail {

constexpr float kBig = 1e10f;

// The 8 pattern values of image column x in row y, read from device memory
// (0 outside the image). Offsets (dy, dx) in the reference order:
// (-2,0) (-1,-1) (-1,1) (0,-2) (0,0) (0,2) (1,-1) (2,0).
__device__ __forceinline__ void pattern8(const float* img, int H, int W, int y, int x,
                                         float v[8]) {
  constexpr int kDy[8] = {-2, -1, -1, 0, 0, 0, 1, 2};
  constexpr int kDx[8] = {0, -1, 1, -2, 0, 2, -1, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gy = y + kDy[i];
    const int gx = x + kDx[i];
    v[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? __ldg(img + gy * W + gx) : 0.0f;
  }
}

// SSD of left pattern `l` against right pattern `r`, in a fixed order of
// explicitly rounded operations (no contraction choices left to the compiler).
__device__ __forceinline__ float ssd8(const float l[8], const float r[8]) {
  float d = __fsub_rn(l[0], r[0]);
  float s = __fmul_rn(d, d);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    d = __fsub_rn(l[k], r[k]);
    s = __fmaf_rn(d, d, s);
  }
  return s;
}

}  // namespace ssd8_detail
