// The 8-point pattern SSD shared by the band kernel (disparity_band.cu) and the
// full-search kernel (disparity_full.cu), so that one (x, xr) pair scores
// bit-identically in both kernels and in both passes of each.
#pragma once

#include <cuda_runtime.h>

namespace ssd8_detail {

constexpr int kHalo = 2;  // pattern reach in x and in y
constexpr int kRows = 5;  // staged rows y-2 .. y+2
constexpr float kBig = 1e10f;

// The 8 pattern values at staged column c; rows are `stride` floats apart,
// row 0 is y-2. Offsets (dy, dx) in the reference order:
// (-2,0) (-1,-1) (-1,1) (0,-2) (0,0) (0,2) (1,-1) (2,0).
__device__ __forceinline__ void load8(const float* s, int stride, int c, float v[8]) {
  v[0] = s[0 * stride + c];
  v[1] = s[1 * stride + c - 1];
  v[2] = s[1 * stride + c + 1];
  v[3] = s[2 * stride + c - 2];
  v[4] = s[2 * stride + c];
  v[5] = s[2 * stride + c + 2];
  v[6] = s[3 * stride + c - 1];
  v[7] = s[4 * stride + c];
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

// Stage rows y-2 .. y+2, columns col0 .. col0+width-1 of `img` into `dst`
// (kRows rows of `width` floats), reading 0 outside the image.
__device__ __forceinline__ void stage(float* dst, int width, const float* img, int H, int W,
                                      int y, int col0) {
  for (int i = threadIdx.x; i < kRows * width; i += blockDim.x) {
    const int r = i / width;
    const int gy = y - kHalo + r;
    const int gx = col0 + (i - r * width);
    dst[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.0f;
  }
}

}  // namespace ssd8_detail
