// Banded 8-point-pattern SSD stereo search with first-minimum winners, sm_90a.
//
// Replaces the TPU kernel odometry_tpu/kernels/disparity_pallas.py:_band_kernel
// (launched by _band_pass, entry disparity_band_pallas). It keeps that kernel's
// output contract and none of its TPU layout: no bf16 three-way split, no
// norm rows in the contraction, no index packing in the SSD's low bits, no
// reverse combine across grid steps. Those exist for the TPU's matrix unit
// and VMEM; here every SSD is computed directly in float32.
//
// Contract, for rows y in [0, H) and query columns x in [0, W):
//   pairs (x, xr):  boundary <= xr,  0 <= xr,  min_d <= x - xr <= max_d,  x < W
//   SSD(x, xr)   =  sum_k (L(y+dy_k, x+dx_k) - R(y+dy_k, xr+dx_k))^2 over the
//                   8 pattern offsets; pixels outside the image read 0.
//   best[y, x]   =  min over x's pairs (1e10 where x has none)
//   match[y, x]  =  smallest xr reaching best (strict-< ascending scan; 0 if none)
//   rmatch[y, xr] = smallest x reaching column xr's minimum (0 if no pair)
//   second[y, x] =  min SSD over x's pairs with |xr - match| > second_excl
// Forward and reverse passes call the same ssd8() with the left value first,
// so a pair scores bit-identically in both.
//
// What bounds it on the H100: not bytes. One call reads the two images
// (376 x 1241 x 4 B x 2, about 3.7 MB) and writes four maps, microseconds of
// HBM time; the arithmetic is about 1.2 GFLOP at the KITTI band [12, 192],
// a few percent of a millisecond of the card's float32 rate. What is left is
// latency and occupancy: how quickly enough blocks start and stream their
// candidate loops. The design: one block per (row, 128-column tile, pass),
// about 7,500 blocks at KITTI size; each block stages the five rows it needs
// of both images (the tile plus the band and a 2-pixel halo, under 10 KB for
// the KITTI band) in shared memory with zero fill at the edges, then each
// thread keeps its own 8 query values in registers and scans its candidates
// ascending. Neighbouring threads read neighbouring shared-memory words, so
// the scan is free of bank conflicts away from the left image edge.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // query columns per block, one thread each
constexpr int kHalo = 2;    // pattern reach in x and in y
constexpr int kRows = 5;    // staged rows y-2 .. y+2
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

__device__ __forceinline__ void stage(float* dst, int width, const float* img, int H, int W,
                                      int y, int col0) {
  for (int i = threadIdx.x; i < kRows * width; i += blockDim.x) {
    const int r = i / width;
    const int gy = y - kHalo + r;
    const int gx = col0 + (i - r * width);
    dst[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.0f;
  }
}

// blockIdx.z == 0: forward pass (query = left x, candidates = right xr = x - d).
// blockIdx.z == 1: reverse pass (query = right xr, candidates = left x = xr + d).
__global__ void __launch_bounds__(kTile)
band_kernel(const float* __restrict__ left, const float* __restrict__ right,
            float* __restrict__ best, int* __restrict__ match, int* __restrict__ rmatch,
            float* __restrict__ second, int H, int W, int boundary, int min_d, int max_d,
            int second_excl) {
  extern __shared__ float smem[];
  const bool rev = blockIdx.z == 1;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int qw = kTile + 2 * kHalo;
  const int cw = kTile + (max_d - min_d) + 2 * kHalo;
  float* qs = smem;
  float* cs = smem + kRows * qw;
  const int qstart = x0 - kHalo;
  const int cstart = (rev ? x0 + min_d : x0 - max_d) - kHalo;
  stage(qs, qw, rev ? right : left, H, W, y, qstart);
  stage(cs, cw, rev ? left : right, H, W, y, cstart);
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  float q[8], c[8];
  load8(qs, qw, x - qstart, q);

  if (!rev) {
    const int lo = max(max(boundary, 0), x - max_d);
    const int hi = x - min_d;
    float b = kBig;
    int m = 0;
    for (int xr = lo; xr <= hi; ++xr) {
      load8(cs, cw, xr - cstart, c);
      const float s = ssd8(q, c);
      if (s < b) {
        b = s;
        m = xr;
      }
    }
    best[y * W + x] = b;
    match[y * W + x] = m;
    if (second != nullptr) {
      float b2 = kBig;
      for (int xr = lo; xr <= hi; ++xr) {
        if (abs(xr - m) <= second_excl) continue;
        load8(cs, cw, xr - cstart, c);
        b2 = fminf(b2, ssd8(q, c));
      }
      second[y * W + x] = b2;
    }
  } else {
    int m = 0;
    if (x >= boundary) {
      const int lo = x + min_d;
      const int hi = min(W - 1, x + max_d);
      float b = kBig;
      for (int xl = lo; xl <= hi; ++xl) {
        load8(cs, cw, xl - cstart, c);
        const float s = ssd8(c, q);
        if (s < b) {
          b = s;
          m = xl;
        }
      }
    }
    rmatch[y * W + x] = m;
  }
}

}  // namespace

// Launches the forward pass, and the reverse pass when rmatch is not null, as
// one grid on `stream`. second may be null. Requires 1 <= min_d <= max_d.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int disparity_band_launch(const float* left, const float* right, float* best,
                                     int* match, int* rmatch, float* second, int H, int W,
                                     int boundary, int min_d, int max_d, int second_excl,
                                     void* stream) {
  const int band = max_d - min_d;
  const size_t smem =
      sizeof(float) * kRows * ((kTile + 2 * kHalo) + (kTile + band + 2 * kHalo));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + kTile - 1) / kTile, H, rmatch != nullptr ? 2 : 1);
  band_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      left, right, best, match, rmatch, second, H, W, boundary, min_d, max_d, second_excl);
  return static_cast<int>(cudaGetLastError());
}
