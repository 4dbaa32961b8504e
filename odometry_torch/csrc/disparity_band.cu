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
// Forward and reverse passes call the same ssd8() (csrc/ssd8.cuh) with the
// left value first, so a pair scores bit-identically in both, and in the
// full-search kernel.
//
// What bounds it on the H100: operations. One call reads the two images
// (376 x 1241 x 4 B x 2, about 3.7 MB) and writes up to four maps, about
// 11 MB in all, 3 us at 3.35 TB/s; the KITTI band [12, 192] has about 77.2 M
// (x, xr) pairs of about 24 float32 operations each (an FMA counted as two),
// about 1.85 GFLOP, 28 us at the card's 67 TFLOP/s outside the tensor cores.
// The reverse pass scores every pair a second time. Beyond that, latency and
// occupancy: how quickly enough blocks start and stream their candidate loops. The design: one block per (row, 128-column tile, pass),
// about 7,500 blocks at KITTI size; each block stages the five rows it needs
// of both images (the tile plus the band and a 2-pixel halo, under 10 KB for
// the KITTI band) in shared memory with zero fill at the edges, then each
// thread keeps its own 8 query values in registers and scans its candidates
// ascending. Neighbouring threads read neighbouring shared-memory words, so
// the scan is free of bank conflicts away from the left image edge.

#include <cuda_runtime.h>

#include "ssd8.cuh"

namespace {

using ssd8_detail::kBig;
using ssd8_detail::kHalo;
using ssd8_detail::kRows;
using ssd8_detail::load8;
using ssd8_detail::ssd8;
using ssd8_detail::stage;

constexpr int kTile = 128;  // query columns per block, one thread each

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
