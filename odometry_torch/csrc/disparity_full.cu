// Full-search 8-point-pattern SSD stereo search with first-minimum winners, sm_90a.
//
// Replaces the TPU kernel odometry_tpu/kernels/disparity_pallas.py:_kernel
// (launched by disparity_cost_argmin_pallas), the search of kitti_config
// (max_disparity None) and of accurate_config (a band too wide for the band
// kernel, applied here as a limit on the scan). It keeps the contract of the
// reference's XLA path (odometry_tpu/kernels/disparity.py:191-238), not the
// Pallas kernel's padded reverse pass, which also scores the zero-padded query
// columns x in [W, Wp) as candidates.
//
// Contract, for rows y in [0, H) and query columns x in [0, W):
//   pairs (x, xr):  boundary <= xr,  0 <= xr,  min_d <= x - xr <= max_d,  x < W
//   SSD(x, xr)   =  sum_k (L(y+dy_k, x+dx_k) - R(y+dy_k, xr+dx_k))^2 over the
//                   8 pattern offsets; pixels outside the image read 0.
//   best[y, x]   =  min over x's pairs (1e10 where x has none)
//   match[y, x]  =  smallest xr reaching best (strict-< ascending scan; 0 if none)
//   rmatch[y, xr] = smallest x reaching column xr's minimum (0 if no pair)
//   second[y, x] =  min SSD over x's pairs with |xr - match| > second_excl
// The full search is max_d = W. Every SSD is ssd8() of csrc/ssd8.cuh, left
// value first, so a pair scores bit-identically in both passes and in the
// band kernel.
//
// What bounds it on the H100: operations. One call reads the two images
// (376 x 1241 x 4 B x 2, about 3.7 MB) and writes up to four maps, about 11 MB
// in all, 3 us at 3.35 TB/s. The full search at 376 x 1241 with boundary 4
// has about 287 M (x, xr) pairs of about 24 float32 operations each (an FMA
// counted as two), about 6.9 GFLOP: about 103 us at 67 TFLOP/s outside the
// tensor cores (the band [12, 1241] of accurate_config: about 282 M pairs,
// about 101 us). The design is the simple one: the reverse pass scores every
// pair a second time, and each SSD is eight shared-memory loads and sixteen
// instructions. A tensor-core norm expansion, forward and reverse winners from
// one pass over the pairs, and better occupancy are later work.
//
// The design: the work per row is a triangle (x has about x - boundary
// candidates), which a sliding band window does not fit. One block per
// (row, pass), 376 x 2 blocks at KITTI size. Each block stages the five rows
// y-2 .. y+2 of both images whole, zero-filled at the edges, in dynamic shared
// memory: 2 x 5 x (W + 4) x 4 B, about 50 KB at W = 1241, above the 48 KB
// default (opted in with cudaFuncSetAttribute). Threads take query columns
// interleaved (x = t, t + blockDim, ...), so each thread gets a mix of short
// and long scans. In the forward pass all lanes of a warp read the same
// candidate column at each step (a broadcast); in the reverse pass they read
// neighbouring columns (no bank conflicts).

#include <cuda_runtime.h>

#include "ssd8.cuh"

namespace {

using ssd8_detail::kBig;
using ssd8_detail::kHalo;
using ssd8_detail::kRows;
using ssd8_detail::load8;
using ssd8_detail::ssd8;
using ssd8_detail::stage;

constexpr int kThreads = 256;

// blockIdx.y == 0: forward pass (query = left x, candidates = right xr = x - d).
// blockIdx.y == 1: reverse pass (query = right xr, candidates = left x = xr + d).
__global__ void __launch_bounds__(kThreads)
full_kernel(const float* __restrict__ left, const float* __restrict__ right,
            float* __restrict__ best, int* __restrict__ match, int* __restrict__ rmatch,
            float* __restrict__ second, int H, int W, int boundary, int min_d, int max_d,
            int second_excl) {
  extern __shared__ float smem[];
  const bool rev = blockIdx.y == 1;
  const int y = blockIdx.x;
  const int sw = W + 2 * kHalo;  // staged width; staged column c holds image column c - 2
  float* ls = smem;
  float* rs = smem + kRows * sw;
  stage(ls, sw, left, H, W, y, -kHalo);
  stage(rs, sw, right, H, W, y, -kHalo);
  __syncthreads();

  float q[8], c[8];
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    if (!rev) {
      load8(ls, sw, x + kHalo, q);
      const int lo = max(max(boundary, 0), x - max_d);
      const int hi = x - min_d;
      float b = kBig;
      int m = 0;
      for (int xr = lo; xr <= hi; ++xr) {
        load8(rs, sw, xr + kHalo, c);
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
          load8(rs, sw, xr + kHalo, c);
          b2 = fminf(b2, ssd8(q, c));
        }
        second[y * W + x] = b2;
      }
    } else {
      int m = 0;
      if (x >= boundary) {
        load8(rs, sw, x + kHalo, q);
        const int lo = x + min_d;
        const int hi = min(W - 1, x + max_d);
        float b = kBig;
        for (int xl = lo; xl <= hi; ++xl) {
          load8(ls, sw, xl + kHalo, c);
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
}

}  // namespace

// Launches the forward pass, and the reverse pass when rmatch is not null, as
// one grid on `stream`. second may be null. Requires 1 <= min_d <= max_d and a
// width whose staged rows fit a block's shared memory (the wrapper checks).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int disparity_full_launch(const float* left, const float* right, float* best,
                                     int* match, int* rmatch, float* second, int H, int W,
                                     int boundary, int min_d, int max_d, int second_excl,
                                     void* stream) {
  const size_t smem = sizeof(float) * 2 * kRows * (W + 2 * kHalo);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(H, rmatch != nullptr ? 2 : 1);
  full_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      left, right, best, match, rmatch, second, H, W, boundary, min_d, max_d, second_excl);
  return static_cast<int>(cudaGetLastError());
}
