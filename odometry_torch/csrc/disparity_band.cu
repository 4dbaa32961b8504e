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
// Every SSD is ssd8() of csrc/ssd8.cuh, left value first, so a pair scores
// bit-identically here and in the full-search kernel.
//
// What bounds it on the H100: operations. One call reads the two images
// (376 x 1241 x 4 B x 2, about 3.7 MB) and writes up to four maps, about
// 11 MB in all, 3 us at 3.35 TB/s; the KITTI band [12, 192] has about 77.2 M
// (x, xr) pairs of about 24 float32 operations each (an FMA counted as two),
// about 1.85 GFLOP, 28 us at the card's 67 TFLOP/s outside the tensor cores.
// ssd8()'s fixed order takes 16 float32 instructions per pair where the bound
// counts 12 FMA slots, so no kernel under the bit-for-bit contract passes
// about 75% of it, and instruction issue, not the float32 rate, sets the pace.
//
// The design is the full-search kernel's single pass (csrc/ssd_row.cuh: one
// block per row scores each pair once for the forward and the reverse winner,
// packed keys, pattern planes, no masks in the steady loop), with a blocking
// fitted to a narrow band: a thread owns 4 query columns 8 apart, so a group
// of 128 columns walks the offsets [min_d - 24, max_d], 205 steps for the 181
// offsets of [12, 192] where 4 columns 32 apart would take 277. Each 8 lanes
// of a warp own 8 neighbouring columns, so the 16-byte plane loads stay free
// of bank conflicts. A block holds a whole row (staged_bytes(): 69.8 KB at
// W = 1241); wider rows, past 4,629 columns with lr, take the tiled route
// (disparity_band_tiled_launch), which the wrapper picks.

#include <cuda_runtime.h>

#include "ssd_row.cuh"

namespace {

using Blocking = ssd_row::Blocking<4, 8>;

template <bool kRev>
__global__ void __launch_bounds__(ssd_row::kThreads, 3)
band_kernel(const float* __restrict__ left, const float* __restrict__ right,
            float* __restrict__ best, int* __restrict__ match, int* __restrict__ rmatch,
            float* __restrict__ second, int H, int W, int boundary, int min_d, int max_d,
            int second_excl) {
  extern __shared__ unsigned long long smem[];
  ssd_row::search_row<Blocking, kRev>(smem, left, right, best, match, rmatch, second, H, W,
                                      boundary, min_d, max_d, second_excl);
}

// The tiled route's search (ssd_row.cuh: search_tile), for wider rows.
template <bool kRev>
__global__ void __launch_bounds__(ssd_row::kThreads, 2)
band_tile_kernel(const float* __restrict__ left, const float* __restrict__ right,
                 unsigned long long* __restrict__ fkey, unsigned long long* __restrict__ rkey,
                 int H, int W, int boundary, int min_d, int max_d) {
  extern __shared__ unsigned long long smem[];
  ssd_row::search_tile<Blocking, kRev>(smem, left, right, fkey, rkey, H, W, boundary, min_d,
                                       max_d);
}

}  // namespace

// Launches the search on `stream`: forward and reverse winners from one pass
// when rmatch is not null, forward only otherwise. second may be null.
// Requires 1 <= min_d <= max_d and a width whose keys and planes fit a
// block's shared memory (the wrapper picks the route). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int disparity_band_launch(const float* left, const float* right, float* best,
                                     int* match, int* rmatch, float* second, int H, int W,
                                     int boundary, int min_d, int max_d, int second_excl,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rmatch != nullptr)
    return ssd_row::launch<Blocking, true>(band_kernel<true>, left, right, best, match, rmatch,
                                           second, H, W, boundary, min_d, max_d, second_excl, s);
  return ssd_row::launch<Blocking, false>(band_kernel<false>, left, right, best, match, rmatch,
                                          second, H, W, boundary, min_d, max_d, second_excl, s);
}

// The same search by the tiled route (three launches: fill the keys, search
// the tiles, unpack), for a width whose keys and planes do not fit one block;
// `keys` is H * W 8-byte words of scratch, 2 * H * W when rmatch is not null.
// Gives the bits of disparity_band_launch at any width. Returns the
// first cudaError_t of the three launches (0 on success).
extern "C" int disparity_band_tiled_launch(const float* left, const float* right, float* best,
                                           int* match, int* rmatch, float* second,
                                           unsigned long long* keys, int H, int W, int boundary,
                                           int min_d, int max_d, int second_excl, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rmatch != nullptr)
    return ssd_row::launch_tiled<Blocking, true>(band_tile_kernel<true>, left, right, best, match,
                                                 rmatch, second, keys, H, W, boundary, min_d,
                                                 max_d, second_excl, s);
  return ssd_row::launch_tiled<Blocking, false>(band_tile_kernel<false>, left, right, best,
                                                match, rmatch, second, keys, H, W, boundary,
                                                min_d, max_d, second_excl, s);
}
