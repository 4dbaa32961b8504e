// Full-search 8-point-pattern SSD stereo search with first-minimum winners, sm_90a.
//
// Replaces the TPU kernel odometry_tpu/kernels/disparity_pallas.py:_kernel
// (launched by disparity_cost_argmin_pallas), the search of kitti_config
// (max_disparity None) and of accurate_config (a band too wide for the band
// kernel, applied here as a limit on the search). It keeps the contract of the
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
// value first, so a pair scores bit-identically here and in the band kernel.
//
// What bounds it on the H100: operations. One call reads the two images
// (376 x 1241 x 4 B x 2, about 3.7 MB) and writes up to four maps, about 11 MB
// in all, 3 us at 3.35 TB/s. The full search at 376 x 1241 with boundary 4
// has about 287 M (x, xr) pairs of about 24 float32 operations each (an FMA
// counted as two), about 6.9 GFLOP: about 103 us at 67 TFLOP/s outside the
// tensor cores (the band [12, 1241] of accurate_config: about 282 M pairs,
// about 101 us).
//
// The design (csrc/ssd_row.cuh, shared with the band kernel), against the
// three things that held the first version back (the reverse pass scored
// every pair again; each SSD reloaded its 8 candidate values from shared
// memory; 752 blocks made 1.4 waves): one block per row scores each pair once
// for the forward and the reverse winner, as packed 64-bit keys reduced with
// min; a thread owns 4 query columns 32 apart and loads a candidate as two
// conflict-free 16-byte reads from pattern planes in shared memory; pairs
// outside the contract score +inf instead of being masked; 69.8 KB of shared
// memory at W = 1241 lets three blocks share an SM, all 376 rows in one wave.
// What is left: a step of 4 pairs issues about 97 instructions, 64 of them
// the SSDs' float32 work in ssd8's fixed order (the bit-for-bit contract with
// B1) and about 4 per pair for the winners, so instruction issue sets the
// pace, not the float32 rate the bound counts (PERF.md has the times).

#include <cuda_runtime.h>

#include "ssd_row.cuh"

namespace {

using Blocking = ssd_row::Blocking<4, 32>;

template <bool kRev>
__global__ void __launch_bounds__(ssd_row::kThreads, 3)
full_kernel(const float* __restrict__ left, const float* __restrict__ right,
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
full_tile_kernel(const float* __restrict__ left, const float* __restrict__ right,
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
extern "C" int disparity_full_launch(const float* left, const float* right, float* best,
                                     int* match, int* rmatch, float* second, int H, int W,
                                     int boundary, int min_d, int max_d, int second_excl,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rmatch != nullptr)
    return ssd_row::launch<Blocking, true>(full_kernel<true>, left, right, best, match, rmatch,
                                           second, H, W, boundary, min_d, max_d, second_excl, s);
  return ssd_row::launch<Blocking, false>(full_kernel<false>, left, right, best, match, rmatch,
                                          second, H, W, boundary, min_d, max_d, second_excl, s);
}

// The same search by the tiled route (three launches: fill the keys, search
// the tiles, unpack), for a width whose keys and planes do not fit one block;
// `keys` is H * W 8-byte words of scratch, 2 * H * W when rmatch is not null.
// Gives the bits of disparity_full_launch at any width. Returns the
// first cudaError_t of the three launches (0 on success).
extern "C" int disparity_full_tiled_launch(const float* left, const float* right, float* best,
                                           int* match, int* rmatch, float* second,
                                           unsigned long long* keys, int H, int W, int boundary,
                                           int min_d, int max_d, int second_excl, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rmatch != nullptr)
    return ssd_row::launch_tiled<Blocking, true>(full_tile_kernel<true>, left, right, best, match,
                                                 rmatch, second, keys, H, W, boundary, min_d,
                                                 max_d, second_excl, s);
  return ssd_row::launch_tiled<Blocking, false>(full_tile_kernel<false>, left, right, best,
                                                match, rmatch, second, keys, H, W, boundary,
                                                min_d, max_d, second_excl, s);
}
