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
// The design, against the three things that held the first version back
// (the reverse pass scored every pair again; each SSD reloaded its 8
// candidate values from shared memory; 752 blocks made 1.4 waves):
// - Each pair is scored once. One block per row y; one SSD of (x, xr) feeds
//   both x's forward winner and xr's reverse winner. The winners are 64-bit
//   keys (float bits of the SSD << 32 | index): an SSD is a float >= +0, so
//   its bits order like the float, and the smallest key is the lowest SSD
//   with the smallest index, the strict-< ascending scan's first minimum,
//   whatever the order of reduction. Keys start at (bits(1e10) << 32) | 0,
//   the "no pair" answer (an SSD of 1e10 or more, +inf or NaN never beats
//   it, as it never beat the scan's 1e10). Reverse keys live in shared
//   memory and take a 64-bit atomicMin, only after a plain read shows the
//   key would lower it (keys only fall, so a stale read costs an atomic,
//   never a lost update); forward winners gather in registers over a warp's
//   stretch of one column's candidates and then take one atomicMin each. The
//   order of arrival does not change the result.
// - Register blocking. A thread owns kRx = 4 query columns 32 apart (lane l
//   of a warp's 128-column group owns x = X0 + l + 32k, their 32 pattern
//   values in registers) and walks one offset e = x_l - xr at a time: one
//   candidate column xr for all 4 SSDs. The block first writes the right
//   image's 8 pattern values of every candidate column into shared memory
//   as two 16-byte planes, so a candidate is two conflict-free 16-byte loads
//   (lanes read 32 neighbouring columns) where it was eight 4-byte loads per
//   SSD; no two lanes touch one reverse key at a step. A pair outside the
//   contract scores +inf instead of being masked: candidate columns left of
//   the boundary hold +inf (and the planes and reverse keys are padded by
//   kPad columns each side), query columns past the image hold +inf. So the
//   steps that need a test are the first 96 offsets of a group (its columns
//   reach min_d 32 offsets apart, split at compile time into the columns
//   that pair) and the band's upper edge; columns past the image for every
//   lane of a group are not scored at all.
// - One wave. Shared memory per block is the keys (8 B per query column and
//   per padded candidate column) and the planes (32 B per padded candidate
//   column): 62.1 KB at W = 1241, so three blocks share an SM, 396 slots for
//   376 rows, and each thread keeps to 80 registers. Every row has the same
//   pairs. Inside a block the steps of all groups (a 128-column group at
//   one offset e), laid end to end, are cut into 8 equal runs, one per warp,
//   so warps get equal work however the triangle of pairs is shaped.
// What is left: a step of 4 pairs issues about 97 instructions, 64 of them
// the SSDs' float32 work in ssd8's fixed order (the bit-for-bit contract with
// B1) and about 4 per pair for the winners, so instruction issue sets the
// pace, not the float32 rate the bound counts (PERF.md has the times).
// `second` is a second scan after the winners, one thread per query column,
// as in the first version; no preset asks for it.

#include <cuda_runtime.h>

#include "ssd8.cuh"

namespace {

using ssd8_detail::kBig;
using ssd8_detail::ssd8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRx = 4;                     // query columns per thread, 32 apart
constexpr int kGroup = 32 * kRx;           // query columns per warp step
constexpr int kSpread = 32 * (kRx - 1);    // offset of a thread's last column
constexpr int kPad = 32;                   // candidate columns padded each side

__device__ __forceinline__ unsigned long long pack(float s, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(s)) << 32) | static_cast<unsigned>(i);
}

// The 8 pattern values of image column x in row y, read from device memory
// (0 outside the image), in load8's order (csrc/ssd8.cuh).
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

// Offsets e in [e0, e1] of group X0 for this lane's columns x_l + 32k,
// candidate xr = x_l - e. Forward winners gather in (fb, fm): the walk goes
// down in xr, so `s <= fb` keeps the smallest xr of a tie; fb starts just
// below 1e10, so that an SSD of 1e10 does not count, and fm at -1 (none).
// A pair outside the contract scores +inf and never counts: columns past
// the image hold +inf queries, and candidates left of the boundary +inf
// values. Only columns kLo <= k < kHi are scored: below kLo their pairs lie
// below min_d for the whole walk, from kHi on the columns lie past the image
// for every lane; with kEdge, a column whose pairs at this e fall outside
// [min_d, max_d] is skipped (the test is the same for the whole warp). Only
// a lane whose columns are all past the image reads a candidate past the
// padding, so it is clamped there where it can happen. The reverse winner
// of xr is the first column reaching min(s_k); only when that can lower the
// key read at the start of the step is its key formed and stored.
template <int kLo, int kHi, bool kEdge, bool kRev>
__device__ __forceinline__ void walk(int e0, int e1, int xl, const float q[kRx][8],
                                     float fb[kRx], int fm[kRx], const float4* plo,
                                     const float4* phi, unsigned long long* rkey, int W,
                                     int min_d, int max_d) {
  if (kLo >= kHi) return;
  const float inf = __int_as_float(0x7f800000);
  for (int e = e0; e <= e1; ++e) {
    const int xr = xl - e;
    const int xc = kPad + (kLo > 0 || kEdge ? min(xr, W + kPad - 1) : xr);
    unsigned long long cur = 0;
    if (kRev) cur = *reinterpret_cast<volatile unsigned long long*>(rkey + xc);
    const float4 c0 = plo[xc];
    const float4 c1 = phi[xc];
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    float s[kRx];
#pragma unroll
    for (int k = 0; k < kRx; ++k) {
      s[k] = inf;
      if (k < kLo || k >= kHi) continue;
      if (kEdge && static_cast<unsigned>(e + 32 * k - min_d) >
                       static_cast<unsigned>(max_d - min_d))
        continue;
      s[k] = ssd8(q[k], c);
      if (s[k] <= fb[k]) {
        fb[k] = s[k];
        fm[k] = xr;
      }
    }
    if (kRev) {
      float rb = s[0];
#pragma unroll
      for (int k = 1; k < kRx; ++k) rb = fminf(rb, s[k]);
      if (rb <= __uint_as_float(static_cast<unsigned>(cur >> 32))) {
        int first = 0;
#pragma unroll
        for (int k = kRx - 1; k >= 0; --k)
          if (s[k] == rb) first = k;
        const unsigned long long key = pack(rb, xl + 32 * first);
        if (key < cur) atomicMin(rkey + xc, key);
      }
    }
  }
}

// Offsets [ea, eb] of a group, by one warp, scoring columns k < kHi: the
// head (e < min_d, where the columns k < kLo have no pair yet), the steps
// where every column pairs, then the steps past max_d - kSpread.
template <int kHi, bool kRev>
__device__ __forceinline__ void walks(int ea, int eb, int xl, const float q[kRx][8],
                                      float fb[kRx], int fm[kRx], const float4* plo,
                                      const float4* phi, unsigned long long* rkey, int W,
                                      int min_d, int max_d) {
  const int u1 = min(eb, max_d - kSpread);
  if (max_d - min_d >= kSpread) {
    // In the head e < min_d, so e + 32k <= max_d for every column.
    static_assert(kRx == 4, "the head below is written out for four columns");
    walk<3, kHi, false, kRev>(max(ea, min_d - 96), min(eb, min_d - 65), xl, q, fb, fm, plo,
                              phi, rkey, W, min_d, max_d);
    walk<2, kHi, false, kRev>(max(ea, min_d - 64), min(eb, min_d - 33), xl, q, fb, fm, plo,
                              phi, rkey, W, min_d, max_d);
    walk<1, kHi, false, kRev>(max(ea, min_d - 32), min(eb, min_d - 1), xl, q, fb, fm, plo,
                              phi, rkey, W, min_d, max_d);
    walk<0, kHi, false, kRev>(max(ea, min_d), u1, xl, q, fb, fm, plo, phi, rkey, W, min_d,
                              max_d);
    walk<0, kHi, true, kRev>(max(ea, u1 + 1), eb, xl, q, fb, fm, plo, phi, rkey, W, min_d,
                             max_d);
  } else {
    walk<0, kHi, true, kRev>(ea, eb, xl, q, fb, fm, plo, phi, rkey, W, min_d, max_d);
  }
}

// Offsets [ea, eb] of the group at column X0, by one warp.
template <bool kRev>
__device__ __forceinline__ void run(int X0, int ea, int eb, const float* left, int H, int y,
                                    const float4* plo, const float4* phi,
                                    unsigned long long* fkey, unsigned long long* rkey, int W,
                                    int min_d, int max_d) {
  const int xl = X0 + (threadIdx.x & 31);
  float q[kRx][8];
  float fb[kRx];
  int fm[kRx];
  const float below_big = __int_as_float(__float_as_int(kBig) - 1);
#pragma unroll
  for (int k = 0; k < kRx; ++k) {
    const int x = xl + 32 * k;
    if (x < W) {
      pattern8(left, H, W, y, x, q[k]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) q[k][i] = __int_as_float(0x7f800000);
    }
    fb[k] = below_big;
    fm[k] = -1;
  }
  // Columns with some lane inside the image: ceil((W - X0) / 32), at most kRx.
  switch (min(kRx, (W - X0 + 31) / 32)) {
    case 1:
      walks<1, kRev>(ea, eb, xl, q, fb, fm, plo, phi, rkey, W, min_d, max_d);
      break;
    case 2:
      walks<2, kRev>(ea, eb, xl, q, fb, fm, plo, phi, rkey, W, min_d, max_d);
      break;
    case 3:
      walks<3, kRev>(ea, eb, xl, q, fb, fm, plo, phi, rkey, W, min_d, max_d);
      break;
    default:
      walks<kRx, kRev>(ea, eb, xl, q, fb, fm, plo, phi, rkey, W, min_d, max_d);
  }
#pragma unroll
  for (int k = 0; k < kRx; ++k) {
    if (fm[k] >= 0) atomicMin(fkey + xl + 32 * k, pack(fb[k], fm[k]));
  }
}

// 8-byte words of the winner keys (forward W, and with kRev reverse W +
// 2 kPad), even so that the pattern planes after them are 16-byte aligned.
__host__ __device__ constexpr int key_words(int W, bool rev) {
  return (W + (rev ? W + 2 * kPad : 0) + 1) & ~1;
}

template <bool kRev>
__global__ void __launch_bounds__(kThreads, 3)
full_kernel(const float* __restrict__ left, const float* __restrict__ right,
            float* __restrict__ best, int* __restrict__ match, int* __restrict__ rmatch,
            float* __restrict__ second, int H, int W, int boundary, int min_d, int max_d,
            int second_excl) {
  extern __shared__ unsigned long long smem[];
  // Reverse keys and pattern planes hold candidate columns -kPad .. W + kPad - 1.
  unsigned long long* fkey = smem;
  unsigned long long* rkey = smem + W;
  float4* plo = reinterpret_cast<float4*>(smem + key_words(W, kRev));
  float4* phi = plo + W + 2 * kPad;
  const int y = blockIdx.x;
  const int b = max(boundary, 0);
  const unsigned long long none = pack(kBig, 0);
  const float inf = __int_as_float(0x7f800000);
  for (int x = threadIdx.x; x < W; x += kThreads) fkey[x] = none;
  for (int i = threadIdx.x; i < W + 2 * kPad; i += kThreads) {
    if (kRev) rkey[i] = none;
    const int xr = i - kPad;
    float v[8];
    if (xr < b) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = inf;  // no pair: left of the boundary
    } else if (xr >= W) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.0f;  // read only by columns past the image
    } else {
      pattern8(right, H, W, y, xr, v);
    }
    plo[i] = make_float4(v[0], v[1], v[2], v[3]);
    phi[i] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  // Group g (query columns g * kGroup ..) walks offsets [min_d - kSpread,
  // min(max_d, X0 + 31 - b)]: the union of its lanes' columns' candidates.
  // The steps of all groups, end to end, are cut into kWarps equal runs.
  const int groups = (W + kGroup - 1) / kGroup;
  const int e_lo = min_d - kSpread;
  long long total = 0;
  for (int g = 0; g < groups; ++g) total += max(0, min(max_d, g * kGroup + 31 - b) - e_lo + 1);
  const int warp = threadIdx.x >> 5;
  const long long s0 = total * warp / kWarps;
  const long long s1 = total * (warp + 1) / kWarps;
  long long base = 0;
  for (int g = 0; g < groups && base < s1; ++g) {
    const int X0 = g * kGroup;
    const int len = max(0, min(max_d, X0 + 31 - b) - e_lo + 1);
    const long long a = max(s0, base);
    const long long z = min(s1, base + len);
    if (a < z) {
      run<kRev>(X0, e_lo + static_cast<int>(a - base), e_lo + static_cast<int>(z - base) - 1,
                left, H, y, plo, phi, fkey, rkey, W, min_d, max_d);
    }
    base += len;
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += kThreads) {
    const unsigned long long f = fkey[x];
    best[y * W + x] = __uint_as_float(static_cast<unsigned>(f >> 32));
    match[y * W + x] = static_cast<int>(f & 0xffffffffu);
    if (kRev) rmatch[y * W + x] = static_cast<int>(rkey[x + kPad] & 0xffffffffu);
  }
  if (second == nullptr) return;
  float q[8];
  for (int x = threadIdx.x; x < W; x += kThreads) {
    const int m = static_cast<int>(fkey[x] & 0xffffffffu);
    pattern8(left, H, W, y, x, q);
    const int lo = max(b, x - max_d);
    const int hi = x - min_d;
    float b2 = kBig;
    for (int xr = lo; xr <= hi; ++xr) {
      if (abs(xr - m) <= second_excl) continue;
      const float4 c0 = plo[xr + kPad];
      const float4 c1 = phi[xr + kPad];
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      b2 = fminf(b2, ssd8(q, c));
    }
    second[y * W + x] = b2;
  }
}

template <bool kRev>
int launch(const float* left, const float* right, float* best, int* match, int* rmatch,
           float* second, int H, int W, int boundary, int min_d, int max_d, int second_excl,
           cudaStream_t stream) {
  const size_t smem = sizeof(unsigned long long) * key_words(W, kRev) + sizeof(float4) * 2 * (W + 2 * kPad);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        full_kernel<kRev>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  full_kernel<kRev><<<H, kThreads, smem, stream>>>(left, right, best, match, rmatch, second, H, W,
                                                   boundary, min_d, max_d, second_excl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the search on `stream`: forward and reverse winners from one pass
// when rmatch is not null, forward only otherwise. second may be null.
// Requires 1 <= min_d <= max_d and a width whose staged rows and keys fit a
// block's shared memory (the wrapper checks). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int disparity_full_launch(const float* left, const float* right, float* best,
                                     int* match, int* rmatch, float* second, int H, int W,
                                     int boundary, int min_d, int max_d, int second_excl,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rmatch != nullptr)
    return launch<true>(left, right, best, match, rmatch, second, H, W, boundary, min_d, max_d,
                        second_excl, s);
  return launch<false>(left, right, best, match, rmatch, second, H, W, boundary, min_d, max_d,
                       second_excl, s);
}
