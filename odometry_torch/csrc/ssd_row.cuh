// The single-pass row search shared by the band kernel (disparity_band.cu) and
// the full-search kernel (disparity_full.cu). Each kernel is one block per
// image row calling search_row() with its own blocking; the two differ only in
// how many query columns a thread owns and how far apart they lie.
//
// Contract, for rows y in [0, H) and query columns x in [0, W):
//   pairs (x, xr):  boundary <= xr,  0 <= xr,  min_d <= x - xr <= max_d,  x < W
//   SSD(x, xr)   =  ssd8() of the 8 pattern values (ssd8.cuh), left first;
//                   pixels outside the image read 0.
//   best[y, x]   =  min over x's pairs (1e10 where x has none)
//   match[y, x]  =  smallest xr reaching best (strict-< ascending scan; 0 if none)
//   rmatch[y, xr] = smallest x reaching column xr's minimum (0 if no pair)
//   second[y, x] =  min SSD over x's pairs with |xr - match| > second_excl
//
// The design:
// - Each pair is scored once. One SSD of (x, xr) feeds both x's forward
//   winner and xr's reverse winner. The winners are 64-bit keys (float bits
//   of the SSD << 32 | index): an SSD is a float >= +0, so its bits order like
//   the float, and the smallest key is the lowest SSD with the smallest index,
//   the strict-< ascending scan's first minimum, whatever the order of
//   reduction. Keys start at (bits(1e10) << 32) | 0, the "no pair" answer (an
//   SSD of 1e10 or more, +inf or NaN never beats it, as it never beat the
//   scan's 1e10). Reverse keys live in shared memory and take a 64-bit
//   atomicMin, only after a plain read shows the key would lower it (keys
//   only fall, so a stale read costs an atomic, never a lost update); forward
//   winners gather in registers over a warp's stretch of one column's
//   candidates and then take one atomicMin each.
// - Register blocking. A thread owns kRx query columns kSp apart, their 8
//   pattern values in registers, and walks one offset e at a time: one
//   candidate column xr = xb - e (xb its first column) for all kRx SSDs, the
//   column k at offset e + kSp k. Lanes are laid out so that each 8 lanes of a
//   warp own 8 neighbouring first columns: lane l's first column is
//   X0 + l % kSp + (l / kSp) kSp kRx in its warp's group of 32 kRx columns.
//   The block first writes the right image's 8 pattern values of every
//   candidate column into shared memory as two 16-byte planes, so a candidate
//   is two 16-byte loads that 8 lanes take from 128 neighbouring bytes, free of
//   bank conflicts; no two lanes touch one reverse key at a step.
// - No masks in the steady loop. A pair outside the contract scores +inf
//   instead: candidate columns left of the boundary hold +inf, query columns
//   past the image hold +inf, and the planes and reverse keys are padded by a
//   group's width (kPad) on each side, which is as far as any lane's walk
//   reaches. A group walks the offsets [min_d - kSpread, max_d]: in the first
//   kSpread of them (the head) the columns below some k have no pair yet, in
//   the last kSpread (the tail) the columns from some k on are past max_d;
//   both are split at compile time into runs that score only the columns
//   that pair. Columns past the image for every lane of a group are not
//   scored. A band narrower than kSpread takes one walk that tests each
//   column's offset.
// - One wave. Shared memory per block is the keys (8 B per query column and
//   per padded candidate column) and the planes (32 B per padded candidate
//   column), staged_bytes(); at W = 1241 that lets three 256-thread blocks
//   share an SM, 396 slots for 376 rows. Every row has the same pairs. Inside
//   a block the steps of all groups (a group at one offset e), laid end to
//   end, are cut into 8 equal runs, one per warp.
// - `second` is a second scan after the winners, one thread per query
//   column; no preset asks for it.
// - Rows too wide for one block's shared memory (past W = 4,629 with the
//   reverse winners, 5,606 without) take the tiled route at the end of this
//   file: the same walk on (row, query tile, candidate tile) blocks, keys
//   merged in device memory, bit for bit the one-block route's answer.
#pragma once

#include <cuda_runtime.h>

#include "ssd8.cuh"

namespace ssd_row {

using ssd8_detail::kBig;
using ssd8_detail::pattern8;
using ssd8_detail::ssd8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// kRx query columns per thread, kSp apart (see the design above).
template <int kRx_, int kSp_>
struct Blocking {
  static constexpr int kRx = kRx_;
  static constexpr int kSp = kSp_;
  static_assert(kSp >= 8 && 32 % kSp == 0, "each 8 lanes read 8 neighbouring columns");
  static constexpr int kGroup = 32 * kRx;           // query columns per warp step
  static constexpr int kSpread = kSp * (kRx - 1);   // offset of a thread's last column
  static constexpr int kPad = kGroup;               // candidate columns padded each side
  static constexpr int kLastBase = kSp - 1 + (32 / kSp - 1) * kSp * kRx;  // lane 31's xb - X0
  __device__ static int base(int lane) { return lane % kSp + lane / kSp * (kSp * kRx); }
};

// 8-byte words of the winner keys (forward W, and with `rev` reverse W +
// 2 pad), even so that the pattern planes after them are 16-byte aligned.
__host__ __device__ constexpr int key_words(int W, bool rev, int pad) {
  return (W + (rev ? W + 2 * pad : 0) + 1) & ~1;
}

// Dynamic shared memory of one block at image width W.
template <class B>
__host__ __device__ constexpr size_t staged_bytes(int W, bool rev) {
  return sizeof(unsigned long long) * key_words(W, rev, B::kPad) +
         2 * sizeof(float4) * (W + 2 * B::kPad);
}

__device__ __forceinline__ unsigned long long pack(float s, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(s)) << 32) | static_cast<unsigned>(i);
}

// The shared-memory state of a row, and the band. Candidate column xr lives
// at index xr - c_lo of the planes and reverse keys.
struct Row {
  const float4* plo;
  const float4* phi;
  unsigned long long* rkey;
  int min_d;
  int max_d;
  int c_lo;
};

// Offsets e in [e0, e1] for this lane's columns xb + kSp k, candidate
// xr = xb - e. Forward winners gather in (fb, fm): the walk goes down in xr,
// so `s <= fb` keeps the smallest xr of a tie; fb starts just below 1e10, so
// that an SSD of 1e10 does not count, and fm at -1 (none). Only columns
// kLo <= k < kHi are scored; with kEdge, a column whose pair at this e falls
// outside [min_d, max_d] is skipped (the test is the same for the whole
// warp). The reverse winner of xr is the first column reaching min(s_k);
// only when that can lower the key read at the start of the step is its key
// formed and stored.
template <class B, int kLo, int kHi, bool kEdge, bool kRev>
__device__ __forceinline__ void walk(int e0, int e1, int xb, const float q[B::kRx][8],
                                     float fb[B::kRx], int fm[B::kRx], const Row& row) {
  if constexpr (kLo < kHi) {
    const float inf = __int_as_float(0x7f800000);
    for (int e = e0; e <= e1; ++e) {
      const int xr = xb - e;
      const int xc = xr - row.c_lo;
      unsigned long long cur = 0;
      if (kRev) cur = *reinterpret_cast<volatile unsigned long long*>(row.rkey + xc);
      const float4 c0 = row.plo[xc];
      const float4 c1 = row.phi[xc];
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      float s[B::kRx];
#pragma unroll
      for (int k = 0; k < B::kRx; ++k) {
        s[k] = inf;
        if (k < kLo || k >= kHi) continue;
        if (kEdge && static_cast<unsigned>(e + B::kSp * k - row.min_d) >
                         static_cast<unsigned>(row.max_d - row.min_d))
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
        for (int k = 1; k < B::kRx; ++k) rb = fminf(rb, s[k]);
        if (rb <= __uint_as_float(static_cast<unsigned>(cur >> 32))) {
          int first = 0;
#pragma unroll
          for (int k = B::kRx - 1; k >= 0; --k)
            if (s[k] == rb) first = k;
          const unsigned long long key = pack(rb, xb + B::kSp * first);
          if (key < cur) atomicMin(row.rkey + xc, key);
        }
      }
    }
  }
}

// Head J = kRx - 1 .. 1: offsets [min_d - kSp J, min_d - kSp (J - 1) - 1] of
// [ea, eb], where the columns k < J have no pair yet (and, the band being at
// least kSpread wide, every column's offset is at most max_d).
template <class B, int kHi, bool kRev, int J>
__device__ __forceinline__ void heads(int ea, int eb, int xb, const float q[B::kRx][8],
                                      float fb[B::kRx], int fm[B::kRx], const Row& row) {
  if constexpr (J >= 1) {
    walk<B, J, kHi, false, kRev>(max(ea, row.min_d - B::kSp * J),
                                 min(eb, row.min_d - B::kSp * (J - 1) - 1), xb, q, fb, fm, row);
    heads<B, kHi, kRev, J - 1>(ea, eb, xb, q, fb, fm, row);
  }
}

// Tail J = kRx - 1 .. 1: offsets [max_d - kSp J + 1, max_d - kSp (J - 1)] of
// [ea, eb], where the columns k >= J are past max_d.
template <class B, int kHi, bool kRev, int J>
__device__ __forceinline__ void tails(int ea, int eb, int xb, const float q[B::kRx][8],
                                      float fb[B::kRx], int fm[B::kRx], const Row& row) {
  if constexpr (J >= 1) {
    walk<B, 0, (J < kHi ? J : kHi), false, kRev>(max(ea, row.max_d - B::kSp * J + 1),
                                                 min(eb, row.max_d - B::kSp * (J - 1)), xb, q,
                                                 fb, fm, row);
    tails<B, kHi, kRev, J - 1>(ea, eb, xb, q, fb, fm, row);
  }
}

// Offsets [ea, eb] of a group, by one warp, scoring columns k < kHi, in
// ascending e: the head, the steps where every column pairs, the tail.
template <class B, int kHi, bool kRev>
__device__ __forceinline__ void walks(int ea, int eb, int xb, const float q[B::kRx][8],
                                      float fb[B::kRx], int fm[B::kRx], const Row& row) {
  if (row.max_d - row.min_d >= B::kSpread) {
    heads<B, kHi, kRev, B::kRx - 1>(ea, eb, xb, q, fb, fm, row);
    walk<B, 0, kHi, false, kRev>(max(ea, row.min_d), min(eb, row.max_d - B::kSpread), xb, q,
                                 fb, fm, row);
    tails<B, kHi, kRev, B::kRx - 1>(ea, eb, xb, q, fb, fm, row);
  } else {
    walk<B, 0, kHi, true, kRev>(ea, eb, xb, q, fb, fm, row);
  }
}

// walks() with kHi = hi (1 <= hi <= kRx) as a compile-time constant.
template <class B, bool kRev, int kHi = B::kRx>
__device__ __forceinline__ void walks_upto(int hi, int ea, int eb, int xb,
                                           const float q[B::kRx][8], float fb[B::kRx],
                                           int fm[B::kRx], const Row& row) {
  if constexpr (kHi > 1) {
    if (hi < kHi) {
      walks_upto<B, kRev, kHi - 1>(hi, ea, eb, xb, q, fb, fm, row);
      return;
    }
  }
  walks<B, kHi, kRev>(ea, eb, xb, q, fb, fm, row);
}

// Offsets [ea, eb] of the group at column X0, by one warp; query column x's
// forward key is fkey[x - q_lo].
template <class B, bool kRev>
__device__ __forceinline__ void run(int X0, int ea, int eb, const float* left, int H, int W,
                                    int y, unsigned long long* fkey, int q_lo, const Row& row) {
  const int xb = X0 + B::base(threadIdx.x & 31);
  float q[B::kRx][8];
  float fb[B::kRx];
  int fm[B::kRx];
  const float below_big = __int_as_float(__float_as_int(kBig) - 1);
#pragma unroll
  for (int k = 0; k < B::kRx; ++k) {
    const int x = xb + B::kSp * k;
    if (x < W) {
      pattern8(left, H, W, y, x, q[k]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) q[k][i] = __int_as_float(0x7f800000);
    }
    fb[k] = below_big;
    fm[k] = -1;
  }
  // Columns k with some lane inside the image (its smallest x is X0 + kSp k).
  walks_upto<B, kRev>(min(B::kRx, (W - X0 + B::kSp - 1) / B::kSp), ea, eb, xb, q, fb, fm, row);
#pragma unroll
  for (int k = 0; k < B::kRx; ++k) {
    if (fm[k] >= 0) atomicMin(fkey + xb + B::kSp * k - q_lo, pack(fb[k], fm[k]));
  }
}

// The groups of query columns [Xa, Xb) (Xa a multiple of kGroup), by the
// block's warps, against the candidate columns [c_lo_pair, c_hi_pair) that
// the staged planes hold unpadded. Group X0 walks offsets [max(min_d -
// kSpread, X0 - c_hi_pair + 1), min(max_d, X0 + kLastBase - c_lo_pair)]: the
// union of its lanes' columns' candidates in that span. The steps of all
// groups, end to end, are cut into kWarps equal runs.
template <class B, bool kRev>
__device__ __forceinline__ void walk_groups(int Xa, int Xb, int c_lo_pair, int c_hi_pair,
                                            const float* left, int H, int W, int y,
                                            unsigned long long* fkey, const Row& row) {
  const int e_lo = row.min_d - B::kSpread;
  auto first = [&](int X0) { return max(e_lo, X0 - c_hi_pair + 1); };
  auto last = [&](int X0) { return min(row.max_d, X0 + B::kLastBase - c_lo_pair); };
  long long total = 0;
  for (int X0 = Xa; X0 < Xb; X0 += B::kGroup) total += max(0, last(X0) - first(X0) + 1);
  const int warp = threadIdx.x >> 5;
  const long long s0 = total * warp / kWarps;
  const long long s1 = total * (warp + 1) / kWarps;
  long long base = 0;
  for (int X0 = Xa; X0 < Xb && base < s1; X0 += B::kGroup) {
    const int ea = first(X0);
    const int len = max(0, last(X0) - ea + 1);
    const long long a = max(s0, base);
    const long long z = min(s1, base + len);
    if (a < z) {
      run<B, kRev>(X0, ea + static_cast<int>(a - base), ea + static_cast<int>(z - base) - 1,
                   left, H, W, y, fkey, Xa, row);
    }
    base += len;
  }
}

// One block per row y = blockIdx.x, blockDim.x = kThreads, staged_bytes<B>(W,
// kRev) of dynamic shared memory at `smem`. rmatch is written with kRev;
// second may be null. Requires 1 <= min_d <= max_d.
template <class B, bool kRev>
__device__ __forceinline__ void search_row(unsigned long long* smem, const float* left,
                                           const float* right, float* best, int* match,
                                           int* rmatch, float* second, int H, int W,
                                           int boundary, int min_d, int max_d,
                                           int second_excl) {
  constexpr int kPad = B::kPad;
  // Reverse keys and pattern planes hold candidate columns -kPad .. W + kPad - 1.
  unsigned long long* fkey = smem;
  unsigned long long* rkey = smem + W;
  float4* plo = reinterpret_cast<float4*>(smem + key_words(W, kRev, kPad));
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

  // Every group walks from min_d - kSpread (no candidate column on the right
  // is cut: the planes hold zeros past the image, read only by query columns
  // past it) to min(max_d, X0 + kLastBase - b).
  const Row row{plo, phi, rkey, min_d, max_d, -kPad};
  walk_groups<B, kRev>(0, W, b, 1 << 30, left, H, W, y, fkey, row);
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

// Launches `kernel` (a __global__ wrapper of search_row<B, kRev>) with one
// block per row on `stream`; returns the cudaError_t of the launch.
template <class B, bool kRev, class Kernel>
int launch(Kernel kernel, const float* left, const float* right, float* best, int* match,
           int* rmatch, float* second, int H, int W, int boundary, int min_d, int max_d,
           int second_excl, cudaStream_t stream) {
  const size_t smem = staged_bytes<B>(W, kRev);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<H, kThreads, smem, stream>>>(left, right, best, match, rmatch, second, H, W, boundary,
                                        min_d, max_d, second_excl);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tiled route, for rows whose keys and planes do not fit one block
// (staged_bytes() above the 227 KB a block may use). Three launches:
//   1. fill_keys: per-row forward (and reverse) key buffers in device memory,
//      every key pack(kBig, 0), the "no pair" answer;
//   2. search_tile: one block per (row, query tile of kTileQ columns,
//      candidate tile of up to kTileC columns inside the query tile's
//      candidate window). It stages the pattern planes of its candidate tile
//      only (padded by kPad, +inf outside the tile, so a pair with another
//      tile's candidate never scores), walks the same run<>() steps as the
//      one-block route over the offsets that reach its candidate tile, and
//      merges its forward and reverse keys into the device buffers with a
//      64-bit atomicMin. Keys are (SSD bits, index): the minimum over tiles
//      is the one-block route's minimum, whatever the order of the merges;
//   3. finish_keys: unpacks best, match and rmatch, and computes second as
//      search_row() does, from the final match, reading the right image.
// So both routes give the same bits.
constexpr int kTileQ = 1024;  // query columns of a block (8 groups of 128)
constexpr int kTileC = 2048;  // candidate columns of a block

// Dynamic shared memory of one tiled-route block (any image width).
template <class B>
__host__ __device__ constexpr size_t tile_bytes(bool rev) {
  static_assert(kTileQ % B::kGroup == 0, "a group never straddles two query tiles");
  return sizeof(unsigned long long) * (kTileQ + (rev ? kTileC + 2 * B::kPad : 0)) +
         2 * sizeof(float4) * (kTileC + 2 * B::kPad);
}

__global__ void fill_keys(unsigned long long* keys, long long n) {
  const unsigned long long none = pack(kBig, 0);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    keys[i] = none;
}

// Row y = blockIdx.z, query tile blockIdx.y, candidate tile blockIdx.x;
// blockDim.x = kThreads, tile_bytes<B>(kRev) of dynamic shared memory.
// gfkey/grkey: (H, W) key buffers filled by fill_keys (grkey with kRev).
template <class B, bool kRev>
__device__ __forceinline__ void search_tile(unsigned long long* smem, const float* left,
                                            const float* right, unsigned long long* gfkey,
                                            unsigned long long* grkey, int H, int W,
                                            int boundary, int min_d, int max_d) {
  constexpr int kPad = B::kPad;
  const int y = blockIdx.z;
  const int Q0 = blockIdx.y * kTileQ;
  const int Q1 = min(W, Q0 + kTileQ);
  // The query tile's candidates are [max(b, Q0 - max_d), Q1 - min_d); this
  // block's are the blockIdx.x-th kTileC of them.
  const int C0 = max(max(boundary, 0), Q0 - max_d) + static_cast<int>(blockIdx.x) * kTileC;
  const int C1 = min(Q1 - min_d, C0 + kTileC);
  if (C0 >= C1) return;  // the same for the whole block
  const int n = C1 - C0 + 2 * kPad;  // candidate columns C0 - kPad .. C1 + kPad - 1
  unsigned long long* fkey = smem;
  unsigned long long* rkey = smem + kTileQ;
  float4* plo = reinterpret_cast<float4*>(smem + kTileQ + (kRev ? kTileC + 2 * kPad : 0));
  float4* phi = plo + kTileC + 2 * kPad;
  const unsigned long long none = pack(kBig, 0);
  const float inf = __int_as_float(0x7f800000);
  for (int x = threadIdx.x; x < kTileQ; x += kThreads) fkey[x] = none;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (kRev) rkey[i] = none;
    const int xr = C0 - kPad + i;
    float v[8];
    if (xr < C0 || xr >= C1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = inf;  // no pair in this block
    } else {
      pattern8(right, H, W, y, xr, v);
    }
    plo[i] = make_float4(v[0], v[1], v[2], v[3]);
    phi[i] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  const Row row{plo, phi, rkey, min_d, max_d, C0 - kPad};
  walk_groups<B, kRev>(Q0, Q1, C0, C1, left, H, W, y, fkey, row);
  __syncthreads();

  // Only keys that a pair lowered are merged (every other is `none`).
  unsigned long long* frow = gfkey + static_cast<size_t>(y) * W;
  for (int x = Q0 + threadIdx.x; x < Q1; x += kThreads) {
    const unsigned long long f = fkey[x - Q0];
    if (f < none) atomicMin(frow + x, f);
  }
  if (kRev) {
    unsigned long long* rrow = grkey + static_cast<size_t>(y) * W;
    for (int xr = C0 + threadIdx.x; xr < C1; xr += kThreads) {
      const unsigned long long r = rkey[xr - C0 + kPad];
      if (r < none) atomicMin(rrow + xr, r);
    }
  }
}

// One thread per pixel: best/match (and rmatch when rkey is not null) from
// the merged keys; second, when not null, as search_row() computes it.
__global__ void finish_keys(const unsigned long long* fkey, const unsigned long long* rkey,
                            const float* left, const float* right, float* best, int* match,
                            int* rmatch, float* second, int H, int W, int boundary, int min_d,
                            int max_d, int second_excl) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<long long>(H) * W) return;
  const unsigned long long f = fkey[i];
  best[i] = __uint_as_float(static_cast<unsigned>(f >> 32));
  match[i] = static_cast<int>(f & 0xffffffffu);
  if (rkey != nullptr) rmatch[i] = static_cast<int>(rkey[i] & 0xffffffffu);
  if (second == nullptr) return;
  const int y = static_cast<int>(i / W);
  const int x = static_cast<int>(i % W);
  const int m = static_cast<int>(f & 0xffffffffu);
  float q[8];
  float c[8];
  pattern8(left, H, W, y, x, q);
  const int lo = max(max(boundary, 0), x - max_d);
  const int hi = x - min_d;
  float b2 = kBig;
  for (int xr = lo; xr <= hi; ++xr) {
    if (abs(xr - m) <= second_excl) continue;
    pattern8(right, H, W, y, xr, c);
    b2 = fminf(b2, ssd8(q, c));
  }
  second[i] = b2;
}

// Launches the tiled route on `stream`: `kernel` is a __global__ wrapper of
// search_tile<B, kRev>; `keys` holds H * W keys, 2 * H * W with kRev.
// Returns the first cudaError_t of the three launches (0 on success).
template <class B, bool kRev, class Kernel>
int launch_tiled(Kernel kernel, const float* left, const float* right, float* best, int* match,
                 int* rmatch, float* second, unsigned long long* keys, int H, int W,
                 int boundary, int min_d, int max_d, int second_excl, cudaStream_t stream) {
  const size_t smem = tile_bytes<B>(kRev);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long pixels = static_cast<long long>(H) * W;
  unsigned long long* fkey = keys;
  unsigned long long* rkey = kRev ? keys + pixels : nullptr;
  const long long n = kRev ? 2 * pixels : pixels;
  const long long fill_blocks = (n + 255) / 256;
  fill_keys<<<static_cast<unsigned>(fill_blocks < 4096 ? fill_blocks : 4096), 256, 0, stream>>>(
      keys, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // Candidate tiles per query tile: its window spans at most
  // kTileQ + min(max_d, W) - min_d columns.
  const int span = kTileQ + (max_d < W ? max_d : W) - min_d;
  const int tiles_c = (span + kTileC - 1) / kTileC;
  const dim3 grid(static_cast<unsigned>(tiles_c > 1 ? tiles_c : 1),
                  static_cast<unsigned>((W + kTileQ - 1) / kTileQ), static_cast<unsigned>(H));
  kernel<<<grid, kThreads, smem, stream>>>(left, right, fkey, rkey, H, W, boundary, min_d, max_d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  finish_keys<<<static_cast<unsigned>((pixels + 255) / 256), 256, 0, stream>>>(
      fkey, rkey, left, right, best, match, rmatch, second, H, W, boundary, min_d, max_d,
      second_excl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd_row
