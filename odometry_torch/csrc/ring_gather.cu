// One-shot all-gather of per-rank shards over ranks that share one card, sm_90a.
//
// Replaces the TPU kernel odometry_tpu/distributed/ring_exchange.py:_ring_kernel
// (launched by _ring_all_gather_padded, entries ring_all_gather and
// gather_keyframe_poses), and computes the same all-gather: every rank's
// output holds every rank's (chunk, D) shard at its origin's place. There a
// device's DMA reaches only its ring neighbours over ICI, so the shards walk a
// ring of num - 1 hops through comm slots, each hop behind a semaphore.
//
// Ranks that share one card share its memory, so every hop of a ring is pure
// latency here. This kernel has no ring: block (g, j) reads byte slice g of
// shard j once and writes it to out[r] + j * nbytes for every rank r. No
// comm slots, no flags, no waits: an ordinary launch whose blocks are
// independent, so any number of them may be resident.
//
// What bounds it on the H100: bytes. An all-gather of num shards of B bytes on
// one card must read num * B and write num^2 * B (every rank's output); at 8
// ranks of 7 x 16384 float32 that is 33.0 MB, 9.9 us at 3.35 TB/s. The kernel
// moves exactly those bytes: each shard is read once through the read-only
// path (the shards are complete before the launch) and each output byte is
// written once. Copies run in 16-byte vectors when every shard, every output
// and the shard size are 16-byte aligned, else in 4-byte words when all are
// 4-byte aligned, else in bytes (the launcher picks the width once per call);
// a slice's tail past the last whole vector goes in bytes. Each thread loads
// kVec vectors before it stores them, so several loads are in flight.
//
// The per-rank pointers (shards, outputs) travel as one table in the kernel's
// parameters (constant bank, __grid_constant__: indexed in place, never
// copied to local memory); pointers to peer cards would fit the same table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;
constexpr int kVec = 2;                         // vectors per thread per round
constexpr long long kSlice = 16LL * kThreads * kVec;  // bytes of a shard per block

struct RankTable {
  const char* local[kMaxRanks];
  char* out[kMaxRanks];
};

// Bytes [lo, lo + n) of shard j (src) to out[r] + base + lo for every rank r,
// as vectors of V (whose size divides every address), whole vectors only;
// returns the bytes done.
template <typename V>
__device__ __forceinline__ long long scatter(const RankTable& t, int num, const char* src,
                                             long long base, long long lo, long long n) {
  const long long nv = n / static_cast<long long>(sizeof(V));
  const V* s = reinterpret_cast<const V*>(src + lo);
  for (long long i0 = threadIdx.x; i0 < nv; i0 += static_cast<long long>(kThreads) * kVec) {
    V v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < nv) v[u] = __ldg(s + i);
    }
    for (int r = 0; r < num; ++r) {
      V* d = reinterpret_cast<V*>(t.out[r] + base + lo);
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const long long i = i0 + u * kThreads;
        if (i < nv) d[i] = v[u];
      }
    }
  }
  return nv * static_cast<long long>(sizeof(V));
}

// blockIdx.y: source shard j; blockIdx.x: byte slice g of it. width: 16, 4 or
// 1, the vector width that every address and nbytes allow.
__global__ void __launch_bounds__(kThreads)
all_gather_kernel(const __grid_constant__ RankTable table, int num, long long nbytes,
                  int width) {
  const int j = blockIdx.y;
  const long long lo = blockIdx.x * kSlice;
  const long long n = min(nbytes - lo, kSlice);
  const char* src = table.local[j];
  const long long base = j * nbytes;
  long long done = 0;
  if (width == 16) {
    done = scatter<uint4>(table, num, src, base, lo, n);
  } else if (width == 4) {
    done = scatter<unsigned int>(table, num, src, base, lo, n);
  }
  scatter<unsigned char>(table, num, src, base, lo + done, n - done);
}

}  // namespace

// All-gathers `num` shards of `nbytes` bytes each on `stream`: local and out
// are host arrays of `num` device pointers, rank r's shard and its output
// (num * nbytes bytes, shard j at j * nbytes). Returns the cudaError_t of the
// launch (0 on success, and nothing launched when nbytes is 0;
// cudaErrorInvalidValue for more than kMaxRanks ranks).
extern "C" int ring_gather_launch(const unsigned long long* local, const unsigned long long* out,
                                  int num, long long nbytes, void* stream) {
  if (num < 1 || num > kMaxRanks || nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  RankTable table;
  uintptr_t a = static_cast<uintptr_t>(nbytes);
  for (int r = 0; r < num; ++r) {
    table.local[r] = reinterpret_cast<const char*>(local[r]);
    table.out[r] = reinterpret_cast<char*>(out[r]);
    a |= static_cast<uintptr_t>(local[r]) | static_cast<uintptr_t>(out[r]);
  }
  const int width = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  const dim3 grid(static_cast<unsigned int>((nbytes + kSlice - 1) / kSlice), num);
  all_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table, num, nbytes,
                                                                              width);
  return static_cast<int>(cudaGetLastError());
}
