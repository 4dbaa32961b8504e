// Ring all-gather of per-rank shards over ranks that share one card, sm_90a.
//
// Replaces the TPU kernel odometry_tpu/distributed/ring_exchange.py:_ring_kernel
// (launched by _ring_all_gather_padded, entries ring_all_gather and
// gather_keyframe_poses). There each device of a mesh owns a (chunk, D) shard;
// the kernel writes its own shard to its place in the output and seeds comm
// slot 0, then in num - 1 steps copies slot s to slot s + 1 of the right
// neighbour with a remote DMA and unpacks the chunk that arrived, which
// originated s + 1 ranks back. One comm slot per step, so every slot is
// written once per call and read only after its own signal: no
// write-after-read hazard (ring_exchange.py:10-21).
//
// Here the ranks of a mesh are CTA groups of one cooperative grid: rank r owns
// blocks [r * G, (r + 1) * G), and block g of every rank moves byte slice g of
// the chunk through the whole ring on its own. The chain of block g is
//   step 0:  local[r] slice -> out[r][r] and comm[r + 1][1], then signal
//            flag[r + 1][1][g]
//   step s:  wait flag[r][s][g]; comm[r][s] slice -> out[r][(r - s) mod num]
//            and, for s < num - 1, comm[r + 1][s + 1], then signal
//            flag[r + 1][s + 1][g]
// (the reference's seed slot 0 is not written: the own shard goes straight to
// the neighbour's slot 1, and each arrived slot is read once, for the unpack
// and the next hop together). Byte slices make the kernel indifferent to the
// dtype, chunk and D: no padding to tiles.
//
// Signals. A flag holds the epoch of the call that last wrote it; the wrapper
// passes a new epoch each call, so flags need no reset between calls. The
// sender's threads fence their slot stores (__threadfence) before a barrier,
// then thread 0 stores the flag with st.release.gpu; the receiver's thread 0
// spins with ld.acquire.gpu, then a barrier releases the block, and the slot
// is read through L2 (__ldcg), never a stale L1 line. Every spin is bounded by
// kSpinCycles of clock64(): past it the block writes the error word and
// leaves, and the wrapper raises. Spin-waits across blocks deadlock unless
// every block is resident at once, so the grid is launched with
// cudaLaunchCooperativeKernel, which refuses a grid that does not fit.
//
// The per-rank pointers (local shard, comm slots (num, chunk bytes), output
// (num, chunk bytes), flags (num, G)) travel as one table in the kernel's
// parameters (constant bank): no copy per call, and pointers to peer cards
// would fit the same table.
//
// What bounds it on the H100: bytes. An all-gather of num shards of B bytes on
// one card must read num * B and write num^2 * B (every rank's output); at 8
// ranks of 7 x 16384 float32 that is 33.0 MB, 9.9 us at 3.35 TB/s. This
// kernel also writes and reads each hop's slot (2 (num - 1) num B more) and
// pays one signal round trip per step on the critical path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;
// About one second at the H100's clocks: far above any real wait.
constexpr long long kSpinCycles = 2000000000LL;

struct RankTable {
  const char* local[kMaxRanks];
  char* comm[kMaxRanks];
  char* out[kMaxRanks];
  int* flags[kMaxRanks];
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Bytes [lo, hi) of src to dst and, when dst2 is not null, to dst2, by the
// whole block: 16-byte vectors when every address is 16-byte aligned, else
// 4-byte words when all are 4-byte aligned, else bytes; the tail in bytes.
// src is read through L2 (it may have been written by another block).
__device__ void copy_slice(char* dst, char* dst2, const char* src, long long lo, long long hi) {
  if (lo >= hi) return;
  const long long n = hi - lo;
  src += lo;
  dst += lo;
  if (dst2 != nullptr) dst2 += lo;
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst2);
  long long done = 0;
  if ((a & 15) == 0) {
    const long long nv = n / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    uint4* d2 = reinterpret_cast<uint4*>(dst2);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 v = __ldcg(s + i);
      d[i] = v;
      if (d2 != nullptr) d2[i] = v;
    }
    done = nv * 16;
  } else if ((a & 3) == 0) {
    const long long nw = n / 4;
    const unsigned int* s = reinterpret_cast<const unsigned int*>(src);
    unsigned int* d = reinterpret_cast<unsigned int*>(dst);
    unsigned int* d2 = reinterpret_cast<unsigned int*>(dst2);
    for (long long i = threadIdx.x; i < nw; i += blockDim.x) {
      const unsigned int v = __ldcg(s + i);
      d[i] = v;
      if (d2 != nullptr) d2[i] = v;
    }
    done = nw * 4;
  }
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  unsigned char* d2 = reinterpret_cast<unsigned char*>(dst2);
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) {
    const unsigned char v = __ldcg(s + i);
    d[i] = v;
    if (d2 != nullptr) d2[i] = v;
  }
}

// Every thread's slot stores become visible at gpu scope before the flag.
__device__ __forceinline__ void signal(int* flag, int epoch) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, epoch);
}

// True once `flag` holds `epoch`; false (and the error word set) after
// kSpinCycles. All threads of the block return the same value.
__device__ __forceinline__ bool wait_flag(const int* flag, int epoch, int* err) {
  int ok = 1;
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(flag) != epoch) {
      if (clock64() - t0 > kSpinCycles) {
        ok = 0;
        atomicExch(err, 1);
        break;
      }
      __nanosleep(64);
    }
  }
  return __syncthreads_and(ok) != 0;
}

__global__ void __launch_bounds__(kThreads)
ring_gather_kernel(const RankTable table, int* err, int num, int G, long long nbytes,
                   long long slice, int epoch) {
  const int r = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int right = (r + 1) % num;
  const long long lo = min(nbytes, g * slice);
  const long long hi = min(nbytes, lo + slice);
  char* out = table.out[r];
  char* comm = table.comm[r];
  char* next = table.comm[right];
  int* next_flags = table.flags[right];

  copy_slice(out + r * nbytes, num > 1 ? next + nbytes : nullptr, table.local[r], lo, hi);
  if (num > 1) signal(next_flags + 1 * G + g, epoch);
  for (int s = 1; s < num; ++s) {
    if (!wait_flag(table.flags[r] + s * G + g, epoch, err)) return;
    const int origin = (r - s + num) % num;
    const bool forward = s + 1 < num;
    copy_slice(out + origin * nbytes, forward ? next + (s + 1) * nbytes : nullptr,
               comm + s * nbytes, lo, hi);
    if (forward) signal(next_flags + (s + 1) * G + g, epoch);
  }
}

}  // namespace

// How many blocks of the kernel can be resident at once on the current
// device (0 when it cannot launch cooperative grids), in *blocks. Returns the
// cudaError_t of the queries.
extern "C" int ring_gather_max_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_gather_kernel, kThreads, 0);
  *blocks = coop ? sms * per_sm : 0;
  return static_cast<int>(e);
}

// All-gathers `num` shards of `nbytes` bytes each, `blocks_per_rank` blocks per
// rank, on `stream`. local/comm/out/flags are host arrays of `num` device
// pointers: rank r's shard, its comm slots (num * nbytes bytes), its output
// (num * nbytes bytes) and its flags (num * blocks_per_rank int32, holding
// epochs other than `epoch`). err is one device int32, set to 1 if a block
// waited past the timeout. Returns the cudaError_t of the launch (0 on
// success; cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident at once, cudaErrorInvalidValue for more than kMaxRanks ranks).
extern "C" int ring_gather_launch(const unsigned long long* local, const unsigned long long* comm,
                                  const unsigned long long* out, const unsigned long long* flags,
                                  int* err, int num, int blocks_per_rank, long long nbytes,
                                  int epoch, void* stream) {
  if (num < 1 || num > kMaxRanks || blocks_per_rank < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RankTable table;
  for (int r = 0; r < num; ++r) {
    table.local[r] = reinterpret_cast<const char*>(local[r]);
    table.comm[r] = reinterpret_cast<char*>(comm[r]);
    table.out[r] = reinterpret_cast<char*>(out[r]);
    table.flags[r] = reinterpret_cast<int*>(flags[r]);
  }
  int G = blocks_per_rank;
  long long slice = ((nbytes + G - 1) / G + 15) / 16 * 16;
  void* args[] = {&table, &err, &num, &G, &nbytes, &slice, &epoch};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ring_gather_kernel), dim3(num * G),
                                  dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  // A refused launch also sets the last error; clear it so a later launch
  // check elsewhere does not report it again.
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
