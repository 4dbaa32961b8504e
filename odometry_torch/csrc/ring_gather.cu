// One-shot all-gather of per-rank shards, on one card or across the cards of
// one host, sm_90a.
//
// Replaces the TPU kernel odometry_tpu/distributed/ring_exchange.py:_ring_kernel
// (launched by _ring_all_gather_padded, entries ring_all_gather and
// gather_keyframe_poses), and computes the same all-gather: every rank's
// output holds every rank's (chunk, D) shard at its origin's place. There a
// device's DMA reaches only its ring neighbours over ICI, so the shards walk a
// ring of num - 1 hops through comm slots, each hop behind a semaphore.
//
// Here there is no ring. Block (g, i) reads byte slice g of source shard
// j = src[i] once and writes it to out[r] + j * nbytes for every rank r. No
// comm slots, no flags, no waits: an ordinary launch whose blocks are
// independent, so any number of them may be resident.
//
// Ranks that share one card share its memory: one launch takes every shard
// (src = 0..num-1, ring_gather_launch_ranks). Across cards the design is *push*: one launch per source
// card, on that card, takes the shards it holds and writes them into every
// rank's output, those on peer cards through their device pointers over
// NVLink (peer access enabled, ring_gather_enable_peer). Push rather than
// pull because each launch then reads only memory of its own card, so the
// shards are known complete by the ordering of that card's own stream, and
// the only cross-card hazards are on the outputs: the wrapper
// (distributed/ring_exchange.py) makes each source card's stream wait for
// every card that holds an output before its launch, and every card's stream
// wait for every launch after. Every H100 of a host reaches every other
// directly, so a ring of num - 1 hops would only add latency.
//
// What bounds it on the H100: bytes. An all-gather of num shards of B bytes on
// one card must read num * B and write num^2 * B (every rank's output); at 8
// ranks of 7 x 16384 float32 that is 33.0 MB, 9.9 us at 3.35 TB/s. Across c
// cards with one rank each, a card receives (c - 1) * B over NVLink (450 GB/s
// each way) and writes c * B to its memory; at 4 cards of 7 x 16384 float32
// the link bounds it, 3.06 us. The kernel moves exactly those bytes: each
// shard is read once through the read-only path (the shards are complete
// before the launch) and each output byte is written once. Copies run in
// 16-byte vectors when every shard, every output and the shard size are
// 16-byte aligned, else in 4-byte words when all are 4-byte aligned, else in
// bytes (the launcher picks the width once per call); a slice's tail past the
// last whole vector goes in bytes. Each thread loads kVec vectors before it
// stores them, so several loads are in flight.
//
// Across processes of one host the kernel is the same push: each process
// launches once per card it holds, and the outputs of other processes' ranks
// are pointers into their allocations, opened here through CUDA IPC
// (ring_gather_ipc_export / _open / _close below; two processes on one card
// need no peer access, two cards take it lazily when the handle opens). The
// wrapper orders the processes' streams with interprocess events behind host
// barriers.
//
// The per-rank pointers (shards, outputs, on this card or a peer) and the
// launch's source ranks travel as one table in the kernel's parameters
// (constant bank, __grid_constant__: indexed in place, never copied to local
// memory).

#include <cuda.h>  // the driver's types only: cuPointerGetAttributes is found with dlsym
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;
constexpr int kVec = 2;                         // vectors per thread per round
constexpr long long kSlice = 16LL * kThreads * kVec;  // bytes of a shard per block
constexpr int kNoPeerAccess = -1;               // ring_gather_enable_peer: not possible
constexpr int kNoDriver = -2;      // ring_gather_ipc_export: no cuPointerGetAttribute
constexpr int kNotIpcCapable = -3;  // ring_gather_ipc_export: not legacy-IPC memory
constexpr int kDriverError = -1000;  // ring_gather_ipc_export: kDriverError - CUresult

struct RankTable {
  const char* local[kMaxRanks];
  char* out[kMaxRanks];
  int src[kMaxRanks];  // the source ranks of this launch, blockIdx.y -> rank
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

// blockIdx.y: the launch's i-th source shard, rank src[i]; blockIdx.x: byte
// slice g of it. width: 16, 4 or 1, the vector width that every address and
// nbytes allow.
__global__ void __launch_bounds__(kThreads)
all_gather_kernel(const __grid_constant__ RankTable table, int num, long long nbytes,
                  int width) {
  const int j = table.src[blockIdx.y];
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

// Pushes the `count` shards of ranks src[0..count) (of `num`, `nbytes` bytes
// each) into every rank's output, on `stream` of the current card: local and
// out are host arrays of `num` device pointers, rank r's shard and its output
// (num * nbytes bytes, shard j at j * nbytes), on this card or a peer card
// whose access is enabled. Returns the cudaError_t of the launch (0 on
// success, and nothing launched when nbytes is 0; cudaErrorInvalidValue for
// more than kMaxRanks ranks or a source rank out of range).
extern "C" int ring_gather_launch_ranks(const unsigned long long* local,
                                        const unsigned long long* out, int num, const int* src,
                                        int count, long long nbytes, void* stream) {
  if (num < 1 || num > kMaxRanks || count < 1 || count > num || nbytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  RankTable table;
  uintptr_t a = static_cast<uintptr_t>(nbytes);
  for (int r = 0; r < num; ++r) {
    table.local[r] = reinterpret_cast<const char*>(local[r]);
    table.out[r] = reinterpret_cast<char*>(out[r]);
    a |= static_cast<uintptr_t>(local[r]) | static_cast<uintptr_t>(out[r]);
  }
  for (int i = 0; i < count; ++i) {
    if (src[i] < 0 || src[i] >= num) return static_cast<int>(cudaErrorInvalidValue);
    table.src[i] = src[i];
  }
  const int width = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  const dim3 grid(static_cast<unsigned int>((nbytes + kSlice - 1) / kSlice), count);
  all_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table, num, nbytes,
                                                                              width);
  return static_cast<int>(cudaGetLastError());
}

// Lets kernels on card `dev` read and write card `peer`'s memory. Returns 0
// when access is enabled (or already was), kNoPeerAccess when the pair
// cannot have it, else the cudaError_t of the failing call. The calling
// thread's current card is restored.
extern "C" int ring_gather_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return kNoPeerAccess;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the "already enabled" error state
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// ---------------------------------------------------------------- CUDA IPC

namespace {

typedef CUresult (*PointerAttributesFn)(unsigned int, CUpointer_attribute*, void**, CUdeviceptr);

PointerAttributesFn pointer_attributes() {
  static const PointerAttributesFn fn = []() -> PointerAttributesFn {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<PointerAttributesFn>(dlsym(lib, "cuPointerGetAttributes"))
               : nullptr;
  }();
  return fn;
}

// The handles exported so far, by buffer id (ids are never reused, so an
// entry never goes stale; a freed allocation's stays, 64 bytes).
std::mutex exported_mutex;
std::unordered_map<unsigned long long, cudaIpcMemHandle_t> exported;

}  // namespace

// Exports, for other processes, the allocation that holds device pointer
// `ptr` (PyTorch's caching allocator sub-allocates, and a handle names a
// whole allocation): writes its legacy IPC handle (64 bytes) to `handle` and
// [ptr's byte offset in it, its base address, its size, its buffer id] to
// `info`. The buffer id is unique in this process for as long as it runs,
// never reused by a later allocation at the same address; an allocation's
// handle is asked of the runtime once. Returns 0, kNoDriver, kNotIpcCapable
// (memory that legacy IPC cannot export, as expandable segments are),
// kDriverError - CUresult, or the cudaError_t of cudaIpcGetMemHandle.
extern "C" int ring_gather_ipc_export(unsigned long long ptr, unsigned char* handle,
                                      unsigned long long* info) {
  const PointerAttributesFn attrs = pointer_attributes();
  if (attrs == nullptr) return kNoDriver;
  unsigned int capable = 0;
  CUdeviceptr base = 0;
  size_t size = 0;
  unsigned long long buffer_id = 0;
  CUpointer_attribute which[4] = {CU_POINTER_ATTRIBUTE_IS_LEGACY_CUDA_IPC_CAPABLE,
                                  CU_POINTER_ATTRIBUTE_RANGE_START_ADDR,
                                  CU_POINTER_ATTRIBUTE_RANGE_SIZE,
                                  CU_POINTER_ATTRIBUTE_BUFFER_ID};
  void* data[4] = {&capable, &base, &size, &buffer_id};
  const CUresult res = attrs(4, which, data, ptr);
  if (res != CUDA_SUCCESS) return kDriverError - static_cast<int>(res);
  if (!capable) return kNotIpcCapable;
  cudaIpcMemHandle_t h;
  {
    std::lock_guard<std::mutex> lock(exported_mutex);
    auto it = exported.find(buffer_id);
    if (it == exported.end()) {
      const cudaError_t err = cudaIpcGetMemHandle(&h, reinterpret_cast<void*>(base));
      if (err != cudaSuccess) return static_cast<int>(err);
      exported.emplace(buffer_id, h);
    } else {
      h = it->second;
    }
  }
  memcpy(handle, &h, sizeof(h));
  info[0] = ptr - base;
  info[1] = base;
  info[2] = size;
  info[3] = buffer_id;
  return 0;
}

// Opens another process's allocation (its handle from ring_gather_ipc_export)
// on the current card, enabling peer access lazily where it lies on another
// card; writes the base pointer here to `ptr`. Returns the cudaError_t.
extern "C" int ring_gather_ipc_open(const unsigned char* handle, unsigned long long* ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  const cudaError_t err = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  *ptr = reinterpret_cast<unsigned long long>(p);
  return static_cast<int>(err);
}

// Closes a pointer that ring_gather_ipc_open returned. Returns the cudaError_t.
extern "C" int ring_gather_ipc_close(unsigned long long ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(reinterpret_cast<void*>(ptr)));
}
