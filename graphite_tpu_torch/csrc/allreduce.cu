// Rank-order all-reduce and gather over CUDA IPC: kernel K8.
//
// Replaces no TPU kernel. It is the port's counterpart of the JAX package's
// lax.psum over the factor axis (graphite_tpu/parallel/sharding.py: every
// cross-factor reduction of a rank's replica, problem.allreduce, and the
// Schur stage's sum of the ranks' disjoint S ranges, graphite_tpu/schur.py).
// XLA schedules those inside the one program of sharded_lm; here they run
// inside the captured LM iteration (ops/device_loop.py), so the transport
// has to be device work that a CUDA graph can hold and that two ranks can
// share on one card (NCCL refuses that, gloo's transport has host steps).
//
// The arena. Each rank owns one block from cudaMalloc (not PyTorch's
// caching allocator: an IPC handle names a whole allocation), mapped once
// by every peer (cudaIpcOpenMemHandle). It holds a header (Header below:
// the published flag, the rank's epoch, the arrival counters and the error
// word) and two halves of `half_bytes` each.
//
// A call (every rank issues the same sequence of calls, with the same
// sizes) is two launches on the caller's stream:
//   put     e = epoch + 1 (the device counter: a replay takes no host
//           argument); copy x into half e & 1 of the own arena; the last
//           block to finish raises the rank's flag to e (st.release.sys,
//           after a system-scope fence: another context, or another card,
//           reads the half);
//   reduce  wait (ld.acquire.sys) until every peer's flag has reached e;
//           then out[i] = row 0 [i] + row 1 [i] + ... added left to right
//           in rank order (gather: out[r, i] = row r [i]); the last block
//           to finish sets epoch = e.
// Each row is first added to +0, as the plain version's rows are (a sum
// of one non-zero term in a zeroed buffer): -0 becomes +0, so the two
// agree bit for bit.
//
// Why two halves are enough: rank r writes half p again at call e + 2,
// after its reduce of call e + 1, which waited for every peer's flag of
// call e + 1; a peer raises that flag only after its reduce of call e,
// the last read of half p of call e, has finished (stream order).
//
// The wait is bounded: after `spin_ns` of the card's global timer (not
// clock64: a preempted block may resume on another SM, whose clock differs)
// the block records the call's tag, the missing peer and the epoch in the
// error word and gives up; a call that finds the word set skips its wait
// and its sums. The wrapper reads the word after an eager call and after a
// captured run and raises (ops/cuda/allreduce.py).
//
// Bound: bytes. x read once, the own half written, `world` halves read and
// out written: (world + 3) x bytes at the card's memory rate; the flags
// and the wait are latency (on one card, two processes' kernels are
// time-sliced, so a waiting rank holds the card until its slice ends).
// Both passes are grid-stride loops of coalesced element loads and
// stores; the halves are read with ld.global.cg (L2, never a stale L1
// line of an earlier call).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxWorld = 8;
constexpr long long kHeaderBytes = 4096;
constexpr int kThreads = 256;

struct Header {
  unsigned long long flag;  // the last epoch this rank published
  unsigned long long pad0[15];  // the flag alone on its 128-byte line
  unsigned long long epoch;  // calls this rank has completed
  unsigned int put_done;  // blocks of the running put that finished
  unsigned int reduce_done;  // blocks of the running reduce that finished
  unsigned long long pad1[14];
  // tag + 1 of the first call that timed out (0: none), the peer it
  // waited for, the epoch, the budget in ns
  long long error[4];
};
static_assert(sizeof(Header) <= kHeaderBytes, "header too large");
static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle size");

struct Arenas {
  char* base[kMaxWorld];  // every rank's arena as this process maps it
};

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ long long add(long long a, long long b) {
  return a + b;
}

__device__ __forceinline__ unsigned long long read_epoch(const Header* h) {
  return *reinterpret_cast<const volatile unsigned long long*>(&h->epoch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    put_kernel(const T* __restrict__ x, char* own, long long n,
               long long half_bytes) {
  Header* h = reinterpret_cast<Header*>(own);
  const unsigned long long e = read_epoch(h) + 1;
  T* dst = reinterpret_cast<T*>(own + kHeaderBytes + (e & 1) * half_bytes);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    dst[i] = x[i];
  __threadfence_system();  // this thread's copies before the arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(&h->put_done, 1u) == gridDim.x - 1) {  // the last block
      h->put_done = 0;
      __threadfence_system();
      store_release_sys(&h->flag, e);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(T* __restrict__ out, Arenas arenas, int world, int rank,
                  long long n, int gather, long long half_bytes, int tag,
                  long long spin_ns) {
  Header* h = reinterpret_cast<Header*>(arenas.base[rank]);
  const unsigned long long e = read_epoch(h) + 1;
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = *reinterpret_cast<volatile long long*>(&h->error[0]) == 0;
    const unsigned long long start = global_ns();
    for (int p = 0; p < world && ok; ++p) {
      if (p == rank) continue;
      const Header* ph = reinterpret_cast<const Header*>(arenas.base[p]);
      while (load_acquire_sys(&ph->flag) < e) {
        if (global_ns() - start > static_cast<unsigned long long>(spin_ns)) {
          if (atomicCAS(reinterpret_cast<unsigned long long*>(&h->error[0]),
                        0ull, static_cast<unsigned long long>(tag) + 1) ==
              0ull) {
            h->error[1] = p;
            h->error[2] = static_cast<long long>(e);
            h->error[3] = spin_ns;
          }
          ok = 0;
          break;
        }
        __nanosleep(128);
      }
    }
  }
  __syncthreads();
  if (ok) {
    const long long off = kHeaderBytes + (e & 1) * half_bytes;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n; i += stride) {
      if (gather) {
        for (int r = 0; r < world; ++r)
          out[r * n + i] = add(
              __ldcg(reinterpret_cast<const T*>(arenas.base[r] + off) + i),
              T(0));
      } else {
        T acc = add(__ldcg(reinterpret_cast<const T*>(arenas.base[0] + off) +
                           i),
                    T(0));
        for (int r = 1; r < world; ++r)
          acc = add(acc, add(__ldcg(reinterpret_cast<const T*>(
                                        arenas.base[r] + off) +
                                    i),
                             T(0)));
        out[i] = acc;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(&h->reduce_done, 1u) == gridDim.x - 1) {  // the last block
      h->reduce_done = 0;
      *reinterpret_cast<volatile unsigned long long*>(&h->epoch) = e;
    }
  }
}

int grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  return static_cast<int>(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

template <typename T>
cudaError_t launch(const void* x, void* out, const Arenas& arenas, int world,
                   int rank, long long n, int gather, long long half_bytes,
                   int tag, long long spin_ns, cudaStream_t stream) {
  const int grid = grid_for(n);
  put_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), arenas.base[rank], n, half_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(out), arenas, world, rank, n, gather, half_bytes, tag,
      spin_ns);
  return cudaGetLastError();
}

}  // namespace

// A zeroed arena of `bytes` (header and both halves).
extern "C" int gt_allreduce_alloc(long long bytes, void** out) {
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(p, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    cudaFree(p);
    return static_cast<int>(err);
  }
  *out = p;
  return 0;
}

extern "C" int gt_allreduce_free(void* arena) {
  return static_cast<int>(cudaFree(arena));
}

// The arena's IPC handle, 64 bytes into `handle`.
extern "C" int gt_allreduce_ipc_get(void* arena, void* handle) {
  return static_cast<int>(cudaIpcGetMemHandle(
      static_cast<cudaIpcMemHandle_t*>(handle), arena));
}

// A peer's arena, mapped into this process from its 64-byte handle.
extern "C" int gt_allreduce_ipc_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int gt_allreduce_ipc_close(void* mapped) {
  return static_cast<int>(cudaIpcCloseMemHandle(mapped));
}

// One call: put and reduce on `stream`. arenas: `world` pointers, this
// process's mappings of every rank's arena (its own at `rank`); dtype 0
// float32, 1 float64, 2 int64; gather 0 (out: n) or 1 (out: world x n).
extern "C" int gt_allreduce_launch(const void* x, void* out,
                                   void* const* arenas, int world, int rank,
                                   long long n, int dtype, int gather,
                                   long long half_bytes, int tag,
                                   long long spin_ns, void* stream) {
  if (world < 1 || world > kMaxWorld || rank < 0 || rank >= world)
    return static_cast<int>(cudaErrorInvalidValue);
  Arenas a = {};
  for (int r = 0; r < world; ++r) a.base[r] = static_cast<char*>(arenas[r]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, out, a, world, rank, n, gather,
                                            half_bytes, tag, spin_ns, s));
    case 1:
      return static_cast<int>(launch<double>(x, out, a, world, rank, n,
                                             gather, half_bytes, tag, spin_ns,
                                             s));
    case 2:
      return static_cast<int>(launch<long long>(x, out, a, world, rank, n,
                                                gather, half_bytes, tag,
                                                spin_ns, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The own arena's error word and epoch after the work queued on `stream`:
// out[0..3] = error[0..3], out[4] = epoch, out[5] = flag (a synchronize).
extern "C" int gt_allreduce_status(void* arena, long long* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Header* h = static_cast<const Header*>(arena);
  cudaError_t err = cudaMemcpyAsync(out, h->error, 4 * sizeof(long long),
                                    cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(out + 4, &h->epoch, sizeof(long long),
                          cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(out + 5, &h->flag, sizeof(long long),
                          cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

extern "C" const char* gt_allreduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
