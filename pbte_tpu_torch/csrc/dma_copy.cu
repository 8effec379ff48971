// Streaming copy kernels for NVIDIA Hopper (sm_90a): y = x, device memory to
// device memory. They measure the copy floor the lattice ring kernel's state
// streams are held against.
//
// Replaces the two Pallas TPU copy probes of scripts/bench_pallas_dma.py:
//   K2 auto_copy.<locals>.f   (body `kern`): the auto-pipelined copy over a
//      grid of row blocks;
//   K3 manual_copy.<locals>.f (body `kern`): one grid step with refs in HBM
//      and an n_bufs-deep hand-written make_async_copy pipeline
//      (in-DMA, a VMEM->VMEM copy standing in for compute, out-DMA).
// Plain PyTorch version and dispatching wrappers:
// pbte_tpu_torch/ops/dma_copy.py.
//
// What bounds them: bytes. A copy does no arithmetic, so its only limit is
// device memory (3.35 TB/s read + write on an H100 SXM data sheet), the
// bytes each SM keeps in flight to cover the memory latency, and how evenly
// the bytes are spread over the SMs: the SMs do not all stream at the same
// rate, so a fixed share per SM ends when the slowest SM ends.
//
// K2 design: the TMA tile copy. On the TPU the BlockSpec pipeline moves each
// row block into VMEM and back by DMA; here the Tensor Memory Accelerator
// does the same. One CTA per tile (the BlockSpec grid); its thread 0 arms an
// mbarrier, issues one 1-D bulk load (cp.async.bulk ... complete_tx) of the
// tile into shared memory, waits, issues one bulk store of the same buffer
// and waits until the store has read it (wait_group.read 0). No register
// carries the data, and the hardware hands tiles to whichever SM is free.
// The other threads of the CTA do nothing: the CTA size only bounds how many
// tiles share an SM, since more bytes in flight per SM than ~32 KB lowered
// the rate (the wrapper picks the size; PERF.md, PR 3).
//
// K3 design: a warp-specialised TMA/mbarrier pipeline in persistent CTAs
// that take their chunks of stage_bytes from a work queue, one atomicAdd per
// chunk, so a faster SM takes more chunks and every CTA ends within one
// chunk of the others: that is the tail split. (A fixed share per CTA,
// strided with the last round split evenly, stayed 4% below the plain copy
// on an H100, and contiguous ranges 11%; see PERF.md, PR 3.) As many CTAs
// run as fit, but no more than put kRingPerSm bytes of stages on one SM.
// Neither kernel takes an L2 cache hint: evict-first (no byte is read twice)
// moved the rate by less than the run-to-run spread. Each CTA moves its
// chunks through NBUFS in-stages and NBUFS out-stages of shared memory:
//   warp 0, lane 0, the producer: claims chunk c, waits on empty[s], writes
//         c to in_chunk[s], arms full[s] and issues the bulk load of the
//         chunk into in_buf[s] (s = i % NBUFS for its i-th chunk), then
//         claims the next chunk while that load is in flight; when the queue
//         is empty it writes -1 and arrives on full[s] without bytes;
//   warps 2-5, the workers: wait on full[s] and out_free[s], copy
//         in_buf[s] -> out_buf[s] with 16-byte shared loads and stores (the
//         TPU kernel's VMEM->VMEM copy, standing in for compute), pass the
//         chunk on in out_chunk[s], run fence.proxy.async.shared::cta, and
//         arrive once per warp on empty[s] (the in-stage is read) and
//         out_ready[s] (the out-stage is written); they stop after passing
//         on -1;
//   warp 1, lane 0, the store: waits on out_ready[s], issues the bulk store
//         of out_chunk[s] and commits its group; once wait_group.read
//         NBUFS-1 shows the store of its chunk i-(NBUFS-1) has read its
//         stage, it arrives on that stage's out_free; it stops at -1.
// No CTA-wide barrier runs inside the chunk loop: each role keeps its own
// phase bit per slot, so loads run NBUFS chunks ahead of the work pass and a
// slow store stalls neither loads nor work. A CTA that gets no chunk passes
// -1 through slot 0 at once; a short chunk is the last one.
//
// Ordering rules (both kernels keep the TPU kernels' rules):
//   - a stage is loaded only after every worker has read its previous chunk
//     (empty[s]; the producer's first wait passes at once);
//   - the workers read an in-stage only after its bytes have landed (full[s]
//     with complete_tx, which also orders the async-proxy write before the
//     generic-proxy reads); in_chunk[s] is written before full[s]'s arrive;
//   - the workers write out-stage s and out_chunk[s] only after the store
//     issued from it NBUFS chunks earlier has read it (out_free[s]);
//   - the workers' generic-proxy writes are made visible to the bulk store's
//     async-proxy reads by fence.proxy.async.shared::cta before out_ready;
//   - every store is complete (wait_group 0) before the CTA exits, and the
//     mbarriers are invalidated only after one __syncthreads past the loops;
//   - the last CTA to finish resets the queue for the next launch; each
//     (device, stream) has its own queue, so launches on other streams may
//     overlap;
//   - every mbarrier wait is bounded: after kWaitBudget clock cycles it traps,
//     so a protocol fault ends the launch with an error instead of a hang.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int kMaxBufs = 4;
// the block ahead of the buffers: K3's four mbarrier sets (full, empty,
// out_ready, out_free) and two slot -> chunk tables, kMaxBufs slots each,
// padded to 128-byte alignment; K2 uses one mbarrier of it
constexpr int kBarrierBytes = 256;
constexpr int kSmemLimit = 232448;  // shared memory one CTA may use
constexpr int kWorkerWarps = 4;
constexpr int kWorkers = 32 * kWorkerWarps;
constexpr int kManualThreads = 64 + kWorkers;  // producer, store, workers
// K3's stages on one SM: enough bytes in flight to cover the memory latency;
// more lowered the copy rate on an H100 (PERF.md, PR 3)
constexpr int kRingPerSm = 128 * 1024;
// ~2 s at the H100's 1.98 GHz boost clock; a copy's waits take microseconds
constexpr long long kWaitBudget = 1LL << 32;

static_assert((4 + 2) * kMaxBufs * 8 <= kBarrierBytes, "block too small");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// block until the phase with this parity has completed; trap after
// kWaitBudget cycles
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitBudget) __trap();
  }
}

// arm `bar` for `bytes` and start the 1-D TMA load global -> shared
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// start the bulk store shared -> global and close its group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's store groups may still be reading shared
// memory (the count is an immediate, so a template argument)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ---- K2 --------------------------------------------------------------------

__global__ void auto_copy_kernel(const unsigned char* __restrict__ x,
                                 unsigned char* __restrict__ y,
                                 long long nbytes, int tile_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const uint32_t bar = smem_addr(smem);
  const uint32_t tile = smem_addr(smem + kBarrierBytes);
  const long long base = static_cast<long long>(blockIdx.x) * tile_bytes;
  const int bytes = static_cast<int>(
      min(static_cast<long long>(tile_bytes), nbytes - base));  // ragged tail
  mbar_init(bar, 1);
  mbar_init_fence();
  bulk_load(tile, x + base, bytes, bar);
  mbar_wait(bar, 0);
  bulk_store(y + base, tile, bytes);
  bulk_wait_read<0>();
  mbar_inval(bar);
}

// ---- K3 --------------------------------------------------------------------

// K3's work queue on one (device, stream): the next unclaimed chunk, and the
// CTAs of the running launch that have finished. Zero between launches.
struct Queue {
  unsigned long long next;
  unsigned int done;
};

template <int NBUFS>
__global__ void __launch_bounds__(kManualThreads)
manual_copy_kernel(const unsigned char* __restrict__ x,
                   unsigned char* __restrict__ y, long long nbytes,
                   int stage_bytes, Queue* __restrict__ queue) {
  static_assert(NBUFS <= kMaxBufs, "too many stages");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_addr(smem);
  const uint32_t empty = full + 8 * kMaxBufs;
  const uint32_t out_ready = empty + 8 * kMaxBufs;
  const uint32_t out_free = out_ready + 8 * kMaxBufs;
  // the chunk in each in-stage and out-stage, -1 for "no more"
  volatile long long* in_chunk =
      reinterpret_cast<long long*>(smem + 4 * 8 * kMaxBufs);
  volatile long long* out_chunk = in_chunk + kMaxBufs;
  unsigned char* in_buf = smem + kBarrierBytes;
  unsigned char* out_buf = in_buf + NBUFS * stage_bytes;
  const long long nchunks = (nbytes + stage_bytes - 1) / stage_bytes;
  auto chunk_bytes = [&](long long c) {  // the last chunk may be short
    return static_cast<int>(
        min(static_cast<long long>(stage_bytes), nbytes - c * stage_bytes));
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUFS; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's arrive
      mbar_init(empty + 8 * s, kWorkerWarps);
      mbar_init(out_ready + 8 * s, kWorkerWarps);
      mbar_init(out_free + 8 * s, 1);  // the store lane
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0) {  // producer
      long long c = static_cast<long long>(atomicAdd(&queue->next, 1ULL));
      for (int i = 0;; ++i) {
        const int s = i % NBUFS;
        mbar_wait(empty + 8 * s, ((i / NBUFS) & 1) ^ 1);  // round 0: at once
        if (c >= nchunks) {
          in_chunk[s] = -1;
          mbar_arrive(full + 8 * s);
          break;
        }
        in_chunk[s] = c;
        bulk_load(smem_addr(in_buf + s * stage_bytes), x + c * stage_bytes,
                  chunk_bytes(c), full + 8 * s);
        c = static_cast<long long>(atomicAdd(&queue->next, 1ULL));
      }
    }
  } else if (warp == 1) {
    if (lane == 0) {  // store
      for (int i = 0;; ++i) {
        const int s = i % NBUFS;
        mbar_wait(out_ready + 8 * s, (i / NBUFS) & 1);
        const long long c = out_chunk[s];
        if (c < 0) break;
        bulk_store(y + c * stage_bytes, smem_addr(out_buf + s * stage_bytes),
                   chunk_bytes(c));
        if (i >= NBUFS - 1) {
          // the store of chunk i - (NBUFS-1) has read its stage
          bulk_wait_read<NBUFS - 1>();
          mbar_arrive(out_free + 8 * ((i - (NBUFS - 1)) % NBUFS));
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // drain
    }
  } else {  // workers
    const int t = threadIdx.x - 64;
    for (int i = 0;; ++i) {
      const int s = i % NBUFS;
      const uint32_t phase = (i / NBUFS) & 1;
      mbar_wait(full + 8 * s, phase);
      mbar_wait(out_free + 8 * s, phase ^ 1);  // round 0 passes at once
      const long long c = in_chunk[s];
      if (c >= 0) {
        const float4* src =
            reinterpret_cast<const float4*>(in_buf + s * stage_bytes);
        float4* dst = reinterpret_cast<float4*>(out_buf + s * stage_bytes);
        const int nv = chunk_bytes(c) / 16;
        int v = t;
        for (; v + 3 * kWorkers < nv; v += 4 * kWorkers) {
          const float4 a = src[v], b = src[v + kWorkers],
                       d = src[v + 2 * kWorkers], e = src[v + 3 * kWorkers];
          dst[v] = a;
          dst[v + kWorkers] = b;
          dst[v + 2 * kWorkers] = d;
          dst[v + 3 * kWorkers] = e;
        }
        for (; v < nv; v += kWorkers) dst[v] = src[v];
      }
      if (t == 0) out_chunk[s] = c;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty + 8 * s);
        mbar_arrive(out_ready + 8 * s);
      }
      if (c < 0) break;
    }
  }

  __syncthreads();  // every role is done with the mbarriers and the queue
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUFS; ++s) {
      mbar_inval(full + 8 * s);
      mbar_inval(empty + 8 * s);
      mbar_inval(out_ready + 8 * s);
      mbar_inval(out_free + 8 * s);
    }
    __threadfence();
    if (atomicAdd(&queue->done, 1u) == gridDim.x - 1) {
      queue->next = 0;  // the last CTA: every claim of this launch is made
      queue->done = 0;
    }
  }
}

// ---- launch ----------------------------------------------------------------

// Raise the kernel's dynamic shared-memory limit and find how many SMs the
// card has and how many CTAs of `threads` threads and `smem` bytes fit on one:
// once per (kernel, device, threads, smem), not on every launch.
struct Fit {
  int sms, per_sm;
};

cudaError_t fit_of(const void* kernel, int threads, int smem, Fit* fit) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, Fit> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *fit = it->second;
    return cudaSuccess;
  }
  // the largest limit, so a later launch of another size is never refused
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  Fit f{0, 0};
  err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (f.per_sm < 1) return cudaErrorInvalidConfiguration;
  *fit = cache[key] = f;
  return cudaSuccess;
}

// K3's queue for (current device, stream): allocated and zeroed on the
// stream at its first launch there, then kept for the life of the process
cudaError_t queue_for(cudaStream_t stream, Queue** queue) {
  static std::mutex mu;
  static std::map<std::pair<int, cudaStream_t>, Queue*> queues;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Queue*& q = queues[{dev, stream}];
  if (q == nullptr) {
    Queue* p = nullptr;
    if ((err = cudaMalloc(&p, sizeof(Queue))) != cudaSuccess) return err;
    if ((err = cudaMemsetAsync(p, 0, sizeof(Queue), stream)) != cudaSuccess) {
      cudaFree(p);
      return err;
    }
    q = p;
  }
  *queue = q;
  return cudaSuccess;
}

cudaError_t launch_auto(const void* x, void* y, long long nbytes,
                        int tile_bytes, int threads, cudaStream_t stream) {
  const int smem = kBarrierBytes + tile_bytes;
  Fit fit;
  cudaError_t err = fit_of(reinterpret_cast<const void*>(auto_copy_kernel),
                           threads, smem, &fit);
  if (err != cudaSuccess) return err;
  const long long grid = (nbytes + tile_bytes - 1) / tile_bytes;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto_copy_kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y),
      nbytes, tile_bytes);
  return cudaGetLastError();
}

template <int NBUFS>
cudaError_t launch_manual(const void* x, void* y, long long nbytes,
                          int stage_bytes, int* grid_out,
                          cudaStream_t stream) {
  const auto kernel = manual_copy_kernel<NBUFS>;
  const int smem = kBarrierBytes + 2 * NBUFS * stage_bytes;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  Fit fit;
  cudaError_t err = fit_of(reinterpret_cast<const void*>(kernel),
                           kManualThreads, smem, &fit);
  if (err != cudaSuccess) return err;
  Queue* queue = nullptr;
  if ((err = queue_for(stream, &queue)) != cudaSuccess) return err;
  // as many CTAs as fit, up to kRingPerSm of stages on an SM, at least one
  const int per_sm = std::max(
      1, std::min(fit.per_sm, kRingPerSm / (2 * NBUFS * stage_bytes)));
  const long long nchunks = (nbytes + stage_bytes - 1) / stage_bytes;
  const int grid = static_cast<int>(
      std::min(nchunks, static_cast<long long>(fit.sms) * per_sm));
  if (grid_out != nullptr) *grid_out = grid;
  kernel<<<grid, kManualThreads, smem, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y),
      nbytes, stage_bytes, queue);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: y = x over nbytes (a multiple of 16, both pointers 16-byte aligned),
// one CTA of `threads` threads per tile of tile_bytes (a multiple of 16, at
// most the CTA's shared memory less the mbarrier block). Thread 0 issues
// the copies. Returns a cudaError_t.
int pbte_dma_auto_copy(const void* x, void* y, long long nbytes,
                       int tile_bytes, int threads, void* stream) {
  if (nbytes <= 0 || nbytes % 16 || tile_bytes <= 0 || tile_bytes % 16 ||
      tile_bytes > kSmemLimit - kBarrierBytes || threads < 32 ||
      threads > 1024 || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_auto(x, y, nbytes, tile_bytes, threads,
                                      static_cast<cudaStream_t>(stream)));
}

// K3: y = x over nbytes (a multiple of 16, both pointers 16-byte aligned)
// through n_bufs (2, 3 or 4) pipeline stages of stage_bytes (a multiple of
// 16) per persistent CTA. *grid_out receives the CTA count (may be null).
// Returns a cudaError_t.
int pbte_dma_manual_copy(const void* x, void* y, long long nbytes,
                         int stage_bytes, int n_bufs, int* grid_out,
                         void* stream) {
  if (nbytes <= 0 || nbytes % 16 || stage_bytes <= 0 || stage_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_bufs) {
    case 2:
      err = launch_manual<2>(x, y, nbytes, stage_bytes, grid_out, st);
      break;
    case 3:
      err = launch_manual<3>(x, y, nbytes, stage_bytes, grid_out, st);
      break;
    case 4:
      err = launch_manual<4>(x, y, nbytes, stage_bytes, grid_out, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* pbte_dma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
