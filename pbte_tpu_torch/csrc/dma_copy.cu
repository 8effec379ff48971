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
// device memory (3.35 TB/s read + write on an H100 SXM data sheet) and the
// number of bytes each SM keeps in flight to cover the memory latency.
//
// K2 design. One CTA per tile of `tile_vec` 16-byte vectors (the Pallas row
// block); each thread moves its vectors through registers, four 16-byte
// loads issued before the four stores so every thread has 64 bytes in
// flight. The tile and the CTA size are parameters, so the probe sweeps them
// as the TPU script sweeps its block rows.
//
// K3 design. Persistent CTAs (as many as fit on the card at once), each
// walking the chunks c = blockIdx.x, blockIdx.x + gridDim.x, ... through its
// own NBUFS-deep pipeline in shared memory:
//   in:   thread 0 issues a 1-D TMA bulk copy global -> in_buf[slot]
//         (cp.async.bulk, completion on the slot's mbarrier);
//   work: all threads copy in_buf[slot] -> out_buf[slot] with 16-byte
//         shared loads and stores (the TPU kernel's VMEM->VMEM copy);
//   out:  thread 0 issues a bulk copy out_buf[slot] -> global (bulk_group).
// It keeps the TPU kernel's ordering rules:
//   - the next load into in_buf[slot] is issued only after every thread has
//     read the slot (the __syncthreads after the work pass);
//   - out_buf[slot] is rewritten only after the store issued from it NBUFS
//     chunks earlier has read it (cp.async.bulk.wait_group.read NBUFS-1);
//   - every store is complete before the CTA exits (wait_group 0).
// The work pass writes out_buf with ordinary (generic-proxy) stores that the
// bulk store then reads through the async proxy, so every writer executes
// fence.proxy.async.shared::cta before the barrier that precedes the store.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kUnroll = 4;
constexpr int kManualThreads = 256;
constexpr int kBarrierBytes = 128;  // room for up to 16 mbarriers, aligned

// ---- K2 --------------------------------------------------------------------

__global__ void auto_copy_kernel(const float4* __restrict__ x,
                                 float4* __restrict__ y, long long n_vec,
                                 int tile_vec) {
  const long long base = static_cast<long long>(blockIdx.x) * tile_vec;
  const long long end = min(base + tile_vec, n_vec);
  const int step = blockDim.x;
  for (long long i = base + threadIdx.x; i < end;
       i += static_cast<long long>(step) * kUnroll) {
    float4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + static_cast<long long>(u) * step;
      if (j < end) r[u] = x[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + static_cast<long long>(u) * step;
      if (j < end) y[j] = r[u];
    }
  }
}

// ---- K3 --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// block until the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// thread 0: arm the slot's mbarrier for `bytes` and start the 1-D TMA load
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

// thread 0: start the bulk store and close its group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// thread 0: at most N of its store groups may still be reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int NBUFS>
__global__ void __launch_bounds__(kManualThreads)
manual_copy_kernel(const unsigned char* __restrict__ x,
                   unsigned char* __restrict__ y, long long nbytes,
                   int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* in_buf = smem + kBarrierBytes;
  unsigned char* out_buf = in_buf + NBUFS * stage_bytes;

  const long long nchunks = (nbytes + stage_bytes - 1) / stage_bytes;
  const long long first = blockIdx.x;
  const int n_local =
      first < nchunks
          ? static_cast<int>((nchunks - 1 - first) / gridDim.x + 1)
          : 0;
  auto chunk_bytes = [&](long long c) {
    return static_cast<int>(
        min(static_cast<long long>(stage_bytes), nbytes - c * stage_bytes));
  };
  auto chunk_of = [&](int i) {
    return first + static_cast<long long>(i) * gridDim.x;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUFS; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBUFS && i < n_local; ++i) {
      const long long c = chunk_of(i);
      bulk_load(smem_addr(in_buf + i * stage_bytes), x + c * stage_bytes,
                chunk_bytes(c), smem_addr(&full[i]));
    }
  }

  for (int i = 0; i < n_local; ++i) {
    const int slot = i % NBUFS;
    const uint32_t parity = (i / NBUFS) & 1;
    const long long c = chunk_of(i);
    const int bytes = chunk_bytes(c);
    unsigned char* ib = in_buf + slot * stage_bytes;
    unsigned char* ob = out_buf + slot * stage_bytes;

    // out_buf[slot] is free once the store of chunk i - NBUFS has read it
    if (threadIdx.x == 0 && i >= NBUFS) bulk_wait_read<NBUFS - 1>();
    mbar_wait(smem_addr(&full[slot]), parity);
    __syncthreads();

    // the "compute": shared -> shared, 16 bytes per thread per step
    for (int o = threadIdx.x * 16; o < bytes; o += kManualThreads * 16) {
      *reinterpret_cast<float4*>(ob + o) =
          *reinterpret_cast<const float4*>(ib + o);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (threadIdx.x == 0) {
      bulk_store(y + c * stage_bytes, smem_addr(ob), bytes);
      // in_buf[slot] was read by every thread before the barrier above
      if (i + NBUFS < n_local) {
        const long long cn = chunk_of(i + NBUFS);
        bulk_load(smem_addr(ib), x + cn * stage_bytes, chunk_bytes(cn),
                  smem_addr(&full[slot]));
      }
    }
  }

  if (threadIdx.x == 0) {
    // drain: every store complete before the CTA exits
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    for (int s = 0; s < NBUFS; ++s) mbar_inval(smem_addr(&full[s]));
  }
}

template <int NBUFS>
cudaError_t launch_manual(const void* x, void* y, long long nbytes,
                          int stage_bytes, int* grid_out,
                          cudaStream_t stream) {
  auto kernel = manual_copy_kernel<NBUFS>;
  const int smem = kBarrierBytes + 2 * NBUFS * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kManualThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long nchunks = (nbytes + stage_bytes - 1) / stage_bytes;
  const int grid = static_cast<int>(
      std::min(nchunks, static_cast<long long>(sms) * per_sm));
  if (grid_out != nullptr) *grid_out = grid;
  kernel<<<grid, kManualThreads, smem, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y),
      nbytes, stage_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: y = x over nbytes (a multiple of 16, both pointers 16-byte aligned),
// one CTA of `threads` threads per tile of tile_bytes (a multiple of 16).
// Returns a cudaError_t.
int pbte_dma_auto_copy(const void* x, void* y, long long nbytes,
                       int tile_bytes, int threads, void* stream) {
  if (nbytes <= 0 || nbytes % 16 || tile_bytes <= 0 || tile_bytes % 16 ||
      threads < 32 || threads > 1024 || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_vec = nbytes / 16;
  const int tile_vec = tile_bytes / 16;
  const long long grid = (n_vec + tile_vec - 1) / tile_vec;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto_copy_kernel<<<static_cast<unsigned>(grid), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n_vec,
      tile_vec);
  return static_cast<int>(cudaGetLastError());
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
