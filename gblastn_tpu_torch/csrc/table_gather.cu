// P1-P3 on Hopper: the table gather out[i] = tab[idx[i]], int32, one thread
// per probe over a grid-stride loop.
//
// Replaces the three Pallas TPU probes of tools/prof_scan_parts.py, which
// compute one function: gk (:164, tab_ref[idx_ref[:]] on an (8, 128) block),
// gk2 (:183, the same through jnp.take) and gk3 (:203, 262,144 probes), each
// gathering from a table held in VMEM. They asked whether a fused scan
// kernel (K3) can probe the presence vector (PV, int32[4^w / 32]: 2 MiB at
// LUT width 12, 512 KiB at 11, 128 KiB at 10) from fast memory.
//
// Two modes answer that question on this card:
//   staged = 0: the table is read from global memory through the read-only
//     path (__ldg). A 2 MiB table stays in the 50 MB L2 after its first
//     touch: the counterpart of the TPU's VMEM table at the PV's size.
//   staged = 1: every block first copies the whole table into dynamic shared
//     memory with coalesced loads, then gathers from there. A block may hold
//     at most 227 KiB (58,112 int32), which needs the opt-in of
//     cudaFuncSetAttribute(MaxDynamicSharedMemorySize) above 48 KiB; a larger
//     table is refused with cudaErrorInvalidValue.
// Indices must lie in [0, n_tab): the kernel does not clamp them, as the TPU
// probe did not.
//
// What bounds it on this card: bytes. Each probe reads one index and writes
// one output, and the table is read once: 8 n + 4 n_tab bytes over the memory
// rate. The gather is one dependent load per probe, from L2 or shared memory;
// enough warps in flight hide its latency. The staged mode also copies the
// table once per block (4 n_tab bytes from L2 for each block), which the
// bound does not count, so it pays off only when a block has many more
// probes than table entries.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // global mode: 8 blocks per SM
constexpr int kStagedThreads = 1024;    // staged: 32 warps per table copy
constexpr int kMaxStagedBytes = 232448; // 227 KiB of shared memory a block
constexpr int kMaxDevices = 64;

bool g_staged_opt_in[kMaxDevices];      // attribute set, per device

__global__ void __launch_bounds__(kThreads)
gather_global(const int32_t* __restrict__ tab,
              const int32_t* __restrict__ idx, int n,
              int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = __ldg(tab + __ldg(idx + i));
  }
}

__global__ void __launch_bounds__(kStagedThreads)
gather_staged(const int32_t* __restrict__ tab, int n_tab,
              const int32_t* __restrict__ idx, int n,
              int32_t* __restrict__ out) {
  extern __shared__ int32_t s_tab[];
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) {
    s_tab[k] = __ldg(tab + k);
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = s_tab[__ldg(idx + i)];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// a cudaError_t as an int (0 = launched).
extern "C" int gblastn_table_gather(const void* tab, int n_tab,
                                    const void* idx, int n, void* out,
                                    int staged, void* stream) {
  if (n <= 0) return 0;
  if (n_tab <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!staged) {
    const long long want = (n + (long long)kThreads - 1) / kThreads;
    const int blocks =
        (int)std::min(want, (long long)sms * (2048 / kThreads));
    gather_global<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)tab, (const int32_t*)idx, n, (int32_t*)out);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)n_tab * sizeof(int32_t);
  if (smem > (size_t)kMaxStagedBytes) return (int)cudaErrorInvalidValue;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!g_staged_opt_in[dev]) {
    // above 48 KiB, dynamic shared memory needs this opt-in before the
    // first launch; without it the launch fails with cudaErrorInvalidValue
    err = cudaFuncSetAttribute(gather_staged,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxStagedBytes);
    if (err != cudaSuccess) return (int)err;
    g_staged_opt_in[dev] = true;
  }
  // as many blocks as fit on the card at once: each one copies the table
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_staged, kStagedThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long want =
      (n + (long long)kStagedThreads - 1) / kStagedThreads;
  const int blocks =
      (int)std::min(want, (long long)sms * std::max(per_sm, 1));
  gather_staged<<<blocks, kStagedThreads, smem, s>>>(
      (const int32_t*)tab, n_tab, (const int32_t*)idx, n, (int32_t*)out);
  return (int)cudaGetLastError();
}
