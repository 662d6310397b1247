// P1-P3 on Hopper: the table gather out[i] = tab[idx[i]] for an int32 table
// and int32 indices, in two modes that never turn into each other.
//
// Replaces the three Pallas TPU probes of tools/prof_scan_parts.py, which
// compute one function from a table held in VMEM: gk (:164, call :171,
// tab_ref[idx_ref[:]] on an (8, 128) block), gk2 (:183, call :187, the same
// through jnp.take) and gk3 (:203, call :208, 262,144 probes). They asked
// whether a fused scan kernel (K3) can probe the presence vector (PV,
// int32[4^w / 32]: 2 MiB at LUT width 12, 512 KiB at 11, 128 KiB at 10) from
// fast on-chip memory.
//
// What bounds it on this card: bytes, as
// gblastn_tpu_torch/tools/prof_scan_parts.py::gather_bound_ms counts them:
// each index read once, each output written once, and each 32-byte sector
// of the table that the indices touch read once, over the memory rate. There
// is no arithmetic beyond the addressing. A probe is one dependent read, so
// what the design controls is how many reads are in flight, and what a
// launch pays before its first probe.
//
// Both modes: each thread takes 4 probes a step, one 16-byte index load
// (the next step's load issued before this step's reads), four independent
// table reads and one 16-byte store. Index or output pointers that are not
// 16-byte aligned take a scalar path of the same depth; the ragged tail
// (n mod 4 probes) takes scalar reads. Each block takes one contiguous share
// of the probes, so a few probes spread over every block of a cluster.
//
// staged = 0 (global): the table is read through the read-only path (__ldg)
//   from L2, where a 2 MiB table stays after its first touch. Blocks of 64
//   threads, one for each 256 probes and at most 32 an SM: an SM issues its
//   random L2 reads one after another, so a few probes are spread over many
//   SMs rather than given to the threads of one.
// staged = 1: the table is split into C equal slices (C of 1, 2, 4, 8 or 16),
//   one for each block of a thread-block cluster, each in that block's own
//   shared memory: a cluster of 16 holds 16 x 227 KiB, so the 2 MiB PV fits,
//   as it fitted in the TPU's VMEM. Each block's thread 0 loads its slice
//   with TMA bulk copies (cp.async.bulk, 16 KiB each, completion counted in
//   bytes on an mbarrier) while a second warp moves the slice's unaligned
//   head and tail (a table view at an odd offset) with plain loads and every
//   thread loads its first indices. After cluster.sync() a probe reads the
//   owning block's slice through distributed shared memory (owner i >> shift
//   for slices of a power of two entries, else i / slice; a cluster of one
//   reads its own shared memory directly). The cluster syncs again before
//   it exits, so no block leaves while another reads its slice.
//   Each block has 1,024 threads and, at 128 KiB or more, an SM of its own.
//   The grid is the number of clusters that ops/gather.py::staged_geometry
//   sizes to the work (not to occupancy): every cluster pays one copy of the
//   table, so a few probes pay one copy, not one for each SM. This file
//   checks the geometry it is given and caches, per device, the SM count,
//   the attributes and the clusters the card holds at once.
//
// Indices must lie in [0, n_tab): the kernel does not clamp them, as the TPU
// probe did not.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;           // global mode: 32 blocks an SM
constexpr int kGlobalProbes = 4 * kThreads;  // global mode: probes a block
constexpr int kStagedThreads = 1024;   // staged: one block an SM
constexpr int kHeader = 16;            // the mbarrier, before the slice
constexpr int kPadBytes = 16;          // room for the <= 3-entry alignment pad
constexpr uint32_t kChunk = 16384;     // bytes a bulk copy
constexpr int kMaxStagedBytes = 232448;  // 227 KiB of shared memory a block
constexpr int kMaxSlice = (kMaxStagedBytes - kHeader - kPadBytes) / 4;
constexpr int kMaxTx = (1 << 20) - 1;  // an mbarrier phase's byte limit
constexpr int kMaxDevices = 64;
constexpr int kMaxOcc = 64;

static_assert(4 * kMaxSlice <= kMaxTx, "a slice completes in one phase");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The probe loop of both modes. Block b takes the b-th of gridDim.x equal
// contiguous shares of the probes, its threads neighbouring probes (so a few
// probes spread over every block of a cluster, and index loads coalesce).
// look(i) reads table entry i; ready() runs once in every thread, after the
// thread's first index loads are issued.
template <class Look, class Ready>
__device__ __forceinline__ void gather_loop(const int32_t* __restrict__ idx,
                                            int n, int32_t* __restrict__ out,
                                            Look look, Ready ready) {
  // 32-bit unsigned: n < 2^31 and gridDim.x < 2^31, so a share's end
  // (at most n + gridDim.x) stays below 2^32; a 64-bit division here would
  // delay the first index load
  const uint32_t tb = blockDim.x, nb = gridDim.x, b = blockIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(idx) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    const uint32_t nq = (uint32_t)n >> 2;
    const uint32_t per = (nq + nb - 1) / nb;
    const uint32_t end = min(per * (b + 1), nq);
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    int4* out4 = reinterpret_cast<int4*>(out);
    uint32_t q = per * b + threadIdx.x;
    int4 v = make_int4(0, 0, 0, 0);
    if (q < end) v = __ldg(idx4 + q);
    ready();
    for (; q < end; q += tb) {
      int4 w = make_int4(0, 0, 0, 0);
      if (q + tb < end) w = __ldg(idx4 + q + tb);
      int4 r;
      r.x = look(v.x);
      r.y = look(v.y);
      r.z = look(v.z);
      r.w = look(v.w);
      out4[q] = r;
      v = w;
    }
    if (b == nb - 1) {
      for (uint32_t i = 4 * nq + threadIdx.x; i < (uint32_t)n; i += tb) {
        out[i] = look(__ldg(idx + i));
      }
    }
    return;
  }
  const uint32_t per = ((uint32_t)n + nb - 1) / nb;
  const uint32_t end = min(per * (b + 1), (uint32_t)n);
  uint32_t i = per * b + threadIdx.x;
  int a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = i + k * tb < end ? __ldg(idx + i + k * tb) : 0;
  }
  ready();
  for (; i < end; i += 4 * tb) {
    const uint32_t j = i + 4 * tb;
    int r[4];
    int c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = j + k * tb < end ? __ldg(idx + j + k * tb) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = look(a[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k * tb < end) out[i + k * tb] = r[k];
      a[k] = c[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_global(const int32_t* __restrict__ tab,
              const int32_t* __restrict__ idx, int n,
              int32_t* __restrict__ out) {
  gather_loop(idx, n, out, [=](int i) { return __ldg(tab + i); }, [] {});
}

// Block r of a cluster holds entries [r * slice, min((r + 1) * slice,
// n_tab)); entry lo + k sits at s_tab[k], and s_tab is offset by the table's
// misalignment (pad entries) so that the bulk copies' shared addresses are
// 16-byte aligned wherever their global ones are.
__global__ void __launch_bounds__(kStagedThreads)
gather_staged(const int32_t* __restrict__ tab, int n_tab, int slice,
              int shift, const int32_t* __restrict__ idx, int n,
              int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int pad = (int)((reinterpret_cast<uintptr_t>(tab) >> 2) & 3);
  int32_t* s_tab = reinterpret_cast<int32_t*>(smem + kHeader) + pad;
  const uint32_t bar = smem_addr(smem);
  const int lo = rank * slice;
  const int cnt = max(min(slice, n_tab - lo), 0);
  const int head = min((4 - pad) & 3, cnt);        // [0, head) plain
  const int body = head + ((cnt - head) & ~3);     // [head, body) bulk
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = 4u * (uint32_t)(body - head);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    const uint32_t dst = smem_addr(s_tab + head);
    const char* src = reinterpret_cast<const char*>(tab + lo + head);
    for (uint32_t off = 0; off < bytes; off += kChunk) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(dst + off), "l"(src + off), "r"(min(bytes - off, kChunk)),
             "r"(bar)
          : "memory");
    }
  } else if (threadIdx.x >= 32 && threadIdx.x < 35) {
    const int t = threadIdx.x - 32;
    if (t < head) s_tab[t] = __ldg(tab + lo + t);
    if (t < cnt - body) s_tab[body + t] = __ldg(tab + lo + body + t);
  }
  auto ready = [&] {
    bar_wait(bar, 0);
    cluster.sync();
  };
  if (cluster.num_blocks() == 1) {
    gather_loop(idx, n, out, [&](int i) { return s_tab[i]; }, ready);
  } else if (shift >= 0) {
    const int mask = slice - 1;
    gather_loop(idx, n, out, [&](int i) {
      return *cluster.map_shared_rank(s_tab + (i & mask), i >> shift);
    }, ready);
  } else {
    gather_loop(idx, n, out, [&](int i) {
      const int r = i / slice;
      return *cluster.map_shared_rank(s_tab + (i - r * slice), r);
    }, ready);
  }
  cluster.sync();
}

// What is cached per device: queried once, never on a launch.
struct Occupancy {
  int cluster, smem, max_clusters;
};
struct DeviceInfo {
  bool known = false;
  int sms = 0;
  int smem_optin = 0;
  bool staged_attrs = false;
  int n_occ = 0;
  Occupancy occ[kMaxOcc];
};
DeviceInfo g_dev[kMaxDevices];
std::mutex g_mu;

cudaError_t device_info(int dev, DeviceInfo** info) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_dev[dev];
  if (!d.known) {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!d.known) {
      cudaError_t err = cudaDeviceGetAttribute(
          &d.sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(
          &d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return err;
      d.known = true;
    }
  }
  *info = &d;
  return cudaSuccess;
}

bool valid_cluster(int c) {
  return c == 1 || c == 2 || c == 4 || c == 8 || c == 16;
}

size_t staged_smem(int slice) {
  return (size_t)kHeader + (size_t)kPadBytes + 4 * (size_t)slice;
}

// Clusters of `cluster` blocks with `smem` bytes each that the card holds
// at once (cudaOccupancyMaxActiveClusters), cached per device.
cudaError_t max_clusters(int dev, int cluster, int smem, int* out) {
  DeviceInfo* d = nullptr;
  cudaError_t err = device_info(dev, &d);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  for (int k = 0; k < d->n_occ; ++k) {
    if (d->occ[k].cluster == cluster && d->occ[k].smem == smem) {
      *out = d->occ[k].max_clusters;
      return cudaSuccess;
    }
  }
  if (!d->staged_attrs) {
    // above 48 KiB, dynamic shared memory needs this opt-in; a cluster of
    // 16 needs the non-portable size (the portable limit is 8)
    err = cudaFuncSetAttribute(gather_staged,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d->smem_optin);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        gather_staged, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    d->staged_attrs = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kStagedThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int m = 0;
  err = cudaOccupancyMaxActiveClusters(&m, gather_staged, &cfg);
  if (err != cudaSuccess) return err;
  if (d->n_occ < kMaxOcc) d->occ[d->n_occ++] = {cluster, smem, m};
  *out = m;
  return cudaSuccess;
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns a cudaError_t as
// an int (0 = success).

// The most clusters of `cluster` blocks with `smem` bytes of dynamic shared
// memory each that device `dev` holds at once (0: it can place none).
extern "C" int gblastn_table_gather_clusters(int dev, int cluster, int smem,
                                             int* out) {
  if (!valid_cluster(cluster) || smem <= 0) return (int)cudaErrorInvalidValue;
  return (int)max_clusters(dev, cluster, smem, out);
}

// out[i] = tab[idx[i]] on `stream` of device `dev` (the current device).
// Global mode (staged = 0) ignores the geometry. Staged mode takes it from
// ops/gather.py::staged_geometry: `clusters` clusters of `cluster` blocks,
// each block holding `slice` entries; `shift` is log2(slice) when slice is
// a power of two, else -1. A geometry that does not cover the table or
// exceeds the card's limits is refused with cudaErrorInvalidValue.
extern "C" int gblastn_table_gather(int dev, const void* tab, int n_tab,
                                    const void* idx, int n, void* out,
                                    int staged, int cluster, int clusters,
                                    int slice, int shift, void* stream) {
  if (n <= 0) return 0;
  if (n_tab <= 0) return (int)cudaErrorInvalidValue;
  DeviceInfo* d = nullptr;
  cudaError_t err = device_info(dev, &d);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!staged) {
    const long long want = (n + (long long)kGlobalProbes - 1) / kGlobalProbes;
    const int blocks = (int)std::min(want, (long long)d->sms * 32);
    gather_global<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)tab, (const int32_t*)idx, n, (int32_t*)out);
    return (int)cudaGetLastError();
  }
  if (!valid_cluster(cluster) || clusters < 1 || slice < 1 ||
      slice > kMaxSlice || (cluster > 1 && slice % 4 != 0) ||
      (long long)slice * cluster < n_tab ||
      (shift >= 0 && (shift > 30 || (1 << shift) != slice))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = staged_smem(slice);
  if (smem > (size_t)d->smem_optin) return (int)cudaErrorInvalidValue;
  int m = 0;
  err = max_clusters(dev, cluster, (int)smem, &m);
  if (err != cudaSuccess) return (int)err;
  if (clusters > m) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kStagedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gather_staged, (const int32_t*)tab, n_tab,
                           slice, shift, (const int32_t*)idx, n,
                           (int32_t*)out);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
