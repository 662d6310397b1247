// R on Hopper: the per-diagonal one-hit replay.
//
// Replaces diag_replay_device with window == 0 (gblastn_tpu/ops/
// seeding.py:1013), an XLA program of the JAX package, and the host
// replay it twins (engine/seeding.py::one_hit_diag_filter). Semantics are
// those of s_BlastnDiagTableExtendInitialHit (NCBI na_ungapped.c:612-755)
// with window 0: seeds in the order (oid, masked diagonal, s, q, index);
// per (oid, masked diagonal), last_hit starts at 0; a seed with s <
// last_hit is skipped; a seed whose score is at least its cutoff is saved
// and sets last_hit to the end of its ungapped extension; any other sets
// it to s + word.
//
// The caller sorts (ops/replay.py::replay_keys: two stable sorts of
// 64-bit keys, torch.sort): key[p] is the primary key (oid << 32 |
// masked diagonal + 2^31) of the seed at sorted position p, order[p] its
// index. The per-seed arrays stay in the original order, in subject-local
// coordinates, so every value is an int32 (the resident bound).
//
// A thread a sorted position. A thread whose key differs from its left
// neighbour's heads a segment (a run of equal keys) and walks it in
// order; every other thread exits. The walk takes kGroup positions at a
// time: their keys and indices, then the four gathers of each, are
// issued before the group's seeds run through the state machine, so a
// segment waits on the memory twice a group, not twice a seed. It writes
// saved = 1 at a saved seed's original index; the wrapper clears the
// output first.
//
// A dense segment (a read's own diagonal holds a seed at nearly every
// base: at config 2, 260 segments of 32 to 1,313 seeds) made one thread
// the long pole: its first seed is saved, its extension covers the rest,
// and the walk then took every later seed of the segment only to skip it
// (0.384 ms for a launch whose bytes take 0.009). So when a group leaves
// last_hit more than kJumpBases past its last seed, the walk jumps to the
// first later seed with s >= last_hit (or the segment's end): an
// exponential search from a stride of kStride positions, then a binary
// one, over the segment's ascending s, as the JAX package's long tier
// does (gblastn_tpu/ops/seeding.py:1150-1215). A probe waits on two
// loads, as a group does, so shorter skips stay with the groups.
//
// What bounds it: bytes. Each sorted row is read once (key and index, 8
// bytes each, and the seed's four int32) and one byte written, 33 bytes a
// seed; the state machine is two compares and a select a seed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;         // sorted positions a walk loads at once
constexpr int kJumpBases = 128;   // a skip this long is searched for
constexpr int kStride = 64;       // the search's first stride

// Whether the walk stops at sorted position r: the segment of key k
// ended there, or its seed starts at or after last.
__device__ __forceinline__ bool stops(const long long* key,
                                      const long long* order,
                                      const int32_t* s_loc, int n,
                                      long long k, int last, int r) {
  return r >= n || __ldg(key + r) != k ||
         __ldg(s_loc + __ldg(order + r)) >= last;
}

// The first sorted position r >= lo at which the walk stops (keys
// ascend, and s ascends inside a segment): probes at lo + kStride - 1,
// then strides that double, then a binary search inside the last one.
__device__ int next_stop(const long long* key, const long long* order,
                         const int32_t* s_loc, int n, long long k,
                         int last, int lo) {
  long long step = 2 * kStride;
  int hi = (int)(lo + kStride - 1LL < n ? lo + kStride - 1LL : n);
  while (!stops(key, order, s_loc, n, k, last, hi)) {
    lo = hi + 1;
    hi = (int)(lo + step - 1 < n ? lo + step - 1 : n);
    step <<= 1;
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (stops(key, order, s_loc, n, k, last, mid))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
diag_replay_kernel(const long long* __restrict__ key,
                   const long long* __restrict__ order,
                   const int32_t* __restrict__ s_loc,
                   const int32_t* __restrict__ end_loc,
                   const int32_t* __restrict__ score,
                   const int32_t* __restrict__ cutoff, int n, int word,
                   uint8_t* __restrict__ saved) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const long long k = key[p];
  if (p > 0 && key[p - 1] == k) return;
  int last = 0;
  for (int p0 = p;;) {
    // every load of the group is made, at a valid address (the last
    // position, index 0), so that none waits behind a branch
    bool in[kGroup];
    long long idx[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      const long long q = p0 + t < n ? p0 + t : n - 1;
      const long long o = __ldg(order + q);
      in[t] = p0 + t < n && __ldg(key + q) == k;
      idx[t] = in[t] ? o : 0;
    }
    int s[kGroup], e[kGroup];
    bool pass[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      s[t] = __ldg(s_loc + idx[t]);
      e[t] = __ldg(end_loc + idx[t]);
      pass[t] = __ldg(score + idx[t]) >= __ldg(cutoff + idx[t]);
    }
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      if (in[t] && s[t] >= last) {
        if (pass[t]) {
          saved[idx[t]] = 1;
          last = e[t];
        } else {
          last = s[t] + word;
        }
      }
    }
    // keys ascend, so the segment ended at the first position not in it
    if (!in[kGroup - 1]) break;
    p0 += kGroup;
    if ((long long)last - s[kGroup - 1] > kJumpBases)
      p0 = next_stop(key, order, s_loc, n, k, last, p0);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, reads no
// host value and waits on nothing; returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int gblastn_diag_replay(const void* key, const void* order,
                                   const void* s_loc, const void* end_loc,
                                   const void* score, const void* cutoff,
                                   int n, int word, void* saved,
                                   void* stream) {
  if (n <= 0) return 0;
  diag_replay_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)key, (const long long*)order,
      (const int32_t*)s_loc, (const int32_t*)end_loc,
      (const int32_t*)score, (const int32_t*)cutoff, n, word,
      (uint8_t*)saved);
  return (int)cudaGetLastError();
}
