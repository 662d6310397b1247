// R on Hopper: the per-diagonal replay, one-hit and two-hit.
//
// Replaces diag_replay_device (gblastn_tpu/ops/seeding.py:1013), an XLA
// program of the JAX package, and the host replays it twins
// (engine/seeding.py::one_hit_diag_filter and two_hit_diag_filter).
// Semantics are those of s_BlastnDiagTableExtendInitialHit (NCBI
// na_ungapped.c:612-755) with scan range 0: seeds in the order (oid,
// masked diagonal, s, q, index); per (oid, masked diagonal), a seed with
// s < last_hit is skipped.
//   window == 0 (one-hit): last_hit starts at 0; a seed whose score is at
//   least its cutoff is saved and sets last_hit to the end of its
//   ungapped extension; any other sets it to s + word. right_run is not
//   read.
//   window > 0 (two-hit): the state is (last_hit, flag), starting at
//   (-window, 0) on a virgin diagonal (s_BlastDiagClear,
//   blast_extend.c:108). A seed takes the first-hit branch when the flag
//   is set or when s + word > last_hit + window (strictly); there its
//   word end s + word gains its right run (right_run, RR's; a null
//   pointer means runs of 0) and it is ready only if the run is at least
//   word (a double word). Off that branch (a second hit within the
//   window) it is ready. A ready seed whose score is at least its cutoff
//   is saved and sets last_hit to its extension's end; any other sets it
//   to its word end. The flag becomes whether the seed was saved.
//
// The jump below stays exact with two-hit: it only needs the next seed
// the machine processes to be the first later seed of the segment with
// s >= last_hit, which holds for any last_hit since s ascends inside a
// segment and every seed before it is skipped. And every processed seed
// moves last_hit past its own s (a failure sets s + word, plus the run on
// the first-hit branch; a save sets the extension's end), so the machine
// never stalls.
//
// Two kernels share the walk: diag_replay_kernel (one-hit: int32 state,
// no run read) and diag_replay_two_hit_kernel (int64 state, the flag and
// the runs), so that the one-hit paths pay nothing for the two-hit
// machine (with one kernel for both, one-hit R took 6% longer at 887,574
// seeds on an H100). Each has a wide twin, diag_replay_wide_kernel and
// diag_replay_two_hit_wide_kernel, that reads int64 subject-local
// coordinates and keeps int64 state: the batch's longest subject decides
// (engine/seeding.py::replay_inputs), so a subject past 2^31 bases is
// replayed exactly and every other batch keeps the narrow kernels' loads
// and registers.
//
// The caller sorts (ops/replay.py::replay_keys): key[p] is the sorted
// key of the seed at sorted position p, order[p] its index, and a segment
// (one oid and masked diagonal) is a run of equal key[p] >> key_shift:
// one stable sort of a packed key (oid, diagonal, s, and q with a mask)
// where it fits 63 bits, else the primary key (oid << 32 | masked
// diagonal made non-negative) of two stable sorts, with shift 0. The
// per-seed arrays stay in the original order, in subject-local
// coordinates: int32 where the longest subject allows it, else int64.
//
// A thread a sorted position. A thread whose segment key differs from
// its left neighbour's heads a segment and walks it in order; every
// other thread exits. The walk takes kGroup positions at a time: their
// keys and indices, then the four gathers of each, are issued before the
// group's seeds run through the state machine. The first group's keys
// and indices come in the same round of loads as the left neighbour's
// key, so a segment of one group waits on the memory twice (three times
// where the head test loads alone), and twice a group after; a group's
// positions in the segment are a count and its cutoff tests a bit mask,
// which keeps the one-hit kernel at 64 registers and the two-hit one at
// 72 (as arrays: 78 and 80). It writes saved = 1 at a saved seed's
// original index; the wrapper clears the output first.
//
// What lost, measured on an H100 (PERF.md): a list of the heads, so that
// every lane walks a real segment (a ballot and a shared atomic a warp,
// in blocks of 512 positions; or one global list from a first pass),
// the rows gathered once into sorted order by such a pass so that the
// walks read them contiguously, and each group's gathers issued with the
// next group's keys (103 and 130 registers: fewer blocks on a SM). Each
// cost more than it saved at config 2.
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
// bytes each, and the seed's four int32, five with two-hit's run) and one
// byte written, 33 bytes a seed (37 with runs); the state machine is a
// few compares and selects a seed.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;         // sorted positions a walk loads at once
constexpr int kJumpBases = 128;   // a skip this long is searched for
constexpr int kStride = 64;       // the search's first stride

// Whether the walk stops at sorted position r: the segment of key k
// ended there, or its seed starts at or after last.
template <typename Coord, typename Last>
__device__ __forceinline__ bool stops(const long long* key,
                                      const long long* order,
                                      const Coord* s_loc, int n, int shift,
                                      long long k, Last last, int r) {
  return r >= n || (__ldg(key + r) >> shift) != k ||
         __ldg(s_loc + __ldg(order + r)) >= last;
}

// The first sorted position r >= lo at which the walk stops (keys
// ascend, and s ascends inside a segment): probes at lo + kStride - 1,
// then strides that double, then a binary search inside the last one.
template <typename Coord, typename Last>
__device__ int next_stop(const long long* key, const long long* order,
                         const Coord* s_loc, int n, int shift, long long k,
                         Last last, int lo) {
  long long step = 2 * kStride;
  int hi = (int)(lo + kStride - 1LL < n ? lo + kStride - 1LL : n);
  while (!stops(key, order, s_loc, n, shift, k, last, hi)) {
    lo = hi + 1;
    hi = (int)(lo + step - 1 < n ? lo + step - 1 : n);
    step <<= 1;
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (stops(key, order, s_loc, n, shift, k, last, mid))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// How many of sorted positions p0 .. p0 + kGroup - 1 lie in segment k
// (keys ascend, so they are the first ones), and their indices; each
// load at a valid position (the last one past the end).
__device__ __forceinline__ int fetch_group(const long long* key,
                                           const long long* order, int n,
                                           int shift, long long k, int p0,
                                           int (&oq)[kGroup]) {
  int m = 0;
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    const int q = p0 + t < n ? p0 + t : n - 1;
    m += p0 + t < n && (__ldg(key + q) >> shift) == k;
    oq[t] = (int)__ldg(order + q);    // an index below n < 2^31
  }
  return m;
}

// The walk of the segment headed by sorted position p, over int32 or
// int64 (Coord) subject-local coordinates. One-hit keeps int32 state on
// int32 coordinates and reads no run; two-hit keeps int64 state (last +
// window and s + word + run must not wrap), the flag, and each seed's run
// (right_run, or 0 where it is a null pointer); int64 coordinates keep
// int64 state in both.
template <bool kTwoHit, typename Coord>
__device__ __forceinline__ void walk(const long long* __restrict__ key,
                                     const long long* __restrict__ order,
                                     const Coord* __restrict__ s_loc,
                                     const Coord* __restrict__ end_loc,
                                     const int32_t* __restrict__ score,
                                     const int32_t* __restrict__ cutoff,
                                     const int32_t* __restrict__ right_run,
                                     int n, int shift, int word, int window,
                                     int p, uint8_t* __restrict__ saved) {
  using Last = typename std::conditional<
      kTwoHit || sizeof(Coord) == 8, long long, int>::type;
  // the first group's keys and indices come with the left neighbour's
  // key, in one round of loads; a thread that does not head a segment
  // exits
  long long kq[kGroup];
  int oq[kGroup];
  const long long prev = __ldg(key + (p > 0 ? p - 1 : 0));
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    const int q = p + t < n ? p + t : n - 1;
    kq[t] = __ldg(key + q);
    oq[t] = (int)__ldg(order + q);    // an index below n < 2^31
  }
  const long long k = kq[0] >> shift;
  if (p > 0 && (prev >> shift) == k) return;
  int m = 0;    // the group's positions in the segment: the first m
#pragma unroll
  for (int t = 0; t < kGroup; ++t) m += p + t < n && (kq[t] >> shift) == k;
  Last last = kTwoHit ? -window : 0;
  bool flag = false;
  for (int p0 = p;;) {
    int idx[kGroup], run[kGroup];
    Coord s[kGroup], e[kGroup];
    unsigned pass = 0;    // bit t: seed t meets its cutoff
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      idx[t] = t < m ? oq[t] : 0;
      s[t] = __ldg(s_loc + idx[t]);
      e[t] = __ldg(end_loc + idx[t]);
      pass |= (unsigned)(__ldg(score + idx[t]) >= __ldg(cutoff + idx[t]))
              << t;
      if (kTwoHit)
        run[t] = right_run != nullptr ? __ldg(right_run + idx[t]) : 0;
    }
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      if (t < m && s[t] >= last) {
        Last word_end = (Last)s[t] + word;
        bool ready = true;
        if (kTwoHit && (flag || word_end > last + window)) {
          word_end += run[t];
          ready = run[t] >= word;
        }
        const bool save = ready && (pass >> t & 1u);
        if (save) saved[idx[t]] = 1;
        last = save ? (Last)e[t] : word_end;
        flag = save;
      }
    }
    // keys ascend, so the segment ended at the first position not in it
    if (m < kGroup) break;
    p0 += kGroup;
    if ((long long)last - s[kGroup - 1] > kJumpBases)
      p0 = next_stop(key, order, s_loc, n, shift, k, last, p0);
    m = fetch_group(key, order, n, shift, k, p0, oq);
  }
}

// A thread a sorted position, at the head of its segment: the one-hit
// walk over Coord subject-local coordinates.
template <typename Coord>
__device__ __forceinline__ void one_hit_at(const long long* key,
                                           const long long* order,
                                           const Coord* s_loc,
                                           const Coord* end_loc,
                                           const int32_t* score,
                                           const int32_t* cutoff, int n,
                                           int shift, int word,
                                           uint8_t* saved) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n)
    walk<false>(key, order, s_loc, end_loc, score, cutoff, nullptr, n,
                shift, word, 0, p, saved);
}

// The same for the two-hit walk.
template <typename Coord>
__device__ __forceinline__ void two_hit_at(const long long* key,
                                           const long long* order,
                                           const Coord* s_loc,
                                           const Coord* end_loc,
                                           const int32_t* score,
                                           const int32_t* cutoff,
                                           const int32_t* right_run, int n,
                                           int shift, int word, int window,
                                           uint8_t* saved) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n)
    walk<true>(key, order, s_loc, end_loc, score, cutoff, right_run, n,
               shift, word, window, p, saved);
}

__global__ void __launch_bounds__(kThreads)
diag_replay_kernel(const long long* __restrict__ key,
                   const long long* __restrict__ order,
                   const int32_t* __restrict__ s_loc,
                   const int32_t* __restrict__ end_loc,
                   const int32_t* __restrict__ score,
                   const int32_t* __restrict__ cutoff, int n, int shift,
                   int word, uint8_t* __restrict__ saved) {
  one_hit_at(key, order, s_loc, end_loc, score, cutoff, n, shift, word,
             saved);
}

__global__ void __launch_bounds__(kThreads)
diag_replay_wide_kernel(const long long* __restrict__ key,
                        const long long* __restrict__ order,
                        const long long* __restrict__ s_loc,
                        const long long* __restrict__ end_loc,
                        const int32_t* __restrict__ score,
                        const int32_t* __restrict__ cutoff, int n,
                        int shift, int word, uint8_t* __restrict__ saved) {
  one_hit_at(key, order, s_loc, end_loc, score, cutoff, n, shift, word,
             saved);
}

// at least three blocks a SM (the int64 state and the runs take more
// registers than the one-hit kernel's)
__global__ void __launch_bounds__(kThreads, 3)
diag_replay_two_hit_kernel(const long long* __restrict__ key,
                           const long long* __restrict__ order,
                           const int32_t* __restrict__ s_loc,
                           const int32_t* __restrict__ end_loc,
                           const int32_t* __restrict__ score,
                           const int32_t* __restrict__ cutoff,
                           const int32_t* __restrict__ right_run, int n,
                           int shift, int word, int window,
                           uint8_t* __restrict__ saved) {
  two_hit_at(key, order, s_loc, end_loc, score, cutoff, right_run, n, shift,
             word, window, saved);
}

// two blocks a SM at least: int64 coordinates and state as well (it
// runs only past 2^31 bases, where the seeds are few)
__global__ void __launch_bounds__(kThreads, 2)
diag_replay_two_hit_wide_kernel(const long long* __restrict__ key,
                                const long long* __restrict__ order,
                                const long long* __restrict__ s_loc,
                                const long long* __restrict__ end_loc,
                                const int32_t* __restrict__ score,
                                const int32_t* __restrict__ cutoff,
                                const int32_t* __restrict__ right_run,
                                int n, int shift, int word, int window,
                                uint8_t* __restrict__ saved) {
  two_hit_at(key, order, s_loc, end_loc, score, cutoff, right_run, n, shift,
             word, window, saved);
}

// Launches the kernel of `window` (one-hit or two-hit) over Coord
// coordinates.
template <typename Coord, typename OneHit, typename TwoHit>
void launch(OneHit one_hit, TwoHit two_hit, const void* key,
            const void* order, const void* s_loc, const void* end_loc,
            const void* score, const void* cutoff, const void* right_run,
            int n, int word, int window, int key_shift, void* saved,
            cudaStream_t st) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (window > 0)
    two_hit<<<blocks, kThreads, 0, st>>>(
        (const long long*)key, (const long long*)order,
        (const Coord*)s_loc, (const Coord*)end_loc, (const int32_t*)score,
        (const int32_t*)cutoff, (const int32_t*)right_run, n, key_shift,
        word, window, (uint8_t*)saved);
  else
    one_hit<<<blocks, kThreads, 0, st>>>(
        (const long long*)key, (const long long*)order,
        (const Coord*)s_loc, (const Coord*)end_loc, (const int32_t*)score,
        (const int32_t*)cutoff, n, key_shift, word, (uint8_t*)saved);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, reads no
// host value and waits on nothing; returns cudaGetLastError() as an int
// (0 = launched).
// s_loc and end_loc are int64 where `wide` is nonzero, else int32.
extern "C" int gblastn_diag_replay(const void* key, const void* order,
                                   const void* s_loc, const void* end_loc,
                                   const void* score, const void* cutoff,
                                   const void* right_run, int n, int word,
                                   int window, int key_shift, int wide,
                                   void* saved, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    launch<long long>(diag_replay_wide_kernel,
                      diag_replay_two_hit_wide_kernel, key, order, s_loc,
                      end_loc, score, cutoff, right_run, n, word, window,
                      key_shift, saved, st);
  else
    launch<int32_t>(diag_replay_kernel, diag_replay_two_hit_kernel, key,
                    order, s_loc, end_loc, score, cutoff, right_run, n,
                    word, window, key_shift, saved, st);
  return (int)cudaGetLastError();
}
