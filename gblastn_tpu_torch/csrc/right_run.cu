// RR on Hopper: the double-word probe of two-hit seeding.
//
// Replaces right_run_packed (gblastn_tpu/ops/seeding.py:729), an XLA
// program of the JAX package, and the host probe it twins
// (engine/seeding.py::compute_right_runs). Semantics are those of
// s_TypeOfWord (NCBI na_ungapped.c:559-586): for each seed, the count of
// exact matches to the right of its word end, at most `word`; the run
// stops at the first position d (< word) where the query base at
// q_off + word + d is ambiguous, a sentinel or differs from the subject
// base at s_off + word + d, or where either position leaves its array or
// the subject one reaches its owning subject's end.
//
// Inputs are packed as the scan reads them: the query as 4na-mask
// nibbles, eight a word (ops/seeding.py::pack_query_nibbles; A=1 C=2 G=4
// T=8, an ambiguity code its member mask, a sentinel 0), the subject as
// 2-bit codes, sixteen a word (the resident subject_w), each word an
// int64 holding 32 bits, the first position in the highest bits. A query
// nibble equal to 1 << code is exactly "unambiguous and equal".
//
// Design: a thread a seed, sixteen bases a step.
//   * Windows. The query window is 64 bits, sixteen nibbles from the
//     run's next position, the first in bits 63-60: two funnel shifts of
//     three query words (the phase q & 7 in nibbles). The subject window
//     is 32 bits, sixteen codes: one funnel shift of two subject words
//     (the phase s & 15 in codes). A step loads only the words it does
//     not hold yet; the first step's loads are issued together, beside
//     the owning subject's end, and not after it. (Loading the second
//     window's words in that first round too took as long at config 1w
//     and on the random sets, PERF.md §6: an empty kernel's launch at the
//     same grid is half of the time.)
//   * One-hot. Spreading the subject window's codes into nibbles (four
//     mask-and-shift rounds) and turning each code c into 1 << c (three
//     three-input logic terms) gives the nibbles the query must equal.
//   * The run. diff = query window ^ one-hot; its leading zero nibbles,
//     __clzll(diff) >> 2 (16 where it is 0), are the window's matches,
//     capped at what the limit leaves. The walk goes on only past a
//     window of sixteen matches: one step at word 11, two at word 28,
//     where a walk of a base a step takes up to 28 dependent compares.
//   * A seed whose subject index is out of range has a run of 0 and
//     reads nothing, as in the plain version. Subject offsets (s_off,
//     the subject words' count S16) are int64, so a seed may lie
//     anywhere in a resident database of any size; the subject word
//     index is an int below 2^31 subject bases (right_run_kernel) and a
//     long long past it (right_run_wide_kernel); the query's offsets stay
//     32-bit (the wrapper keeps its buffer below 2^31), and the limits
//     are taken in 64 bits.
// tests/test_torch_rr.py holds a torch emulation of this arithmetic to
// the plain version at every query and subject phase.
//
// What bounds it: bytes. Each seed reads q_off, s_off and oid (16 bytes)
// and writes its run (4); of the query nibbles, the subject words and the
// subject ends it needs only the words that hold a base it compares (from
// the word end through the base that stops the run short of its limit)
// and its owning subject's end, 8 bytes each, each counted once however
// many seeds share it (chip_smoke.py::rr_work tallies them for a run).
// A window loads a word or two past the run's stop; those land in the
// same cache lines, and the bound does not count them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kLow = 0x1111111111111111ull;   // bit 0 of each nibble

// sixteen 2-bit codes, the first in bits 31-30, as sixteen nibbles, the
// first in bits 63-60, each nibble 1 << code
__device__ __forceinline__ uint64_t one_hot(uint32_t codes) {
  uint64_t x = codes;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  const uint64_t y = x >> 1;                 // each code's high bit at bit 0
  return (~(x | y) & kLow) | ((x & ~y & kLow) << 1) |
         ((y & ~x & kLow) << 2) | ((x & y & kLow) << 3);
}

template <typename Index>
__device__ __forceinline__ uint32_t word_at(const long long* p, Index i,
                                            Index last) {
  return i <= last ? (uint32_t)__ldg(p + i) : 0u;
}

// The run of seed i. Index is the subject words' index type: int where
// the subject words number below 2^27 (16 * S16 < 2^31), as the kernel
// was before its offsets widened, else long long.
template <typename Index>
__device__ __forceinline__ void run_at(const long long* __restrict__ query_nib,
                                       const long long* __restrict__ subject_w,
                                       const long long* __restrict__ sub_ends,
                                       const int32_t* __restrict__ q_off,
                                       const long long* __restrict__ s_off,
                                       const int32_t* __restrict__ oid,
                                       int Q8, long long S16, int n_sub,
                                       int n, int word,
                                       int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int o = oid[i];
  int run = 0;
  if (o >= 0 && o < n_sub) {
    const long long q64 = (long long)q_off[i] + word;
    const long long s64 = s_off[i] + word;
    if (q64 >= 0 && s64 >= 0 && q64 < 8LL * Q8 && s64 < 16LL * S16) {
      const int q = (int)q64;
      // the last words that can hold a base of the run (the word size
      // and the arrays' ends), so the first loads need no subject end
      const int q_last = (int)min((long long)Q8 - 1, (q64 + word - 1) >> 3);
      const Index s_last = (Index)min(S16 - 1, (s64 + word - 1) >> 4);
      int qw = q >> 3;
      Index sw = (Index)(s64 >> 4);
      const int qsh = (q & 7) << 2, ssh = (int)(s64 & 15) << 1;
      uint32_t w0 = word_at(query_nib, qw, q_last);
      uint32_t w1 = word_at(query_nib, qw + 1, q_last);
      uint32_t w2 = word_at(query_nib, qw + 2, q_last);
      uint32_t u0 = word_at(subject_w, sw, s_last);
      uint32_t u1 = word_at(subject_w, sw + 1, s_last);
      long long s_hi = __ldg(sub_ends + o);
      if (s_hi > 16LL * S16) s_hi = 16LL * S16;
      // the positions the run may reach: inside the query, inside the
      // owning subject, at most `word`
      long long lim64 = word;
      if (8LL * Q8 - q64 < lim64) lim64 = 8LL * Q8 - q64;
      if (s_hi - s64 < lim64) lim64 = s_hi - s64;
      const int lim = (int)max(lim64, 0LL);
      while (run < lim) {
        const uint64_t qwin =
            ((uint64_t)__funnelshift_l(w1, w0, qsh) << 32) |
            __funnelshift_l(w2, w1, qsh);
        const uint64_t diff = qwin ^ one_hot(__funnelshift_l(u1, u0, ssh));
        const int left = lim - run;
        const int m = __clzll((long long)diff) >> 2;
        if (m < 16 || left <= 16) {
          run += min(m, left);
          break;
        }
        run += 16;
        qw += 2;
        sw += 1;
        w0 = w2;
        w1 = word_at(query_nib, qw + 1, q_last);
        w2 = word_at(query_nib, qw + 2, q_last);
        u0 = u1;
        u1 = word_at(subject_w, sw + 1, s_last);
      }
    }
  }
  out[i] = run;
}

__global__ void __launch_bounds__(kThreads)
right_run_kernel(const long long* __restrict__ query_nib,
                 const long long* __restrict__ subject_w,
                 const long long* __restrict__ sub_ends,
                 const int32_t* __restrict__ q_off,
                 const long long* __restrict__ s_off,
                 const int32_t* __restrict__ oid, int Q8, long long S16,
                 int n_sub, int n, int word, int32_t* __restrict__ out) {
  run_at<int>(query_nib, subject_w, sub_ends, q_off, s_off, oid, Q8, S16,
              n_sub, n, word, out);
}

__global__ void __launch_bounds__(kThreads)
right_run_wide_kernel(const long long* __restrict__ query_nib,
                      const long long* __restrict__ subject_w,
                      const long long* __restrict__ sub_ends,
                      const int32_t* __restrict__ q_off,
                      const long long* __restrict__ s_off,
                      const int32_t* __restrict__ oid, int Q8,
                      long long S16, int n_sub, int n, int word,
                      int32_t* __restrict__ out) {
  run_at<long long>(query_nib, subject_w, sub_ends, q_off, s_off, oid, Q8,
                    S16, n_sub, n, word, out);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, reads no
// host value and waits on nothing; returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int gblastn_right_run(const void* query_nib,
                                 const void* subject_w,
                                 const void* sub_ends, const void* q_off,
                                 const void* s_off, const void* oid, int Q8,
                                 long long S16, int n_sub, int n, int word,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  const auto kernel =
      16LL * S16 < (1LL << 31) ? right_run_kernel : right_run_wide_kernel;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
           (cudaStream_t)stream>>>(
      (const long long*)query_nib, (const long long*)subject_w,
      (const long long*)sub_ends, (const int32_t*)q_off,
      (const long long*)s_off, (const int32_t*)oid, Q8, S16, n_sub, n, word,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
