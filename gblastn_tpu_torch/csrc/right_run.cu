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
// A thread a seed. The thread holds one query word and one subject word
// and steps a base at a time, loading the next word when a step crosses
// into it: at most ceil(word / 8) + 1 query loads and ceil(word / 16) +
// 1 subject loads (five and three at word 28), all through the read-only
// cache. The walk ends early at the first mismatch; a random seed's run
// is 0 three times in four. A seed whose subject index is out of range
// has a run of 0 (reads nothing), as in the plain version.
//
// What bounds it: bytes. Each seed reads q_off, s_off and oid (12 bytes)
// and writes its run (4); of the query nibbles, the subject words and the
// subject ends it needs only the words that hold a base it compares (from
// the word end through the base that stops the run short of its limit)
// and its owning subject's end, 8 bytes each, each counted once however
// many seeds share it (chip_smoke.py::rr_bytes tallies them for a run).
// The compares are a few int32 operations a base of the run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
right_run_kernel(const long long* __restrict__ query_nib,
                 const long long* __restrict__ subject_w,
                 const long long* __restrict__ sub_ends,
                 const int32_t* __restrict__ q_off,
                 const int32_t* __restrict__ s_off,
                 const int32_t* __restrict__ oid, int Q8, int S16,
                 int n_sub, int n, int word, int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int o = oid[i];
  int run = 0;
  if (o >= 0 && o < n_sub) {
    const long long q = (long long)q_off[i] + word;
    const long long s = (long long)s_off[i] + word;
    long long s_hi = __ldg(sub_ends + o);
    if (s_hi > 16LL * S16) s_hi = 16LL * S16;
    // the positions the run may reach: inside the query, inside the
    // owning subject, at most `word`
    long long lim = word;
    if (8LL * Q8 - q < lim) lim = 8LL * Q8 - q;
    if (s_hi - s < lim) lim = s_hi - s;
    if (q < 0 || s < 0) lim = 0;
    if (lim > 0) {
      long long qw = q >> 3, sw = s >> 4;
      int qp = (int)(q & 7), sp = (int)(s & 15);
      unsigned qbits = (unsigned)__ldg(query_nib + qw);
      unsigned sbits = (unsigned)__ldg(subject_w + sw);
      while (run < lim) {
        const unsigned qn = (qbits >> ((7 - qp) << 2)) & 15u;
        const unsigned sc = (sbits >> ((15 - sp) << 1)) & 3u;
        if (qn != (1u << sc)) break;
        ++run;
        if (++qp == 8 && run < lim) {
          qp = 0;
          qbits = (unsigned)__ldg(query_nib + ++qw);
        }
        if (++sp == 16 && run < lim) {
          sp = 0;
          sbits = (unsigned)__ldg(subject_w + ++sw);
        }
      }
    }
  }
  out[i] = run;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, reads no
// host value and waits on nothing; returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int gblastn_right_run(const void* query_nib,
                                 const void* subject_w,
                                 const void* sub_ends, const void* q_off,
                                 const void* s_off, const void* oid, int Q8,
                                 int S16, int n_sub, int n, int word,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  right_run_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const long long*)query_nib, (const long long*)subject_w,
      (const long long*)sub_ends, (const int32_t*)q_off,
      (const int32_t*)s_off, (const int32_t*)oid, Q8, S16, n_sub, n, word,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
