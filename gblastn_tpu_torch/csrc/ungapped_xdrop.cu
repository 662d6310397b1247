// K1 on Hopper: exact two-way X-drop ungapped extension, one thread per seed.
//
// Replaces the Pallas TPU kernel gblastn_tpu/ops/pallas_ungapped.py
// (_make_kernel / kernel, launched by _call_batched). Semantics are those
// of s_NuclUngappedExtendExact (NCBI na_ungapped.c:152), reset-at-best:
//   * the left walk scores q_off-1, q_off-2, ...; the right walk scores
//     q_off, q_off+1, ... (step j reads q_off-j on the left, q_off+j-1 on
//     the right, and the same offsets from s_off in the subject);
//   * steps past the seed's budget (max_l / max_r) score NEG_BIG;
//   * a walk stops at the first step whose running sum falls below
//     max(best so far, 0) - x; best starts at 0 at position 0 and moves
//     only on a strictly greater sum, so ties keep the first position.
// Outputs per seed: q_start = q_off - l_pos, s_start = s_off - l_pos,
// length = l_pos + r_pos, score = l_best + r_best, flags: bit 1 / bit 2 =
// the left / right walk ended at its step budget. Bit 0 (window overrun on
// the TPU) is never set: this kernel has no window.
//
// Scores come from the packed query byte (4na mask | degeneracy << 4)
// against the 2-bit subject code through the closed form of
// _scores_closed_form, reading the constants table64[64:70].
//
// What bounds it on this card: each step is a dependent pair of byte loads
// (query, subject) followed by a compare-and-branch, so a thread is latency
// bound, and a warp runs as long as its longest walk (divergence). The
// arrays are read in place (no guard-padded window copies); a seed's
// neighbourhood is a few hundred contiguous bytes that stay in L1/L2 across
// steps. Accumulation is int32: one NEG_BIG (-2^24) per walk ends it, so it
// cannot overflow. The least time for the work is set by operations: the
// walk steps taken x 9 int32 operations each over the card's int32 rate.
// A step needs the score of its pair (3: the query's mask, the test against
// the subject code's bit, the reward/penalty select), the sum (1), the
// X-drop test (2: best - x, compare) and the best with its step (3:
// compare, two selects); the two byte loads, the addressing and the loop
// control are not counted. The bytes, each input read once, are an order
// of magnitude less (chip_smoke.py prints both).
// A warp-per-seed layout with a warp-wide prefix scan over 32 steps at a
// time is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegBig = -(1 << 24);
constexpr int kThreads = 128;

struct Consts {
  int reward, penalty, amb2, amb3, amb4, sentinel;
};

__device__ __forceinline__ int score_closed(unsigned qp, int scode,
                                            const Consts& c) {
  const unsigned qmask = qp & 15u;
  const unsigned deg = qp >> 4;
  const unsigned sbit = 1u << (scode < 0 ? 0 : (scode > 3 ? 3 : scode));
  if (qmask == 0u) return c.sentinel;
  if (qmask == sbit) return c.reward;
  if (qmask & sbit) return deg == 2u ? c.amb2 : (deg == 3u ? c.amb3 : c.amb4);
  return c.penalty;
}

// One direction of the walk. dir = -1 (left) reads q0 - j, dir = +1
// (right) reads q0 + j - 1. Returns the best sum (>= 0) and its step in
// *pos (0 when best == 0); *bound is 1 when the walk stopped past its
// budget.
__device__ __forceinline__ int walk(const uint8_t* __restrict__ query,
                                   const int8_t* __restrict__ subject,
                                   long long q0, long long s0, int dir,
                                   int max_steps, int x, const Consts& c,
                                   int* pos, int* bound) {
  int sum = 0, best = 0, best_pos = 0;
  int j = 1;
  for (;; ++j) {
    int sc;
    if (j <= max_steps) {
      const long long d = dir > 0 ? (long long)(j - 1) : -(long long)j;
      sc = score_closed(__ldg(query + q0 + d), __ldg(subject + s0 + d), c);
    } else {
      sc = kNegBig;
    }
    sum += sc;
    if (sum < best - x) break;
    if (sum > best) {
      best = sum;
      best_pos = j;
    }
  }
  *pos = best_pos;
  *bound = j > max_steps ? 1 : 0;
  return best;
}

__global__ void __launch_bounds__(kThreads)
ungapped_xdrop_kernel(const uint8_t* __restrict__ query,
                      const int8_t* __restrict__ subject,
                      const int32_t* __restrict__ table64,
                      const int32_t* __restrict__ q_off,
                      const int32_t* __restrict__ s_off,
                      const int32_t* __restrict__ x_drop,
                      const int32_t* __restrict__ max_l,
                      const int32_t* __restrict__ max_r, int n,
                      int32_t* __restrict__ out_q,
                      int32_t* __restrict__ out_s,
                      int32_t* __restrict__ out_len,
                      int32_t* __restrict__ out_score,
                      int32_t* __restrict__ out_flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Consts c;
  c.reward = __ldg(table64 + 64);
  c.penalty = __ldg(table64 + 65);
  c.amb2 = __ldg(table64 + 66);
  c.amb3 = __ldg(table64 + 67);
  c.amb4 = __ldg(table64 + 68);
  c.sentinel = __ldg(table64 + 69);

  const long long q0 = q_off[i];
  const long long s0 = s_off[i];
  const int x = x_drop[i];
  int l_pos, l_bound, r_pos, r_bound;
  const int l_best = walk(query, subject, q0, s0, -1, max_l[i], x, c,
                          &l_pos, &l_bound);
  const int r_best = walk(query, subject, q0, s0, +1, max_r[i], x, c,
                          &r_pos, &r_bound);
  out_q[i] = (int32_t)(q0 - l_pos);
  out_s[i] = (int32_t)(s0 - l_pos);
  out_len[i] = l_pos + r_pos;
  out_score[i] = l_best + r_best;
  out_flags[i] = 2 * l_bound + 4 * r_bound;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int gblastn_ungapped_xdrop(
    const void* query, const void* subject, const void* table64,
    const void* q_off, const void* s_off, const void* x_drop,
    const void* max_l, const void* max_r, int n, void* out_q, void* out_s,
    void* out_len, void* out_score, void* out_flags, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  ungapped_xdrop_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)query, (const int8_t*)subject,
      (const int32_t*)table64, (const int32_t*)q_off,
      (const int32_t*)s_off, (const int32_t*)x_drop, (const int32_t*)max_l,
      (const int32_t*)max_r, n, (int32_t*)out_q, (int32_t*)out_s,
      (int32_t*)out_len, (int32_t*)out_score, (int32_t*)out_flags);
  return (int)cudaGetLastError();
}
