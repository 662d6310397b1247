// K1 on Hopper: exact two-way X-drop ungapped extension of every seed.
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
// Coordinates: the subject offsets (s_off, the output s_start) and the
// subject's length S are int64, so a seed may lie anywhere in a resident
// database of any size, a single subject past 2^31 bases included; the
// query offsets, the budgets, lengths and scores stay int32 (a walk never
// leaves the query, whose buffer is below 2^31).
//
// Ranges, checked here and not by the caller, so that a launch waits on
// nothing: a seed needs max_l, max_r >= 0, q_off - max_l >= 0, s_off -
// max_l >= 0, q_off + max_r <= Q, s_off + max_r <= S and 0 <= x < 2^23.
// A seed outside them gets no walk and the outputs (q_off, s_off, 0, 0,
// FLAG_RANGE = 8); the caller raises when it fetches the flags
// (ops/ungapped.py::check_flags). Since sum <= best, a step whose score
// is at most -(x + 1) always ends its walk; with x < 2^23 so does every
// NEG_BIG step, the budget's step max_steps + 1 among them.
//
// Scores come from a 1024-entry int32 table in shared memory indexed by
// (packed query byte << 2) | clamp(subject code, 0, 3), built by each
// block from table64[64:70] through the closed form (_scores in
// ops/ungapped.py): a shift-or and one shared load a step in place of a
// dozen compares and selects on the integer pipe.
//
// One thread a seed. Its left walk and then its right walk run in one
// loop, the direction and the walk's state in registers, so a warp runs
// as long as its longest left + right, not max(left) + max(right). An
// iteration takes a group of kGroup = 8 steps: byte loads at immediate
// offsets from one pointer a sequence (the left walk's in reverse order),
// one pointer step and one budget test a group. The walk's state is the
// sum and g = best - sum, so a step is a subtraction, a max with 0 and
// two compares (a new best; the drop, g > x); a group's drops are tested
// at every step and acted on by one branch, which takes the group's steps
// again, with an exit at the drop, only where the walk ends.
//
// What bounds it on this card: dispatching each step's instructions
// (about 16 a step in the groups of 8, two byte loads and a shared load
// among them). The least time for the work is set by operations: the
// walk steps of the plain version x 9 int32 operations each over the
// card's int32 rate. A step needs the score of its pair (3: the query's
// mask, the test against the subject code's bit, the reward/penalty
// select), the sum (1), the X-drop test (2: best - x, compare) and the
// best with its step (3: compare, two selects); the two byte loads, the
// addressing and the loop control are not counted. The bytes, each input
// read once, are an order of magnitude less (chip_smoke.py prints both).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegBig = -(1 << 24);
constexpr int kXLimit = 1 << 23;
constexpr int kFlagRange = 8;
constexpr int kTable = 1024;
constexpr int kThreads = 256;        // seeds a block
constexpr int kGroup = 8;            // steps an iteration

__device__ __forceinline__ int score_closed(unsigned qp, int scode,
                                            const int32_t* c) {
  const unsigned qmask = qp & 15u;
  const unsigned deg = qp >> 4;
  const unsigned sbit = 1u << (scode < 0 ? 0 : (scode > 3 ? 3 : scode));
  if (qmask == 0u) return __ldg(c + 5);
  if (qmask == sbit) return __ldg(c + 0);
  if (qmask & sbit) return __ldg(c + (deg == 2u ? 2 : (deg == 3u ? 3 : 4)));
  return __ldg(c + 1);
}

// The score table of (packed query byte << 2) | subject code, from the
// closed-form constants table64[64:70]. Every thread of the block calls it.
__device__ __forceinline__ void build_table(int* tab,
                                            const int32_t* table64) {
  for (int e = threadIdx.x; e < kTable; e += blockDim.x)
    tab[e] = score_closed((unsigned)e >> 2, e & 3, table64 + 64);
  __syncthreads();
}

// The score of packed query byte qp against subject code sc from the
// table at shared address tab: one clamp (DPX: max(min(sc + 0, 3), 0)),
// two shift-adds and one shared load.
__device__ __forceinline__ int score(unsigned tab, unsigned qp, int sc) {
  const unsigned c = (unsigned)__viaddmin_s32_relu(sc, 0, 3);
  int v;
  asm("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(tab + (qp << 4) + (c << 2)));
  return v;
}

// The table's shared address in a register the compiler cannot
// rematerialise (else the loop rebuilds it from the CTA's id each time).
__device__ __forceinline__ unsigned table_address(const int* tab) {
  unsigned a;
  asm volatile("mov.u32 %0, %1;"
               : "=r"(a) : "r"((unsigned)__cvta_generic_to_shared(tab)));
  return a;
}

// Byte loads through the read-only path into 32-bit registers (the
// query byte zero-extended, the subject code sign-extended), so no mask
// follows them.
__device__ __forceinline__ unsigned ld_u8(const uint8_t* p) {
  unsigned v;
  asm("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_s8(const int8_t* p) {
  int v;
  asm("ld.global.nc.s8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ bool in_range(int q0, long long s0, int x,
                                         int ml, int mr, int Q,
                                         long long S) {
  return ml >= 0 && mr >= 0 && x >= 0 && x < kXLimit &&
         (long long)q0 - ml >= 0 && s0 - ml >= 0 &&
         (long long)q0 + mr <= Q && s0 + mr <= S;
}

struct Outs {
  int32_t *q;
  long long* s;
  int32_t *len, *score, *flags;
  __device__ void put(int i, int q0, long long s0, int l_pos, int r_pos,
                      int best, int f) const {
    q[i] = q0 - l_pos;
    s[i] = s0 - l_pos;
    len[i] = l_pos + r_pos;
    score[i] = best;
    flags[i] = f;
  }
};

__global__ void __launch_bounds__(kThreads)
k1_kernel(const uint8_t* __restrict__ query,
                 const int8_t* __restrict__ subject,
                 const int32_t* __restrict__ table64,
                 const int32_t* __restrict__ q_off,
                 const long long* __restrict__ s_off,
                 const int32_t* __restrict__ x_drop,
                 const int32_t* __restrict__ max_l,
                 const int32_t* __restrict__ max_r, int n, int Q,
                 long long S, Outs out) {
  __shared__ int tab_[kTable];
  build_table(tab_, table64);
  const unsigned tab = table_address(tab_);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int q0 = q_off[i], x = x_drop[i];
  const long long s0 = s_off[i];
  const int ml = max_l[i], mr = max_r[i];
  if (!in_range(q0, s0, x, ml, mr, Q, S)) {
    out.put(i, q0, s0, 0, 0, 0, kFlagRange);
    return;
  }
  // The left walk, then the right one, in this one loop, kGroup steps an
  // iteration: steps j+1 .. j+kGroup read the bytes at qp[0..kGroup-1],
  // sp[0..kGroup-1] (the left walk's from q0 - j - kGroup, in reverse;
  // the right walk's from q0 + j), which then move by dl. rem = the
  // budget's steps left. The walk's state is its sum and g = best - sum
  // >= 0: a step of score sc is strictly above the best when g < sc,
  // leaves g = max(g - sc, 0), and drops when then g > x (with x >= 0,
  // the same test as sum < best - x against the best before the step);
  // best = sum + g.
  const uint8_t* qp = query + ((long long)q0 - kGroup);
  const int8_t* sp = subject + (s0 - kGroup);
  long long dl = -kGroup;
  int rem = ml, j = 0, flags = 0, l_best = 0, l_pos = 0;
  int sum = 0, g = 0, pos = 0;
  bool left = true;
  for (;;) {
    int stop = 0;                 // the step that ended the walk
    if (rem >= kGroup) {
      // a group inside the budget: scored in address order, taken in the
      // walk's order; the drop tested at every step, acted on once
      int a[kGroup], sc[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        a[k] = score(tab, ld_u8(qp + k), ld_s8(sp + k));
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
        sc[t] = left ? a[kGroup - 1 - t] : a[t];
      const int sum0 = sum, g0 = g, pos0 = pos;
      bool drop = false;
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        const int d = g - sc[t];
        if (d < 0) pos = j + t + 1;
        g = max(d, 0);
        sum += sc[t];
        drop |= g > x;
      }
      if (!drop) {
        j += kGroup;
        rem -= kGroup;
        qp += dl;
        sp += dl;
        continue;
      }
      // the walk ends in this group: its steps again, up to the drop
      sum = sum0;
      g = g0;
      pos = pos0;
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        const int d = g - sc[t];
        if (d < 0) pos = j + t + 1;
        g = max(d, 0);
        sum += sc[t];
        if (g > x) {
          stop = j + t + 1;
          break;
        }
      }
    } else {
      // under a group left: one step at a time; the step past the
      // budget scores NEG_BIG and drops
      for (int t = 0;; ++t) {
        const int k = left ? kGroup - 1 - t : t;
        const int sc = t < rem ? score(tab, ld_u8(qp + k), ld_s8(sp + k))
                               : kNegBig;
        const int d = g - sc;
        if (d < 0) pos = j + t + 1;
        g = max(d, 0);
        sum += sc;
        if (g > x) {
          stop = j + t + 1;
          break;
        }
      }
      if (stop - j > rem) flags |= left ? 2 : 4;   // past the budget
    }
    if (!left) break;
    l_best = sum + g;
    l_pos = pos;
    left = false;
    rem = mr;
    j = sum = g = pos = 0;
    qp = query + q0;
    sp = subject + s0;
    dl = kGroup;
  }
  out.put(i, q0, s0, l_pos, pos, l_best + sum + g, flags);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, reads no
// host value and waits on nothing; returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int gblastn_ungapped_xdrop(
    const void* query, const void* subject, const void* table64,
    const void* q_off, const void* s_off, const void* x_drop,
    const void* max_l, const void* max_r, int n, int Q, long long S,
    void* out_q, void* out_s, void* out_len, void* out_score,
    void* out_flags, void* stream) {
  if (n <= 0) return 0;
  const Outs out{(int32_t*)out_q, (long long*)out_s, (int32_t*)out_len,
                 (int32_t*)out_score, (int32_t*)out_flags};
  k1_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
              (cudaStream_t)stream>>>(
      (const uint8_t*)query, (const int8_t*)subject,
      (const int32_t*)table64, (const int32_t*)q_off,
      (const long long*)s_off, (const int32_t*)x_drop,
      (const int32_t*)max_l, (const int32_t*)max_r, n, Q, S, out);
  return (int)cudaGetLastError();
}
