// G on Hopper: the approximate-ungapped gate of one-hit seeding.
//
// Replaces approx_gate_device (gblastn_tpu/ops/seeding.py:908, with
// _clamped_reset_walk :871), an XLA program of the JAX package, and the
// host gate it twins (engine/approx.py::approx_ungapped_one). Semantics
// are those of s_NuclUngappedExtend (NCBI na_ungapped.c:263), unclamped:
// the JAX package's 48-byte clamp, its 1536-byte second tier and its
// host fallback for unresolved seeds are workarounds for the TPU's
// static shapes, and here every seed's walk runs to its end.
//
// One thread a seed, over every K1 output. A seed is gated ("need") when
// its exact K1 score meets its context's word cutoff; the kernel tests
// that itself, so nothing is compacted and nothing waits before it. For
// a gated seed, in reference coordinates (query q_ref = q_off - 1; the
// subject local to its owning subject, which starts on a byte):
//   adj = (4 - (s_loc & 3)) & 3, q_ext = q_ref + adj, s_ext = s_loc + adj;
//   the left walk takes min(q_ext, s_ext) >> 2 byte-steps back from
//   (q_ext, s_ext), the right walk min(qlen - q_ext, slen - s_ext) >> 2
//   forward; a step scores table256[qbyte ^ sbyte], where qbyte is the
//   batch's packed query byte at the step's buffer position (the four
//   codes ((q0<<6)|(q1<<4)|(q2<<2)|q3) & 0xFF, ambiguity codes bleeding
//   into the neighbouring slots as in the C; ops/replay.py::query_bytes,
//   built once a batch) and sbyte is the packed subject byte; the running
//   sum moves into the score whenever
//   it turns positive (and the walk's extent to that step), and the walk
//   ends after a step that leaves it below -x_drop.
// A gated seed whose approximate score is below its context's reduced
// cutoff is demoted: its rows become q_start = a_q, s_start = a_s,
// length = max(s_off + word + run - a_s, a_r - a_q + 1), score = a_score
// (as engine/seeding.py::_finish_init_hits writes them; run is the seed's
// right run from RR with two-hit seeding, 0 where right_run is a null
// pointer), flags |= 2. Every
// gated seed gets flags |= 1. Other seeds keep K1's rows.
//
// Ranges, checked here so that a launch waits on nothing: a seed whose
// context or subject index is out of range, or whose walks would read
// outside the query buffer or the packed subject, gets FLAG_RANGE = 8,
// no walk, and K1's rows; the caller raises when it fetches the flags
// (ops/replay.py::check_gate_flags).
//
// What bounds it: the byte-steps of the gated seeds, each a few int32
// operations. The least time for the work is set by operations: the
// byte-steps of the plain version x 5 over the card's int32 rate. A step
// needs the XOR (1), the sum (1), the reset test (1), the reset's update
// (1) and the drop test (1); the two byte loads and the shared table
// load, the addressing and the loop control are not counted. The bytes,
// each input read once, are a few times less at the search path's
// shapes (chip_smoke.py prints both).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // seeds a block
constexpr int kFlagNeed = 1;
constexpr int kFlagDemote = 2;
constexpr int kFlagRange = 8;

__device__ __forceinline__ unsigned ld_u8(const uint8_t* p) {
  unsigned v;
  asm("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

struct Walk {
  int best;   // the score the walk moved into the total
  int pos;    // the step of its last reset (0: none)
};

// One direction: step j (1-based) reads the packed query byte at
// q + qstep * j and the subject byte at s + sstep * j; at most n steps.
__device__ __forceinline__ Walk walk(const int* tab, const uint8_t* q,
                                     int qstep, const uint8_t* s,
                                     int sstep, int n, int x) {
  Walk w{0, 0};
  int sum = 0;
  for (int j = 1; j <= n; ++j) {
    q += qstep;
    s += sstep;
    sum += tab[ld_u8(q) ^ ld_u8(s)];
    if (sum > 0) {
      w.best += sum;
      w.pos = j;
      sum = 0;
    }
    if (sum < -x) break;
  }
  return w;
}

struct Seeds {
  const int32_t *q_off, *s_off, *ctx, *oid, *ug_q, *ug_s, *ug_len,
      *ug_score;
};

struct Outs {
  int32_t *q, *s, *len, *score, *flags;
};

__global__ void __launch_bounds__(kThreads)
approx_gate_kernel(const uint8_t* __restrict__ qbytes,
                   const uint8_t* __restrict__ packed,
                   const int32_t* __restrict__ table256,
                   const int32_t* __restrict__ ctx_tables,
                   const long long* __restrict__ sub_starts,
                   const long long* __restrict__ sub_ends, Seeds in,
                   const int32_t* __restrict__ right_run, int QB, int P,
                   int n_ctx, int n_sub, int n, int word, int concat_end,
                   Outs out) {
  __shared__ int tab[256];
  for (int e = threadIdx.x; e < 256; e += blockDim.x) tab[e] = table256[e];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int rq = in.ug_q[i], rs = in.ug_s[i], rlen = in.ug_len[i];
  int rscore = in.ug_score[i];
  const int c = in.ctx[i];
  int flags = 0;
  if (c < 0 || c >= n_ctx) {
    flags = kFlagRange;
  } else if (rscore >= __ldg(ctx_tables + c)) {
    flags = kFlagNeed;
    const int o = in.oid[i];
    const int q_off = in.q_off[i], s_off = in.s_off[i];
    bool ok = o >= 0 && o < n_sub;
    const long long st = ok ? __ldg(sub_starts + o) : 0;
    const long long en = ok ? __ldg(sub_ends + o) : 0;
    const long long s_loc = (long long)s_off - st;
    const long long adj = (4 - (s_loc & 3)) & 3;
    const long long q_ext = (long long)q_off - 1 + adj;
    const long long s_ext = s_loc + adj;
    const long long qb = q_ext + 1;
    const long long sb = (st >> 2) + (s_ext >> 2);
    const long long n_left = (q_ext < s_ext ? q_ext : s_ext) >> 2;
    const long long rq_lim = (long long)concat_end - 1 - q_ext;
    const long long rs_lim = (en - st) - s_ext;
    const long long n_right = (rq_lim < rs_lim ? rq_lim : rs_lim) >> 2;
    // the query length behind the QB packed bytes: a step at buffer
    // position p reads the codes p .. p + 3
    const long long Q = (long long)QB + 3;
    ok = ok &&
         (n_left <= 0 || (qb - 4 * n_left >= 0 && qb <= Q &&
                          sb - n_left >= 0 && sb <= P)) &&
         (n_right <= 0 || (qb >= 0 && qb + 4 * n_right <= Q && sb >= 0 &&
                           sb + n_right <= P));
    if (!ok) {
      flags |= kFlagRange;
    } else {
      const int x = __ldg(ctx_tables + 2 * n_ctx + c);
      // the left walk reads the query byte at qb - 4j, the subject byte
      // at sb - j; the right one at qb + 4(j - 1) and sb + j - 1
      const Walk l = walk(tab, qbytes + qb, -4, packed + sb, -1,
                          (int)(n_left > 0 ? n_left : 0), x);
      const Walk r = walk(tab, qbytes + qb - 4, 4, packed + sb - 1, 1,
                          (int)(n_right > 0 ? n_right : 0), x);
      const int a_score = l.best + r.best;
      if (a_score < __ldg(ctx_tables + n_ctx + c)) {
        flags |= kFlagDemote;
        const long long a_q = q_ext - 4LL * l.pos + 1;
        const long long a_s = s_ext - 4LL * l.pos + st;
        const long long a_r = (r.pos > 0 ? q_ext + 4LL * r.pos - 1 : q_ext)
                              + 1;
        const long long run = right_run != nullptr ? right_run[i] : 0;
        const long long by_seed = (long long)s_off + word + run - a_s;
        const long long by_walk = a_r - a_q + 1;
        rq = (int)a_q;
        rs = (int)a_s;
        rlen = (int)(by_seed > by_walk ? by_seed : by_walk);
        rscore = a_score;
      }
    }
  }
  out.q[i] = rq;
  out.s[i] = rs;
  out.len[i] = rlen;
  out.score[i] = rscore;
  out.flags[i] = flags;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, reads no
// host value and waits on nothing; returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int gblastn_approx_gate(
    const void* qbytes, const void* packed, const void* table256,
    const void* ctx_tables, const void* sub_starts, const void* sub_ends,
    const void* q_off, const void* s_off, const void* ctx, const void* oid,
    const void* ug_q, const void* ug_s, const void* ug_len,
    const void* ug_score, const void* right_run, int QB, int P, int n_ctx,
    int n_sub, int n, int word, int concat_end, void* out_q, void* out_s,
    void* out_len, void* out_score, void* out_flags, void* stream) {
  if (n <= 0) return 0;
  const Seeds in{(const int32_t*)q_off, (const int32_t*)s_off,
                 (const int32_t*)ctx,   (const int32_t*)oid,
                 (const int32_t*)ug_q,  (const int32_t*)ug_s,
                 (const int32_t*)ug_len, (const int32_t*)ug_score};
  const Outs out{(int32_t*)out_q, (int32_t*)out_s, (int32_t*)out_len,
                 (int32_t*)out_score, (int32_t*)out_flags};
  approx_gate_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)qbytes, (const uint8_t*)packed,
      (const int32_t*)table256, (const int32_t*)ctx_tables,
      (const long long*)sub_starts, (const long long*)sub_ends, in,
      (const int32_t*)right_run, QB, P, n_ctx, n_sub, n, word, concat_end,
      out);
  return (int)cudaGetLastError();
}
