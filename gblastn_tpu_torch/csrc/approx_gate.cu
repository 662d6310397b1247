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
// A seed is gated ("need") when its exact K1 score meets its context's
// word cutoff. For a gated seed, in reference coordinates (query q_ref =
// q_off - 1; the subject local to its owning subject, which starts on a
// byte):
//   adj = (4 - (s_loc & 3)) & 3, q_ext = q_ref + adj, s_ext = s_loc + adj;
//   the left walk takes min(q_ext, s_ext) >> 2 byte-steps back from
//   (q_ext, s_ext), the right walk min(qlen - q_ext, slen - s_ext) >> 2
//   forward; a step scores table256[qbyte ^ sbyte], where qbyte is the
//   batch's packed query byte at the step's buffer position (the four
//   codes ((q0<<6)|(q1<<4)|(q2<<2)|q3) & 0xFF, ambiguity codes bleeding
//   into the neighbouring slots as in the C; ops/replay.py::query_bytes,
//   built once a batch) and sbyte is the packed subject byte; the running
//   sum moves into the score whenever it turns positive (and the walk's
//   extent to that step), and the walk ends after a step that leaves it
//   below -x_drop.
// A gated seed whose approximate score is below its context's reduced
// cutoff is demoted: its rows become q_start = a_q, s_start = a_s,
// length = max(s_off + word + run - a_s, a_r - a_q + 1), score = a_score
// (as engine/seeding.py::_finish_init_hits writes them; run is the seed's
// right run from RR with two-hit seeding, 0 where right_run is a null
// pointer), flags |= 2. Every gated seed gets flags |= 1. Other seeds
// keep K1's rows.
//
// Coordinates: the seeds' subject offsets (s_off, K1's s_start) and the
// output s_start are int64, as are the packed subject's length and the
// subject bounds, so a seed may lie anywhere in a resident database of any
// size; query offsets, lengths, scores and the walks' step counts stay
// int32.
//
// Ranges, checked here so that a launch waits on nothing: a seed whose
// context or subject index is out of range, or whose walks would read
// outside the query buffer or the packed subject, gets FLAG_RANGE = 8,
// no walk, and K1's rows; the caller raises when it fetches the flags
// (ops/replay.py::check_gate_flags).
//
// Design (tools/prof_launch.py times it against the parent's kernel;
// PERF.md has the designs that lost, measured on an H100):
//   * Gated seeds only in the warps, in their order. A block takes 256
//     seeds, a thread a seed; it writes the outputs of a seed that is not
//     walked at once and lists the walked ones in shared memory, so that
//     they fill the block's first warps. The order is kept: K1's seeds
//     come in subject order, so neighbouring gated seeds lie on one
//     read's diagonal and walk the same bytes for about as long. (A
//     warp's queue over chunks strided across the grid mixed them and
//     was slower than the parent's kernel; so was a block that refilled
//     its lanes from four times as many seeds.)
//   * A thread takes both walks of its seed in one loop, the left one
//     first, so a warp runs as long as its longest left + right (K1's
//     layout). (Lanes sharing one walk, joined by a shuffle scan of each
//     run's sum and largest partial sum, cost three times the
//     instructions a step and lost at every team size.)
//   * A group of kSteps steps issues all its query bytes (stride 4) and
//     subject bytes, at immediate offsets from the group's lowest byte
//     (the left walk takes them in reverse), before any score. A full
//     group runs without a branch and is kept where no step dropped; the
//     walk's last group is taken again a step at a time (once a walk).
//     Groups of 16 steps were the fastest of 4, 8, 16 and 32.
//
// What bounds it: the byte-steps of the gated seeds, each a few int32
// operations. The least time for the work is set by operations: the
// byte-steps of the plain version x 5 over the card's int32 rate. A step
// needs the XOR (1), the sum (1), the reset test (1), the reset's update
// (1) and the drop test (1); the two byte loads and the shared table
// load, the addressing and the loop control are not counted.
// The bytes, each input read once, are a few times less at the search
// path's shapes (chip_smoke.py prints both).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;  // steps a walk loads at once
constexpr unsigned kFull = 0xffffffffu;

constexpr int kFlagNeed = 1;
constexpr int kFlagDemote = 2;
constexpr int kFlagRange = 8;

struct Seeds {
  const int32_t* q_off;
  const long long* s_off;
  const int32_t *ctx, *oid, *ug_q;
  const long long* ug_s;
  const int32_t *ug_len, *ug_score;
};

struct Outs {
  int32_t* q;
  long long* s;
  int32_t *len, *score, *flags;
};

struct Gate {
  const uint8_t* qbytes;
  const uint8_t* packed;
  const int32_t* table256;
  const int32_t* ctx_tables;
  const long long* sub_starts;
  const long long* sub_ends;
  Seeds in;
  const int32_t* right_run;
  long long P;
  int QB, n_ctx, n_sub, n, word, concat_end;
  Outs out;
};

// Where a gated seed's walks start and how far they may go.
struct Geo {
  long long st, q_ext, s_ext, qb, sb, n_left, n_right;
};

// The seed's walk geometry; false where a walk would read outside the
// query buffer or the packed subject, or the subject index is out of
// range.
__device__ __forceinline__ bool geometry(const Gate& g, int i, Geo& w) {
  const int o = __ldg(g.in.oid + i);
  const bool ok = o >= 0 && o < g.n_sub;
  w.st = ok ? __ldg(g.sub_starts + o) : 0;
  const long long en = ok ? __ldg(g.sub_ends + o) : 0;
  const long long s_loc = __ldg(g.in.s_off + i) - w.st;
  const long long adj = (4 - (s_loc & 3)) & 3;
  w.q_ext = (long long)__ldg(g.in.q_off + i) - 1 + adj;
  w.s_ext = s_loc + adj;
  w.qb = w.q_ext + 1;
  w.sb = (w.st >> 2) + (w.s_ext >> 2);
  w.n_left = (w.q_ext < w.s_ext ? w.q_ext : w.s_ext) >> 2;
  const long long rq_lim = (long long)g.concat_end - 1 - w.q_ext;
  const long long rs_lim = (en - w.st) - w.s_ext;
  w.n_right = (rq_lim < rs_lim ? rq_lim : rs_lim) >> 2;
  // the query length behind the QB packed bytes: a step at buffer
  // position p reads the codes p .. p + 3
  const long long Q = (long long)g.QB + 3;
  return ok &&
         (w.n_left <= 0 || (w.qb - 4 * w.n_left >= 0 && w.qb <= Q &&
                            w.sb - w.n_left >= 0 && w.sb <= g.P)) &&
         (w.n_right <= 0 || (w.qb >= 0 && w.qb + 4 * w.n_right <= Q &&
                             w.sb >= 0 && w.sb + w.n_right <= g.P));
}

__device__ __forceinline__ void put(const Gate& g, int i, int q,
                                    long long s, int len, int score,
                                    int flags) {
  g.out.q[i] = q;
  g.out.s[i] = s;
  g.out.len[i] = len;
  g.out.score[i] = score;
  g.out.flags[i] = flags;
}

// Seed i's outputs where it is not walked (K1's rows, and its flags);
// true where it is gated and in range, and the walks write them.
__device__ __forceinline__ bool classify(const Gate& g, int i) {
  const int c = __ldg(g.in.ctx + i);
  const int score = __ldg(g.in.ug_score + i);
  int flags = 0;
  if (c < 0 || c >= g.n_ctx) {
    flags = kFlagRange;
  } else if (score >= __ldg(g.ctx_tables + c)) {
    Geo w;
    if (geometry(g, i, w)) return true;
    flags = kFlagNeed | kFlagRange;
  }
  put(g, i, __ldg(g.in.ug_q + i), __ldg(g.in.ug_s + i),
      __ldg(g.in.ug_len + i), score, flags);
  return false;
}

struct Walk {
  int best;   // M at the walk's end: the score moved into the total
  int pos;    // the step of its last strict rise (0: none)
};

// One group of kSteps steps of a walk, from its lowest query byte q
// (the steps' query bytes stride 4) and lowest subject byte s: the
// scores in walk order (the left walk takes the bytes in reverse). Every
// load is issued before any score; a byte past the walk's budget (k >=
// rem) is not loaded.
__device__ __forceinline__ void group_scores(const int* tab,
                                             const uint8_t* q,
                                             const uint8_t* s, bool left,
                                             int rem, int (&sc)[kSteps]) {
  unsigned qv[kSteps], sv[kSteps];
  if (rem >= kSteps) {
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      qv[i] = __ldg(q + 4 * i);
      sv[i] = __ldg(s + i);
    }
  } else {
    // the budget's bytes: i in [lo, hi)
    const int lo = left ? kSteps - rem : 0, hi = left ? kSteps : rem;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const bool v = i >= lo && i < hi;
      qv[i] = v ? __ldg(q + 4 * i) : 0u;
      sv[i] = v ? __ldg(s + i) : 0u;
    }
  }
  int raw[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) raw[i] = tab[qv[i] ^ sv[i]];
#pragma unroll
  for (int k = 0; k < kSteps; ++k)
    sc[k] = left ? raw[kSteps - 1 - k] : raw[k];
}

// Both walks of a seed in one loop, the left one first, so a warp runs
// as long as its longest left + right (K1's layout); kSteps steps a
// group. A full group runs without a branch, as if the walk went on, and
// is kept where no step dropped; otherwise, and in the walk's last,
// partial group, the group is taken again a step at a time up to the
// drop or the budget (once a walk).
__device__ __forceinline__ void seed_walk(const Gate& g, const int* tab,
                                          const Geo& w, int x, Walk& lw,
                                          Walk& rw) {
  const int nl = w.n_left > 0 ? (int)w.n_left : 0;
  const int nr = w.n_right > 0 ? (int)w.n_right : 0;
  bool left = nl > 0;
  int rem = left ? nl : nr;    // steps the walk may still take
  int done = 0;                // steps it took
  // the left walk's step j reads the query byte at qb - 4j and the
  // subject byte at sb - j; the right one's at qb + 4(j - 1), sb + j - 1
  const uint8_t* q =
      left ? g.qbytes + (w.qb - 4LL * kSteps) : g.qbytes + w.qb;
  const uint8_t* s = left ? g.packed + (w.sb - kSteps) : g.packed + w.sb;
  int sum = 0, best = 0, pos = 0;
  lw = Walk{0, 0};
  while (rem > 0) {
    int sc[kSteps];
    group_scores(tab, q, s, left, rem, sc);
    int s2 = sum, b2 = best, k2 = 0;
    bool drop = false;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      s2 += sc[k];
      const bool up = s2 > 0;
      b2 = up ? b2 + s2 : b2;
      k2 = up ? k + 1 : k2;
      s2 = up ? 0 : s2;
      drop = drop || s2 < -x;
    }
    if (!drop && rem >= kSteps) {
      sum = s2;
      best = b2;
      pos = k2 ? done + k2 : pos;
      rem -= kSteps;
    } else {
      bool stop = false;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (!stop && k < rem) {
          sum += sc[k];
          if (sum > 0) {
            best += sum;
            pos = done + k + 1;
            sum = 0;
          } else if (sum < -x) {
            stop = true;
          }
        }
      }
      rem = 0;
    }
    done += kSteps;
    q += left ? -4 * kSteps : 4 * kSteps;
    s += left ? -kSteps : kSteps;
    if (rem <= 0 && left) {    // on to the right walk
      lw = Walk{best, pos};
      left = false;
      rem = nr;
      done = sum = best = pos = 0;
      q = g.qbytes + w.qb;
      s = g.packed + w.sb;
    }
  }
  rw = Walk{best, pos};
}

// A walked seed's outputs from its two walks.
__device__ __forceinline__ void gate_put(const Gate& g, int i, int c,
                                         const Geo& w, Walk l, Walk r) {
  int rq = __ldg(g.in.ug_q + i);
  long long rs = __ldg(g.in.ug_s + i);
  int rlen = __ldg(g.in.ug_len + i), rscore = __ldg(g.in.ug_score + i);
  int flags = kFlagNeed;
  const int a_score = l.best + r.best;
  if (a_score < __ldg(g.ctx_tables + g.n_ctx + c)) {
    flags |= kFlagDemote;
    const long long a_q = w.q_ext - 4LL * l.pos + 1;
    const long long a_s = w.s_ext - 4LL * l.pos + w.st;
    const long long a_r =
        (r.pos > 0 ? w.q_ext + 4LL * r.pos - 1 : w.q_ext) + 1;
    const long long run = g.right_run != nullptr ? g.right_run[i] : 0;
    const long long by_seed = __ldg(g.in.s_off + i) + g.word + run - a_s;
    const long long by_walk = a_r - a_q + 1;
    rq = (int)a_q;
    rs = a_s;
    rlen = (int)(by_seed > by_walk ? by_seed : by_walk);
    rscore = a_score;
  }
  put(g, i, rq, rs, rlen, rscore, flags);
}

// A block takes kThreads seeds, a thread a seed: it writes the outputs
// of a seed that is not walked and lists the walked ones in shared
// memory, in their order (a ballot a warp), so that they fill the
// block's first warps; then thread t walks the list's seed t.
__global__ void __launch_bounds__(kThreads)
approx_gate_kernel(const Gate g) {
  __shared__ int tab[256];
  __shared__ int list[kThreads];
  __shared__ int warp_n[kWarps];
  for (int e = threadIdx.x; e < 256; e += kThreads) tab[e] = g.table256[e];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool walk = i < g.n && classify(g, (int)i);
  const unsigned m = __ballot_sync(kFull, walk);
  if (lane == 0) warp_n[wi] = __popc(m);
  __syncthreads();
  int at = __popc(m & ((1u << lane) - 1)), total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    at += k < wi ? warp_n[k] : 0;
    total += warp_n[k];
  }
  if (walk) list[at] = (int)i;
  __syncthreads();
  if ((int)threadIdx.x >= total) return;
  const int j = list[threadIdx.x];
  const int c = __ldg(g.in.ctx + j);
  Geo w;
  geometry(g, j, w);
  Walk l, r;
  seed_walk(g, tab, w, __ldg(g.ctx_tables + 2 * g.n_ctx + c), l, r);
  gate_put(g, j, c, w, l, r);
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
    const void* ug_score, const void* right_run, int QB, long long P,
    int n_ctx, int n_sub, int n, int word, int concat_end, void* out_q,
    void* out_s,
    void* out_len, void* out_score, void* out_flags, void* stream) {
  if (n <= 0) return 0;
  const Gate g{(const uint8_t*)qbytes, (const uint8_t*)packed,
               (const int32_t*)table256, (const int32_t*)ctx_tables,
               (const long long*)sub_starts, (const long long*)sub_ends,
               Seeds{(const int32_t*)q_off, (const long long*)s_off,
                     (const int32_t*)ctx, (const int32_t*)oid,
                     (const int32_t*)ug_q, (const long long*)ug_s,
                     (const int32_t*)ug_len, (const int32_t*)ug_score},
               (const int32_t*)right_run, P, QB, n_ctx, n_sub, n, word,
               concat_end,
               Outs{(int32_t*)out_q, (long long*)out_s, (int32_t*)out_len,
                    (int32_t*)out_score, (int32_t*)out_flags}};
  approx_gate_kernel<<<(int)(((long long)n + kThreads - 1) / kThreads),
                       kThreads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
