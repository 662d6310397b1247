// K2 on Hopper: score-only banded gapped DP with group-lazy X-drop.
//
// Replaces the Pallas TPU kernel gblastn_tpu/ops/pallas_gapped.py:83
// (_kernel, launched by _call at :278, with its truncated scan
// _scan_steps at :393). Semantics are those of
// gblastn_tpu/ops/gapped_ref.py::banded_dp_score, for every job (one
// direction of one seed):
//   * an affine-gap DP restricted to W = 128 diagonals centred on the
//     seed's diagonal: band position p of row i holds column
//     j = i + p - 64, so the diagonal predecessor stays at p and the
//     vertical one sits at p + 1;
//   * the horizontal gap E as an inclusive prefix max over the band:
//     E(p) = max_{p' < p} (Ht(p') + p'e) - oe - pe, over cells above NEG/2;
//   * F kept sticky on pruned cells (the host aligner's quirk);
//   * cells below max(best through the previous 8-row group, 0) - X are
//     pruned, X = max(x, gap_open + gap_extend); at every group boundary
//     a job whose row is all dead stops (death latch);
//   * FLAG_EDGE (1) when a live cell, row 0 included, touched band
//     position 0 or 127; FLAG_ROWS (2) when still alive after `rows` rows
//     with M > rows;
//   * a job with M <= 0 or N <= 0 returns (0, 0); otherwise the score is
//     max(best, 0).
// A right job (job < n_right) reads subject[a0 + i - 1] down its rows and
// query[b0 + j - 1] along its columns; a left job reads subject[a0 - i] and
// query[b0 - j]. Scores are int32 with NEG = -2^24 and the score matrix
// unclipped (its sentinel row holds NEG), exactly as the oracle computes
// them; no packed form, so no sentinel can be clipped alive.
//
// Layout. One warp per job, lane l holding band positions 4l .. 4l+3 in
// registers: H, F and the best per position. The block's four warps take
// jobs in the order the caller computed (`order`: the longest row budget
// first, ops/gapped.py::job_order), so the few long jobs start in the
// first wave instead of setting the kernel's end from the last one, and
// each job writes its result at its own index, the caller's order. The
// launch reads no host value and checks no range: the job ranges were
// checked on the host when the job set was built (ops/gapped.py::
// check_jobs), so a CUDA graph can capture the launch.
//
// Operands off the row chain. Each job stages its subject codes and its
// query window by tiles of 32 rows into its own double buffer in shared
// memory with 16-byte cp.async copies, one tile ahead: tile k covers rows
// 32k+1 .. 32k+32, whose band reads query columns 32k-63 .. 32k+95 (159
// bytes) and 32 subject codes. Copy starts are aligned down to 16 bytes
// of address, so a tensor view at any offset works; since a tile steps 32
// bytes the offset carried is the same for every tile of a job. A left
// job's window is copied forwards and read backwards. Only chunks that
// hold a byte the job reads ([b0, b0 + N) or [b0 - N, b0), and the rows'
// subject range) are copied: such a chunk lies in the 16-byte granule of
// a byte of the tensor, so inside its allocation (CUDA allocations are
// 256-byte aligned). When a tile's bytes arrive the warp builds its query
// profile: every window byte's score against subject codes 0..3 (int32,
// the matrix unclipped), laid out so that a lane reads its four positions
// forwards in both directions, and for each row the offset of its profile
// row. A row's four scores are then four shared loads at one offset, made
// while the row before it runs; the chain from row i's H to row i+1's H
// holds no load.
//
// The chain per row and position, with Hopper's DPX fused ops:
//   Ht = incol ? __viaddmax_s32(H, score, Fv) : Fv     (max(H + s, Fv))
//   u  = Ht + p e                                      (not gated)
//   run: the lane's prefix max (__vimax3_s32), then the maximum over the
//        previous lanes' run (the window below)
//   hn = __viaddmax_s32(excl, -(oe + p e), Ht)         (max(E, Ht))
//   live = inrange && hn >= thr; H = live ? hn : NEG
//   F  = live ? __viaddmax_s32(hn, -oe, Fv - e) : Fv; best = max(best, H)
// Fv is F one position up: an in-register shift plus one __shfl_down_sync.
// A group of 8 rows whose columns all lie in [1, N] runs without the
// column masks.
//
// Why the ungated u and E are exact. thr = max(best, 0) - X > NEG/2, since
// the host check keeps x < 2^22 and gap_open + gap_extend < 2^22, and
// best >= 0 (row 0 holds 0 at j = 0). A source p' with Ht(p') <= NEG/2
// gives the term Ht(p') - oe - (p - p')e <= NEG/2 < thr, so whenever E or
// hn is at least thr its maximum comes from a live source, and the gated
// and ungated forms agree; below thr both prune to NEG and leave F and
// best alone.
//
// The truncated scan, per job (the port of _scan_steps). Let r = the
// matrix's largest entry, floored at 0. Every H of rows t+1 .. i-1 of a
// group that started after row t is at most best(t) + (i-1-t) r, since a
// row's maximum grows by at most r (diagonal) and F and E only subtract;
// so Ht of row i <= best(t) + 8 r <= best(t) + 9 r. An E term from a source
// d positions back is Ht(p') - oe - d e <= best(t) + 9 r - oe - d e, and
// the cell survives only if it is >= thr >= best(t) - X, which needs
// d e <= X + 9 r - oe. So with e > 0 no source at distance
// d >= g = (X + 9 r - oe) / e + 1 can make a live cell, and a window over
// distances 1 .. g (or more) is exact by the argument above. Position
// p = 4l + k takes its own lane's positions below it from the prefix max
// and needs lanes l-1 .. l-L, L = ceil(g / 4). For L <= 8 the window is
// 2, 4, 6 or 8 lanes (L rounded up), read by that many independent
// shuffles and reduced by a VIMNMX3 tree: one shuffle deep on the chain;
// larger L (or e <= 0) takes all lanes by a shift and five doubling
// steps. Each width is its own instantiation of the row loop, chosen once
// per job: a runtime step count compiled to a divergence-safe branch
// around every shuffle. At config 2 (X 33, open 5, extend 2, r 2) g = 23,
// L = 6; megablast's greedy scoring (X 54, extend 5) has L = 4; the X 400
// test jobs take all lanes. g and L come from the job's own x and the
// matrix staged in shared memory, in the kernel: no host reduction, no
// pow2 bucket.
//
// What bounds it now. The work is the cells the recurrence needs: those
// with column j in [0, N] of every row a job computes before its group
// dies or its rows run out; at 18 int32 operations a cell in the plain
// version's tally (the diagonal add; Ht; u: test, add, select; the prefix
// max; E: test, subtract, select; H; the X-drop test and select; the
// liveness test; F: four; best), loads and loop control not counted, over
// the card's int32 rate. The fused chain above issues about 12 of them a
// cell; the bound keeps the function's tally. The bytes are negligible.
// A job is a chain of dependent rows, so the longest jobs (up to N + 64
// rows, about 1,560 for a 1.5 kb read) set a floor of rows x one warp's
// row latency that no amount of parallel work removes: at config 2 the
// longest job alone takes about three quarters of the whole launch
// (PERF.md). Two or four jobs a warp (16 or 8 lanes a job) would take
// fewer shuffles a job but give each lane 8 or 16 positions, a longer
// serial row; a build of them gave results that depended on the warp's
// other job, so it was not kept.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 128;
constexpr int kHalf = kW / 2;
constexpr int kStep = 8;
constexpr int kNeg = -(1 << 24);
constexpr int kNegH = kNeg / 2;
constexpr int kFlagEdge = 1;
constexpr int kFlagRows = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kP = kW / 32;               // band positions per lane
static_assert(kP == 4, "four positions a lane");
constexpr int kWarps = 4;                 // warps (jobs) per block

constexpr int kTile = 32;                 // rows per staged tile
static_assert(kTile == 32 && kTile % kStep == 0, "a lane for each row");
constexpr int kQChunks = (kW + kTile - 1 + 15 + 15) / 16;   // 11
constexpr int kSChunks = (kTile + 15 + 15) / 16;            // 3
constexpr int kQBytes = kQChunks * 16;                      // 176
constexpr int kSBytes = kSChunks * 16;                      // 48

// one job's staging: the tile's bytes as copied; its query profile (the
// score of every window byte against subject codes 0..3, laid out so that
// band positions read it forwards in both directions); and for each row
// the offset of its profile row (buffer, subject code and the diagonal's
// shift), rows 0..7 of buffer 0 repeated at 64..71 for the prefetch that
// runs off the end of buffer 1
struct __align__(16) JobSmem {
  int prof[2][4][kQBytes];
  int row_off[2 * kTile + kStep];
  uint8_t q[2][kQBytes];
  uint8_t s[2][kSBytes];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kWarps * 32)
gapped_band_kernel(const uint8_t* __restrict__ query,
                   const int8_t* __restrict__ subject,
                   const int32_t* __restrict__ matrix,    // [16 * 4]
                   const long long* __restrict__ a0_arr,
                   const long long* __restrict__ b0_arr,
                   const int32_t* __restrict__ m_arr,
                   const int32_t* __restrict__ n_arr,
                   const int32_t* __restrict__ x_arr,
                   const int32_t* __restrict__ order, int n_jobs,
                   int n_right, int rows, int gap_open, int gap_extend,
                   int32_t* __restrict__ out_score,
                   int32_t* __restrict__ out_flags) {
  __shared__ __align__(16) int smat_all[kWarps][64];
  __shared__ JobSmem stage_all[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + warp;
  if (slot >= n_jobs) return;                // the whole warp leaves
  int* smat = smat_all[warp];
  JobSmem& st = stage_all[warp];
  const int mv0 = matrix[lane];
  const int mv1 = matrix[lane + 32];
  smat[lane] = mv0;
  smat[lane + 32] = mv1;
  const int rmax = max(__reduce_max_sync(kFull, max(mv0, mv1)), 0);
  __syncwarp();

  const int job = order[slot];
  const int M = m_arr[job];
  const int N = n_arr[job];
  if (M <= 0 || N <= 0) {
    if (lane == 0) {
      out_score[job] = 0;
      out_flags[job] = 0;
    }
    return;
  }
  const bool right = job < n_right;
  const long long A0 = a0_arr[job];
  const long long B0 = b0_arr[job];
  const int e = gap_extend;
  const int oe = gap_open + gap_extend;
  const int X = max(x_arr[job], oe);
  const int R = min(M, rows);

  // the scan's reach g in band positions, then the lanes before its own
  // that a lane must see, L = ceil(g / kP) (see the note); 0: the whole job
  int lanes_back = 0;
  if (e > 0) {
    const long long g = ((long long)X + 9LL * rmax - oe) / e + 1;
    const long long L = (g + kP - 1) / kP;
    lanes_back = L <= 8 ? (int)L : 0;
  }

  // staging: tile k into buffer k & 1. The windows' starts are aligned
  // down to 16 bytes of address (the tensors may be views at any offset);
  // chunk c of the query window starts at qal(k) + 16c, of the subject
  // window at sal(k) + 16c. Only chunks that hold a byte the job reads are
  // copied.
  const uintptr_t q_lo = (uintptr_t)(query + (right ? B0 : B0 - N));
  const uintptr_t q_hi = (uintptr_t)(query + (right ? B0 + N : B0));
  const uintptr_t s_lo = (uintptr_t)(subject + (right ? A0 : A0 - R));
  const uintptr_t s_hi = (uintptr_t)(subject + (right ? A0 + R : A0));
  auto issue_tile = [&](int k) {
    const long long qs = right ? B0 + (long long)k * kTile - kHalf
                               : B0 - (long long)(k + 1) * kTile - (kHalf - 1);
    const long long ss = right ? A0 + (long long)k * kTile
                               : A0 - (long long)(k + 1) * kTile;
    const uintptr_t qal = (uintptr_t)(query + qs) & ~(uintptr_t)15;
    const uintptr_t sal = (uintptr_t)(subject + ss) & ~(uintptr_t)15;
    if (lane < kQChunks) {
      const uintptr_t a = qal + 16 * lane;
      if (a < q_hi && a + 16 > q_lo)
        cp_async16(&st.q[k & 1][16 * lane], (const void*)a);
    } else if (lane < kQChunks + kSChunks) {
      const int cs = lane - kQChunks;
      const uintptr_t a = sal + 16 * cs;
      if (a < s_hi && a + 16 > s_lo)
        cp_async16(&st.s[k & 1][16 * cs], (const void*)a);
    }
    cp_async_commit();
  };
  // the windows' offsets within their 16-byte granules, the same for every
  // tile (tiles step by 32 bytes)
  const int off_s = (int)((uintptr_t)(subject + A0) & 15);
  const int off_q =
      (int)((uintptr_t)(query + (right ? B0 - kHalf : B0 - (kHalf - 1))) &
            15);
  // the profile of tile k from its staged bytes. Entry t of a right job's
  // profile is window byte t, of a left job's byte kQBytes - 1 - t; band
  // position p of tile row r then reads entry r + off_q + p (right) or
  // (kQBytes - kW) - (kTile - 1 - r) - off_q + p (left), in the profile row
  // of the row's subject code
  auto build_profile = [&](int k) {
    const int b = k & 1;
    for (int t = lane; t < kQBytes; t += 32) {
      const int code = st.q[b][right ? t : kQBytes - 1 - t] & 15;
      const int4 v = *reinterpret_cast<const int4*>(smat + code * 4);
      st.prof[b][0][t] = v.x;
      st.prof[b][1][t] = v.y;
      st.prof[b][2][t] = v.z;
      st.prof[b][3][t] = v.w;
    }
    const int rr = right ? lane : kTile - 1 - lane;   // kTile == 32 rows
    const int a_code = st.s[b][rr + off_s] & 3;
    const int off = (b * 4 + a_code) * kQBytes +
                    (right ? rr + off_q : (kQBytes - kW) - rr - off_q);
    st.row_off[b * kTile + lane] = off;
    if (b == 0 && lane < kStep) st.row_off[2 * kTile + lane] = off;
  };
  const int p0 = kP * lane;                    // first band position held
  const int* prof_lane = &st.prof[0][0][0] + p0;
  // match scores of row `row` (>= 1) for this lane's positions; `row` - 1
  // taken modulo 64 indexes row_off (a group's rows and the one after it
  // are consecutive entries)
  auto load_scores = [&](int row_idx, int (&sc)[kP]) {
    const int* pr = prof_lane + st.row_off[row_idx];
#pragma unroll
    for (int k = 0; k < kP; ++k) sc[k] = pr[k];
  };

  issue_tile(0);
  issue_tile(1);

  // row 0: H(0, j) = -open - j*e for j in [0, N], position p -> j = p - 64
  int H[kP], F[kP], best[kP], pe[kP], noepe[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int j = p0 + k - kHalf;
    int h = kNeg;
    if (j >= 0 && j <= N) h = j == 0 ? 0 : -gap_open - j * e;
    if (j > 0 && -gap_open - j * e < -X) h = kNeg;
    H[k] = h;
    F[k] = h > kNegH ? h - oe : kNeg;
    best[k] = h;
    pe[k] = (p0 + k) * e;
    noepe[k] = -(oe + pe[k]);
  }

  for (int t = lane; t < 2 * kTile + kStep; t += 32) st.row_off[t] = 0;
  cp_async_wait_one_pending();
  __syncwarp();
  build_profile(0);
  __syncwarp();
  int scA[kP], scB[kP];
  load_scores(0, scA);
  bool dead = false;

  // the rows of the job, with the window over the previous lanes fixed at
  // kWin lanes (2, 4, 6 or 8; 0: all of them)
  auto run_rows = [&](auto win) {
    constexpr int kWin = decltype(win)::value;
    // the parallel window reads lanes l-1 .. l-kWin, one shuffle each;
    // lanes below kWin read lane 0 instead, a source they may see (lane 0
    // masks its own)
    int src[kWin > 0 ? kWin : 1];
#pragma unroll
    for (int d = 1; d <= kWin; ++d) src[d - 1] = max(lane - d, 0);

    // one row: `interior` when every position's column lies in [1, N];
    // `idx` is the next row's row_off entry; the row's scores are in cur,
    // the next row's go to nxt
    auto row = [&](int ii, int idx, int thr, auto interior, int (&cur)[kP],
                   int (&nxt)[kP]) {
      load_scores(idx, nxt);
      // vertical predecessor (i-1, j) sat one band position up
      int fnext = __shfl_down_sync(kFull, F[0], 1);
      if (lane == 31) fnext = kNeg;
      int Fv[kP], Ht[kP], uu[kP], run[kP];
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        Fv[k] = k + 1 < kP ? F[k + 1] : fnext;
        if constexpr (decltype(interior)::value) {
          Ht[k] = __viaddmax_s32(H[k], cur[k], Fv[k]);
        } else {
          const int j = ii + p0 + k - kHalf;
          Ht[k] = (j >= 1 && j <= N) ? __viaddmax_s32(H[k], cur[k], Fv[k])
                                     : Fv[k];
        }
        uu[k] = Ht[k] + pe[k];
        // the lane's prefix max, two positions a step
        run[k] = k == 0       ? uu[0]
                 : k % 2 == 1 ? max(run[k - 1], uu[k])
                              : __vimax3_s32(run[k - 2], uu[k - 1], uu[k]);
      }
      // the previous lanes' maxima over the window the reach needs
      int w;
      if constexpr (kWin > 0) {
        int v[kWin];
#pragma unroll
        for (int d = 0; d < kWin; ++d)
          v[d] = __shfl_sync(kFull, run[kP - 1], src[d]);
        w = v[0];
#pragma unroll
        for (int d = 1; d < kWin; d += 2)
          w = d + 1 < kWin ? __vimax3_s32(w, v[d], v[d + 1]) : max(w, v[d]);
        if (lane == 0) w = kNeg;
      } else {
        // all of them: lane l-1's, then windows of 2, 4, ... lanes (the
        // lowest lanes read their own value back, which changes nothing)
        w = __shfl_up_sync(kFull, run[kP - 1], 1);
        if (lane == 0) w = kNeg;
#pragma unroll
        for (int sh = 1; sh < 32; sh <<= 1)
          w = max(w, __shfl_up_sync(kFull, w, sh));
      }
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const int excl = k == 0 ? w : max(w, run[k - 1]);
        const int hn = __viaddmax_s32(excl, noepe[k], Ht[k]);
        bool live = hn >= thr;
        if constexpr (!decltype(interior)::value) {
          const int j = ii + p0 + k - kHalf;
          live = live && j >= 0 && j <= N;
        }
        const int Hn = live ? hn : kNeg;
        F[k] = live ? __viaddmax_s32(hn, -oe, Fv[k] - e) : Fv[k];
        H[k] = Hn;
        best[k] = max(best[k], Hn);
      }
    };

    for (int i = 0; i < R; i += kStep) {
      // group-lazy threshold: best through the previous group
      const int bl = __vimax3_s32(best[0], best[1], max(best[2], best[3]));
      const int thr = max(__reduce_max_sync(kFull, bl), 0) - X;
      // the last group of a tile prefetches the next tile's first row:
      // its bytes must have arrived and its profile be built
      if ((i + kStep) % kTile == 0 && i + kStep < R) {
        cp_async_wait_all();
        __syncwarp();
        build_profile((i + kStep) / kTile);
        __syncwarp();
      }
      const int idx0 = (i & (2 * kTile - 1)) + 1;
      if (i >= kHalf && i + kStep + kHalf - 1 <= N && i + kStep <= R) {
        // every row of the group inside the band's columns [1, N]
#pragma unroll
        for (int u = 0; u < kStep; u += 2) {
          row(i + u + 1, idx0 + u, thr, std::true_type(), scA, scB);
          row(i + u + 2, idx0 + u + 1, thr, std::true_type(), scB, scA);
        }
      } else {
#pragma unroll
        for (int u = 0; u < kStep; u += 2) {
          if (i + u + 1 > R) break;
          row(i + u + 1, idx0 + u, thr, std::false_type(), scA, scB);
          if (i + u + 2 > R) break;
          row(i + u + 2, idx0 + u + 1, thr, std::false_type(), scB, scA);
        }
      }
      // group boundary: death latch
      bool any_live = false;
#pragma unroll
      for (int k = 0; k < kP; ++k) any_live |= H[k] > kNegH;
      if (!__any_sync(kFull, any_live)) {
        dead = true;
        break;
      }
      // a tile done: its byte buffer takes the tile after the next
      if ((i + kStep) % kTile == 0) {
        __syncwarp();
        if (i + kStep + kTile < R) {
          issue_tile((i + kStep) / kTile + 1);
        }
      }
    }
  };
  // one instantiation for each window a job can take (a wider window than
  // the reach is exact too): 2, 4, 6 or 8 lanes, or all of them
  if (lanes_back == 0) {
    run_rows(std::integral_constant<int, 0>());
  } else if (lanes_back <= 2) {
    run_rows(std::integral_constant<int, 2>());
  } else if (lanes_back <= 4) {
    run_rows(std::integral_constant<int, 4>());
  } else if (lanes_back <= 6) {
    run_rows(std::integral_constant<int, 6>());
  } else {
    run_rows(std::integral_constant<int, 8>());
  }
  cp_async_wait_all();

  const int bl = __vimax3_s32(best[0], best[1], max(best[2], best[3]));
  const int score = __reduce_max_sync(kFull, bl);
  // FLAG_EDGE: band position 0 is lane 0's first, 127 lane 31's last
  const int edge_lo = __shfl_sync(kFull, best[0], 0) > kNegH;
  const int edge_hi = __shfl_sync(kFull, best[kP - 1], 31) > kNegH;
  if (lane == 0) {
    out_score[job] = max(score, 0);
    out_flags[job] = ((edge_lo || edge_hi) ? kFlagEdge : 0) +
                     ((!dead && M > rows) ? kFlagRows : 0);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int gblastn_gapped_band(
    const void* query, const void* subject, const void* matrix,
    const void* a0, const void* b0, const void* m, const void* n,
    const void* x, const void* order, int n_jobs, int n_right, int rows,
    int gap_open, int gap_extend, void* out_score, void* out_flags,
    void* stream) {
  if (n_jobs <= 0) return 0;
  const int blocks = (n_jobs + kWarps - 1) / kWarps;
  gapped_band_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)query, (const int8_t*)subject, (const int32_t*)matrix,
      (const long long*)a0, (const long long*)b0, (const int32_t*)m,
      (const int32_t*)n, (const int32_t*)x, (const int32_t*)order, n_jobs,
      n_right, rows, gap_open, gap_extend, (int32_t*)out_score,
      (int32_t*)out_flags);
  return (int)cudaGetLastError();
}
