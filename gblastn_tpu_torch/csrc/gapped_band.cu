// K2 on Hopper: score-only banded gapped DP with group-lazy X-drop, one
// warp per job.
//
// Replaces the Pallas TPU kernel gblastn_tpu/ops/pallas_gapped.py:83
// (_kernel, launched by _call at :278). Semantics are those of
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
// query[b0 - j]. Both read the resident subject codes and the batch's
// BLASTNA query bytes in place: no guard-padded, reversed or windowed
// copies, no job buckets. Scores are int32 with NEG = -2^24 and the score
// matrix unclipped, exactly as the oracle computes them: the most negative
// value formed is NEG plus the sentinel score (-2^30), inside int32.
//
// Layout: one warp per job, lane l holding band positions 4l .. 4l+3 in
// registers (H, F and the best per position). Per row the vertical
// predecessor F(p+1) is an in-register shift plus one __shfl_down_sync, the
// band prefix max is a serial max over the lane's four positions followed
// by a 5-step __shfl_up_sync scan, and every 8 rows a warp max gives the
// threshold and __any_sync the death test. A warp only ever waits on its
// own lanes, so there is no __syncthreads: the 16 x 4 score matrix is copied
// into the warp's own slice of shared memory behind a __syncwarp. A warp
// (not a 128-thread block) per job keeps the row's cross-position steps in
// shuffles and lets each job exit on its own; four warps share a block.
//
// What bounds it on this card: the rows are a chain of dependent steps
// (each needs the previous row's H and F), so one job is latency bound and
// the card is filled by many jobs in flight. The work is the cells the
// recurrence needs: those with column j in [0, N] of every row a job
// computes before its group dies or its rows run out (the kernel also
// computes the band positions outside [0, N], but they are not work the
// function needs). Each such cell needs 18 int32 operations: the diagonal
// add (1); Ht = max(diag, F from above) (1); u = Ht > NEG/2 ? Ht + p*e :
// NEG (3: test, add, select); the prefix max (1); E = excl > NEG/2 ?
// excl - oe - p*e : NEG (3, with oe + p*e a constant per position); H =
// max(Ht, E) (1); the X-drop threshold (2: test, select); the liveness
// test (1); F = live ? max(F - e, H - oe) : F (4); best = max(best, H)
// (1). Loads, addressing and the per-row and per-group steps are not
// counted. The bytes are negligible (two codes per cell, read from L1/L2,
// and 28 bytes in, 8 out per job), so the bound is cells x 18 over the
// card's int32 rate. Making it fast is later work: several jobs per warp,
// query and subject tiles staged through shared memory, and the JAX
// package's truncated scan depth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 128;
constexpr int kHalf = kW / 2;
constexpr int kStep = 8;
constexpr int kNeg = -(1 << 24);
constexpr int kNegH = kNeg / 2;
constexpr int kFlagEdge = 1;
constexpr int kFlagRows = 2;
constexpr int kWarps = 4;                 // jobs (warps) per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
gapped_band_kernel(const uint8_t* __restrict__ query,
                   const int8_t* __restrict__ subject,
                   const int32_t* __restrict__ matrix,    // [16 * 4]
                   const long long* __restrict__ a0,
                   const long long* __restrict__ b0,
                   const int32_t* __restrict__ m_arr,
                   const int32_t* __restrict__ n_arr,
                   const int32_t* __restrict__ x_arr, int n_jobs,
                   int n_right, int rows, int gap_open, int gap_extend,
                   int32_t* __restrict__ out_score,
                   int32_t* __restrict__ out_flags) {
  __shared__ int smat_all[kWarps][64];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarps + warp;
  if (job >= n_jobs) return;                 // the whole warp leaves
  int* smat = smat_all[warp];
  smat[lane] = matrix[lane];
  smat[lane + 32] = matrix[lane + 32];
  __syncwarp();

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
  const long long A0 = a0[job];
  const long long B0 = b0[job];
  const int e = gap_extend;
  const int oe = gap_open + gap_extend;
  const int X = max(x_arr[job], oe);
  const int p0 = 4 * lane;                   // first band position held

  // row 0: H(0, j) = -open - j*e for j in [0, N], position p -> j = p - 64
  int H[4], F[4], best[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = p0 + k - kHalf;
    int h = kNeg;
    if (j >= 0 && j <= N) h = j == 0 ? 0 : -gap_open - j * e;
    if (j > 0 && -gap_open - j * e < -X) h = kNeg;
    H[k] = h;
    F[k] = h > kNegH ? h - oe : kNeg;
    best[k] = h;
  }

  const int R = min(M, rows);
  bool dead = false;
  int i = 0;
  while (i < R) {
    // group-lazy threshold: best through the previous group
    const int bm = __reduce_max_sync(
        kFull, max(max(best[0], best[1]), max(best[2], best[3])));
    const int thr = max(bm, 0) - X;
    const int gend = min(i + kStep, R);
    while (i < gend) {
      ++i;
      const int a_code =
          __ldg(subject + (right ? A0 + i - 1 : A0 - i));
      // vertical predecessor (i-1, j) sat one band position up
      int fnext = __shfl_down_sync(kFull, F[0], 1);
      if (lane == 31) fnext = kNeg;
      const int Fv[4] = {F[1], F[2], F[3], fnext};
      int Ht[4], run[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = i + p0 + k - kHalf;
        int diag = kNeg;
        if (j >= 1 && j <= N) {
          const int b = __ldg(query + (right ? B0 + j - 1 : B0 - j));
          diag = H[k] + smat[b * 4 + a_code];
        }
        Ht[k] = max(diag, Fv[k]);
        const int u = Ht[k] > kNegH ? Ht[k] + (p0 + k) * e : kNeg;
        run[k] = k == 0 ? u : max(run[k - 1], u);
      }
      // inclusive scan of the lanes' maxima, then the previous lane's
      int carry = run[3];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, carry, d);
        if (lane >= d) carry = max(carry, v);
      }
      carry = __shfl_up_sync(kFull, carry, 1);
      if (lane == 0) carry = kNeg;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + k;
        const int j = i + p - kHalf;
        const int excl = k == 0 ? carry : max(carry, run[k - 1]);
        const int E = excl > kNegH ? excl - oe - p * e : kNeg;
        int hn = max(Ht[k], E);
        if (j < 0 || j > N) hn = kNeg;
        if (hn < thr) hn = kNeg;
        F[k] = hn > kNegH ? max(Fv[k] - e, hn - oe) : Fv[k];
        H[k] = hn;
        best[k] = max(best[k], hn);
      }
    }
    // group boundary: death latch
    const bool any_live = H[0] > kNegH || H[1] > kNegH || H[2] > kNegH ||
                          H[3] > kNegH;
    if (!__any_sync(kFull, any_live)) {
      dead = true;
      break;
    }
  }

  const int score = __reduce_max_sync(
      kFull, max(max(best[0], best[1]), max(best[2], best[3])));
  // FLAG_EDGE: band position 0 is lane 0's first, 127 lane 31's last
  const int edge_lo = __shfl_sync(kFull, best[0], 0) > kNegH;
  const int edge_hi = __shfl_sync(kFull, best[3], 31) > kNegH;
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
    const void* x, int n_jobs, int n_right, int rows, int gap_open,
    int gap_extend, void* out_score, void* out_flags, void* stream) {
  if (n_jobs <= 0) return 0;
  const int blocks = (n_jobs + kWarps - 1) / kWarps;
  gapped_band_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)query, (const int8_t*)subject, (const int32_t*)matrix,
      (const long long*)a0, (const long long*)b0, (const int32_t*)m,
      (const int32_t*)n, (const int32_t*)x, n_jobs, n_right, rows, gap_open,
      gap_extend, (int32_t*)out_score, (int32_t*)out_flags);
  return (int)cudaGetLastError();
}
