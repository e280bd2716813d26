// Batched, swap-free, greedy GF(2) Gauss-Jordan elimination over bit-packed
// columns, two shots through one team of warps.
//
// Replaces: qldpc_tpu/ops/osd_pallas.py::_elim_kernel_v3 (the pallas_call
// in eliminate_blocks under QLDPC_OSD_KERNEL=3), which interleaves two
// independent shot blocks through v1's column scan so that one block's
// stalls overlap the other's. Per shot it computes exactly K2's function
// (csrc/gf2_elim.cu), exit after every column included: for each column
// c < K in order, the pivot is the lowest unused row r < m with bit c set,
// every other row with bit c set is XORed with the pivot row and the
// residual syndrome follows; a shot stops when `rank` pivots are reached or
// (exit_on_valid) when every unused row's residual is zero. Each shot exits
// on its own, so every output equals K2's.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 rows,
// stage-1 8 words, prefix 40 words, full width 70 words): as K2, the matrix
// is read and written once, and the cost is each shot's chain of dependent
// column steps (a column read, a ballot, shuffles, the pivot row's reads
// and ballots, the XORs, a team barrier), whose latency K2 leaves exposed.
//
// Design: K2's column-bitset layout and team of warps (gf2_elim_common.cuh),
// with one team carrying two adjacent shots of the batch. The OSD sorts its
// batch by BP residual weight, so neighbours tend to stop at similar depths.
// Every warp keeps both shots' row state in registers (the rows < m are
// shared). Both shots are at the same column while both run, so the loop
// runs a double step: both columns' loads, both pivot searches and both
// pivots' row updates issued branch-free (every ballot and shuffle for both
// shots, so that the two chains interleave), both pivot rows' reads over
// each of the warp's column groups issued together, and one XOR pass whose
// batches of four columns draw from either shot; then one named barrier for
// the pair, after which each pivot column's owner writes it as its pivot's
// unit column. Once one shot stops, the other goes on alone through K2's
// own column step (column_step), its row state swapped into slot 0, so a
// stopped shot costs nothing. The last team of an odd batch carries one
// shot. The pair's columns sit in shared memory where a team's two fit
// (stage 1 at [[144]]), and otherwise in device memory: the column input
// itself (G1's column layout, one slot a shot), eliminated in place;
// gf2_elim_pair_sizes reports which. Input and output are K2's
// (gf2_elim_common.cuh).
#include "gf2_elim_common.cuh"

namespace {

// XOR e0 into the columns of shot 0 (H0) whose bit is set in m0, and e1
// into those of shot 1 (H1) in m1, over one 32-column group (word offset
// grp): four columns a batch from either shot, their loads issued together.
template <int R>
__device__ __forceinline__ void xor_columns_pair(
    unsigned* H0, unsigned* H1, int grp, unsigned m0, unsigned m1,
    const unsigned (&e0)[R], const unsigned (&e1)[R], int lane, int NR,
    int S) {
  while (m0 | m1) {
    unsigned* cp[4];  // each picked column, nullptr for none
    bool second[4];   // picked from shot 1
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      second[u] = m0 == 0u;
      const unsigned mk = second[u] ? m1 : m0;
      cp[u] = mk ? (second[u] ? H1 : H0) + grp + (__ffs(mk) - 1) * S
                 : nullptr;
      if (second[u])
        m1 &= m1 - 1u;
      else
        m0 &= m0 - 1u;
    }
    unsigned x[4][R];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int q = 32 * k + lane;
        x[u][k] = (cp[u] && (k < R - 1 || q < NR)) ? cp[u][q] : 0u;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int q = 32 * k + lane;
        if (cp[u] && (k < R - 1 || q < NR))
          cp[u][q] = x[u][k] ^ (second[u] ? e1[k] : e0[k]);
      }
  }
}

// Exchange two shots' row state (registers: no indexing by shot).
template <int R>
__device__ __forceinline__ void swap_rows(unsigned (&a)[R], unsigned (&b)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const unsigned x = a[k];
    a[k] = b[k];
    b[k] = x;
  }
}

template <int R, bool kDev>
__global__ void __launch_bounds__(max_block_threads(R, true), 1)
gf2_elim_pair_kernel(int* __restrict__ hp,           // (B, 32W, S) cols
                     int* __restrict__ hp_out,       // (B, W, M) or null
                     const int* __restrict__ s_in,   // (B, M)
                     int* __restrict__ s_out,        // (B, M)
                     int* __restrict__ colofrow,     // (B, M)
                     int* __restrict__ steps,        // (B): column steps
                     const int* __restrict__ live,   // [lo, hi) or null
                     int B, int W, int M, int m, int K, int rank,
                     int full_jordan, int exit_on_valid, int spb, int T,
                     int S) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int team = (threadIdx.x >> 5) / T;
  const int t = (threadIdx.x >> 5) - team * T;  // warp in the team
  const int pair = blockIdx.x * spb + team;
  if (2 * pair >= B) return;  // the whole team; no block barrier follows
  // the pair's shots 2 pair, 2 pair + 1 (if < B), each gated on its own:
  // the team runs those in the live range [lo, hi) from b0 on, one or two,
  // and a gated-off shot leaves before its first load
  int lo, hi;
  live_range(live, B, lo, hi);
  const int pair_end = min(2 * pair + 2, B);
  for (int b = 2 * pair; b < pair_end; ++b)
    if (b < lo || b >= hi)
      skip_shot(colofrow + (size_t)b * M, steps + b, M, t, lane);
  const int b0 = max(2 * pair, lo);
  const int nshot = min(pair_end, hi) - b0;
  if (nshot <= 0) return;
  const int NR = (M + 31) >> 5;
  const int shot_words = 32 * W * S;
  // device memory: the column input's slots of shots b0 and b0 + 1 (the
  // second read only where nshot is 2)
  unsigned* H[2];
  H[0] = kDev ? (unsigned*)hp + (size_t)b0 * shot_words
              : smem + (size_t)team * 2 * shot_words;
  H[1] = H[0] + shot_words;

  unsigned used[2][R], sres[2][R], valid[R];
  valid_rows(valid, m, lane);
  bool done[2];
  int nstep[2] = {0, 0};  // column steps each shot ran
  int npiv[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h < nshot) {
      const size_t b = b0 + h;
      if (!kDev)  // else H[h] is the shot's column input
        load_columns(H[h], hp, b, W, S, t, T, lane);
      load_rows(s_in + b * M, M, NR, used[h], sres[h], lane);
      if (t == 0)
        for (int r = lane; r < M; r += 32) colofrow[b * M + r] = -1;
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) used[h][k] = sres[h][k] = 0u;
    }
  }
  team_sync(team, T);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    done[h] = h >= nshot ||
              (exit_on_valid && !pending(sres[h], used[h], valid));

  int col = 0;
  int gc_mod = 0;   // (col / 32) mod T: warp gc_mod owns column col
  int g_first = t;  // this warp's first group at or after the pivot's word
  // double steps while both shots run
  for (; col < K && !done[0] && !done[1]; ++col) {
    const int gc = col >> 5;
    if (col > 0 && (col & 31) == 0) {  // a new group: no division by T
      if (++gc_mod == T) gc_mod = 0;
      if (!full_jordan && g_first < gc) g_first += T;
    }
    // both columns' words, then both pivot searches, branch-free: every
    // load, ballot and shuffle is issued for both shots, so that the two
    // chains interleave
    unsigned cw[2][R];
#pragma unroll
    for (int h = 0; h < 2; ++h) read_column(H[h] + col * S, cw[h], lane, NR);
    int pq[2] = {-1, -1};         // the pivot's row word, -1 for none
    unsigned pbit[2] = {0u, 0u};  // its bit in that word
#pragma unroll
    for (int k = 0; k < R; ++k) {
      unsigned cand[2], bal[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cand[h] = cw[h][k] & ~used[h][k] & valid[k];
        bal[h] = __ballot_sync(kFull, cand[h] != 0u);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int L = __ffs(bal[h]) - 1;
        const unsigned c = __shfl_sync(kFull, cand[h], L & 31);
        if (pq[h] < 0 && bal[h]) {
          pq[h] = 32 * k + L;
          pbit[h] = c & (0u - c);
        }
      }
    }
    // both pivots' steps on the row state, predicated (pbit 0 for none)
    int pr[2], pqc[2];  // the pivot's bit; its row word, 0 for none
    unsigned ps[2];     // the pivot row's residual bit
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ++nstep[h];
      pr[h] = (__ffs(pbit[h]) - 1) & 31;
      pqc[h] = pq[h] < 0 ? 0 : pq[h];
      const bool owner = lane == (pqc[h] & 31);
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (owner && k == (pqc[h] >> 5)) cw[h][k] &= ~pbit[h];  // its elim
      ps[h] = (row_word(sres[h], pqc[h]) >> pr[h]) & (pq[h] >= 0);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool owner = lane == (pqc[h] & 31);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (ps[h]) sres[h][k] ^= cw[h][k];
        if (owner && k == (pqc[h] >> 5)) used[h][k] |= pbit[h];
      }
      if (t == 0 && owner && pq[h] >= 0)
        colofrow[(size_t)(b0 + h) * M + 32 * pq[h] + pr[h]] = col;
      npiv[h] += pq[h] >= 0;
    }
    // both pivot rows' bits over this warp's groups from the pivot's word
    // on, two groups a batch (four reads issued together); column col is
    // left to the unit writes after the barrier, as in K2
    if (pq[0] >= 0 || pq[1] >= 0) {
      for (int g = g_first; g < W; g += 2 * T) {
        int base[2];
        unsigned masks[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int gg = g + u * T;
          base[u] = 32 * (gg < W ? gg : g) * S;  // in range: no branch
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned bit =
                (H[h][base[u] + lane * S + pqc[h]] >> pr[h]) & 1u;
            masks[h][u] = __ballot_sync(kFull, pq[h] >= 0 && gg < W && bit);
            if (gg == gc) masks[h][u] &= ~(1u << (col & 31));
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          xor_columns_pair<R>(H[0], H[1], base[u], masks[0][u], masks[1][u],
                              cw[0], cw[1], lane, NR, S);
      }
    }
    // each shot's exit, from registers alone, before the barrier
    bool pend[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) pend[h] = pending(sres[h], used[h], valid);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      done[h] = npiv[h] >= rank || (exit_on_valid && !pend[h]);
    team_sync(team, T);
    if (gc_mod == t) {  // after the barrier: no warp reads column col again
#pragma unroll
      for (int h = 0; h < 2; ++h)
        write_unit<R>(H[h] + col * S, pq[h], pbit[h], lane, NR);
      __syncwarp();
    }
  }
  // the shot still running, if any, goes on alone through K2's column
  // step, its row state moved to slot 0
  const bool moved = done[0];  // shot 1 goes on alone
  if (moved) {
    swap_rows(used[0], used[1]);
    swap_rows(sres[0], sres[1]);
  }
  {
    unsigned* H0 = moved ? H[1] : H[0];
    int* cf = colofrow + (size_t)(b0 + moved) * M;
    int np = moved ? npiv[1] : npiv[0];
    int ns = moved ? nstep[1] : nstep[0];
    bool d = done[0] && done[1];
    for (; col < K && !d; ++col) {
      if (col > 0 && (col & 31) == 0) {
        if (++gc_mod == T) gc_mod = 0;
        if (!full_jordan && g_first < (col >> 5)) g_first += T;
      }
      ++ns;
      d = column_step(H0, col, g_first, gc_mod, W, NR, S, used[0], sres[0],
                      valid, np, cf, rank, exit_on_valid, team, t, T, lane);
    }
    if (moved)
      nstep[1] = ns;
    else
      nstep[0] = ns;
  }
  if (moved) swap_rows(sres[0], sres[1]);  // the residuals go out by shot
  team_sync(team, T);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h < nshot) {
      const size_t b = b0 + h;
      if (hp_out)
        store_columns(H[h], (unsigned*)hp_out + b * W * M, W, M, NR, S, t,
                      T, lane);
      if (t == 0) {
        store_rows(sres[h], s_out + b * M, M, NR, lane);
        if (lane == 0) steps[b] = nstep[h];
      }
    }
  }
}

GF2_PICK(gf2_elim_pair_kernel)

Plan plan(int B, int W, int M, int smem_limit, int sms,
          int block_shots = 0) {
  return make_plan(B, W, M, smem_limit, sms, 2, true, block_shots);
}

}  // namespace

// One team's (two shots') column bytes, the column stride in words, the
// row words a lane holds, and 1 when the columns stay in device memory, for
// W words by M rows: out[0..3].
extern "C" int gf2_elim_pair_sizes(int W, int M, int smem_limit,
                                   long long* out) {
  return plan_sizes(plan(2, W, M, smem_limit, 1), out);
}

// The launch of B shots of W words by M rows: registers and local (spill)
// bytes a thread, shots a block, dynamic shared memory a block, 1 on the
// device-memory branch, blocks, blocks resident per SM, and warps a team
// of two shots: out[0..7]. `smem_limit` and `block_shots` as for
// gf2_elim_info (K5 rounds an odd block_shots up to a team of two).
extern "C" int gf2_elim_pair_info(int B, int W, int M, int smem_limit,
                                  int block_shots, int* out) {
  const Plan p = plan(B, W, M, smem_limit, sm_count(), block_shots);
  return plan_info(p, pick(p.R, p.dev), 2, out);
}

// `hp`: B shots of G1's column layout (plan_launch); `live`: a device int32
// pair [lo, hi), the shots to run (null: all B); hp_out null: no reduced
// matrix; `smem_limit` and `block_shots` as for gf2_elim_info.
extern "C" int gf2_elim_pair_launch(int* hp, int* hp_out, const int* s_in,
                                    int* s_out, int* colofrow, int* steps,
                                    const int* live, int B, int W, int M,
                                    int m, int K, int rank, int full_jordan,
                                    int exit_on_valid, int smem_limit,
                                    int block_shots, void* stream) {
  const Plan p = plan(B, W, M, smem_limit, sm_count(), block_shots);
  return plan_launch(p, pick(p.R, p.dev), hp, hp_out, s_in, s_out, colofrow,
                     steps, live, B, W, M, m, K, rank, full_jordan,
                     exit_on_valid, stream);
}
