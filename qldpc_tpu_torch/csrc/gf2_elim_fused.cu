// Batched, swap-free, greedy GF(2) Gauss-Jordan elimination over bit-packed
// columns, four pivots per team barrier.
//
// Replaces: qldpc_tpu/ops/osd_pallas.py::_elim_kernel_v2 (the pallas_call
// in eliminate_blocks under QLDPC_OSD_KERNEL=2). Per shot it computes K2's
// column steps (csrc/gf2_elim.cu): for each column c < K in order, the
// pivot is the lowest unused row r < m with bit c set, every other row with
// bit c set is XORed with the pivot row and the residual syndrome follows.
// The columns are taken in groups of 4, and the exit (rank reached, or
// every unused row's residual zero) is tested once per group, so a shot may
// run up to 3 columns past K2's exit: s_red, the OSD-0 bits and validity
// are unchanged (later pivots carry a zero syndrome bit), while
// prow_of_col, used and steps follow this kernel's own exit. Columns of the
// last group at or beyond K never pivot.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 rows,
// stage-1 8 words, prefix 40 words, full width 70 words): as K2, the matrix
// is read and written once, and the cost is each shot's chain of dependent
// column steps; K2 pays one team barrier and one read-modify-write of every
// touched tail column per column.
//
// Design: K2's column-bitset layout, input and output, and team of warps
// per shot (gf2_elim_common.cuh). A group's four columns lie in one
// 32-column group, owned by one warp. A group:
//  1. every warp of the team reads the four columns into registers;
//  2. the four pivots are chosen one after another from registers (ballot
//     and shuffles, as K2 chooses one); pivot i's elim_i (its column
//     without the pivot row) is XORed into each group column not yet
//     pivoted whose pivot-row bit is set, and the row state follows. The
//     bit p_i of each earlier elim_l is kept: c[i] bit l;
//  3. tail masks: over its own 32-column groups from the group's word on
//     (all under full_jordan), each warp reads each pivot row's bits
//     against the pre-group state, one shared read and one ballot per
//     pivot and group, and corrects them in registers in pivot order,
//       mask_i ^= XOR over l < i of (c[i] bit l ? mask_l : 0),
//     the column form of v2's prow_i = T0[r_i] ^ XOR_{l<i} R_l[r_i] prow_l:
//     pivot l flips column j's bit p_i exactly when it XORs elim_l into j;
//  4. one fused tail pass: every column in the union of the masks, the
//     group's own four left out, gets one read-modify-write with the XOR of
//     the elim_i whose mask holds it;
//  5. the exit test from registers, one named barrier, after which the
//     owner writes the four group columns from its registers: a pivot
//     column as its pivot's unit column, any other as its updated value.
// So a group pays one team barrier and at most one read-modify-write per
// tail column, where K2 pays four of each.
#include "gf2_elim_common.cuh"

#define GF2_GROUP 4  // columns per fused group

namespace {

// XOR into every column of a 32-column group (word offset grp) whose bit j
// is set in any mk[i] the XOR of the el[i] whose mask holds j; four columns
// a batch, their loads issued together.
template <int R>
__device__ __forceinline__ void xor_columns_fused(
    unsigned* H, int grp, const unsigned (&mk)[GF2_GROUP],
    const unsigned (&el)[GF2_GROUP][R], int lane, int NR, int S) {
  unsigned mask = mk[0] | mk[1] | mk[2] | mk[3];
  while (mask) {
    int off[4];  // word offset of each picked column, -1 for none
    int j[4];    // its column in the group
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      j[u] = __ffs(mask) - 1;
      off[u] = mask ? grp + j[u] * S : -1;
      mask &= mask - 1u;
    }
    unsigned x[4][R];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int q = 32 * k + lane;
        x[u][k] = (off[u] >= 0 && (k < R - 1 || q < NR)) ? H[off[u] + q] : 0u;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int q = 32 * k + lane;
        unsigned e = 0u;
#pragma unroll
        for (int i = 0; i < GF2_GROUP; ++i)
          if ((mk[i] >> (j[u] & 31)) & 1u) e ^= el[i][k];
        if (off[u] >= 0 && (k < R - 1 || q < NR)) H[off[u] + q] = x[u][k] ^ e;
      }
  }
}

template <int R, bool kDev>
__global__ void __launch_bounds__(max_block_threads(R, true), 1)
gf2_elim_fused_kernel(int* __restrict__ hp,           // (B, 32W, S) cols
                      int* __restrict__ hp_out,       // (B, W, M) or null
                      const int* __restrict__ s_in,   // (B, M)
                      int* __restrict__ s_out,        // (B, M)
                      int* __restrict__ colofrow,     // (B, M)
                      int* __restrict__ steps,        // (B): columns run
                      const int* __restrict__ live,   // [lo, hi) or null
                      int B, int W, int M, int m, int K, int rank,
                      int full_jordan, int exit_on_valid, int spb, int T,
                      int S) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int team = (threadIdx.x >> 5) / T;
  const int t = (threadIdx.x >> 5) - team * T;  // warp in the team
  const int b = blockIdx.x * spb + team;
  if (b >= B) return;  // the whole team; no block barrier follows
  int lo, hi;
  live_range(live, B, lo, hi);
  if (b < lo || b >= hi) {  // gated off
    skip_shot(colofrow + (size_t)b * M, steps + b, M, t, lane);
    return;
  }
  const int NR = (M + 31) >> 5;
  const int shot_words = 32 * W * S;
  unsigned* H = kDev ? (unsigned*)hp + (size_t)b * shot_words
                     : smem + (size_t)team * shot_words;
  int* cf = colofrow + (size_t)b * M;

  if (!kDev)  // else H is the shot's column input itself
    load_columns(H, hp, b, W, S, t, T, lane);
  unsigned used[R], sres[R], valid[R];
  valid_rows(valid, m, lane);
  load_rows(s_in + (size_t)b * M, M, NR, used, sres, lane);
  if (t == 0)
    for (int r = lane; r < M; r += 32) cf[r] = -1;
  team_sync(team, T);

  bool done = exit_on_valid && !pending(sres, used, valid);
  int npiv = 0;
  int col = 0;      // the group's first column
  int gc_mod = 0;   // (col / 32) mod T: warp gc_mod owns the group
  int g_first = t;  // this warp's first group at or after the group's word
  for (; col < K && !done; col += GF2_GROUP) {
    const int gc = col >> 5;
    if (col > 0 && (col & 31) == 0) {  // a new group: no division by T
      if (++gc_mod == T) gc_mod = 0;
      if (!full_jordan && g_first < gc) g_first += T;
    }
    // 1. the group's columns; a pivoted one becomes its elim
    unsigned gw[GF2_GROUP][R];
#pragma unroll
    for (int i = 0; i < GF2_GROUP; ++i)
      read_column(H + (col + i) * S, gw[i], lane, NR);
    // 2. the pivots, one after another, from registers
    int pq[GF2_GROUP];        // pivot row word, -1 for none
    unsigned pbit[GF2_GROUP]; // its bit in that word
    unsigned corr[GF2_GROUP]; // bit l: elim_l holds pivot row i
    bool any = false;
#pragma unroll
    for (int i = 0; i < GF2_GROUP; ++i) {
      pq[i] = -1;
      pbit[i] = 0u;
      corr[i] = 0u;
      if (col + i < K) find_pivot(gw[i], used, valid, pq[i], pbit[i]);
      if (pq[i] < 0) continue;
      any = true;
      const int pr = __ffs(pbit[i]) - 1;
      pivot_rows(gw[i], sres, used, pq[i], pbit[i], lane);
      if (t == 0 && lane == (pq[i] & 31)) cf[32 * pq[i] + pr] = col + i;
#pragma unroll
      for (int j = 0; j < GF2_GROUP; ++j) {
        if (j == i) continue;
        const unsigned bit = (row_word(gw[j], pq[i]) >> pr) & 1u;
        if (j < i && pq[j] >= 0) {  // a pivot column: its unit has no bit
          corr[i] |= bit << j;
        } else if (bit) {
#pragma unroll
          for (int k = 0; k < R; ++k) gw[j][k] ^= gw[i][k];
        }
      }
      ++npiv;
    }
    // 3-4. the tail: corrected masks, then one fused pass per group
    if (any) {
      for (int g = g_first; g < W; g += T) {
        const int base = 32 * g * S;
        unsigned bits[GF2_GROUP];
#pragma unroll
        for (int i = 0; i < GF2_GROUP; ++i) {
          const int pqc = pq[i] < 0 ? 0 : pq[i];  // in range: no branch
          bits[i] = (H[base + lane * S + pqc] >> ((__ffs(pbit[i]) - 1) & 31))
                    & 1u;
        }
        unsigned mk[GF2_GROUP];
#pragma unroll
        for (int i = 0; i < GF2_GROUP; ++i) {
          mk[i] = __ballot_sync(kFull, pq[i] >= 0 && bits[i]);
#pragma unroll
          for (int l = 0; l < i; ++l)
            if ((corr[i] >> l) & 1u) mk[i] ^= mk[l];
        }
        if (g == gc) {  // the group's own columns are in registers
#pragma unroll
          for (int i = 0; i < GF2_GROUP; ++i)
            mk[i] &= ~(0xfu << (col & 31));
        }
        xor_columns_fused<R>(H, base, mk, gw, lane, NR, S);
      }
    }
    // 5. the exit, from registers alone, before the barrier
    done = npiv >= rank || (exit_on_valid && !pending(sres, used, valid));
    team_sync(team, T);
    if (gc_mod == t) {  // after the barrier: no warp reads them again
#pragma unroll
      for (int i = 0; i < GF2_GROUP; ++i) {
        unsigned* cp = H + (col + i) * S;
        if (pq[i] >= 0) {
          write_unit<R>(cp, pq[i], pbit[i], lane, NR);
        } else {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const int q = 32 * k + lane;
            if (k < R - 1 || q < NR) cp[q] = gw[i][k];
          }
        }
      }
      __syncwarp();
    }
  }
  team_sync(team, T);

  if (hp_out)
    store_columns(H, (unsigned*)hp_out + (size_t)b * W * M, W, M, NR, S, t,
                  T, lane);
  if (t == 0) {
    store_rows(sres, s_out + (size_t)b * M, M, NR, lane);
    if (lane == 0) steps[b] = col < K ? col : K;
  }
}

GF2_PICK(gf2_elim_fused_kernel)

Plan plan(int B, int W, int M, int smem_limit, int sms,
          int block_shots = 0) {
  return make_plan(B, W, M, smem_limit, sms, 1, true, block_shots);
}

}  // namespace

// One shot's column bytes, the column stride in words, the row words a
// lane holds, and 1 when the columns stay in device memory, for W words by
// M rows: out[0..3].
extern "C" int gf2_elim_fused_sizes(int W, int M, int smem_limit,
                                    long long* out) {
  return plan_sizes(plan(1, W, M, smem_limit, 1), out);
}

// The launch of B shots of W words by M rows: registers and local (spill)
// bytes a thread, shots a block, dynamic shared memory a block, 1 on the
// device-memory branch, blocks, blocks resident per SM, and warps a shot:
// out[0..7]. `smem_limit` and `block_shots` as for gf2_elim_info.
extern "C" int gf2_elim_fused_info(int B, int W, int M, int smem_limit,
                                   int block_shots, int* out) {
  const Plan p = plan(B, W, M, smem_limit, sm_count(), block_shots);
  return plan_info(p, pick(p.R, p.dev), 1, out);
}

// `hp`: B shots of G1's column layout (plan_launch); `live`: a device int32
// pair [lo, hi), the shots to run (null: all B); hp_out null: no reduced
// matrix; `smem_limit` and `block_shots` as for gf2_elim_info.
extern "C" int gf2_elim_fused_launch(int* hp, int* hp_out, const int* s_in,
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
