// Batched, swap-free, greedy GF(2) Gauss-Jordan elimination over bit-packed
// columns, one team of warps per shot over column bitsets.
//
// Replaces: qldpc_tpu/ops/osd_pallas.py::_elim_kernel (v1, the pallas_call
// in eliminate_blocks). Semantics per shot: for each column c < K in order,
// the pivot is the lowest unused row r < m with bit c set; every other row
// with bit c set is XORed with the pivot row, the residual syndrome in
// step; colofrow[pivot] = c. A shot stops when `rank` pivots are reached,
// or (exit_on_valid) when every unused row carries a zero residual — the
// residual then lies in the pivot span and no later pivot changes s_red or
// the OSD-0 correction. Left-word skipping: a step in word w updates words
// >= w only (full_jordan updates all), which leaves the pivot sequence,
// s_red, colofrow and every pivot column identical to full Gauss-Jordan.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 rows,
// stage-1 8 words, prefix 40 words, full width 70 words): the matrix is
// read and written once, and the column steps are a chain of dependent
// steps per shot (tens of columns for most failed-BP shots, a few hundred
// at most, the longest shot of a launch setting its time), each doing a
// handful of word XORs. So a step must cost few cycles, and no shot may
// wait for another.
//
// Design: a team of T warps runs one shot's column loop and exits on its
// own; a block holds several shots and has no block barrier at all. The
// shot's matrix lives column-major: column j is ceil(M/32) words over the
// rows (word l holds rows 32l..32l+31), its stride made odd so that lane l
// reading column j0 + l at one word hits 32 different banks. Lane l owns
// row words l, l + 32, ... (R = ceil(M/1024) of them, R <= GF2_MAXR) of
// every column, and every warp of the team keeps the same row state —
// used rows, the residual syndrome, rows < m — as bitmasks in registers.
// Warp t owns the 32-column groups g = t (mod T). A column step: every
// warp reads the column's words and picks the pivot by one ballot and a
// find-first-set; each warp reads the pivot row's bits over its own groups
// from the pivot's word on (one shared read and one ballot per group) and
// XORs the column's other rows into each of its columns whose pivot bit is
// set, the pivot column left out; one named barrier for the team (a
// __syncwarp for a team of one); then the pivot column's owner writes it
// as the pivot's unit column, which no other warp reads again. All 32W
// columns are carried, those past K too, as the words-major plain version
// XORs whole words. The input is G1's column layout (csrc/gather_pack.cu),
// copied into shared memory as it is. The reduced matrix goes out
// words-major by 32x32 bit transposes of five __shfl_xor_sync butterfly
// rounds, four interleaved, each warp of the team taking its share of the
// words, and only when the caller asks for it (hp_out not null). A shot
// whose columns exceed the shared memory a block may hold (the 70-word
// basis rerun and the full_jordan reprocess at [[144]], every width at
// [[288]]) runs the same code on its column input in device memory,
// eliminated in place with no load; gf2_elim_sizes reports whether a width
// does. The layout, the row state, the pivot search and the host-side plan
// are shared with K4 and K5 (gf2_elim_common.cuh).
#include "gf2_elim_common.cuh"

namespace {

template <int R, bool kDev>
__global__ void __launch_bounds__(1024)
gf2_elim_kernel(int* __restrict__ hp,           // (B, 32W, S) columns
                int* __restrict__ hp_out,       // (B, W, M) or null
                const int* __restrict__ s_in,   // (B, M)
                int* __restrict__ s_out,        // (B, M)
                int* __restrict__ colofrow,     // (B, M)
                int* __restrict__ steps,        // (B): column steps run
                const int* __restrict__ live,   // [lo, hi) or null
                int B, int W, int M, int m, int K, int rank, int full_jordan,
                int exit_on_valid, int spb, int T, int S) {
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
  // row state, the same in every warp of the team
  unsigned used[R], sres[R], valid[R];
  valid_rows(valid, m, lane);
  load_rows(s_in + (size_t)b * M, M, NR, used, sres, lane);
  if (t == 0)
    for (int r = lane; r < M; r += 32) cf[r] = -1;
  team_sync(team, T);

  bool done = exit_on_valid && !pending(sres, used, valid);
  int npiv = 0;
  int col = 0;
  int gc_mod = 0;   // (col / 32) mod T: warp gc_mod owns column col
  int g_first = t;  // this warp's first group at or after the pivot's word
  for (; col < K && !done; ++col) {
    if (col > 0 && (col & 31) == 0) {  // a new group: no division by T
      if (++gc_mod == T) gc_mod = 0;
      if (!full_jordan && g_first < (col >> 5)) g_first += T;
    }
    done = column_step(H, col, g_first, gc_mod, W, NR, S, used, sres, valid,
                       npiv, cf, rank, exit_on_valid, team, t, T, lane);
  }
  team_sync(team, T);

  if (hp_out)
    store_columns(H, (unsigned*)hp_out + (size_t)b * W * M, W, M, NR, S, t,
                  T, lane);
  if (t == 0) {
    store_rows(sres, s_out + (size_t)b * M, M, NR, lane);
    if (lane == 0) steps[b] = col;
  }
}

GF2_PICK(gf2_elim_kernel)

Plan plan(int B, int W, int M, int smem_limit, int block_shots) {
  return make_plan(B, W, M, smem_limit, sm_count(), 1, false, block_shots);
}

}  // namespace

// One shot's column bytes, the column stride in words, the row words a
// lane holds, and 1 when the columns stay in device memory, for W words by
// M rows: out[0..3].
extern "C" int gf2_elim_sizes(int W, int M, int smem_limit, long long* out) {
  return plan_sizes(make_plan(1, W, M, smem_limit, 1), out);
}

// The launch of B shots of W words by M rows: registers and local (spill)
// bytes a thread, shots a block, dynamic shared memory a block, 1 on the
// device-memory branch, blocks, blocks resident per SM, and warps a shot:
// out[0..7]. `smem_limit`: the shared-memory budget a block; `block_shots`:
// the shots a block asked for (0: the plan's own rule; make_plan).
extern "C" int gf2_elim_info(int B, int W, int M, int smem_limit,
                             int block_shots, int* out) {
  const Plan p = plan(B, W, M, smem_limit, block_shots);
  return plan_info(p, pick(p.R, p.dev), 1, out);
}

// `hp`: B shots of G1's column layout (plan_launch); `live`: a device int32
// pair [lo, hi), the shots to run (null: all B); hp_out null: no reduced
// matrix; `smem_limit` and `block_shots` as for gf2_elim_info.
extern "C" int gf2_elim_launch(int* hp, int* hp_out, const int* s_in,
                               int* s_out, int* colofrow, int* steps,
                               const int* live, int B, int W, int M, int m,
                               int K, int rank, int full_jordan,
                               int exit_on_valid, int smem_limit,
                               int block_shots, void* stream) {
  const Plan p = plan(B, W, M, smem_limit, block_shots);
  return plan_launch(p, pick(p.R, p.dev), hp, hp_out, s_in, s_out, colofrow,
                     steps, live, B, W, M, m, K, rank, full_jordan,
                     exit_on_valid, stream);
}
