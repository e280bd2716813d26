// Batched, swap-free, greedy GF(2) Gauss-Jordan elimination over bit-packed
// columns with a fused 4-column update, one shot per thread block.
//
// Replaces: qldpc_tpu/ops/osd_pallas.py::_elim_kernel_v2 (the pallas_call
// in eliminate_blocks under QLDPC_OSD_KERNEL=2). Per shot it computes K2's
// function (csrc/gf2_elim.cu): for each column c < K in order, the pivot is
// the lowest unused row r < m with bit c set, every other row with bit c
// set is XORed with the pivot row and the residual syndrome follows. The
// columns are taken in groups of 4. A group's columns share one 32-bit word
// w (groups start at multiples of 4, words at multiples of 32), so the 4
// pivots are chosen one after another, each updating only word w and the
// syndrome of the rows that hold its bit. The up-to-4 rank-1 updates of the
// other words (> w; all but w under full_jordan) then land in one
// read-modify-write pass, with the corrected pivot rows
//   prow_i = T0[r_i] ^ XOR_{l<i} R_l[r_i] * prow_l
// (T0 = the words before the group; R_l[r] = row r was eliminated by pivot
// l; an earlier pivot row may itself be hit by a later pivot). Plain GF(2)
// algebra: the same matrix as four sequential steps. The exit (rank
// reached, or every unused row's residual zero) is tested once per group,
// so a shot may run up to 3 columns past K2's exit: s_red, the OSD-0 bits
// and validity are unchanged (later pivots carry a zero syndrome bit),
// while prow_of_col, used and steps follow this kernel's own exit. Columns
// of the last group at or beyond K never pivot.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 rows,
// stage-1 8 words, prefix 40 words, full width 70 words): as K2, the matrix
// must be read and written once, and each column step scans every row; the
// cost is the chain of dependent steps per shot, each ended by a block
// barrier. K2 pays two barriers per column and one read-modify-write of
// the tail words per eliminated row per column. This design pays one
// barrier per column for the pivot choices plus two per group (one that
// publishes the pivot rows' correction masks and tests the exit, one that
// publishes the corrected pivot rows), and one tail pass per group: 1.5
// barriers per column and a quarter of the tail traffic. Layout as K2:
// words-major, rows on threads, the shot's matrix in shared memory up to
// the 227 KB a block may hold and in device memory beyond.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define GF2_MAXR 4   // rows per thread: M <= 4 * blockDim.x
#define GF2_GROUP 4  // columns per fused group

__global__ void __launch_bounds__(1024)
gf2_elim_fused_kernel(int* __restrict__ hp,        // (B, W, M) in/out
                      int* __restrict__ s,         // (B, M) in/out
                      int* __restrict__ colofrow,  // (B, M) out
                      int* __restrict__ steps,     // (B) out: columns run
                      int W, int M, int m, int K, int rank, int full_jordan,
                      int exit_on_valid, int use_smem) {
  extern __shared__ int smem[];
  // pivot slots, two banks used by alternate groups: a bank is reset at the
  // start of the group after its last use, once every thread has passed
  // that group's closing barriers
  __shared__ int piv_slot[2][GF2_GROUP];
  __shared__ int pmask[GF2_GROUP];  // bit l: pivot row i was hit by pivot l
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* s_sm = smem;
  int* cf_sm = smem + M;
  int* prow_sm = smem + 2 * M;            // (GF2_GROUP, W) corrected rows
  int* hp_b = hp + (size_t)b * W * M;
  int* H = use_smem ? prow_sm + GF2_GROUP * W : hp_b;
  if (use_smem)
    for (int i = tid; i < W * M; i += nt) H[i] = hp_b[i];
  for (int r = tid; r < M; r += nt) {
    s_sm[r] = s[(size_t)b * M + r];
    cf_sm[r] = -1;
  }
  if (tid < 2 * GF2_GROUP) piv_slot[tid / GF2_GROUP][tid % GF2_GROUP] = INT_MAX;
  __syncthreads();

  int done = 0;
  if (exit_on_valid) {
    int nz = 0;
    for (int r = tid; r < m; r += nt) nz |= s_sm[r] != 0;
    done = !__syncthreads_or(nz);
  }
  int npiv = 0;
  int col = 0;
  for (; col < K && !done; col += GF2_GROUP) {
    const int bank = (col / GF2_GROUP) & 1;
    if (tid < GF2_GROUP) piv_slot[bank ^ 1][tid] = INT_MAX;
    const int w = col >> 5;
    const int ng = min(GF2_GROUP, K - col);
    unsigned hit = 0;  // bit i*GF2_MAXR + k: row tid + k*nt hit by pivot i
    int piv[GF2_GROUP];
    // --- the group's pivots, one after another, on word w only ---
    for (int i = 0; i < ng; ++i) {
      const int c = col + i;
      const int bit = c & 31;
      unsigned has_bit = 0;
      int mine = INT_MAX;
#pragma unroll
      for (int k = 0; k < GF2_MAXR; ++k) {
        const int r = tid + k * nt;
        if (r < M && ((H[w * M + r] >> bit) & 1)) {
          has_bit |= 1u << k;
          if (r < m && cf_sm[r] < 0 && r < mine) mine = r;
        }
      }
      const int wmin = __reduce_min_sync(0xffffffffu, mine);
      if ((tid & 31) == 0 && wmin != INT_MAX)
        atomicMin(&piv_slot[bank][i], wmin);
      __syncthreads();
      const int p = piv_slot[bank][i];
      piv[i] = p;
      if (p != INT_MAX) {
        // the pivot row is never written during its own step
        const int pw = H[w * M + p];
        const int ps = s_sm[p];
#pragma unroll
        for (int k = 0; k < GF2_MAXR; ++k) {
          const int r = tid + k * nt;
          if (((has_bit >> k) & 1) && r != p) {
            H[w * M + r] ^= pw;
            s_sm[r] ^= ps;
            hit |= 1u << (i * GF2_MAXR + k);
          }
        }
        if (p % nt == tid) {
          cf_sm[p] = c;
          const int kp = p / nt;
          int pm = 0;
          for (int l = 0; l < i; ++l) pm |= ((hit >> (l * GF2_MAXR + kp)) & 1) << l;
          pmask[i] = pm;
        }
        ++npiv;
      }
    }
    // --- exit test (own rows only) + publish pmask and word w ---
    int pending = 0;
    if (exit_on_valid)
      for (int r = tid; r < m; r += nt) pending |= cf_sm[r] < 0 && s_sm[r];
    const int any_pending = __syncthreads_or(pending);
    // --- fused tail update of every other word that needs it ---
    const int j0 = full_jordan ? 0 : w + 1;
    if (j0 < W) {
      for (int jj = j0 + tid; jj < W; jj += nt) {
        if (jj == w) continue;
        int pr[GF2_GROUP];
#pragma unroll
        for (int i = 0; i < GF2_GROUP; ++i) {
          if (i >= ng || piv[i] == INT_MAX) continue;
          int v = H[jj * M + piv[i]];
          const int pm = pmask[i];
          for (int l = 0; l < i; ++l)
            if ((pm >> l) & 1) v ^= pr[l];
          pr[i] = v;
          prow_sm[i * W + jj] = v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < GF2_MAXR; ++k) {
        const int r = tid + k * nt;
        unsigned mk = 0;
        for (int i = 0; i < ng; ++i) mk |= ((hit >> (i * GF2_MAXR + k)) & 1) << i;
        if (r >= M || !mk) continue;
        for (int jj = j0; jj < W; ++jj) {
          if (jj == w) continue;
          int x = H[jj * M + r];
          for (int i = 0; i < ng; ++i)
            if ((mk >> i) & 1) x ^= prow_sm[i * W + jj];
          H[jj * M + r] = x;
        }
      }
    }
    if (npiv >= rank || (exit_on_valid && !any_pending)) done = 1;
  }
  __syncthreads();  // the last tail pass wrote rows of every thread

  if (use_smem)
    for (int i = tid; i < W * M; i += nt) hp_b[i] = H[i];
  for (int r = tid; r < M; r += nt) {
    s[(size_t)b * M + r] = s_sm[r];
    colofrow[(size_t)b * M + r] = cf_sm[r];
  }
  if (tid == 0) steps[b] = min(col, K);
}

extern "C" int gf2_elim_fused_launch(int* hp, int* s, int* colofrow,
                                     int* steps, int B, int W, int M, int m,
                                     int K, int rank, int full_jordan,
                                     int exit_on_valid, int threads,
                                     int smem_limit, void* stream) {
  const size_t small = ((size_t)2 * M + (size_t)GF2_GROUP * W) * sizeof(int);
  const size_t full = small + (size_t)W * M * sizeof(int);
  const int use_smem = full <= (size_t)smem_limit;
  const size_t smem = use_smem ? full : small;
  cudaError_t err = cudaFuncSetAttribute(
      gf2_elim_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    gf2_elim_fused_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        hp, s, colofrow, steps, W, M, m, K, rank, full_jordan, exit_on_valid,
        use_smem);
  }
  return (int)cudaGetLastError();
}
