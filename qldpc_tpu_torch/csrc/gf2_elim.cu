// Batched, swap-free, greedy GF(2) Gauss-Jordan elimination over bit-packed
// columns, one shot per thread block.
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
// stage-1 8 words, prefix 40 words, full width 70 words): the matrix must
// be read and written once (161 KB per shot at the prefix width), and each
// column step scans all rows and XORs the rows that hold the bit; the
// step count is each shot's own exit depth (tens of columns for most
// failed-BP shots). The cost is a chain of dependent steps per shot, so
// the design keeps a shot's matrix in shared memory (words-major, rows on
// threads: a column's bits of neighbouring rows are neighbouring words),
// picks the pivot with a warp min plus one shared atomic, broadcasts the
// pivot row by reading it straight from shared memory (its owner never
// writes it during the step), and lets every shot exit on its own. Wider
// matrices than the 227 KB a block may hold (the 70-word basis rerun and
// the full_jordan reprocess) run the same code on the device-memory copy.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define GF2_MAXR 4  // rows per thread: M <= 4 * blockDim.x

__global__ void __launch_bounds__(1024)
gf2_elim_kernel(int* __restrict__ hp,        // (B, W, M) in/out
                int* __restrict__ s,         // (B, M) in/out
                int* __restrict__ colofrow,  // (B, M) out
                int* __restrict__ steps,     // (B) out: column steps run
                int W, int M, int m, int K, int rank, int full_jordan,
                int exit_on_valid, int use_smem) {
  extern __shared__ int smem[];
  __shared__ int piv_slot[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* s_sm = smem;
  int* cf_sm = smem + M;
  int* hp_b = hp + (size_t)b * W * M;
  int* H = use_smem ? smem + 2 * M : hp_b;
  if (use_smem)
    for (int i = tid; i < W * M; i += nt) H[i] = hp_b[i];
  for (int r = tid; r < M; r += nt) {
    s_sm[r] = s[(size_t)b * M + r];
    cf_sm[r] = -1;
  }
  if (tid == 0) piv_slot[0] = piv_slot[1] = INT_MAX;
  __syncthreads();

  int done = 0;
  if (exit_on_valid) {
    int nz = 0;
    for (int r = tid; r < m; r += nt) nz |= s_sm[r] != 0;
    done = !__syncthreads_or(nz);
  }
  int npiv = 0;
  int col = 0;
  for (; col < K && !done; ++col) {
    const int w = col >> 5;
    const int bit = col & 31;
    unsigned has_bit = 0;  // bit k: row tid + k*nt holds column `col`
    int mine = INT_MAX;
#pragma unroll
    for (int k = 0; k < GF2_MAXR; ++k) {
      const int r = tid + k * nt;
      if (r < M && ((H[w * M + r] >> bit) & 1)) {
        has_bit |= 1u << k;
        if (r < m && cf_sm[r] < 0 && r < mine) mine = r;
      }
    }
    const int slot = col & 1;
    const int wmin = __reduce_min_sync(0xffffffffu, mine);
    if ((tid & 31) == 0 && wmin != INT_MAX) atomicMin(&piv_slot[slot], wmin);
    // the other slot was last read in the previous step, before its
    // closing barrier: reset it for the next step
    if (tid == 0) piv_slot[slot ^ 1] = INT_MAX;
    __syncthreads();
    const int piv = piv_slot[slot];
    if (piv != INT_MAX) {
      const int w0 = full_jordan ? 0 : w;
      const int ps = s_sm[piv];
#pragma unroll
      for (int k = 0; k < GF2_MAXR; ++k) {
        const int r = tid + k * nt;
        if (((has_bit >> k) & 1) && r != piv) {
          for (int j = w0; j < W; ++j) H[j * M + r] ^= H[j * M + piv];
          s_sm[r] ^= ps;
        }
      }
      if (piv % nt == tid) cf_sm[piv] = col;
      ++npiv;
    }
    int pending = 0;
    if (exit_on_valid)
      for (int r = tid; r < m; r += nt) pending |= cf_sm[r] < 0 && s_sm[r];
    const int any_pending = __syncthreads_or(pending);  // step barrier
    if (npiv >= rank || (exit_on_valid && !any_pending)) done = 1;
  }

  if (use_smem)
    for (int i = tid; i < W * M; i += nt) hp_b[i] = H[i];
  for (int r = tid; r < M; r += nt) {
    s[(size_t)b * M + r] = s_sm[r];
    colofrow[(size_t)b * M + r] = cf_sm[r];
  }
  if (tid == 0) steps[b] = col;
}

extern "C" int gf2_elim_launch(int* hp, int* s, int* colofrow, int* steps,
                               int B, int W, int M, int m, int K, int rank,
                               int full_jordan, int exit_on_valid,
                               int threads, int smem_limit, void* stream) {
  const size_t small = (size_t)2 * M * sizeof(int);
  const size_t full = small + (size_t)W * M * sizeof(int);
  const int use_smem = full <= (size_t)smem_limit;
  const size_t smem = use_smem ? full : small;
  cudaError_t err = cudaFuncSetAttribute(
      gf2_elim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    gf2_elim_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        hp, s, colofrow, steps, W, M, m, K, rank, full_jordan,
        exit_on_valid, use_smem);
  }
  return (int)cudaGetLastError();
}
