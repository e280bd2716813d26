// Batched, swap-free, greedy GF(2) Gauss-Jordan elimination over bit-packed
// columns, two shots per thread block advancing through one column loop.
//
// Replaces: qldpc_tpu/ops/osd_pallas.py::_elim_kernel_v3 (the pallas_call
// in eliminate_blocks under QLDPC_OSD_KERNEL=3), which interleaves two
// independent shot blocks through v1's column scan so that one block's
// stalls overlap the other's. Per shot it computes exactly K2's function
// (csrc/gf2_elim.cu), exit after every column included: for each column
// c < K in order, the pivot is the lowest unused row r < m with bit c set,
// every other row with bit c set is XORed with the pivot row and the
// residual syndrome follows; a shot stops when `rank` pivots are reached or
// (exit_on_valid) when every unused row's residual is zero. Each shot keeps
// its own column and exits on its own, so every output equals K2's.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 rows,
// stage-1 8 words, prefix 40 words, full width 70 words): as K2, the matrix
// must be read and written once, and the cost is the chain of dependent
// column steps per shot, each ended by block barriers. Here one step serves
// both shots of a block: two barriers per step (pivot choice, then the
// exit flags of both shots, gathered with a shared atomicOr) instead of two
// per shot-step, on half as many blocks. Layout as K2: words-major, rows on
// threads, each thread holding the same rows of both shots. Two stage-1
// matrices (2 x 32 KB) sit in shared memory; when two do not fit in the
// 227 KB a block may hold, both run on their device-memory copies.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define GF2_MAXR 4  // rows per thread: M <= 4 * blockDim.x

__global__ void __launch_bounds__(1024)
gf2_elim_pair_kernel(int* __restrict__ hp,        // (B, W, M) in/out
                     int* __restrict__ s,         // (B, M) in/out
                     int* __restrict__ colofrow,  // (B, M) out
                     int* __restrict__ steps,     // (B) out: column steps
                     int B, int W, int M, int m, int K, int rank,
                     int full_jordan, int exit_on_valid, int use_smem) {
  extern __shared__ int smem[];
  // pivot slot per (step parity, shot); pending flags per step parity (bit
  // h: shot h still has an unused row with a nonzero residual)
  __shared__ int piv_slot[2][2];
  __shared__ int pend[2];
  const int b0 = 2 * blockIdx.x;
  const int nshot = min(2, B - b0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* s_sm[2];
  int* cf_sm[2];
  int* H[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int* base = smem + (size_t)h * (2 * M + (use_smem ? W * M : 0));
    s_sm[h] = base;
    cf_sm[h] = base + M;
    int* hp_b = hp + (size_t)(b0 + h) * W * M;
    H[h] = use_smem ? base + 2 * M : hp_b;
  }
  for (int h = 0; h < nshot; ++h) {
    int* hp_b = hp + (size_t)(b0 + h) * W * M;
    if (use_smem)
      for (int i = tid; i < W * M; i += nt) H[h][i] = hp_b[i];
    for (int r = tid; r < M; r += nt) {
      s_sm[h][r] = s[(size_t)(b0 + h) * M + r];
      cf_sm[h][r] = -1;
    }
  }
  if (tid < 4) piv_slot[tid >> 1][tid & 1] = INT_MAX;
  if (tid < 2) pend[tid] = 0;
  __syncthreads();

  int done[2] = {1, 1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int nz = 0;
    if (h < nshot && exit_on_valid)
      for (int r = tid; r < m; r += nt) nz |= s_sm[h][r] != 0;
    const int any = __syncthreads_or(nz);
    done[h] = h >= nshot || K <= 0 || (exit_on_valid && !any);
  }
  int col[2] = {0, 0};
  int npiv[2] = {0, 0};
  for (int step = 0; !(done[0] && done[1]); ++step) {
    const int slot = step & 1;
    unsigned has_bit[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (done[h]) continue;
      const int w = col[h] >> 5;
      const int bit = col[h] & 31;
      int mine = INT_MAX;
#pragma unroll
      for (int k = 0; k < GF2_MAXR; ++k) {
        const int r = tid + k * nt;
        if (r < M && ((H[h][w * M + r] >> bit) & 1)) {
          has_bit[h] |= 1u << k;
          if (r < m && cf_sm[h][r] < 0 && r < mine) mine = r;
        }
      }
      const int wmin = __reduce_min_sync(0xffffffffu, mine);
      if ((tid & 31) == 0 && wmin != INT_MAX)
        atomicMin(&piv_slot[slot][h], wmin);
    }
    // the other parity's slots were last read before the previous step's
    // closing barrier: reset them for the next step
    if (tid < 2) piv_slot[slot ^ 1][tid] = INT_MAX;
    __syncthreads();
    // the other parity's flags were last read right after the previous
    // step's closing barrier, which every thread has left by now
    if (tid == 0) pend[slot ^ 1] = 0;
    int pending = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (done[h]) continue;
      const int c = col[h];
      const int piv = piv_slot[slot][h];
      if (piv != INT_MAX) {
        const int w0 = full_jordan ? 0 : c >> 5;
        const int ps = s_sm[h][piv];
        int* Hh = H[h];
#pragma unroll
        for (int k = 0; k < GF2_MAXR; ++k) {
          const int r = tid + k * nt;
          if (((has_bit[h] >> k) & 1) && r != piv) {
            for (int j = w0; j < W; ++j) Hh[j * M + r] ^= Hh[j * M + piv];
            s_sm[h][r] ^= ps;
          }
        }
        if (piv % nt == tid) cf_sm[h][piv] = c;
        ++npiv[h];
      }
      if (exit_on_valid) {
        int p = 0;
        for (int r = tid; r < m; r += nt) p |= cf_sm[h][r] < 0 && s_sm[h][r];
        pending |= p << h;
      }
    }
    const int wp = __reduce_or_sync(0xffffffffu, pending);
    if ((tid & 31) == 0 && wp) atomicOr(&pend[slot], wp);
    __syncthreads();  // step barrier
    const int flags = pend[slot];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (done[h]) continue;
      ++col[h];
      if (npiv[h] >= rank || (exit_on_valid && !((flags >> h) & 1))
          || col[h] >= K)
        done[h] = 1;
    }
  }

  for (int h = 0; h < nshot; ++h) {
    int* hp_b = hp + (size_t)(b0 + h) * W * M;
    if (use_smem)
      for (int i = tid; i < W * M; i += nt) hp_b[i] = H[h][i];
    for (int r = tid; r < M; r += nt) {
      s[(size_t)(b0 + h) * M + r] = s_sm[h][r];
      colofrow[(size_t)(b0 + h) * M + r] = cf_sm[h][r];
    }
    if (tid == 0) steps[b0 + h] = col[h];
  }
}

extern "C" int gf2_elim_pair_launch(int* hp, int* s, int* colofrow,
                                    int* steps, int B, int W, int M, int m,
                                    int K, int rank, int full_jordan,
                                    int exit_on_valid, int threads,
                                    int smem_limit, void* stream) {
  const size_t small = (size_t)2 * 2 * M * sizeof(int);
  const size_t full = small + (size_t)2 * W * M * sizeof(int);
  const int use_smem = full <= (size_t)smem_limit;
  const size_t smem = use_smem ? full : small;
  cudaError_t err = cudaFuncSetAttribute(
      gf2_elim_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    gf2_elim_pair_kernel<<<(B + 1) / 2, threads, smem,
                           (cudaStream_t)stream>>>(
        hp, s, colofrow, steps, B, W, M, m, K, rank, full_jordan,
        exit_on_valid, use_smem);
  }
  return (int)cudaGetLastError();
}
