// G1: per-shot column gather and bit-pack of a sparse decoding matrix into
// the eliminators' words-major input.
//
//   out[b, w, r] = sum over c < 32 of H[r, cols[b, 32w + c]] << c
//                  (columns 32w + c >= K pack as zeros)
//
// Replaces: the XLA gather-pack of the JAX package's OSD
// (qldpc_tpu/ops/osd.py::_gather_pack with words_major=True), whose port
// (qldpc_tpu_torch/ops/osd_cuda.py::_gather_pack) is this kernel's plain
// version: a dense (n, m) uint8 gather of each 256-column chunk and 32
// int64 shift-or steps over every row. The decoding matrices are sparse
// ([[144,12,12]]'s H_Z: 1008 x 8785, at most 6 rows a column, 3.5 on
// average), so this kernel reads H as CSC (each column's rows, built once a
// matrix) and touches only the set bits.
//
// Gate: `live`, a device int32 pair [lo, hi), names the shots to pack (a
// null pointer: all B). The grid covers every shot, so the host never
// reads the pair; a block whose shot lies outside it leaves at once and its
// words stay unwritten (the OSD never consumes them).
//
// Bound on the H100: the output's bytes (4 m a word of a live shot) over
// 3.35 TB/s, with the column indices (8 bytes) and their rows (4 bytes a
// set bit) read once; a launch at the main path's widths (8, 40, 70 words
// by 1008 rows, a few hundred live shots) moves tens of MB.
//
// Design: one block of GP_THREADS threads per (word, shot). The block
// zeroes the word's m rows in shared memory; lane c of every warp takes
// column 32w + c, and warp k ORs bit c into the rows of that column's set
// bits k, k + GP_WARPS, ... (shared-memory atomics: different columns of
// the word share rows); then the block stores the m words to consecutive
// addresses. Blocks of one shot's words are neighbours in the grid, so a
// shot's (W, m) output is written in order.
#include <cuda_runtime.h>
#include <stdint.h>

#define GP_THREADS 256
#define GP_WARPS (GP_THREADS / 32)
#define GP_MAX_ROWS 12288  // rows a block stages (48 KB of shared memory)
#define GP_MAX_SHOTS 65535 // the grid's second dimension

__global__ void __launch_bounds__(GP_THREADS)
gather_pack_kernel(const int* __restrict__ colptr,  // (n + 1)
                   const int* __restrict__ rows,    // (nnz)
                   const long long* __restrict__ cols,  // (B, ld), K used
                   long long ld,
                   const int* __restrict__ live,    // [lo, hi) or null
                   int* __restrict__ out,           // (B, W, m)
                   int B, int K, int W, int m) {
  extern __shared__ unsigned acc[];
  const int w = blockIdx.x;
  const int b = blockIdx.y;
  if (live && (b < live[0] || b >= live[1])) return;  // gated off
  for (int r = threadIdx.x; r < m; r += GP_THREADS) acc[r] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = 32 * w + lane;
  if (c < K) {
    const long long j = cols[(size_t)b * ld + c];
    const int e1 = colptr[j + 1];
    for (int e = colptr[j] + warp; e < e1; e += GP_WARPS)
      atomicOr(&acc[rows[e]], 1u << lane);
  }
  __syncthreads();
  int* o = out + ((size_t)b * W + w) * m;
  for (int r = threadIdx.x; r < m; r += GP_THREADS) o[r] = (int)acc[r];
}

// B shots of K columns each (row stride ld of cols, in elements) into W
// words by m rows; the caller guarantees K <= 32 W and every column index
// in [0, n). `live`: a device int32 pair [lo, hi), the shots to pack (null:
// all B).
extern "C" int gather_pack_launch(const int* colptr, const int* rows,
                                  const long long* cols, long long ld,
                                  const int* live, int* out, int B, int K,
                                  int W, int m, void* stream) {
  if (B > GP_MAX_SHOTS || m > GP_MAX_ROWS || K > 32 * W || m < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && W > 0 && m > 0) {
    const dim3 grid(W, B);
    gather_pack_kernel<<<grid, GP_THREADS, m * sizeof(unsigned),
                         (cudaStream_t)stream>>>(colptr, rows, cols, ld, live,
                                                 out, B, K, W, m);
  }
  return (int)cudaGetLastError();
}
