// G1: per-shot column gather and bit-pack of a sparse decoding matrix into
// the eliminators' own column layout (csrc/gf2_elim_common.cuh): column
// 32w + c of shot b is S words over the rows,
//
//   out[b, 32w + c, l] = sum over i < 32 of H[32l + i, cols[b, 32w + c]] << i
//
// for l < NR = ceil(m/32); words NR..S-1 (the odd stride's padding) and
// columns at or past K are zero. S is the eliminators' stride, which the
// caller reads from their *_sizes entry point.
//
// Replaces: the XLA gather-pack of the JAX package's OSD
// (qldpc_tpu/ops/osd.py::_gather_pack with words_major=True), a dense
// (n, m) uint8 gather of each 256-column chunk and 32 int64 shift-or steps
// over every row. Its port (qldpc_tpu_torch/ops/osd_cuda.py::_gather_pack)
// and that port's bit transpose into this layout are G1's plain version.
// The decoding matrices are sparse ([[144,12,12]]'s H_Z: 1008 x 8785, at
// most 6 rows a column, 3.5 on average), so the kernel reads H as CSC
// (each column's rows, built once a matrix) and touches only the set bits.
//
// Gate: `live`, a device int32 pair [lo, hi), names the shots to pack (a
// null pointer: all B). The grid covers every shot, so the host never
// reads the pair; a warp whose shot lies outside it leaves at once and its
// words stay unwritten (the OSD never consumes them).
//
// Bound on the H100: the output's bytes (4 S a column of a live shot) over
// 3.35 TB/s, with the column indices (8 bytes), their CSC offsets (8
// bytes) and rows (4 bytes a set bit) read once. At [[144]]'s 1008 rows
// S = 33 against 31.5 words of rows, so the layout writes 4.8% more bytes
// than a words-major (W, m) one would.
//
// Design: one warp per (shot, 32-column group), no shared-memory atomics
// and no block barrier. Lane c owns column 32w + c: it reads the column
// index, its CSC range and its first GPC_DEG rows (a few loads of its own,
// all lanes in parallel, issued before the warp zeroes its tile) and ORs
// each row's bit into its own column's S words of the warp's tile in
// shared memory, which no other lane touches (so no atomics; the odd
// stride spreads the lanes' words over the banks). After a __syncwarp the
// warp stores the tile, 32 S words that are contiguous in the output and
// 128-byte aligned, with 16-byte stores, and reads it nowhere else. The
// eliminators then copy a shot's columns straight into shared memory, or
// work on them in place on their device-memory branch, with no transpose.
#include <cuda_runtime.h>
#include <stdint.h>

#define GPC_WARPS 4        // warps (32-column groups) a block
#define GPC_MAX_STRIDE 129 // the eliminators' widest stride (M <= 4096)
#define GPC_DEG 8          // rows of its column a lane loads up front
#define GP_MAX_DEVICES 16

__global__ void __launch_bounds__(32 * GPC_WARPS)
gather_pack_kernel(const int* __restrict__ colptr,      // (n + 1)
                   const int* __restrict__ rows,        // (nnz)
                   const long long* __restrict__ cols,  // (B, ld)
                   long long ld,
                   const int* __restrict__ live,        // [lo, hi) or null
                   int* __restrict__ out,               // (B, 32 W, S)
                   int B, int K, int W, int S) {
  extern __shared__ uint4 tiles[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task = (long long)blockIdx.x * GPC_WARPS + warp;
  if (task >= (long long)B * W) return;  // the whole warp
  const int b = (int)(task / W);
  const int w = (int)(task - (long long)b * W);
  if (live && (b < live[0] || b >= live[1])) return;  // gated off
  // this lane's column: its CSC range and first GPC_DEG rows, loaded
  // before the tile is zeroed so that the zeroing hides their latency
  const int c = 32 * w + lane;
  int e = 0, e1 = 0;
  if (c < K) {
    const long long j = cols[(size_t)b * ld + c];
    e = colptr[j];
    e1 = colptr[j + 1];
  }
  int first[GPC_DEG];  // -1: none
#pragma unroll
  for (int d = 0; d < GPC_DEG; ++d) first[d] = e + d < e1 ? rows[e + d] : -1;
  const int n4 = 8 * S;  // the tile's 32 S words as 16-byte vectors
  uint4* tile4 = tiles + warp * n4;
  for (int i = lane; i < n4; i += 32) tile4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  unsigned* col = (unsigned*)tile4 + lane * S;
#pragma unroll
  for (int d = 0; d < GPC_DEG; ++d)
    if (first[d] >= 0) col[first[d] >> 5] |= 1u << (first[d] & 31);
  for (e += GPC_DEG; e < e1; ++e) {  // a column of more rows
    const int r = rows[e];
    col[r >> 5] |= 1u << (r & 31);
  }
  __syncwarp();
  uint4* o4 = (uint4*)(out + ((size_t)b * W + w) * 32 * S);
  for (int i = lane; i < n4; i += 32) o4[i] = tile4[i];
}

// B shots of K columns (row stride ld of cols, in elements) into 32 W
// columns of S words each (out: B shots of 32 W S words, 16-byte aligned);
// the caller guarantees K <= 32 W, every column index in [0, n) and
// S >= ceil(m / 32) for the matrix's m rows.
// `live`: a device int32 pair [lo, hi), the shots to pack (null: all B).
extern "C" int gather_pack_launch(const int* colptr, const int* rows,
                                  const long long* cols, long long ld,
                                  const int* live, int* out, int B, int K,
                                  int W, int S, void* stream) {
  if (K > 32 * W || K < 0 || B < 0 || W < 0 || S < 1 ||
      S > GPC_MAX_STRIDE || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int smem = GPC_WARPS * 32 * S * (int)sizeof(unsigned);
  // dynamic shared memory opted in to so far, by device
  static int allowed[GP_MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= GP_MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  const long long tasks = (long long)B * W;
  if (tasks > 0) {
    const long long grid = (tasks + GPC_WARPS - 1) / GPC_WARPS;
    gather_pack_kernel<<<(unsigned)grid, 32 * GPC_WARPS, smem,
                         (cudaStream_t)stream>>>(colptr, rows, cols, ld, live,
                                                 out, B, K, W, S);
  }
  return (int)cudaGetLastError();
}
