// take_along_axis on a 2-D tile of 4-byte elements:
//   axis 0: out[r, c] = x[idx[r, c], c];  axis 1: out[r, c] = x[r, idx[r, c]].
//
// Replaces: scripts/pallas_gather_probe.py::probe.kernel (the pallas_call
// that mapped which dynamic-gather forms the TPU compiler accepts). On
// Hopper every form is an ordinary indexed load.
//
// Bound on the H100: the bytes of x, idx and out once over 3.35 TB/s; at
// the probe's shapes (at most 1024 x 128 elements, 1.5 MB in all) that is
// under half a microsecond, below a launch's own latency, so the launch
// bounds the kernel and the host's issue (the wrapper's checks, allocation
// and ctypes call) bounds a call. float32 and int32 move as the same 32-bit
// words. Design, for the bytes that larger shapes do move:
// - A thread takes four consecutive elements of the flattened tile: one
//   16-byte load of idx, four gathered 4-byte loads, one 16-byte store.
//   Along axis 0 those are four neighbouring columns, so a warp's gathered
//   loads fall on neighbouring words of the rows it picks.
// - Along axis 1 a block first stages the rows of x its 1,024 outputs lie
//   in, with 16-byte loads, in shared memory, and gathers from there; when
//   those rows exceed TA_STAGE_MAX elements (rows of more than ~5,600
//   columns) it gathers from device memory instead.
// - Edges are handled in the kernel: a row length that is not a multiple of
//   four (a thread's four elements then cross a row end), the tile's last
//   partial group, and pointers off a 16-byte boundary take 4-byte accesses.
#include <cuda_runtime.h>
#include <stdint.h>

#define TA_THREADS 256
#define TA_BLOCK (TA_THREADS * 4)  // elements of the output a block writes
#define TA_STAGE_MAX 12288         // staged elements of x (48 KB)

// Row of flat element e: a 32-bit division while the tile has fewer than
// 2^31 elements.
__device__ __forceinline__ long long ta_row(long long e, int cols,
                                            bool narrow) {
  return narrow ? (long long)((int)e / cols) : e / cols;
}

__global__ void __launch_bounds__(TA_THREADS)
take_along_kernel(const uint32_t* __restrict__ x,
                  const int* __restrict__ idx, uint32_t* __restrict__ out,
                  int rows, int cols, int axis, int vec, int stage) {
  extern __shared__ uint4 xs4[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(xs4);
  const long long n = (long long)rows * cols;
  const long long b0 = (long long)blockIdx.x * TA_BLOCK;
  const long long i0 = b0 + 4LL * threadIdx.x;
  const bool narrow = n <= 0x7fffffffLL;
  // the indices first: their load overlaps the staging of x
  const bool full = vec && i0 + 4 <= n;
  int k[4] = {0, 0, 0, 0};
  if (full) {
    const int4 q = *reinterpret_cast<const int4*>(idx + i0);
    k[0] = q.x;
    k[1] = q.y;
    k[2] = q.z;
    k[3] = q.w;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (i0 + v < n) k[v] = idx[i0 + v];
  }
  long long base = 0;  // first staged element, a multiple of four
  if (stage) {
    const long long b1 = min(n, b0 + TA_BLOCK);
    // from the first row's start, rounded down to four, to the last's end
    const long long z = (ta_row(b1 - 1, cols, narrow) + 1) * cols;
    base = (ta_row(b0, cols, narrow) * cols) & ~3LL;
    for (long long e = base + 4LL * threadIdx.x; e < z; e += TA_BLOCK) {
      if (vec && e + 4 <= z) {
        *reinterpret_cast<uint4*>(xs + (e - base)) =
            *reinterpret_cast<const uint4*>(x + e);
      } else {
        for (int v = 0; v < 4 && e + v < z; ++v) xs[e + v - base] = x[e + v];
      }
    }
    __syncthreads();
  }
  if (i0 >= n) return;
  int r = (int)ta_row(i0, cols, narrow);  // row and column of element i0
  int c = (int)(i0 - (long long)r * cols);
  uint32_t o[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    if (i0 + v < n) {
      if (axis == 0)
        o[v] = x[(long long)k[v] * cols + c];
      else if (stage)
        o[v] = xs[(long long)r * cols + k[v] - base];
      else
        o[v] = x[(long long)r * cols + k[v]];
    }
    if (++c == cols) {
      c = 0;
      ++r;
    }
  }
  if (full) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (i0 + v < n) out[i0 + v] = o[v];
  }
}

// The caller guarantees every idx lies in [0, rows) for axis 0 and in
// [0, cols) for axis 1.
extern "C" int take_along_launch(const void* x, const int* idx, void* out,
                                 int rows, int cols, int axis, void* stream) {
  const long long n = (long long)rows * cols;
  if (n > 0) {
    const int vec =
        (((uintptr_t)x | (uintptr_t)idx | (uintptr_t)out) & 15) == 0;
    // a block's outputs span at most TA_BLOCK + 2 * cols - 2 staged
    // elements, plus three before the first for alignment
    const long long staged = TA_BLOCK + 2LL * cols + 4;
    const int stage = axis == 1 && staged <= TA_STAGE_MAX;
    const size_t smem = stage ? (size_t)staged * sizeof(uint32_t) : 0;
    take_along_kernel<<<(unsigned)((n + TA_BLOCK - 1) / TA_BLOCK),
                        TA_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, idx, (uint32_t*)out, rows, cols, axis, vec,
        stage);
  }
  return (int)cudaGetLastError();
}
