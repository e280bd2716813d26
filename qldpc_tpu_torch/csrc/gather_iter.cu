// Iterated gather along rows over a tile that stays on-chip, then a column
// sum: `iters` rounds of y = y[idx[r, l], l] + 1, out = sum over rows.
//
// Replaces: scripts/pallas_gather_bench.py::gather_kernel (the pallas_call
// in pallas_gather), the probe of how fast a dynamic gather runs inside a
// kernel whose data never leaves fast memory (the TPU's VMEM there, shared
// memory here). Its largest case, 35,280 rows, is the edge-slot grid of
// [[144,12,12]] that the flooding BP kernel gathers from every iteration.
//
// Bound on the H100: device memory is touched once (x and idx read, the
// tile and the sums written); every round reads one gathered element and
// writes one element of shared memory per tile element, so shared-memory
// bandwidth (128 B/clk/SM) bounds the rounds. Design:
// - Lane columns are independent, so a block owns L whole columns and keeps
//   them in shared memory for all rounds (the wrapper picks L; L = 1 at
//   35,280 rows in float32: a 141 KB column).
// - Indices are read once. Each is stored as the uint16 shared-memory
//   offset of its source element (row * L + lane), so a round does one
//   2-byte index read and no division; a block's tile holds at most
//   GI_MAX_STAGE * 1024 = 36,864 elements, below 65,536.
// - In-place hazard: y[r] = y[idx[r]] + 1 may read an element another
//   thread writes in the same round, and two float32 tiles of 35,280 rows
//   do not fit in one block. Each thread gathers its E elements (at most
//   36) into registers, the block waits, writes them back plus one, waits.
//   E is a template argument, the smallest instance that holds the tile,
//   so the register array is exactly as large as the tile needs and the
//   element offsets are constants (stride 1024 threads when E > 1).
// - bf16: the add is done in float32 and rounded once to bf16, as PyTorch
//   and XLA do; the sums accumulate in float32 and round once at the end.
// - x and idx are row-major (rows, lanes): a block reads its L columns with
//   a stride of `lanes` elements once, into shared memory, and never again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GI_MAX_STAGE 36  // tile elements per thread: rows * L <= 36 * 1024
#define GI_THREADS 1024  // threads of a block whose tile needs E > 1

__device__ __forceinline__ float gi_to_f(float v) { return v; }
__device__ __forceinline__ float gi_to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T gi_from_f(float v);
template <> __device__ __forceinline__ float gi_from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 gi_from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int E>
__global__ void __launch_bounds__(GI_THREADS, 1)
gather_iter_kernel(const T* __restrict__ x,      // (rows, lanes)
                   const int* __restrict__ idx,  // (rows, lanes) in [0, rows)
                   T* __restrict__ sum,          // (1, lanes) out
                   T* __restrict__ tile,         // (rows, lanes) out
                   int rows, int lanes, int L, int iters, size_t y_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const int nt = E > 1 ? GI_THREADS : blockDim.x;
  const int l0 = blockIdx.x * L;
  const int Lb = min(L, lanes - l0);  // lanes of this block
  const int n = rows * Lb;            // element i = row * Lb + lane
  T* Y = reinterpret_cast<T*>(smem);
  uint16_t* src = reinterpret_cast<uint16_t*>(smem + y_bytes);

  for (int i = tid; i < n; i += nt) {
    const int r = i / Lb;
    const int j = i - r * Lb;
    const size_t g = (size_t)r * lanes + l0 + j;
    Y[i] = x[g];
    src[i] = (uint16_t)(idx[g] * Lb + j);
  }
  __syncthreads();

  float stage[E];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = tid + k * nt;
      if (i < n) stage[k] = gi_to_f(Y[src[i]]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = tid + k * nt;
      if (i < n) Y[i] = gi_from_f<T>(stage[k] + 1.0f);
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt) {
    const int r = i / Lb;
    tile[(size_t)r * lanes + l0 + (i - r * Lb)] = Y[i];
  }
  for (int j = 0; j < Lb; ++j) {
    float acc = 0.f;
    for (int r = tid; r < rows; r += nt) acc += gi_to_f(Y[r * Lb + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((tid & 31) == 0) red[tid >> 5] = acc;
    __syncthreads();
    if (tid < 32) {
      float v = tid < (nt >> 5) ? red[tid] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (tid == 0) sum[l0 + j] = gi_from_f<T>(v);
    }
    __syncthreads();  // red is reused by the next column
  }
}

template <typename T, int E>
static int launch(const void* x, const int* idx, void* sum, void* tile,
                  int rows, int lanes, int L, int iters, int threads,
                  cudaStream_t stream) {
  const size_t y_bytes = ((size_t)rows * L * sizeof(T) + 15) & ~(size_t)15;
  const size_t smem = y_bytes + (size_t)rows * L * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      gather_iter_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (lanes + L - 1) / L;
  if (blocks > 0 && rows > 0) {
    gather_iter_kernel<T, E><<<blocks, threads, smem, stream>>>(
        (const T*)x, idx, (T*)sum, (T*)tile, rows, lanes, L, iters, y_bytes);
  }
  return (int)cudaGetLastError();
}

// The smallest instance whose E holds rows * L elements on `threads`.
template <typename T>
static int launch_for(const void* x, const int* idx, void* sum, void* tile,
                      int rows, int lanes, int L, int iters, int threads,
                      cudaStream_t stream) {
  const int need = (rows * L + threads - 1) / threads;
  if (need <= 1)
    return launch<T, 1>(x, idx, sum, tile, rows, lanes, L, iters, threads,
                        stream);
  if (threads != GI_THREADS) return (int)cudaErrorInvalidValue;
#define GI_CASE(e)                                                        \
  if (need <= e)                                                          \
    return launch<T, e>(x, idx, sum, tile, rows, lanes, L, iters, threads, \
                        stream);
  GI_CASE(2) GI_CASE(4) GI_CASE(8) GI_CASE(16) GI_CASE(24)
  GI_CASE(GI_MAX_STAGE)
#undef GI_CASE
  return (int)cudaErrorInvalidValue;
}

// is_bf16: 0 -> float32 tile, 1 -> bfloat16 tile. The caller guarantees
// rows * L <= GI_MAX_STAGE * GI_THREADS (threads = GI_THREADS whenever the
// tile exceeds one element per thread) and that the tile plus its uint16
// offsets fit the block's shared memory.
extern "C" int gather_iter_launch(const void* x, const int* idx, void* sum,
                                  void* tile, int rows, int lanes, int L,
                                  int iters, int is_bf16, int threads,
                                  void* stream) {
  if (is_bf16)
    return launch_for<__nv_bfloat16>(x, idx, sum, tile, rows, lanes, L,
                                     iters, threads, (cudaStream_t)stream);
  return launch_for<float>(x, idx, sum, tile, rows, lanes, L, iters, threads,
                           (cudaStream_t)stream);
}
