// R1: a batch's BP residual syndrome and its weight, from the columns the
// hard decision sets. For shot b and a decoding matrix H (m, n):
//
//   residual[b, r] = syndrome[b, r] ^ (XOR of H[r, j] over the columns j
//                                      whose hard[b, j] is odd)
//   weight[b]      = sum over r of residual[b, r]
//
// residual is (B, m) int32 and weight (B,) int32: the layout the OSD's
// eliminators and its ordering read.
//
// Replaces: no Pallas kernel. It stands in for the JAX package's XLA
// product `hard @ HT` (a bf16 MXU product of the (B, n) hard decision with
// the dense (n, m) transpose of H) in the OSD's ordering
// (qldpc_tpu/parallel/engine.py:236-240) and in osd_batch's residual
// (qldpc_tpu/ops/osd.py:173). Their port, a float32 product on 0/1
// operands (exact: its counts stay below 2^24), is R1's plain version,
// ops/osd_cuda.py::bp_residual_plain.
//
// Bound on the H100: bytes. The hard decision, one byte a column a shot,
// is read once (at [[144,12,12]] and a 4,096-shot pool 36.0 MB, 10.7 us
// over 3.35 TB/s), the syndrome once and the residual written once (B m
// and 4 B m bytes). The work is sparse: a shot sets about as many columns
// as its error has flips (~60 of 8,785 at [[144]] p = 0.004), and a column
// holds at most a few rows, so the CSC (H's rows by column, a few hundred
// KB) stays in L2 and a shot XORs a few hundred rows.
//
// Design: one block a shot, so that a pool of 1,024-8,192 shots keeps the
// card's loads in flight. The block's threads scan the shot's hard row in
// 16-byte streaming loads, two in flight a thread (the row's unaligned
// head and tail a byte a thread). A thread that finds a set byte XORs that
// column's rows into the shot's bitset of ceil(m/32) words in shared
// memory (shared-memory atomics). After a barrier the threads write the
// residual, each row's bit XOR its syndrome byte, coalesced, and sum it a
// warp at a time into the weight. With a counter (telemetry on), each warp
// adds the set columns it scanned with one atomic; without, it is null.
#include <cuda_runtime.h>
#include <stdint.h>

#define BR_THREADS 256
#define BR_MAX_WORDS (48 * 1024 / 4 - 1)  // the bitset and the weight

struct BrShot {
  const int* colptr;  // (n + 1): column j's rows at [colptr[j], colptr[j+1])
  const int* rows;
  unsigned* bits;     // the shot's bitset in shared memory
};

__device__ __forceinline__ void br_column(const BrShot& s, int j) {
  const int e1 = __ldg(s.colptr + j + 1);
  for (int e = __ldg(s.colptr + j); e < e1; ++e) {
    const int r = __ldg(s.rows + e);
    atomicXor(s.bits + (r >> 5), 1u << (r & 31));
  }
}

// The odd bytes of four hard bytes w, the first at column j; returns them.
__device__ __forceinline__ int br_word(const BrShot& s, uint32_t w, int j) {
  w &= 0x01010101u;
  int ones = 0;
  while (w) {
    const int byte = (__ffs(w) - 1) >> 3;
    w &= w - 1;
    br_column(s, j + byte);
    ++ones;
  }
  return ones;
}

__device__ __forceinline__ int br_chunk(const BrShot& s, uint4 v, int j) {
  if (!(v.x | v.y | v.z | v.w)) return 0;
  return br_word(s, v.x, j) + br_word(s, v.y, j + 4) +
         br_word(s, v.z, j + 8) + br_word(s, v.w, j + 12);
}

__global__ void __launch_bounds__(BR_THREADS)
bp_residual_kernel(const int8_t* __restrict__ hard,
                   const int8_t* __restrict__ syndrome,
                   const int* __restrict__ colptr,
                   const int* __restrict__ rows, int n, int m,
                   int* __restrict__ residual, int* __restrict__ weight,
                   unsigned long long* ones_out) {
  extern __shared__ unsigned bits[];  // ceil(m/32) words, then the weight
  const int t = threadIdx.x;
  const int words = (m + 31) >> 5;
  for (int i = t; i <= words; i += BR_THREADS) bits[i] = 0;
  __syncthreads();
  const long long b = blockIdx.x;
  const int8_t* h = hard + b * n;
  const BrShot s{colptr, rows, bits};
  // bytes before the row's first 16-byte boundary, the whole chunks, and
  // the bytes after the last
  const int head = min((int)((16 - ((uintptr_t)h & 15)) & 15), n);
  const int chunks = (n - head) >> 4;
  const int tail = head + (chunks << 4);
  int ones = 0;
  if (t < head && (h[t] & 1)) {
    br_column(s, t);
    ++ones;
  }
  if (tail + t < n && (h[tail + t] & 1)) {
    br_column(s, tail + t);
    ++ones;
  }
  const uint4* v = reinterpret_cast<const uint4*>(h + head);
  for (int c = t; c < chunks; c += 2 * BR_THREADS) {
    const bool two = c + BR_THREADS < chunks;
    const uint4 a = __ldcs(v + c);
    const uint4 a2 = two ? __ldcs(v + c + BR_THREADS) : make_uint4(0, 0, 0, 0);
    ones += br_chunk(s, a, head + 16 * c);
    ones += br_chunk(s, a2, head + 16 * (c + BR_THREADS));
  }
  __syncthreads();
  const int8_t* syn = syndrome + b * m;
  int* res = residual + b * m;
  int sum = 0;
  for (int r = t; r < m; r += BR_THREADS) {
    const int x = (int)syn[r] ^ (int)((bits[r >> 5] >> (r & 31)) & 1u);
    res[r] = x;
    sum += x;
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  if ((t & 31) == 0 && sum) atomicAdd(bits + words, (unsigned)sum);
  if (ones_out) {
    ones = __reduce_add_sync(0xffffffffu, ones);
    if ((t & 31) == 0 && ones)
      atomicAdd(ones_out, (unsigned long long)ones);
  }
  __syncthreads();
  if (t == 0) weight[b] = (int)bits[words];
}

// hard (B, n) and syndrome (B, m) int8, contiguous; H's CSC (colptr n + 1
// entries, rows in [0, m)); residual (B, m) and weight (B,) int32,
// contiguous. ones: one device uint64 to add the scanned set columns to,
// or null.
extern "C" int bp_residual_launch(const void* hard, const void* syndrome,
                                  const void* colptr, const void* rows,
                                  int batch, int n, int m, void* residual,
                                  void* weight, void* ones, void* stream) {
  const int words = (m + 31) / 32;
  if (batch < 0 || n < 0 || m < 0 || words > BR_MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  if (batch > 0)
    bp_residual_kernel<<<batch, BR_THREADS, (words + 1) * sizeof(unsigned),
                         (cudaStream_t)stream>>>(
        (const int8_t*)hard, (const int8_t*)syndrome, (const int*)colptr,
        (const int*)rows, n, m, (int*)residual, (int*)weight,
        (unsigned long long*)ones);
  return (int)cudaGetLastError();
}
