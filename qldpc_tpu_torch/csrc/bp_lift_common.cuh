// What the two lifted min-sum kernels share: K1 (bp_lift_flood.cu,
// flooding) and K3 (bp_lift_layered.cu, time-layered). Both keep one shot's
// state in one thread block and compute every neighbour from the lift's
// quasi-cyclic structure; they differ only in the order of their passes.
//
// State of one shot (shared memory, or a per-shot slab in device memory for
// graphs too large for a block): the row states S[m], then the posteriors
// V[NB * P] in the internal column-slot order (pattern, t, x, y).
// Row state S[r] = {P1, P2, q-sign bits of slots 0-31, q-sign bits of slots
// 32-35 | syndrome bit << 8 | argmin}: the two products the row's update
// computed, P1 = (alpha*sgn)*m1 and P2 = (alpha*sgn)*m2, the sign of each
// edge's q and the first edge slot that reached m1. R of slot e is
// sign ? -P : P with P = (e == argmin) ? P2 : P1, the very product the
// update computed, so it is bit-equal to storing R. At tied minima
// m2 == m1, so every tied edge gets the magnitude the |q| == m1 rule gives.
//
// Neighbours: check row r = (t, x, y) meets edge slot e = (pattern pb,
// time offset o, rep-check cx, cy) at column slot r + chk_off[e] + wrap,
// and column position q at check row q + col_off[e] - wrap', where the
// wraps (ell*mm if x passes cx, mm if y passes cy) depend only on (x, y)
// and e: two ell*mm x MAX_EB byte tables in shared memory. The per-edge
// constants are a __grid_constant__ parameter; every edge loop is unrolled,
// so they are operands, not loads. Dead edge slots are no-ops rather than
// branches: they read a word inside the shot's state and fold
// |q| = BP_BIG, which moves neither m1, m2 nor argmin, and their sign bits
// are masked off.
//
// Bit-exactness with the plain PyTorch versions: built with -fmad=false;
// R = (alpha*sgn)*mag with the edge sign as a select; each posterior sums R
// in edge-slot order from zero, then adds the prior; the min1/min2 tie rule
// of the Pallas kernel; a sign is read from q + 0.0f, so -0.0 is not
// negative.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define BP_BIG 1e30f
// MAX_EB and FLOOD_THREADS are read from here by ops/bp_lift_cuda.py
#define MAX_EB 36  // edge slots a graph may have (35 in every BB code here)
#define NO_EDGE 63u
#define FLOOD_THREADS 512
#define FLOOD_BLOCKS_PER_SM 2
#define SMEM_PER_SM 233472  // bytes of the largest shared-memory carveout

// The lift's per-edge constants (mirrored by ops/bp_lift_cuda._FloodGraph),
// offsets in bytes. Slots past EB are dead everywhere (their live bits are
// 0) and address position 0.
struct FloodGraph {
  int chk_off[MAX_EB];   // 4 * (pb*P - o*ell*mm - cx*mm - cy)
  int col_off[MAX_EB];   // 16 * (o*ell*mm + cx*mm + cy)
  int pb_off[MAX_EB];    // 4 * pb * P
  int pb_last[MAX_EB];   // 1 on the last edge slot of its pattern
  int EB, NB, P, L;      // P = m = T*ell*mm, L = ell*mm
};

// Bytes of one shot's state: row states, then posteriors (at least 16
// bytes a position, so a dead edge slot's address, which may run up to one
// row-state region past either end of the posteriors, stays inside); a
// multiple of 16 so every shot's slab of the device-memory branch stays
// aligned. The address depends only on the row and the slot, not on which
// thread walks the row.
__host__ __device__ inline size_t state_bytes(const FloodGraph& g) {
  const size_t v = (size_t)g.NB * g.P * 4, s = (size_t)g.P * 16;
  return (s + (v > s ? v : s) + 15) & ~(size_t)15;
}

// Bytes of the two wrap tables (check side, then column side), L rows of
// MAX_EB bytes each, rounded to 16.
__host__ __device__ inline size_t wrap_bytes(const FloodGraph& g) {
  return ((size_t)2 * g.L * MAX_EB + 15) & ~(size_t)15;
}

template <typename T>
__device__ __forceinline__ T ld(const unsigned char* p) {
  return *reinterpret_cast<const T*>(p);
}

// Bit b of an edge-slot word holds slot 32*w + 31 - b (first slot
// highest), so slot e's bit is tested as the sign of word << (e & 31).
__device__ __forceinline__ unsigned top_bit(unsigned w, int e) {
  return (w << (e & 31)) & 0x80000000u;
}

// The kernels' inputs beyond the graph:
// pos_info[2p] = {live bits of row p's edge slots 0-31, 32-35, x*mm + y};
// pos_info[2p+1] = the same for the edge slots at column position p.
// wrap[xy*MAX_EB + e] = ell*mm*(x < cx) + mm*(y < cy) of slot e at a row of
// (x, y); then wrap[L*MAX_EB + xy*MAX_EB + e] = ell*mm*(x >= ell - cx) +
// mm*(y >= mm - cy) at a column position of (x, y).

// A shot's start: zero products and signs (they rebuild R = 0 exactly) with
// the syndrome bits, the priors as posteriors, and the wrap tables.
__device__ __forceinline__ void init_shot(const FloodGraph& gr,
                                          const int8_t* __restrict__ s_b,
                                          const float* __restrict__ prior_grid,
                                          const int* __restrict__ wrap,
                                          uint4* S, float* V,
                                          unsigned char* wt, int tid, int nt) {
  const int m = gr.P;
  for (int r = tid; r < m; r += nt)
    S[r] = make_uint4(0u, 0u, 0u, (s_b[r] ? 1u << 8 : 0u) | NO_EDGE);
  for (int i = tid; i < gr.NB * m; i += nt) V[i] = prior_grid[i];
  for (int i = tid; i < (int)(wrap_bytes(gr) / 4); i += nt)
    reinterpret_cast<int*>(wt)[i] = wrap[i];
}

// One check row's walk over its edge slots: the old R rebuilt from S[r],
// Q = clip(V - R) (V itself when !clip_q), m1, m2, argmin and the q signs;
// when `update`, the new row state in S[r]. Returns 1 when the parity of
// the row's posterior signs differs from its syndrome bit (a caller that
// discards it pays nothing for it).
__device__ __forceinline__ int check_row(const FloodGraph& gr,
                                         const int4* __restrict__ pos_info,
                                         const unsigned char* wt,
                                         const unsigned char* Vb, uint4* S,
                                         int r, bool clip_q, bool update,
                                         float a, float clip, float nclip) {
  const int4 pi = __ldg(pos_info + 2 * r);
  const unsigned lw0 = (unsigned)pi.x, lw1 = (unsigned)pi.y;
  const unsigned char* wr = wt + pi.z * MAX_EB;
  const unsigned char* Vr = Vb + 4 * r;
  const uint4 st = S[r];
  const float p1o = __uint_as_float(st.x), p2o = __uint_as_float(st.y);
  float m1 = BP_BIG, m2 = BP_BIG;
  unsigned amin = NO_EDGE;
  // sign bits of q and of the posteriors, shifted in slot by slot;
  // +0.0f turns a -0.0 into +0.0, so a sign bit means < 0 exactly
  unsigned sq0 = 0u, sq1 = 0u, sv0 = 0u, sv1 = 0u;
#pragma unroll
  for (int e = 0; e < MAX_EB; ++e) {
    const bool live = top_bit(e < 32 ? lw0 : lw1, e);
    // a dead slot reads a word of this shot's state and folds
    // |q| = BP_BIG, which moves neither m1, m2 nor argmin
    const float v = ld<float>(Vr + 4 * (int)wr[e] + gr.chk_off[e]);
    // old R: the row's product for this slot, with its q sign
    const float po = ((st.w ^ (unsigned)e) & 63u) == 0u ? p2o : p1o;
    const float ro = __uint_as_float(
        __float_as_uint(po) ^ top_bit(e < 32 ? st.z : st.w, e));
    const float q = clip_q ? fminf(fmaxf(v - ro, nclip), clip) : v;
    const float aq = live ? fabsf(q) : BP_BIG;
    if (aq < m1) amin = (unsigned)e;
    m2 = fminf(m2, fmaxf(aq, m1));
    m1 = fminf(m1, aq);
    const unsigned qb = __float_as_uint(q + 0.f);
    const unsigned vb = __float_as_uint(v + 0.f);
    if (e < 32) {
      sq0 = __funnelshift_l(qb, sq0, 1);
      sv0 = __funnelshift_l(vb, sv0, 1);
    } else {
      sq1 = __funnelshift_l(qb, sq1, 1);
      sv1 = __funnelshift_l(vb, sv1, 1);
    }
  }
  // first slot to the top bit, dead slots cleared
  const unsigned sg0 = sq0 & lw0;
  const unsigned sg1 = (sq1 << (64 - MAX_EB)) & lw1;
  const unsigned sbit = (st.w >> 8) & 1u;
  const int vnegs = __popc(sv0 & lw0) + __popc((sv1 << (64 - MAX_EB)) & lw1);
  if (update) {
    const int negs = __popc(sg0) + __popc(sg1);
    const float sgn = (float)(1 - 2 * (negs & 1)) * (float)(1 - 2 * (int)sbit);
    const float as = a * sgn;
    S[r] = make_uint4(__float_as_uint(as * m1), __float_as_uint(as * m2), sg0,
                      sg1 | (sbit << 8) | amin);
  }
  return (vnegs & 1) != (int)sbit;
}

// The posterior-sign parity of check row r against its syndrome bit alone:
// check_row's parity without the min, the signs of q or the store.
__device__ __forceinline__ int row_parity(const FloodGraph& gr,
                                          const int4* __restrict__ pos_info,
                                          const unsigned char* wt,
                                          const unsigned char* Vb,
                                          const uint4* S, int r) {
  const int4 pi = __ldg(pos_info + 2 * r);
  const unsigned char* wr = wt + pi.z * MAX_EB;
  const unsigned char* Vr = Vb + 4 * r;
  unsigned sv0 = 0u, sv1 = 0u;
#pragma unroll
  for (int e = 0; e < MAX_EB; ++e) {
    const float v = ld<float>(Vr + 4 * (int)wr[e] + gr.chk_off[e]);
    const unsigned vb = __float_as_uint(v + 0.f);
    if (e < 32)
      sv0 = __funnelshift_l(vb, sv0, 1);
    else
      sv1 = __funnelshift_l(vb, sv1, 1);
  }
  const unsigned sbit = (reinterpret_cast<const unsigned*>(S + r)[3] >> 8) & 1u;
  const int vnegs = __popc(sv0 & (unsigned)pi.x)
                    + __popc((sv1 << (64 - MAX_EB)) & (unsigned)pi.y);
  return (vnegs & 1) != (int)sbit;
}

// Variable pass at column position q: each pattern's sum of the committed R
// in edge-slot order, stored at its last slot, then the prior added.
__device__ __forceinline__ void column_update(
    const FloodGraph& gr, const int4* __restrict__ pos_info,
    const unsigned char* wt, unsigned char* Vb, const uint4* S,
    const float* __restrict__ prior_grid, int q) {
  const int m = gr.P;
  float* V = reinterpret_cast<float*>(Vb);
  const int4 pi = __ldg(pos_info + 2 * q + 1);
  const unsigned lw0 = (unsigned)pi.x, lw1 = (unsigned)pi.y;
  const unsigned char* wq = wt + gr.L * MAX_EB + pi.z * MAX_EB;
  const unsigned char* Sq = reinterpret_cast<const unsigned char*>(S) + 16 * q;
  unsigned char* Vq = Vb + 4 * q;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < MAX_EB; ++e) {
    const bool live = top_bit(e < 32 ? lw0 : lw1, e);
    const uint4 st = ld<uint4>(Sq - 16 * (int)wq[e] + gr.col_off[e]);
    const unsigned p = ((st.w ^ (unsigned)e) & 63u) == 0u ? st.y : st.x;
    const float rr = __uint_as_float(p ^ top_bit(e < 32 ? st.z : st.w, e));
    if (live) acc = acc + rr;
    if (gr.pb_last[e]) {
      *reinterpret_cast<float*>(Vq + gr.pb_off[e]) = acc;
      acc = 0.f;
    }
  }
  for (int pb = 0; pb < gr.NB; ++pb)
    V[pb * m + q] = __ldg(prior_grid + pb * m + q) + V[pb * m + q];
}

// Epilogue: posteriors in original column order; edge-free (residual)
// columns keep the prior. Converged shots stopped at their converging
// iteration (sweep), so V holds the frozen posterior and hard = V < 0.
__device__ __forceinline__ void write_outputs(
    const float* V, const int* __restrict__ out_gather,
    const uint8_t* __restrict__ residual, const float* __restrict__ prior,
    float* __restrict__ values, int8_t* __restrict__ hard,
    uint8_t* __restrict__ conv, int* __restrict__ iters, int b, int n,
    int maxIter, int conv_it, int tid, int nt) {
  for (int j = tid; j < n; j += nt) {
    const float v = residual[j] ? prior[j] : V[out_gather[j]];
    values[(size_t)b * n + j] = v;
    hard[(size_t)b * n + j] = v < 0.f;
  }
  if (tid == 0) {
    conv[b] = conv_it >= 0;
    iters[b] = conv_it >= 0 ? conv_it : maxIter - 1;
  }
}

// Dynamic shared memory of one block: the wrap tables, and the shot's
// state unless it lives in device memory.
static int smem_bytes(const FloodGraph& g, bool dev_state) {
  return (int)(wrap_bytes(g) + (dev_state ? 0 : state_bytes(g)));
}

// Shared memory for `smem` bytes a block at FLOOD_BLOCKS_PER_SM blocks an
// SM (1 KB a block is reserved), the rest of the SM's 256 KB left to the
// L1 cache, which then holds pos_info and the priors.
template <typename Kernel>
static cudaError_t configure(Kernel k, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long need = (long)FLOOD_BLOCKS_PER_SM * (smem + 1024);
  const int pct = (int)((need * 100 + SMEM_PER_SM - 1) / SMEM_PER_SM);
  return cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              pct < 100 ? pct : 100);
}

// One shot's state bytes, the wrap tables' bytes and a block's dynamic
// shared memory with the state in it: out[0..2]. The host sizes the
// device-memory slab and chooses the branch from these.
static int bp_lift_sizes(const FloodGraph* graph, long long* out) {
  out[0] = (long long)state_bytes(*graph);
  out[1] = (long long)wrap_bytes(*graph);
  out[2] = smem_bytes(*graph, false);
  return 0;
}

// Registers and local (spill) bytes a thread, dynamic shared memory bytes
// a block and blocks per SM of kernel `k`, for the state in shared memory
// (dev_state 0) or device memory (1): out[0..3].
template <typename Kernel>
static int bp_lift_info(Kernel k, const FloodGraph* graph, int threads,
                        int dev_state, int* out) {
  if (graph->EB > MAX_EB) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(*graph, dev_state);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err == cudaSuccess) err = configure(k, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], k,
                                                            threads, smem);
}

// One block per shot on `stream`; the state in `scratch` when it is given.
template <typename Kernel>
static int bp_lift_launch(Kernel k, const FloodGraph* graph,
                          const int8_t* syn, const float* prior_grid,
                          const int4* pos_info, const int* wrap,
                          const float* alpha, const int* out_gather,
                          const uint8_t* residual, const float* prior,
                          float* values, int8_t* hard, uint8_t* conv,
                          int* iters, unsigned char* scratch, int B, int n,
                          int maxIter, float clip, int threads,
                          void* stream) {
  if (graph->EB > MAX_EB || threads > FLOOD_THREADS)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(*graph, scratch != nullptr);
  cudaError_t err = configure(k, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    k<<<B, threads, smem, (cudaStream_t)stream>>>(
        *graph, syn, prior_grid, pos_info, wrap, alpha, out_gather, residual,
        prior, values, hard, conv, iters, scratch, n, maxIter, clip, -clip);
  }
  return (int)cudaGetLastError();
}
