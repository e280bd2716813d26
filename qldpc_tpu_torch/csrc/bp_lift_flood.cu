// Flooding normalized min-sum BP on a lifted BB decoding graph, all
// iterations of one shot in one thread block, several shots per SM.
//
// Replaces: qldpc_tpu/ops/bp_lift_pallas.py::_bp_kernel with
// schedule="flooding" (the pallas_call in decode_batch_lift_pallas). The
// Pallas kernel moves messages between check and column layouts with static
// rolls because Mosaic has no dynamic gather; here each thread computes its
// neighbours from the lift's quasi-cyclic structure.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 checks,
// EB = 35 edge slots, NB = 10 base patterns, B = 1024 shots): device-memory
// traffic is one syndrome read and one posterior/decision write per shot
// (~46 MB, ~14 us), while the arithmetic is ~17 float32 operations per live
// edge per iteration over ~30.7k edges and every iteration a shot runs, so
// operations bound it (~0.29 ms a call). In practice the kernel is bound
// by instruction issue: compares, selects, min/max and bit operations run
// at half the float32 add rate, and each edge of each pass needs a dozen
// or more of them. The design keeps everything else off that path:
//
// 1. Compressed check messages. A check row keeps the two products its
//    update computes, P1 = (alpha*sgn)*m1 and P2 = (alpha*sgn)*m2, the
//    q-sign bit of each edge and the first edge slot that reaches m1
//    (argmin); R of edge e is rebuilt as sign ? -P : P with
//    P = (e == argmin) ? P2 : P1, the very product the update computed, so
//    it is bit-equal to storing R. At tied minima m2 == m1, so every tied
//    edge gets the same magnitude as under the |q| == m1 rule. argmin is
//    found in the same walk that finds m1, so the check pass reads each
//    posterior once and never stores Q. One row's state is 16 bytes (one
//    shared-memory load in the variable pass). Per shot at [[144]]: 16 KB
//    of row states plus 40 KB of posteriors (the first design kept R as
//    35 x 1008 floats, 181 KB).
// 2. Neighbours computed on chip. Check row r = (t, x, y) meets edge slot
//    e = (pattern pb, time offset o, rep-check cx, cy) at column slot
//    r + chk_off[e] + wrap, and column position q at check row
//    q + col_off[e] - wrap', where the wraps (ell*mm if x passes cx, mm if
//    y passes cy) depend only on (x, y) and e: two ell*mm x 36 byte tables
//    in shared memory (5 KB at [[144]]). The per-edge constants are a
//    __grid_constant__ parameter; every edge loop is unrolled, so they are
//    operands, not loads. Each position's live bits and (x, y) are one
//    16-byte load per pass, from L1: the shared-memory carveout is sized to
//    the resident blocks so the tables and priors stay cached.
// 3. Several shots per SM. A block of FLOOD_THREADS threads holds one
//    shot; thread p handles check row p and column position p (and
//    p + FLOOD_THREADS, ...) in the two passes. Two blocks share an SM at
//    [[144]] (62 KB of shared memory and 64 registers a thread each: with
//    more blocks at fewer registers the unrolled loops spill), so one
//    shot's barrier waits are filled by the other, and each block still
//    stops at its own shot's convergence.
// Graphs whose state exceeds the 227 KB a block may hold use a per-shot
// scratch slab in device memory through the same code.
//
// Bit-exactness with the plain PyTorch version (and the Pallas kernel in
// interpret mode): built with -fmad=false; R = (alpha*sgn)*mag with the
// edge sign as a select; each posterior sums R in edge-slot order from
// zero, then adds the prior; the min1/min2 tie rule of the Pallas kernel.
// Dead edge slots are no-ops rather than branches: they read a word inside
// the shot's state and fold |q| = BP_BIG, which moves neither m1, m2 nor
// argmin, and their sign bits are masked off.
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
// offsets in bytes. Every edge loop is unrolled, so each constant is an
// operand read from the parameter bank, not a load. Slots past EB are
// dead everywhere (their live bits are 0) and address position 0.
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
// aligned.
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

// Every edge loop walks all MAX_EB slots. DEV_STATE: the per-shot state
// lives in the scratch slab in device memory (graphs too
// large for shared memory); else in shared memory, addressed as such so
// every state access is a shared-memory instruction.
template <bool DEV_STATE>
__global__ void __launch_bounds__(FLOOD_THREADS, FLOOD_BLOCKS_PER_SM)
bp_flood_kernel(const __grid_constant__ FloodGraph gr,
                const int8_t* __restrict__ syn,        // (B, m)
                const float* __restrict__ prior_grid,  // (NB * P)
                const int4* __restrict__ pos_info,     // (m, 2) see below
                const int* __restrict__ wrap,          // wrap tables
                const float* __restrict__ alpha,       // (maxIter)
                const int* __restrict__ out_gather,    // (n) slot
                const uint8_t* __restrict__ residual,  // (n)
                const float* __restrict__ prior,       // (n)
                float* __restrict__ values,            // (B, n)
                int8_t* __restrict__ hard,             // (B, n)
                uint8_t* __restrict__ conv,            // (B)
                int* __restrict__ iters,               // (B)
                unsigned char* __restrict__ scratch,   // DEV_STATE only
                int n, int maxIter, float clip, float nclip) {
  // pos_info[2p] = {live bits of row p's edge slots 0-31, 32-35, x*mm + y};
  // pos_info[2p+1] = the same for the edge slots at column position p.
  // wrap[xy*MAX_EB + e] = ell*mm*(x < cx) + mm*(y < cy) of slot e at a row of
  // (x, y); then wrap[L*MAX_EB + xy*MAX_EB + e] = ell*mm*(x >= ell - cx) +
  // mm*(y >= mm - cy) at a column position of (x, y).
  // Row state S[r] = {P1, P2, q-sign bits of slots 0-31, q-sign bits of
  // slots 32-35 | syndrome bit << 8 | argmin}.
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m = gr.P;
  unsigned char* base;
  unsigned char* wt;
  if constexpr (DEV_STATE) {
    base = scratch + (size_t)b * state_bytes(gr);
    wt = smem;
  } else {
    base = smem;
    wt = smem + state_bytes(gr);
  }
  uint4* S = reinterpret_cast<uint4*>(base);              // (m) row states
  unsigned char* Vb = base + (size_t)m * 16;              // (NB * P) f32
  float* V = reinterpret_cast<float*>(Vb);
  const int8_t* s_b = syn + (size_t)b * m;

  // zero products and signs rebuild R = 0 exactly
  for (int r = tid; r < m; r += nt)
    S[r] = make_uint4(0u, 0u, 0u, (s_b[r] ? 1u << 8 : 0u) | NO_EDGE);
  for (int i = tid; i < gr.NB * m; i += nt) V[i] = prior_grid[i];
  for (int i = tid; i < (int)(wrap_bytes(gr) / 4); i += nt)
    reinterpret_cast<int*>(wt)[i] = wrap[i];
  __syncthreads();

  int conv_it = -1;
  for (int it = 0;; ++it) {
    // Check pass: parity of the current posteriors (the convergence test
    // of iteration it-1) and, while iterations remain, the new row state.
    const bool update = it < maxIter;
    const float a = update ? alpha[it] : 0.f;
    int bad = 0;
    for (int r = tid; r < m; r += nt) {
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
        // iteration 0 sends the prior itself (no clip)
        const float q = it > 0 ? fminf(fmaxf(v - ro, nclip), clip) : v;
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
      const int vnegs =
          __popc(sv0 & lw0) + __popc((sv1 << (64 - MAX_EB)) & lw1);
      bad |= (vnegs & 1) != (int)sbit;
      if (update) {
        const int negs = __popc(sg0) + __popc(sg1);
        const float sgn = (float)(1 - 2 * (negs & 1))
                          * (float)(1 - 2 * (int)sbit);
        const float as = a * sgn;
        S[r] = make_uint4(__float_as_uint(as * m1), __float_as_uint(as * m2),
                          sg0, sg1 | (sbit << 8) | amin);
      }
    }
    const int any_bad = __syncthreads_or(bad);
    if (it > 0 && !any_bad) {
      conv_it = it - 1;
      break;
    }
    if (!update) break;
    // Variable pass: each pattern's sum of R in edge-slot order, stored at
    // its last slot; then the priors added.
    const unsigned char* Sb = reinterpret_cast<const unsigned char*>(S);
    for (int q = tid; q < m; q += nt) {
      const int4 pi = __ldg(pos_info + 2 * q + 1);
      const unsigned lw0 = (unsigned)pi.x, lw1 = (unsigned)pi.y;
      const unsigned char* wq = wt + gr.L * MAX_EB + pi.z * MAX_EB;
      const unsigned char* Sq = Sb + 16 * q;
      unsigned char* Vq = Vb + 4 * q;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < MAX_EB; ++e) {
        const bool live = top_bit(e < 32 ? lw0 : lw1, e);
        const uint4 st = ld<uint4>(Sq - 16 * (int)wq[e] + gr.col_off[e]);
        const unsigned p = ((st.w ^ (unsigned)e) & 63u) == 0u ? st.y : st.x;
        const float rr =
            __uint_as_float(p ^ top_bit(e < 32 ? st.z : st.w, e));
        if (live) acc = acc + rr;
        if (gr.pb_last[e]) {
          *reinterpret_cast<float*>(Vq + gr.pb_off[e]) = acc;
          acc = 0.f;
        }
      }
      for (int pb = 0; pb < gr.NB; ++pb)
        V[pb * m + q] = __ldg(prior_grid + pb * m + q) + V[pb * m + q];
    }
    __syncthreads();
  }

  // Epilogue: posteriors in original column order; edge-free (residual)
  // columns keep the prior. Converged shots stopped at their converging
  // iteration, so V holds the frozen posterior and hard = V < 0.
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

using FloodKernel = decltype(&bp_flood_kernel<false>);

// Dynamic shared memory of one block: the wrap tables, and the shot's
// state unless it lives in device memory.
static int smem_bytes(const FloodGraph& g, bool dev_state) {
  return (int)(wrap_bytes(g) + (dev_state ? 0 : state_bytes(g)));
}

// Shared memory for `smem` bytes a block at FLOOD_BLOCKS_PER_SM blocks an
// SM (1 KB a block is reserved), the rest of the SM's 256 KB left to the
// L1 cache, which then holds pos_info and the priors.
static cudaError_t configure(FloodKernel k, int smem) {
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
extern "C" int bp_flood_sizes(const FloodGraph* graph, long long* out) {
  out[0] = (long long)state_bytes(*graph);
  out[1] = (long long)wrap_bytes(*graph);
  out[2] = smem_bytes(*graph, false);
  return 0;
}

// Registers and local (spill) bytes a thread, dynamic shared memory bytes
// a block and blocks per SM, for the state in shared memory (dev_state 0)
// or device memory (1): out[0..3].
extern "C" int bp_flood_info(const FloodGraph* graph, int threads,
                             int dev_state, int* out) {
  if (graph->EB > MAX_EB) return (int)cudaErrorInvalidValue;
  FloodKernel k = dev_state ? bp_flood_kernel<true> : bp_flood_kernel<false>;
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

extern "C" int bp_flood_launch(
    const FloodGraph* graph, const int8_t* syn, const float* prior_grid,
    const int4* pos_info, const int* wrap, const float* alpha,
    const int* out_gather, const uint8_t* residual, const float* prior,
    float* values, int8_t* hard, uint8_t* conv, int* iters,
    unsigned char* scratch, int B, int n, int maxIter, float clip,
    int threads, void* stream) {
  if (graph->EB > MAX_EB || threads > FLOOD_THREADS)
    return (int)cudaErrorInvalidValue;
  FloodKernel k = scratch ? bp_flood_kernel<true> : bp_flood_kernel<false>;
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
