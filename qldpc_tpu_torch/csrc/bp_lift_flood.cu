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
//
// The state layout, the row update, the variable pass and the host-side
// sizing and launch live in bp_lift_common.cuh, shared with K3.
#include "bp_lift_common.cuh"

// One shot a block; thread p walks check rows p, p + nt, ... in the check
// pass and column positions p, p + nt, ... in the variable pass.
template <bool DEV_STATE>
__global__ void __launch_bounds__(FLOOD_THREADS, FLOOD_BLOCKS_PER_SM)
bp_flood_kernel(const __grid_constant__ FloodGraph gr,
                const int8_t* __restrict__ syn,        // (B, m)
                const float* __restrict__ prior_grid,  // (NB * P)
                const int4* __restrict__ pos_info,     // (m, 2)
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
  init_shot(gr, syn + (size_t)b * m, prior_grid, wrap, S, V, wt, tid, nt);
  __syncthreads();

  int conv_it = -1;
  for (int it = 0;; ++it) {
    // Check pass: parity of the current posteriors (the convergence test
    // of iteration it-1) and, while iterations remain, the new row state;
    // iteration 0 sends the prior itself (no clip).
    const bool update = it < maxIter;
    const float a = update ? alpha[it] : 0.f;
    int bad = 0;
    for (int r = tid; r < m; r += nt)
      bad |= check_row(gr, pos_info, wt, Vb, S, r, it > 0, update, a, clip,
                       nclip);
    const int any_bad = __syncthreads_or(bad);
    if (it > 0 && !any_bad) {
      conv_it = it - 1;
      break;
    }
    if (!update) break;
    for (int q = tid; q < m; q += nt)
      column_update(gr, pos_info, wt, Vb, S, prior_grid, q);
    __syncthreads();
  }
  write_outputs(V, out_gather, residual, prior, values, hard, conv, iters, b,
                n, maxIter, conv_it, tid, nt);
}

extern "C" int bp_flood_sizes(const FloodGraph* graph, long long* out) {
  return bp_lift_sizes(graph, out);
}

extern "C" int bp_flood_info(const FloodGraph* graph, int threads,
                             int dev_state, int* out) {
  return bp_lift_info(
      dev_state ? bp_flood_kernel<true> : bp_flood_kernel<false>, graph,
      threads, dev_state, out);
}

extern "C" int bp_flood_launch(
    const FloodGraph* graph, const int8_t* syn, const float* prior_grid,
    const int4* pos_info, const int* wrap, const float* alpha,
    const int* out_gather, const uint8_t* residual, const float* prior,
    float* values, int8_t* hard, uint8_t* conv, int* iters,
    unsigned char* scratch, int B, int n, int maxIter, float clip,
    int threads, void* stream) {
  return bp_lift_launch(
      scratch ? bp_flood_kernel<true> : bp_flood_kernel<false>, graph, syn,
      prior_grid, pos_info, wrap, alpha, out_gather, residual, prior, values,
      hard, conv, iters, scratch, B, n, maxIter, clip, threads, stream);
}
