// Time-layered normalized min-sum BP on a lifted BB decoding graph, all
// sweeps of one shot in one thread block, several shots per SM.
//
// Replaces: qldpc_tpu/ops/bp_lift_pallas.py::_bp_kernel with
// schedule="layered" (layered_body, the pallas_call in
// decode_batch_lift_pallas). A sweep is two half-updates: the checks whose
// time slice t = row / (ell*mm) is even, then the odd ones. A half-update
// computes Q = clip(V - R) on its layer's checks (clipped from the very
// first half, unlike K1's first iteration), commits their new R while the
// other layer's R stays as it was, and every posterior is rebuilt from all
// committed R before the next half. Convergence is tested once a sweep.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 checks,
// EB = 35 edge slots, B = 1024 shots): device-memory traffic is one
// syndrome read and one posterior/decision write per shot (~46 MB, ~14 us);
// each sweep does ~18 float32 operations per live edge (one check update,
// two posterior rebuilds, one parity test) over ~30.7k edges and every
// sweep a shot runs, so operations bound it (~0.28 ms a call). As in K1,
// the kernel is bound in practice by instruction issue (compares, selects,
// min/max and bit operations at half the float32 add rate), and by its
// four block barriers a sweep (five when the even rows are satisfied). The
// design is K1's (bp_lift_common.cuh):
//
// 1. Compressed check state. Each row keeps 16 bytes: P1, P2, the q-sign
//    bits, the syndrome bit and the argmin slot; R is rebuilt from them bit
//    for bit. A half leaves the other layer's row states untouched. Per
//    shot at [[144]]: 56,448 bytes of state (R as floats took 181 KB, one
//    shot per SM); at [[288]] 161,280 bytes, in shared memory.
// 2. Neighbours computed on chip from the per-edge constants, the wrap
//    tables and each position's live bits, every edge loop unrolled, dead
//    slots no-ops.
// 3. Each half-pass maps its threads onto its own layer's rows: thread p
//    of half L walks layer indices i = p, p + nt, ... and takes row
//    (2*(i / Ls) + L)*Ls + i % Ls, Ls = ell*mm, so no thread idles on the
//    other layer's rows (504 rows a layer at [[144]]: one a thread). With
//    T time slices the even layer holds ceil(T/2) of them, the odd one
//    floor(T/2). The parity test of sweep s-1 rides in sweep s's first
//    half: the update walk of each even row folds its posterior signs in;
//    when __syncthreads_or finds every even row satisfied, each thread
//    also walks its odd rows for their posterior signs alone (no min, no
//    store), and a second __syncthreads_or gives the exit. Most sweeps of
//    an unconverged shot skip that walk.
// 4. Several shots per SM: K1's block of FLOOD_THREADS threads at 64
//    registers, two blocks an SM, the shared-memory carveout sized to the
//    resident blocks so L1 keeps pos_info and the priors.
// The two posterior rebuilds are K1's variable pass: every posterior summed
// from all committed R in edge-slot order, then the prior (an incremental
// V += dR would not be bit-exact). Graphs whose state exceeds the 227 KB a
// block may hold use a per-shot scratch slab in device memory through the
// same code.
//
// Bit-exactness with the plain PyTorch version (and the Pallas kernel in
// interpret mode): as K1 (bp_lift_common.cuh), with Q clipped in every
// half and R = 0 rebuilt exactly from the zero products before the first.
#include "bp_lift_common.cuh"

// Rows of layer L (0: the ceil(T/2) even time slices, 1: the floor(T/2)
// odd ones) of m = T*Ls rows. Recomputed where used: kept live across the
// sweep loop, the two sizes cost the device-memory branch a spill.
__device__ __forceinline__ int layer_size(int m, int Ls, int L) {
  const int n_odd = m / (2 * Ls) * Ls;
  return L ? n_odd : m - n_odd;
}

// Check row of layer index i in layer L.
__device__ __forceinline__ int layer_row(int i, int L, int Ls) {
  return i + (i / Ls + L) * Ls;
}

template <bool DEV_STATE>
__global__ void __launch_bounds__(FLOOD_THREADS, FLOOD_BLOCKS_PER_SM)
bp_layered_kernel(const __grid_constant__ FloodGraph gr,
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
  const int Ls = gr.L;
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
  for (int sw = 0;; ++sw) {
    // First half (even time slices), with the parity of the posteriors
    // left by sweep sw-1 (its convergence test): the even rows' parity
    // rides in their update walk; the odd rows are walked for their parity
    // only when every even row is satisfied. The even rows' new state does
    // not reach V when the shot stops here.
    const bool update = sw < maxIter;
    int bad = 0;
    {
      const float a = update ? alpha[sw] : 0.f;
      for (int i = tid; i < layer_size(m, Ls, 0); i += nt)
        bad |= check_row(gr, pos_info, wt, Vb, S, layer_row(i, 0, Ls), true,
                         update, a, clip, nclip);
    }
    if (sw == 0) {
      __syncthreads();
    } else if (!__syncthreads_or(bad)) {
      for (int i = tid; i < layer_size(m, Ls, 1); i += nt)
        bad |= row_parity(gr, pos_info, wt, Vb, S, layer_row(i, 1, Ls));
      if (!__syncthreads_or(bad)) {
        conv_it = sw - 1;
        break;
      }
    }
    if (!update) break;
    for (int q = tid; q < m; q += nt)
      column_update(gr, pos_info, wt, Vb, S, prior_grid, q);
    __syncthreads();
    // Second half (odd time slices); its parity is not needed. alpha is
    // read again rather than kept live across the first half.
    const float a = alpha[sw];
    for (int i = tid; i < layer_size(m, Ls, 1); i += nt)
      check_row(gr, pos_info, wt, Vb, S, layer_row(i, 1, Ls), true, true, a,
                clip, nclip);
    __syncthreads();
    for (int q = tid; q < m; q += nt)
      column_update(gr, pos_info, wt, Vb, S, prior_grid, q);
    __syncthreads();
  }
  write_outputs(V, out_gather, residual, prior, values, hard, conv, iters, b,
                n, maxIter, conv_it, tid, nt);
}

extern "C" int bp_layered_sizes(const FloodGraph* graph, long long* out) {
  return bp_lift_sizes(graph, out);
}

extern "C" int bp_layered_info(const FloodGraph* graph, int threads,
                               int dev_state, int* out) {
  return bp_lift_info(
      dev_state ? bp_layered_kernel<true> : bp_layered_kernel<false>, graph,
      threads, dev_state, out);
}

extern "C" int bp_layered_launch(
    const FloodGraph* graph, const int8_t* syn, const float* prior_grid,
    const int4* pos_info, const int* wrap, const float* alpha,
    const int* out_gather, const uint8_t* residual, const float* prior,
    float* values, int8_t* hard, uint8_t* conv, int* iters,
    unsigned char* scratch, int B, int n, int maxIter, float clip,
    int threads, void* stream) {
  return bp_lift_launch(
      scratch ? bp_layered_kernel<true> : bp_layered_kernel<false>, graph,
      syn, prior_grid, pos_info, wrap, alpha, out_gather, residual, prior,
      values, hard, conv, iters, scratch, B, n, maxIter, clip, threads,
      stream);
}
