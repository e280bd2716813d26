// Time-layered normalized min-sum BP on a lifted BB decoding graph, all
// sweeps of one shot in one thread block.
//
// Replaces: qldpc_tpu/ops/bp_lift_pallas.py::_bp_kernel with
// schedule="layered" (layered_body, the pallas_call in
// decode_batch_lift_pallas). A sweep is two half-updates: the checks whose
// time slice t = row / (ell*mm) is even, then the odd ones. A half-update
// computes Q = clip(V - R) on its layer's checks, commits their new R, and
// the posteriors are rebuilt from every committed R before the next half.
// The Pallas kernel keeps Q resident and rebuilds R from saved per-check
// stats and packed bits to save TPU roll passes; its docstring states that
// this is bit-equal to storing R, so here R itself is stored.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 checks,
// EB = 35 edge slots, NB*ell*mm*T = 10080 column slots, B = 1024 shots):
// device-memory traffic is one syndrome read and one posterior/decision
// write per shot (~46 MB, ~14 us); each sweep does ~17 float32 operations
// per live edge in its two check half-passes (each edge is updated once a
// sweep) plus two posterior rebuilds and a parity pass, over ~30k edges and
// every sweep a shot runs, so operations bound it. Design against that, as
// K1 (bp_lift_flood.cu) does: R (35 x 1008 f32 = 141 KB) and the
// posteriors (40 KB) live in shared memory, so sweeps never touch device
// memory, and each block stops at its own shot's convergence. Graphs whose
// state exceeds the 227 KB a block may hold use a per-shot scratch slab in
// device memory through the same code. The parity test of sweep s-1 rides
// in the first check pass of sweep s, which reads every check's posteriors
// anyway.
//
// Bit-exactness with the plain PyTorch version (and the Pallas kernel in
// interpret mode): built with -fmad=false; R = (alpha*sgn)*mag with the
// edge sign as a select; the running min1/min2 tie rule
// m2 = min(m2, a < m1 ? m1 : a); each posterior sums R in edge-slot order
// from zero, then adds the prior; Q = min(max(V - R, -clip), clip) from the
// very first half (the layered schedule clips the prior, unlike K1's first
// iteration).
#include <cuda_runtime.h>
#include <stdint.h>

#define BP_BIG 1e30f

// One check's half-update: Q from the posteriors and the committed R, the
// min1/min2/sign reduction, then the new R in place.
__device__ __forceinline__ void check_update(
    float* __restrict__ R, const float* __restrict__ V,
    const int* __restrict__ chk_nbr, int r, int m, int EB, int syn_bit,
    float a, float clip) {
  float m1 = BP_BIG, m2 = BP_BIG;
  int negs = 0;
  for (int e = 0; e < EB; ++e) {
    const int s = chk_nbr[e * m + r];
    if (s < 0) continue;
    const float q = fminf(fmaxf(V[s] - R[e * m + r], -clip), clip);
    const float aq = fabsf(q);
    m2 = fminf(m2, aq < m1 ? m1 : aq);
    m1 = fminf(m1, aq);
    negs += (q < 0.f);
    R[e * m + r] = q;  // own slot: Q until the update below
  }
  const float sgn = (float)(1 - 2 * (negs & 1)) * (float)(1 - 2 * syn_bit);
  const float as = a * sgn;
  for (int e = 0; e < EB; ++e) {
    if (chk_nbr[e * m + r] < 0) continue;
    const float q = R[e * m + r];
    const float rpos = as * (fabsf(q) == m1 ? m2 : m1);
    R[e * m + r] = q < 0.f ? -rpos : rpos;
  }
}

// Posterior = (sum of R in edge-slot order) + prior, every column slot.
__device__ __forceinline__ void rebuild_posteriors(
    float* __restrict__ V, const float* __restrict__ R,
    const float* __restrict__ prior_grid, const int* __restrict__ col_chk,
    const int* __restrict__ pb_start, int m, int P, int G, int tid, int nt) {
  for (int sl = tid; sl < G; sl += nt) {
    const int pb = sl / P;
    const int q = sl - pb * P;
    float acc = 0.f;
    for (int e = pb_start[pb]; e < pb_start[pb + 1]; ++e) {
      const int r = col_chk[e * P + q];
      if (r >= 0) acc = acc + R[e * m + r];
    }
    V[sl] = prior_grid[sl] + acc;
  }
}

// State layout per shot: R[EB * m] (check layout, edge slot major) then
// V[NB * P] (internal column-slot order pb, t, x, y).
__global__ void __launch_bounds__(1024)
bp_layered_kernel(const int8_t* __restrict__ syn,        // (B, m)
                  const float* __restrict__ prior_grid,  // (NB * P)
                  const int* __restrict__ chk_nbr,       // (EB, m) slot | -1
                  const int* __restrict__ col_chk,       // (EB, P) row | -1
                  const int* __restrict__ pb_start,      // (NB + 1)
                  const float* __restrict__ alpha,       // (maxIter)
                  const int* __restrict__ out_gather,    // (n) slot
                  const uint8_t* __restrict__ residual,  // (n)
                  const float* __restrict__ prior,       // (n)
                  float* __restrict__ values,            // (B, n)
                  int8_t* __restrict__ hard,             // (B, n)
                  uint8_t* __restrict__ conv,            // (B)
                  int* __restrict__ iters,               // (B)
                  float* __restrict__ scratch,           // null: shared
                  int m, int EB, int P, int NB, int n, int maxIter,
                  int n2,                                // ell * mm
                  float clip) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int G = NB * P;
  const size_t state = (size_t)EB * m + (size_t)G;
  float* R = scratch ? scratch + (size_t)b * state : smem;
  float* V = R + (size_t)EB * m;
  const int8_t* s_b = syn + (size_t)b * m;

  for (int i = tid; i < EB * m; i += nt) R[i] = 0.f;
  for (int i = tid; i < G; i += nt) V[i] = prior_grid[i];
  __syncthreads();

  int conv_it = -1;
  for (int sw = 0;; ++sw) {
    // First half (even time slices), fused with the parity of the
    // posteriors left by sweep sw-1 (its convergence test).
    const bool update = sw < maxIter;
    const float a = update ? alpha[sw] : 0.f;
    int bad = 0;
    for (int r = tid; r < m; r += nt) {
      int par = 0;
      for (int e = 0; e < EB; ++e) {
        const int s = chk_nbr[e * m + r];
        if (s >= 0) par ^= (V[s] < 0.f);
      }
      bad |= (par != (int)s_b[r]);
      if (update && ((r / n2) & 1) == 0)
        check_update(R, V, chk_nbr, r, m, EB, s_b[r], a, clip);
    }
    const int any_bad = __syncthreads_or(bad);
    if (sw > 0 && !any_bad) {
      conv_it = sw - 1;
      break;
    }
    if (!update) break;
    rebuild_posteriors(V, R, prior_grid, col_chk, pb_start, m, P, G, tid,
                       nt);
    __syncthreads();
    // Second half (odd time slices).
    for (int r = tid; r < m; r += nt)
      if ((r / n2) & 1) check_update(R, V, chk_nbr, r, m, EB, s_b[r], a, clip);
    __syncthreads();
    rebuild_posteriors(V, R, prior_grid, col_chk, pb_start, m, P, G, tid,
                       nt);
    __syncthreads();
  }

  // Epilogue: posteriors in original column order; edge-free (residual)
  // columns keep the prior. Converged shots stopped at their converging
  // sweep, so V holds the frozen posterior and hard = V < 0.
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

extern "C" int bp_layered_launch(
    const int8_t* syn, const float* prior_grid, const int* chk_nbr,
    const int* col_chk, const int* pb_start, const float* alpha,
    const int* out_gather, const uint8_t* residual, const float* prior,
    float* values, int8_t* hard, uint8_t* conv, int* iters, float* scratch,
    int B, int m, int EB, int P, int NB, int n, int maxIter, int n2,
    float clip, int threads, void* stream) {
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = ((size_t)EB * m + (size_t)NB * P) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        bp_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0) {
    bp_layered_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        syn, prior_grid, chk_nbr, col_chk, pb_start, alpha, out_gather,
        residual, prior, values, hard, conv, iters, scratch, m, EB, P, NB, n,
        maxIter, n2, clip);
  }
  return (int)cudaGetLastError();
}
