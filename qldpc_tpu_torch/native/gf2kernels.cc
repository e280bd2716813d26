// Native host kernels: bit-packed batched Pauli-frame propagation, GF(2)
// Gauss-Jordan elimination, and the single-core baseline decoder.
//
// Host code of the PyTorch/CUDA port (a copy of the JAX package's source,
// so the port builds nothing of that package): the decoding-matrix
// builder's fault-enumeration sweep (every fault = one bit lane, gates =
// word-wise XOR row ops), a bit-packed GF(2) eliminator used for ranks and
// column bases of decoding matrices, and the per-trial min-sum BP + OSD
// decoder that is bench_cuda.py's single-core baseline (reference
// src/noise/kernels.py, src/decoding/kernels.py:48-106, :234-366,
// src/decoding/osd.py:5-77).
//
// Built on demand by qldpc_tpu_torch/native/build.py (g++ -O3 -shared,
// into build/native/) and bound with ctypes; a NumPy fallback keeps the
// package functional without a toolchain. No device code depends on it.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <vector>

namespace {

constexpr int32_t OP_CNOT = 1;

inline void xor_row(uint64_t* dst, const uint64_t* src, int64_t W) {
  for (int64_t w = 0; w < W; ++w) dst[w] ^= src[w];
}

}  // namespace

extern "C" {

// Propagate `nbatch` error frames (packed 64/word along the batch axis)
// through the circuit. basis_z != 0: CNOT XORs target row into control row,
// `op_prep` resets, `op_meas` records (Z-frame rules, reference
// src/noise/kernels.py:50-89); else the X-frame mirror.
//
// state: (total_qubits, W) uint64, zero-initialized by the caller.
// syn:   (num_meas, W) uint64 output.
// Injections (sorted by pos ascending) flip bit `inj_bit[i]` of qubit row
// `inj_q[i]` immediately before executing gate index `inj_pos[i]`.
void propagate_frames(const int32_t* ops, const int32_t* q1,
                      const int32_t* q2, int64_t n_gates, int32_t basis_z,
                      int32_t op_prep, int32_t op_meas, int64_t W,
                      const int64_t* inj_pos, const int64_t* inj_q,
                      const int64_t* inj_bit, int64_t n_inj,
                      uint64_t* state, uint64_t* syn) {
  int64_t ptr = 0;
  int64_t syn_count = 0;
  for (int64_t i = 0; i < n_gates; ++i) {
    while (ptr < n_inj && inj_pos[ptr] == i) {
      state[inj_q[ptr] * W + (inj_bit[ptr] >> 6)] ^=
          (uint64_t{1} << (inj_bit[ptr] & 63));
      ++ptr;
    }
    const int32_t op = ops[i];
    if (op == OP_CNOT) {
      if (basis_z)
        xor_row(state + int64_t(q1[i]) * W, state + int64_t(q2[i]) * W, W);
      else
        xor_row(state + int64_t(q2[i]) * W, state + int64_t(q1[i]) * W, W);
    } else if (op == op_prep) {
      std::memset(state + int64_t(q1[i]) * W, 0, size_t(W) * 8);
    } else if (op == op_meas) {
      std::memcpy(syn + syn_count * W, state + int64_t(q1[i]) * W,
                  size_t(W) * 8);
      ++syn_count;
    }
  }
  while (ptr < n_inj) {
    state[inj_q[ptr] * W + (inj_bit[ptr] >> 6)] ^=
        (uint64_t{1} << (inj_bit[ptr] & 63));
    ++ptr;
  }
}

// Swap-free GF(2) Gauss-Jordan on a row-bit-packed matrix (columns packed
// 64/word). Eliminates the first `ncols` columns; returns the pivot row of
// each column in prow_of_col (-1 if none). A (m, W) uint64 and s (m) are
// reduced in place. Returns the number of pivots.
int64_t gf2_eliminate_packed(uint64_t* A, uint8_t* s, int64_t m, int64_t W,
                             int64_t ncols, int64_t* prow_of_col) {
  int64_t npiv = 0;
  // used-row bitmap
  bool* used = new bool[m]();
  for (int64_t col = 0; col < ncols; ++col) {
    const int64_t w = col >> 6;
    const uint64_t bit = uint64_t{1} << (col & 63);
    int64_t piv = -1;
    for (int64_t r = 0; r < m; ++r) {
      if (!used[r] && (A[r * W + w] & bit)) { piv = r; break; }
    }
    prow_of_col[col] = piv;
    if (piv < 0) continue;
    used[piv] = true;
    ++npiv;
    const uint64_t* prow = A + piv * W;
    const uint8_t ps = s[piv];
    for (int64_t r = 0; r < m; ++r) {
      if (r != piv && (A[r * W + w] & bit)) {
        xor_row(A + r * W, prow, W);
        s[r] ^= ps;
      }
    }
  }
  delete[] used;
  return npiv;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Single-core baseline decoder: normalized min-sum BP with OSD-w fallback.
//
// Purpose: a MEASURED single-core native baseline for the throughput metric
// (BASELINE.md's "vs single-core Numba"). The reference only claims
// "50-100x faster than python" (reference src/noise/__init__.py:6); this
// routine reproduces the reference's per-trial decode structure —
// minsum_decoder_full's CSR min-sum loop with in-loop syndrome check and
// early exit (reference src/decoding/kernels.py:234-366) followed by
// performOSD_enhanced's reliability-sorted bit-packed elimination + order-w
// reprocessing (reference src/decoding/osd.py:5-77, kernels.py:36-106) — as
// a fresh single-thread C++ implementation, so trials/s can be measured on
// this host instead of estimated.
// ---------------------------------------------------------------------------

namespace {

struct Csr {
  const int64_t* indptr;  // (m+1)
  const int32_t* indices; // (nnz)
};

// One normalized-min-sum decode. Q/R are edge arrays over CSR positions.
// Returns true if converged (hard reproduces the syndrome).
bool minsum_decode(int64_t m, int64_t n, Csr H, const float* prior,
                   const uint8_t* syn, int64_t maxIter,
                   const float* alpha_seq, float clip, float* Q, float* R,
                   float* values, uint8_t* hard) {
  const int64_t nnz = H.indptr[m];
  for (int64_t r = 0; r < m; ++r)
    for (int64_t e = H.indptr[r]; e < H.indptr[r + 1]; ++e)
      Q[e] = prior[H.indices[e]];
  for (int64_t it = 0; it < maxIter; ++it) {
    const float alpha = alpha_seq[it];
    for (int64_t j = 0; j < n; ++j) values[j] = prior[j];
    for (int64_t r = 0; r < m; ++r) {
      float m1 = 1e30f, m2 = 1e30f;
      int64_t e1 = -1;
      float sgn = syn[r] ? -1.0f : 1.0f;
      for (int64_t e = H.indptr[r]; e < H.indptr[r + 1]; ++e) {
        const float v = Q[e];
        if (v < 0) sgn = -sgn;
        const float a = v < 0 ? -v : v;
        if (a < m1) { m2 = m1; m1 = a; e1 = e; }
        else if (a < m2) { m2 = a; }
      }
      for (int64_t e = H.indptr[r]; e < H.indptr[r + 1]; ++e) {
        const float sj = Q[e] < 0 ? -1.0f : 1.0f;
        const float msg = alpha * sgn * sj * (e == e1 ? m2 : m1);
        R[e] = msg;
        values[H.indices[e]] += msg;
      }
    }
    for (int64_t r = 0; r < m; ++r)
      for (int64_t e = H.indptr[r]; e < H.indptr[r + 1]; ++e) {
        float q = values[H.indices[e]] - R[e];
        Q[e] = q < -clip ? -clip : (q > clip ? clip : q);
      }
    bool ok = true;
    for (int64_t j = 0; j < n; ++j) hard[j] = values[j] < 0 ? 1 : 0;
    for (int64_t r = 0; r < m && ok; ++r) {
      uint8_t acc = 0;
      for (int64_t e = H.indptr[r]; e < H.indptr[r + 1]; ++e)
        acc ^= hard[H.indices[e]];
      ok = (acc == syn[r]);
    }
    if (ok) return true;
  }
  return false;
}

// Reliability-sorted OSD with order-w reprocessing. Writes the chosen
// solution into sol (n). Scratch: A (m*W words), perm/inv (n), prow (n),
// idx buffers. Returns the number of pivots found.
int64_t osd_decode(int64_t m, int64_t n, Csr H, const float* prior,
                   const uint8_t* syn, const float* values, int64_t order,
                   int64_t num_test, uint64_t* A, uint8_t* s,
                   int32_t* perm, int64_t* prow, uint8_t* sol,
                   uint8_t* base_bits, uint8_t* cand_bits) {
  const int64_t W = (n + 63) >> 6;
  // reliability order: |posterior LLR| ascending == least reliable first
  for (int64_t j = 0; j < n; ++j) perm[j] = int32_t(j);
  // simple index sort (std::sort with lambda)
  std::sort(perm, perm + n, [&](int32_t a, int32_t b) {
    const float va = values[a] < 0 ? -values[a] : values[a];
    const float vb = values[b] < 0 ? -values[b] : values[b];
    return va < vb;
  });
  // inverse permutation: sorted position of each original column
  // (reuse prow as scratch for inv during packing)
  int64_t* inv = prow;  // will be overwritten with pivot rows after packing
  for (int64_t j = 0; j < n; ++j) inv[perm[j]] = j;
  std::memset(A, 0, size_t(m) * W * 8);
  for (int64_t r = 0; r < m; ++r) {
    for (int64_t e = H.indptr[r]; e < H.indptr[r + 1]; ++e) {
      const int64_t pos = inv[H.indices[e]];
      A[r * W + (pos >> 6)] |= uint64_t{1} << (pos & 63);
    }
    s[r] = syn[r];
  }
  // Gauss-Jordan over sorted columns, stopping once every row has pivoted
  std::vector<uint8_t> used(m, 0);
  int64_t npiv = 0;
  for (int64_t j = 0; j < n; ++j) prow[j] = -1;
  for (int64_t col = 0; col < n && npiv < m; ++col) {
    const int64_t w = col >> 6;
    const uint64_t bit = uint64_t{1} << (col & 63);
    int64_t piv = -1;
    for (int64_t r = 0; r < m; ++r)
      if (!used[r] && (A[r * W + w] & bit)) { piv = r; break; }
    if (piv < 0) continue;
    prow[col] = piv;
    used[piv] = true;
    ++npiv;
    const uint64_t* prow_data = A + piv * W;
    const uint8_t ps = s[piv];
    for (int64_t r = 0; r < m; ++r)
      if (r != piv && (A[r * W + w] & bit)) {
        xor_row(A + r * W, prow_data, W);
        s[r] ^= ps;
      }
  }
  // pivot (sorted-col, row) pairs in sorted-column order
  std::vector<int64_t> pcols;
  pcols.reserve(npiv);
  for (int64_t col = 0; col < n; ++col)
    if (prow[col] >= 0) pcols.push_back(col);
  // OSD-0: pivot columns take the reduced syndrome, everything else 0
  std::memset(base_bits, 0, size_t(n));
  for (int64_t pi = 0; pi < int64_t(pcols.size()); ++pi)
    base_bits[pcols[pi]] = s[prow[pcols[pi]]];
  // test positions: the num_test least-reliable NON-pivot sorted columns
  // (reference osd.py picks order+10 least-reliable non-pivot positions)
  std::vector<int64_t> test;
  for (int64_t col = 0; col < n && int64_t(test.size()) < num_test; ++col)
    if (prow[col] < 0) test.push_back(col);
  // candidate search: flip subsets of size <= order; score by
  // sum(|prior|*bit) + huge penalty per unsatisfied check (unused rows
  // with nonzero reduced syndrome are unsatisfiable by any candidate and
  // cancel in comparisons, so they are ignored for ranking — matching the
  // reference's constant-offset behavior under full rank)
  auto weight_of = [&](const uint8_t* bits) {
    double wsum = 0.0;
    for (int64_t j = 0; j < n; ++j)
      if (bits[j]) {
        const float a = prior[perm[j]];
        wsum += a < 0 ? -a : a;
      }
    return wsum;
  };
  std::memcpy(cand_bits, base_bits, size_t(n));
  double best = weight_of(base_bits);
  std::vector<int64_t> best_flip;
  const int64_t T = int64_t(test.size());
  auto eval_flip = [&](std::initializer_list<int64_t> flips) {
    // flipping non-pivot col c adjusts every pivot col p by the reduced
    // A[prow[p]][c] coefficient
    double wsum = 0.0;
    for (int64_t pi = 0; pi < int64_t(pcols.size()); ++pi) {
      const int64_t col = pcols[pi];
      const int64_t r = prow[col];
      uint8_t b = s[r];
      for (int64_t c : flips)
        b ^= uint8_t((A[r * W + (c >> 6)] >> (c & 63)) & 1);
      if (b) {
        const float a = prior[perm[col]];
        wsum += a < 0 ? -a : a;
      }
    }
    for (int64_t c : flips) {
      const float a = prior[perm[c]];
      wsum += a < 0 ? -a : a;
    }
    if (wsum < best) {
      best = wsum;
      best_flip.assign(flips.begin(), flips.end());
    }
  };
  if (order >= 1)
    for (int64_t i = 0; i < T; ++i) eval_flip({test[i]});
  if (order >= 2)
    for (int64_t i = 0; i < T; ++i)
      for (int64_t j2 = i + 1; j2 < T; ++j2) eval_flip({test[i], test[j2]});
  // materialize the winner in ORIGINAL column order
  std::memcpy(cand_bits, base_bits, size_t(n));
  if (!best_flip.empty()) {
    for (int64_t c : best_flip) cand_bits[c] ^= 1;
    for (int64_t pi = 0; pi < int64_t(pcols.size()); ++pi) {
      const int64_t col = pcols[pi];
      const int64_t r = prow[col];
      uint8_t b = s[r];
      for (int64_t c : best_flip)
        b ^= uint8_t((A[r * W + (c >> 6)] >> (c & 63)) & 1);
      cand_bits[col] = b;
    }
  }
  std::memset(sol, 0, size_t(n));
  for (int64_t j = 0; j < n; ++j)
    if (cand_bits[j]) sol[perm[j]] = 1;
  return npiv;
}

}  // namespace

extern "C" {

// Decode `ntrials` syndromes single-threaded: min-sum BP (maxIter,
// alpha_seq, clip) with OSD-`order` fallback for unconverged trials.
// Returns elapsed seconds. conv_out[t] = 1 if BP converged; wsum_out
// accumulates total solution weight (prevents dead-code elimination and
// gives a sanity statistic).
// sol_out: optional (ntrials, n) uint8 decoded error patterns (pass NULL
// to skip materializing them).
double baseline_decode_trials(
    int64_t m, int64_t n, const int64_t* indptr, const int32_t* indices,
    const float* prior, const uint8_t* syndromes, int64_t ntrials,
    int64_t maxIter, const float* alpha_seq, float clip, int64_t order,
    int64_t num_test, uint8_t* conv_out, double* wsum_out,
    uint8_t* sol_out) {
  Csr H{indptr, indices};
  const int64_t nnz = indptr[m];
  const int64_t W = (n + 63) >> 6;
  std::vector<float> Q(nnz), R(nnz), values(n);
  std::vector<uint8_t> hard(n), sol(n), s(m), base_bits(n), cand_bits(n);
  std::vector<uint64_t> A(size_t(m) * W);
  std::vector<int32_t> perm(n);
  std::vector<int64_t> prow(n);
  double wsum = 0.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int64_t t = 0; t < ntrials; ++t) {
    const uint8_t* syn = syndromes + t * m;
    const bool conv = minsum_decode(m, n, H, prior, syn, maxIter, alpha_seq,
                                    clip, Q.data(), R.data(), values.data(),
                                    hard.data());
    conv_out[t] = conv ? 1 : 0;
    const uint8_t* final_sol = hard.data();
    if (!conv) {
      osd_decode(m, n, H, prior, syn, values.data(), order, num_test,
                 A.data(), s.data(), perm.data(), prow.data(), sol.data(),
                 base_bits.data(), cand_bits.data());
      final_sol = sol.data();
    }
    for (int64_t j = 0; j < n; ++j)
      if (final_sol[j]) wsum += 1.0;
    if (sol_out) std::memcpy(sol_out + t * n, final_sol, size_t(n));
  }
  const auto t1 = std::chrono::steady_clock::now();
  *wsum_out = wsum;
  return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"
