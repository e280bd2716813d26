// S1: a round's syndromes and logical effects from its gate randoms, both
// frames in one launch. For shot b and frame f (Z, then X):
//
//   aug_f[b] = XOR of A_f[:, l] over the elementary locations l of frame f
//              that flip in shot b                (rows: num_syn, then k)
//
// Location l of gate location g flips when err[b, g] is set and the fault
// has the frame's component there: a measurement or preparation location
// always (SEL_CONST), an idle when pauli[b, g] is not the frame's idle_keep
// (0 = X for the Z frame, 2 = Z for the X frame; SEL_IDLE), a CNOT leg when
// bit cat2[b, g] of the frame's control or target mask is set (SEL_CTRL,
// SEL_TGT). The outputs are int8 0/1, (B, num_syn) and (B, k) a frame.
//
// Replaces: the JAX package's fault_bits (qldpc_tpu/ops/sampler.py:120, an
// XLA gather of the draws onto the elementary locations and lookup tables)
// and augmented_bits (:146, a bf16 MXU product of the dense (R, L)
// signature with the fault bits): XLA steps, not a Pallas kernel. Their port,
// qldpc_tpu_torch/ops/sampler.py::fault_bits and augmented_bits (three
// index_selects, lookup tables and where's over (L, B), then a float32
// product on 0/1 operands), is S1's plain version.
//
// Bound on the H100: the bytes of err, one byte a gate location a shot,
// read once over 3.35 TB/s (at [[144,12,12]] and 1024 shots 17.7 MB, 5.3
// us). The work is sparse: at p = 0.004 a shot has ~69 erring gate
// locations of 17,280, and a flipped location XORs ~5 signature rows, so
// pauli and cat2 are read at the erring gates only (a sector each), the
// tables (a few hundred KB) stay in L2, and the outputs are B (R_z + R_x)
// bytes.
//
// Design: one block a shot, so that a round of 512-1024 shots fills the
// card with loads in flight. The block's threads scan the shot's err row in
// 16-byte streaming loads, two in flight a thread (the row's unaligned head
// and tail a byte a thread). A thread that finds a set byte reads that
// gate's pauli and cat2, walks the gate's elementary locations in both
// frames (CSR over gate locations: each entry its location and selector),
// applies the frame's flip rule and XORs the flipped location's signature
// rows (CSR over locations) into the frame's bitset in shared memory, with
// shared-memory atomics (ceil(R/32) words a frame). After a barrier the
// block writes both frames' rows. With a flip counter (telemetry on), each
// warp adds the locations it flipped with one atomic; without, it is null.
#include <cuda_runtime.h>
#include <stdint.h>

#define TS_THREADS 256
#define TS_SEL_CONST 0
#define TS_SEL_IDLE 1
#define TS_SEL_CTRL 2
#define TS_MAX_WORDS (48 * 1024 / 4)  // both frames' bitsets, static limit

struct TsFrame {
  const int* loc_ptr;    // (gates + 1) entries of each gate location
  const int* loc_entry;  // elementary location << 2 | selector
  const int* sig_ptr;    // (L + 1) signature rows of each location
  const int* sig_row;
  int8_t* syn;           // (B, num_syn)
  int8_t* tru;           // (B, rows - num_syn)
  int gates, rows, num_syn, words;
  int idle_keep, ctrl_mask, tgt_mask;
};

// Flips frame f at gate location g: returns the locations flipped.
__device__ __forceinline__ int ts_frame(const TsFrame& f, unsigned* bits,
                                        int g, int pa, int c2) {
  if (g >= f.gates) return 0;
  int flips = 0;
  const int e1 = __ldg(f.loc_ptr + g + 1);
  for (int e = __ldg(f.loc_ptr + g); e < e1; ++e) {
    const int ent = __ldg(f.loc_entry + e);
    const int sel = ent & 3;
    const bool hit =
        sel == TS_SEL_CONST ? true
        : sel == TS_SEL_IDLE
            ? pa != f.idle_keep
            : (((sel == TS_SEL_CTRL ? f.ctrl_mask : f.tgt_mask) >> c2) & 1);
    if (!hit) continue;
    ++flips;
    const int l = ent >> 2;
    const int q1 = __ldg(f.sig_ptr + l + 1);
    for (int q = __ldg(f.sig_ptr + l); q < q1; ++q) {
      const int r = __ldg(f.sig_row + q);
      atomicXor(bits + (r >> 5), 1u << (r & 31));
    }
  }
  return flips;
}

struct TsShot {
  const int* pauli;  // the shot's row
  const int* cat2;
  unsigned* bz;
  unsigned* bx;
};

__device__ __forceinline__ int ts_gate(const TsFrame& z, const TsFrame& x,
                                       const TsShot& s, int g) {
  const int pa = __ldg(s.pauli + g);
  const int c2 = __ldg(s.cat2 + g);
  return ts_frame(z, s.bz, g, pa, c2) + ts_frame(x, s.bx, g, pa, c2);
}

// The set bytes of four err bytes w, the first at gate location g.
__device__ __forceinline__ int ts_word(const TsFrame& z, const TsFrame& x,
                                       const TsShot& s, uint32_t w, int g) {
  int flips = 0;
  while (w) {
    const int byte = (__ffs(w) - 1) >> 3;
    w &= ~(0xffu << (8 * byte));
    flips += ts_gate(z, x, s, g + byte);
  }
  return flips;
}

__device__ __forceinline__ int ts_chunk(const TsFrame& z, const TsFrame& x,
                                        const TsShot& s, uint4 v, int g) {
  if (!(v.x | v.y | v.z | v.w)) return 0;
  return ts_word(z, x, s, v.x, g) + ts_word(z, x, s, v.y, g + 4) +
         ts_word(z, x, s, v.z, g + 8) + ts_word(z, x, s, v.w, g + 12);
}

__device__ __forceinline__ void ts_write(const TsFrame& f,
                                         const unsigned* bits, long long b) {
  int8_t* syn = f.syn + b * f.num_syn;
  for (int r = threadIdx.x; r < f.num_syn; r += TS_THREADS)
    syn[r] = (int8_t)((bits[r >> 5] >> (r & 31)) & 1);
  const int k = f.rows - f.num_syn;
  int8_t* tru = f.tru + b * k;
  for (int j = threadIdx.x; j < k; j += TS_THREADS) {
    const int r = f.num_syn + j;
    tru[j] = (int8_t)((bits[r >> 5] >> (r & 31)) & 1);
  }
}

__global__ void __launch_bounds__(TS_THREADS)
trial_syndromes_kernel(const uint8_t* __restrict__ err,
                       const int* __restrict__ pauli,
                       const int* __restrict__ cat2, int n, TsFrame z,
                       TsFrame x, unsigned long long* flips_out) {
  extern __shared__ unsigned bits[];
  const int t = threadIdx.x;
  for (int i = t; i < z.words + x.words; i += TS_THREADS) bits[i] = 0;
  __syncthreads();
  const long long b = blockIdx.x;
  const uint8_t* e = err + b * n;
  const TsShot s{pauli + b * n, cat2 + b * n, bits, bits + z.words};
  // bytes before the row's first 16-byte boundary, the whole chunks, and
  // the bytes after the last
  const int head = min((int)((16 - ((uintptr_t)e & 15)) & 15), n);
  const int chunks = (n - head) >> 4;
  const int tail = head + (chunks << 4);
  int flips = 0;
  if (t < head && e[t]) flips += ts_gate(z, x, s, t);
  if (tail + t < n && e[tail + t]) flips += ts_gate(z, x, s, tail + t);
  const uint4* v = reinterpret_cast<const uint4*>(e + head);
  for (int c = t; c < chunks; c += 2 * TS_THREADS) {
    const bool two = c + TS_THREADS < chunks;
    const uint4 a = __ldcs(v + c);
    const uint4 a2 = two ? __ldcs(v + c + TS_THREADS) : make_uint4(0, 0, 0, 0);
    flips += ts_chunk(z, x, s, a, head + 16 * c);
    flips += ts_chunk(z, x, s, a2, head + 16 * (c + TS_THREADS));
  }
  __syncthreads();
  ts_write(z, s.bz, b);
  ts_write(x, s.bx, b);
  if (flips_out) {
    flips = __reduce_add_sync(0xffffffffu, flips);
    if ((t & 31) == 0 && flips)
      atomicAdd(flips_out, (unsigned long long)flips);
  }
}

static TsFrame ts_frame_of(const void* loc_ptr, const void* loc_entry,
                           const void* sig_ptr, const void* sig_row,
                           void* syn, void* tru, int gates, int rows,
                           int num_syn, int idle_keep, int ctrl_mask,
                           int tgt_mask) {
  TsFrame f;
  f.loc_ptr = (const int*)loc_ptr;
  f.loc_entry = (const int*)loc_entry;
  f.sig_ptr = (const int*)sig_ptr;
  f.sig_row = (const int*)sig_row;
  f.syn = (int8_t*)syn;
  f.tru = (int8_t*)tru;
  f.gates = gates;
  f.rows = rows;
  f.num_syn = num_syn;
  f.words = (rows + 31) / 32;
  f.idle_keep = idle_keep;
  f.ctrl_mask = ctrl_mask;
  f.tgt_mask = tgt_mask;
  return f;
}

// err (B, n) bool, pauli and cat2 (B, n) int32, all contiguous; each
// frame's tables as TrialMaps holds them (ops/sampler.py), gates <= n, and
// its outputs contiguous int8. flips: one device uint64 to add to, or null.
extern "C" int trial_syndromes_launch(
    const void* err, const void* pauli, const void* cat2, int batch, int n,
    const void* z_loc_ptr, const void* z_loc_entry, const void* z_sig_ptr,
    const void* z_sig_row, void* z_syn, void* z_tru, int z_gates,
    int z_rows, int z_num_syn, int z_idle_keep, int z_ctrl_mask,
    int z_tgt_mask, const void* x_loc_ptr, const void* x_loc_entry,
    const void* x_sig_ptr, const void* x_sig_row, void* x_syn, void* x_tru,
    int x_gates, int x_rows, int x_num_syn, int x_idle_keep, int x_ctrl_mask,
    int x_tgt_mask, void* flips, void* stream) {
  const TsFrame z = ts_frame_of(z_loc_ptr, z_loc_entry, z_sig_ptr, z_sig_row,
                                z_syn, z_tru, z_gates, z_rows, z_num_syn,
                                z_idle_keep, z_ctrl_mask, z_tgt_mask);
  const TsFrame x = ts_frame_of(x_loc_ptr, x_loc_entry, x_sig_ptr, x_sig_row,
                                x_syn, x_tru, x_gates, x_rows, x_num_syn,
                                x_idle_keep, x_ctrl_mask, x_tgt_mask);
  if (batch < 0 || n < 0 || z.gates > n || x.gates > n ||
      z.words + x.words > TS_MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  if (batch > 0)
    trial_syndromes_kernel<<<batch, TS_THREADS,
                             (z.words + x.words) * sizeof(unsigned),
                             (cudaStream_t)stream>>>(
        (const uint8_t*)err, (const int*)pauli, (const int*)cat2, n, z, x,
        (unsigned long long*)flips);
  return (int)cudaGetLastError();
}
