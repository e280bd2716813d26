// Batched, swap-free, greedy GF(2) Gauss-Jordan elimination over bit-packed
// columns, one team of warps per shot over column bitsets.
//
// Replaces: qldpc_tpu/ops/osd_pallas.py::_elim_kernel (v1, the pallas_call
// in eliminate_blocks). Semantics per shot: for each column c < K in order,
// the pivot is the lowest unused row r < m with bit c set; every other row
// with bit c set is XORed with the pivot row, the residual syndrome in
// step; colofrow[pivot] = c. A shot stops when `rank` pivots are reached,
// or (exit_on_valid) when every unused row carries a zero residual — the
// residual then lies in the pivot span and no later pivot changes s_red or
// the OSD-0 correction. Left-word skipping: a step in word w updates words
// >= w only (full_jordan updates all), which leaves the pivot sequence,
// s_red, colofrow and every pivot column identical to full Gauss-Jordan.
//
// Bound on the H100 at the [[144,12,12]] main-path shapes (m = 1008 rows,
// stage-1 8 words, prefix 40 words, full width 70 words): the matrix is
// read and written once, and the column steps are a chain of dependent
// steps per shot (tens of columns for most failed-BP shots, a few hundred
// at most, the longest shot of a launch setting its time), each doing a
// handful of word XORs. So a step must cost few cycles, and no shot may
// wait for another.
//
// Design: a team of T warps runs one shot's column loop and exits on its
// own; a block holds several shots and has no block barrier at all. The
// shot's matrix lives column-major: column j is ceil(M/32) words over the
// rows (word l holds rows 32l..32l+31), its stride made odd so that lane l
// reading column j0 + l at one word hits 32 different banks. Lane l owns
// row words l, l + 32, ... (R = ceil(M/1024) of them, R <= GF2_MAXR) of
// every column, and every warp of the team keeps the same row state —
// used rows, the residual syndrome, rows < m — as bitmasks in registers.
// Warp t owns the 32-column groups g = t (mod T). A column step: every
// warp reads the column's words and picks the pivot by one ballot and a
// find-first-set; each warp reads the pivot row's bits over its own groups
// from the pivot's word on (one shared read and one ballot per group) and
// XORs the column's other rows into each of its columns whose pivot bit is
// set, the pivot column left out; one named barrier for the team (a
// __syncwarp for a team of one); then the pivot column's owner writes it
// as the pivot's unit column, which no other warp reads again. All 32W
// columns are carried, those past K too, as the words-major plain version
// XORs whole words. The (B, W, M) words-major input is turned into column
// words on the way in, and back on the way out, by 32x32 bit transposes of
// five __shfl_xor_sync butterfly rounds, four interleaved, each warp of the
// team taking its share of the words. A shot whose columns exceed the shared
// memory a block may hold (the 70-word basis rerun and the full_jordan
// reprocess at [[144]], every width at [[288]]) runs the same code on a
// per-shot slab in device memory of the same layout; gf2_elim_sizes
// reports whether a width needs it and its size, so the wrapper allocates
// it by the kernel's rule and formula.
#include <cuda_runtime.h>
#include <stdint.h>

#define GF2_MAXR 4          // row words a lane holds per column: M <= 4096
#define GF2_BLOCK_SHOTS 8   // most shots (teams) one block holds
#define GF2_DEV_SHOTS 4     // shots a block holds on the device-memory branch
#define GF2_MAX_TEAM 16     // most warps one shot takes
#define GF2_BLOCK_WARPS 32  // most warps one block holds (1024 threads)

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int NR;               // row words a column holds, ceil(M / 32)
  int R;                // row words a lane holds, ceil(NR / 32)
  int S;                // column stride in words: NR made odd
  long long shot_bytes; // one shot's columns
  int dev;              // 1: the columns live in a device-memory slab
  int T;                // warps a shot (its team)
  int spb;              // shots (teams) a block
  int smem;             // dynamic shared memory bytes a block
  int grid;             // blocks
};

// Where B shots of W words by M rows run. A shot takes a team of one warp
// per 2 words, up to GF2_MAX_TEAM; a block holds as many shots as fit its
// shared memory, but no more than B / SMs, so a small batch still spreads
// over every SM. Its columns go to a device-memory slab when one shot's
// exceed `smem_limit`.
Plan make_plan(int B, int W, int M, int smem_limit, int sms) {
  Plan p;
  p.NR = (M + 31) / 32;
  p.R = (p.NR + 31) / 32;
  p.S = p.NR | 1;
  p.shot_bytes = 4LL * 32 * W * p.S;
  const long long fit = p.shot_bytes > 0 ? smem_limit / p.shot_bytes : 0;
  p.dev = fit < 1;
  const int T = W / 2;
  p.T = T < 1 ? 1 : (T > GF2_MAX_TEAM ? GF2_MAX_TEAM : T);
  int cap = p.dev ? GF2_DEV_SHOTS
                  : (int)(fit < GF2_BLOCK_SHOTS ? fit : GF2_BLOCK_SHOTS);
  if (cap > GF2_BLOCK_WARPS / p.T) cap = GF2_BLOCK_WARPS / p.T;
  int spb = sms > 0 ? B / sms : 1;
  spb = spb < cap ? spb : cap;
  p.spb = spb > 1 ? spb : 1;
  p.smem = p.dev ? 0 : (int)(p.spb * p.shot_bytes);
  p.grid = (B + p.spb - 1) / p.spb;
  return p;
}

// Four 32x32 bit transposes across a warp, interleaved: lane i holds row i
// of each block (bit c = column c) on entry and column i (bit r = row r)
// on exit.
__device__ __forceinline__ void transpose32x4(unsigned (&x)[4], int lane) {
  const unsigned masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const unsigned mk = masks[i];  // bits c with (c & j) == 0
    unsigned y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = __shfl_xor_sync(kFull, x[u], j);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = (lane & j) ? (x[u] & ~mk) | ((y[u] >> j) & mk)
                        : (x[u] & mk) | ((y[u] << j) & ~mk);
  }
}

// The warps of one shot's team: a named barrier (ids 1.. by team), or the
// warp's own sync for a team of one. Orders shared and device memory
// among the team.
__device__ __forceinline__ void team_sync(int team, int T) {
  if (T == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(32 * T) : "memory");
}

// XOR elim into every column of a 32-column group (word offset grp) whose
// bit is set in `mask`, four columns at a time (their loads issued
// together).
template <int R>
__device__ __forceinline__ void xor_columns(unsigned* H, int grp,
                                            unsigned mask,
                                            const unsigned (&elim)[R],
                                            int lane, int NR, int S) {
  while (mask) {
    int off[4];  // word offset of each picked column, -1 for none
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      off[u] = mask ? grp + (__ffs(mask) - 1) * S : -1;
      mask &= mask - 1u;
    }
    unsigned x[4][R];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int q = 32 * k + lane;
        x[u][k] = (off[u] >= 0 && (k < R - 1 || q < NR)) ? H[off[u] + q] : 0u;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int q = 32 * k + lane;
        if (off[u] >= 0 && (k < R - 1 || q < NR))
          H[off[u] + q] = x[u][k] ^ elim[k];
      }
  }
}

template <int R, bool kDev>
__global__ void __launch_bounds__(1024)
gf2_elim_kernel(const int* __restrict__ hp_in,  // (B, W, M)
                int* __restrict__ hp_out,       // (B, W, M)
                const int* __restrict__ s_in,   // (B, M)
                int* __restrict__ s_out,        // (B, M)
                int* __restrict__ colofrow,     // (B, M)
                int* __restrict__ steps,        // (B): column steps run
                unsigned* __restrict__ slab,    // (B, shot words) if kDev
                int B, int W, int M, int m, int K, int rank, int full_jordan,
                int exit_on_valid, int spb, int T, int S) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int team = (threadIdx.x >> 5) / T;
  const int t = (threadIdx.x >> 5) - team * T;  // warp in the team
  const int b = blockIdx.x * spb + team;
  if (b >= B) return;  // the whole team; no block barrier follows
  const int NR = (M + 31) >> 5;
  const int shot_words = 32 * W * S;
  unsigned* H = kDev ? slab + (size_t)b * shot_words
                     : smem + (size_t)team * shot_words;
  const unsigned* hin = (const unsigned*)hp_in + (size_t)b * W * M;
  unsigned* hout = (unsigned*)hp_out + (size_t)b * W * M;
  const int* sb = s_in + (size_t)b * M;
  int* cf = colofrow + (size_t)b * M;

  // words-major rows -> column words; warp t takes words t, t + T, ...
  for (int w = t; w < W; w += T) {
    unsigned* colw = H + (32 * w + lane) * S;
    for (int l0 = 0; l0 < NR; l0 += 4) {
      unsigned x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 32 * (l0 + u) + lane;
        x[u] = (l0 + u < NR && r < M) ? hin[(size_t)w * M + r] : 0u;
      }
      transpose32x4(x, lane);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (l0 + u < NR) colw[l0 + u] = x[u];
    }
  }
  // row state, the same in every warp of the team
  unsigned used[R], sres[R], valid[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r0 = 32 * (32 * k + lane);
    valid[k] = r0 >= m ? 0u : (m - r0 >= 32 ? kFull : (1u << (m - r0)) - 1u);
    used[k] = 0u;
    sres[k] = 0u;
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    for (int j = 0; j < 32 && 32 * k + j < NR; ++j) {
      const int r = 32 * (32 * k + j) + lane;
      const unsigned word = __ballot_sync(kFull, r < M && sb[r] != 0);
      if (lane == j) sres[k] = word;
    }
  if (t == 0)
    for (int r = lane; r < M; r += 32) cf[r] = -1;
  team_sync(team, T);

  bool done = false;
  if (exit_on_valid) {
    unsigned pend = 0u;
#pragma unroll
    for (int k = 0; k < R; ++k) pend |= sres[k] & valid[k];
    done = !__any_sync(kFull, pend != 0u);
  }
  int npiv = 0;
  int col = 0;
  int gc_mod = 0;   // (col / 32) mod T: warp gc_mod owns column col
  int g_first = t;  // this warp's first group at or after the pivot's word
  for (; col < K && !done; ++col) {
    const int gc = col >> 5;
    if (col > 0 && (col & 31) == 0) {  // a new group: no division by T
      if (++gc_mod == T) gc_mod = 0;
      if (!full_jordan && g_first < gc) g_first += T;
    }
    const unsigned* cp = H + col * S;
    unsigned cw[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int q = 32 * k + lane;
      cw[k] = (k < R - 1 || q < NR) ? cp[q] : 0u;
    }
    // pivot: the lowest unused row r < m holding the column's bit
    int pq = -1;        // its row word
    unsigned pbit = 0;  // its bit in that word
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (pq < 0) {
        const unsigned cand = cw[k] & ~used[k] & valid[k];
        const unsigned bal = __ballot_sync(kFull, cand != 0u);
        if (bal) {
          const int L = __ffs(bal) - 1;
          const unsigned c = __shfl_sync(kFull, cand, L);
          pq = 32 * k + L;
          pbit = c & (0u - c);
        }
      }
    }
    int unit_q = -1;  // this warp turns column col into the pivot's unit
    if (pq >= 0) {
      const int pl = pq & 31, pk = pq >> 5;
      const int pr = __ffs(pbit) - 1;
      const bool owner = lane == pl;
      unsigned elim[R];
      unsigned sp = 0u;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        elim[k] = cw[k] & ~((owner && k == pk) ? pbit : 0u);
        if (k == pk) sp = sres[k];
      }
      const unsigned ps = (__shfl_sync(kFull, sp, pl) >> pr) & 1u;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (ps) sres[k] ^= elim[k];
        if (owner && k == pk) used[k] |= pbit;
      }
      if (t == 0 && owner) cf[32 * pq + pr] = col;
      // the pivot row's bits, 32 columns a ballot, over this warp's groups
      // g = t (mod T) from the pivot's word on; an XOR never changes a
      // pivot-row bit, so each batch of four groups is read before it is
      // updated. Column col itself is left to the unit write below: every
      // warp of the team reads it in this step.
      for (int g = g_first; g < W; g += 4 * T) {
        int base[4];
        unsigned masks[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int gg = g + u * T;
          base[u] = 32 * (gg < W ? gg : g) * S;  // in range: no branch
          const unsigned bit = (H[base[u] + lane * S + pq] >> pr) & 1u;
          masks[u] = __ballot_sync(kFull, gg < W && bit);
          if (gg == gc) masks[u] &= ~(1u << (col & 31));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xor_columns<R>(H, base[u], masks[u], elim, lane, NR, S);
      }
      if (gc_mod == t) unit_q = pq;
      ++npiv;
    }
    // the exit, from registers alone, before the barrier
    done = npiv >= rank;
    if (exit_on_valid && !done) {
      unsigned pend = 0u;
#pragma unroll
      for (int k = 0; k < R; ++k) pend |= sres[k] & ~used[k] & valid[k];
      done = !__any_sync(kFull, pend != 0u);
    }
    team_sync(team, T);
    if (unit_q >= 0) {  // after the barrier: no warp reads column col again
      unsigned* cpw = H + col * S;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int q = 32 * k + lane;
        if (k < R - 1 || q < NR) cpw[q] = q == unit_q ? pbit : 0u;
      }
      __syncwarp();
    }
  }
  team_sync(team, T);

  // column words -> words-major rows; warp t takes words t, t + T, ...
  for (int w = t; w < W; w += T) {
    const unsigned* colw = H + (32 * w + lane) * S;
    for (int l0 = 0; l0 < NR; l0 += 4) {
      unsigned x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = l0 + u < NR ? colw[l0 + u] : 0u;
      transpose32x4(x, lane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 32 * (l0 + u) + lane;
        if (l0 + u < NR && r < M) hout[(size_t)w * M + r] = x[u];
      }
    }
  }
  if (t == 0) {
    int* so = s_out + (size_t)b * M;
#pragma unroll
    for (int k = 0; k < R; ++k)
      for (int j = 0; j < 32 && 32 * k + j < NR; ++j) {
        const unsigned word = __shfl_sync(kFull, sres[k], j);
        const int r = 32 * (32 * k + j) + lane;
        if (r < M) so[r] = (word >> lane) & 1u;
      }
    if (lane == 0) steps[b] = col;
  }
}

using ElimKernel = void (*)(const int*, int*, const int*, int*, int*, int*,
                            unsigned*, int, int, int, int, int, int, int, int,
                            int, int, int);

template <int R>
ElimKernel pick_r(bool dev) {
  return dev ? gf2_elim_kernel<R, true> : gf2_elim_kernel<R, false>;
}

ElimKernel pick(int R, bool dev) {
  switch (R) {
    case 1: return pick_r<1>(dev);
    case 2: return pick_r<2>(dev);
    case 3: return pick_r<3>(dev);
    case 4: return pick_r<4>(dev);
    default: return nullptr;
  }
}

constexpr int kMaxDevices = 16;

int device() {
  int d = 0;
  return cudaGetDevice(&d) == cudaSuccess && d < kMaxDevices ? d : 0;
}

// SMs of the current device, asked once per device
int sm_count() {
  static int sms[kMaxDevices] = {};
  const int d = device();
  if (!sms[d] &&
      cudaDeviceGetAttribute(&sms[d], cudaDevAttrMultiProcessorCount, d) !=
          cudaSuccess)
    return 1;
  return sms[d];
}

// Lets kernel (R, dev) take `smem` dynamic bytes; set only when it grows
cudaError_t allow_smem(const Plan& p, ElimKernel k) {
  static int allowed[kMaxDevices][GF2_MAXR + 1][2] = {};
  int& a = allowed[device()][p.R][p.dev];
  if (p.smem <= a) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err == cudaSuccess) a = p.smem;
  return err;
}

}  // namespace

// One shot's column bytes, the column stride in words, the row words a
// lane holds, and 1 when the columns go to a device-memory slab of B times
// out[0] bytes, for W words by M rows: out[0..3].
extern "C" int gf2_elim_sizes(int W, int M, int smem_limit, long long* out) {
  const Plan p = make_plan(1, W, M, smem_limit, 1);
  out[0] = p.shot_bytes;
  out[1] = p.S;
  out[2] = p.R;
  out[3] = p.dev;
  return 0;
}

// The launch of B shots of W words by M rows: registers and local (spill)
// bytes a thread, shots a block, dynamic shared memory a block, 1 on the
// device-memory branch, blocks, blocks resident per SM, and warps a shot:
// out[0..7].
extern "C" int gf2_elim_info(int B, int W, int M, int smem_limit, int* out) {
  const Plan p = make_plan(B, W, M, smem_limit, sm_count());
  const ElimKernel k = pick(p.R, p.dev);
  if (!k) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err == cudaSuccess) err = allow_smem(p, k);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = p.spb;
  out[3] = p.smem;
  out[4] = p.dev;
  out[5] = p.grid;
  out[7] = p.T;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[6], k, 32 * p.T * p.spb, p.smem);
}

extern "C" int gf2_elim_launch(const int* hp_in, int* hp_out, const int* s_in,
                               int* s_out, int* colofrow, int* steps,
                               void* slab, int B, int W, int M, int m, int K,
                               int rank, int full_jordan, int exit_on_valid,
                               int smem_limit, void* stream) {
  const Plan p = make_plan(B, W, M, smem_limit, sm_count());
  const ElimKernel k = pick(p.R, p.dev);
  if (!k || m > M || (p.dev && B > 0 && !slab))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(p, k);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    k<<<p.grid, 32 * p.T * p.spb, p.smem, (cudaStream_t)stream>>>(
        hp_in, hp_out, s_in, s_out, colofrow, steps, (unsigned*)slab, B, W,
        M, m, K, rank, full_jordan, exit_on_valid, p.spb, p.T, p.S);
  }
  return (int)cudaGetLastError();
}
