// What the three GF(2) eliminators share (K2 csrc/gf2_elim.cu, K4
// csrc/gf2_elim_fused.cu, K5 csrc/gf2_elim_pair.cu): the column-bitset
// layout of a shot, its team of warps, its load (a copy of G1's column
// output) and its store, the row state, the pivot search, the column XOR,
// and the host-side plan, launch shape and launch.
//
// Layout: a shot's matrix lives column-major: column j is ceil(M/32) words
// over the rows (word l holds rows 32l..32l+31), its stride S made odd so
// that lane l reading column j0 + l at one word hits 32 different banks.
// Lane l owns row words l, l + 32, ... (R = ceil(M/1024) of them, R <=
// GF2_MAXR) of every column, and every warp of a team keeps the same row
// state (used rows, the residual syndrome, rows < m) as bitmasks in
// registers. Warp t of a team of T owns the 32-column groups g = t (mod T).
// The input comes in this layout (G1's column output, csrc/gather_pack.cu):
// copied into shared memory, or, where one team's columns exceed the shared
// memory a block may hold, eliminated in place in device memory. The
// reduced matrix goes out words-major (B, W, M), and only where the caller
// asks for it. A team carries `spt` shots (1 for K2 and K4, 2 for K5); a
// block holds several teams and has no block barrier.
//
// The gate: a launch may take a device int32 pair [lo, hi), the live shots
// of its batch. The grid covers every shot; a team whose shot lies outside
// the range records no pivot row and no step and leaves before its first
// load (K5 gates each shot of its pair). The OSD decides on the device how
// many shots a launch needs (the staged tail, the basis rerun, the
// reprocess), so no host read sizes a launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GF2_MAXR 4          // row words a lane holds per column: M <= 4096
#define GF2_BLOCK_SHOTS 8   // most teams one block holds (barrier ids 1..8)
#define GF2_DEV_SHOTS 4     // teams a block holds on the device-memory branch
#define GF2_MAX_TEAM 16     // most warps one team takes

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Most threads a block of an eliminator holds: 1024, or 512 where a kernel
// keeps more row state a lane (`narrow`) and R > 1, so that its launch
// bound leaves 128 registers a thread. (K4 and K5 also state one block per
// SM as their minimum: without it ptxas held K5 at R = 2 to 64 registers
// and spilled.)
constexpr int max_block_threads(int R, bool narrow) {
  return narrow && R > 1 ? 512 : 1024;
}

struct Plan {
  int NR;               // row words a column holds, ceil(M / 32)
  int R;                // row words a lane holds, ceil(NR / 32)
  int S;                // column stride in words: NR made odd
  long long team_bytes; // one team's columns (spt shots)
  int dev;              // 1: the columns stay in device memory
  int T;                // warps a team
  int spb;              // teams a block
  int smem;             // dynamic shared memory bytes a block
  int grid;             // blocks
};

// Where B shots of W words by M rows run, `spt` shots a team. A team takes
// one warp per 2 words, up to GF2_MAX_TEAM; a block holds as many teams as
// fit its shared memory, but no more than teams / SMs, so a small batch
// still spreads over every SM. The columns stay in device memory (the
// input, eliminated in place) when one team's exceed `smem_limit`, the
// caller's shared-memory budget a block. `block_shots` > 0, the caller's
// shots a block, sets the teams a block to ceil(block_shots / spt) in place
// of teams / SMs, clamped as that rule is (what fits the budget,
// GF2_BLOCK_SHOTS or GF2_DEV_SHOTS, the warps a block) and to the batch's
// teams; 0 keeps the rule.
Plan make_plan(int B, int W, int M, int smem_limit, int sms, int spt = 1,
               bool narrow = false, int block_shots = 0) {
  Plan p;
  p.NR = (M + 31) / 32;
  p.R = (p.NR + 31) / 32;
  p.S = p.NR | 1;
  p.team_bytes = spt * 4LL * 32 * W * p.S;
  const long long fit = p.team_bytes > 0 ? smem_limit / p.team_bytes : 0;
  p.dev = fit < 1;
  const int T = W / 2;
  p.T = T < 1 ? 1 : (T > GF2_MAX_TEAM ? GF2_MAX_TEAM : T);
  int cap = p.dev ? GF2_DEV_SHOTS
                  : (int)(fit < GF2_BLOCK_SHOTS ? fit : GF2_BLOCK_SHOTS);
  const int warps = max_block_threads(p.R, narrow) / 32;
  if (cap > warps / p.T) cap = warps / p.T;
  const int teams = (B + spt - 1) / spt;
  int spb = sms > 0 ? teams / sms : 1;
  if (block_shots > 0) {
    spb = (block_shots + spt - 1) / spt;
    if (spb > teams) spb = teams;
  }
  spb = spb < cap ? spb : cap;
  p.spb = spb > 1 ? spb : 1;
  p.smem = p.dev ? 0 : (int)(p.spb * p.team_bytes);
  p.grid = (teams + p.spb - 1) / p.spb;
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

// The warps of one team: a named barrier (ids 1.. by team), or the warp's
// own sync for a team of one. Orders shared and device memory among the
// team.
__device__ __forceinline__ void team_sync(int team, int T) {
  if (T == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(32 * T) : "memory");
}

// One shot's column input (G1's column layout, the same 32 W S words as H)
// copied into H, 16 bytes a lane, the team's warps taking interleaved
// vectors. The device-memory branch skips it: there H is the input itself.
__device__ __forceinline__ void load_columns(unsigned* H, const int* hp,
                                             size_t b, int W, int S, int t,
                                             int T, int lane) {
  const int n4 = 8 * W * S;  // 32 W S words as 16-byte vectors
  const uint4* src = (const uint4*)hp + b * n4;
  uint4* dst = (uint4*)H;
  for (int i = 32 * t + lane; i < n4; i += 32 * T) dst[i] = src[i];
}

// One shot's column words in H -> its words-major rows (W, M).
__device__ __forceinline__ void store_columns(const unsigned* H,
                                              unsigned* hout, int W, int M,
                                              int NR, int S, int t, int T,
                                              int lane) {
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
}

// Rows r < m may pivot: bit i of valid[k] at lane l is row 32(32k + l) + i.
template <int R>
__device__ __forceinline__ void valid_rows(unsigned (&valid)[R], int m,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r0 = 32 * (32 * k + lane);
    valid[k] = r0 >= m ? 0u : (m - r0 >= 32 ? kFull : (1u << (m - r0)) - 1u);
  }
}

// The residual syndrome s (M int 0/1) as row bitmasks; no row used yet.
// Four row words a batch, their loads issued together before the ballots
// (a load guarded inside each ballot's condition is compiled to a branch
// per word, and the 32 loads of a lane word then wait one after another).
template <int R>
__device__ __forceinline__ void load_rows(const int* s, int M, int NR,
                                          unsigned (&used)[R],
                                          unsigned (&sres)[R], int lane) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    used[k] = 0u;
    sres[k] = 0u;
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    for (int j0 = 0; j0 < 32 && 32 * k + j0 < NR; j0 += 4) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 32 * (32 * k + j0 + u) + lane;
        v[u] = (32 * k + j0 + u < NR && r < M) ? s[r] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned word = __ballot_sync(kFull, v[u] != 0);
        if (lane == j0 + u) sres[k] = word;
      }
    }
}

// The residual syndrome back to M int 0/1 (one warp).
template <int R>
__device__ __forceinline__ void store_rows(const unsigned (&sres)[R], int* so,
                                           int M, int NR, int lane) {
#pragma unroll
  for (int k = 0; k < R; ++k)
    for (int j = 0; j < 32 && 32 * k + j < NR; ++j) {
      const unsigned word = __shfl_sync(kFull, sres[k], j);
      const int r = 32 * (32 * k + j) + lane;
      if (r < M) so[r] = (word >> lane) & 1u;
    }
}

// True while an unused row r < m still carries a residual bit.
template <int R>
__device__ __forceinline__ bool pending(const unsigned (&sres)[R],
                                        const unsigned (&used)[R],
                                        const unsigned (&valid)[R]) {
  unsigned pend = 0u;
#pragma unroll
  for (int k = 0; k < R; ++k) pend |= sres[k] & ~used[k] & valid[k];
  return __any_sync(kFull, pend != 0u);
}

// A column's words at this lane (cp: the column's first word).
template <int R>
__device__ __forceinline__ void read_column(const unsigned* cp,
                                            unsigned (&cw)[R], int lane,
                                            int NR) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = 32 * k + lane;
    cw[k] = (k < R - 1 || q < NR) ? cp[q] : 0u;
  }
}

// The pivot of a column: the lowest unused row r < m holding its bit, as
// its row word pq (-1 for none) and its bit pbit in that word.
template <int R>
__device__ __forceinline__ void find_pivot(const unsigned (&cw)[R],
                                           const unsigned (&used)[R],
                                           const unsigned (&valid)[R],
                                           int& pq, unsigned& pbit) {
  pq = -1;
  pbit = 0u;
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
}

// Row word pq (at its lane pq & 31) of a column held as R words a lane,
// broadcast to the warp: each word shuffled, then one picked. (A select of
// one word by pq >> 5 before a single shuffle is compiled to an indexed
// load, which puts the whole array in local memory at R > 1.)
template <int R>
__device__ __forceinline__ unsigned row_word(const unsigned (&cw)[R], int pq) {
  unsigned v = 0u;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const unsigned w = __shfl_sync(kFull, cw[k], pq & 31);
    if (k == (pq >> 5)) v = w;
  }
  return v;
}

// A pivot's step on the row state: elim = the column without its pivot
// row; rows holding the column's bit take the pivot's residual bit; the
// pivot row becomes used.
template <int R>
__device__ __forceinline__ void pivot_rows(unsigned (&elim)[R],
                                           unsigned (&sres)[R],
                                           unsigned (&used)[R], int pq,
                                           unsigned pbit, int lane) {
  const bool owner = lane == (pq & 31);
  const int pk = pq >> 5;
  const int pr = __ffs(pbit) - 1;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (owner && k == pk) elim[k] &= ~pbit;
  const unsigned ps = (row_word(sres, pq) >> pr) & 1u;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (ps) sres[k] ^= elim[k];
    if (owner && k == pk) used[k] |= pbit;
  }
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

// The live shots [lo, hi) of a launch, read from a device int32 pair (a
// null pointer: every shot), clamped to [0, B).
__device__ __forceinline__ void live_range(const int* live, int B, int& lo,
                                           int& hi) {
  lo = 0;
  hi = B;
  if (live) {
    lo = max(live[0], 0);
    hi = min(live[1], B);
  }
}

// A shot outside the live range leaves before its first load: warp 0 of
// its team records no pivot row and no column step, so that its
// prow_of_col and used read empty; its matrix and residual outputs are
// left unwritten (unspecified, never consumed).
__device__ __forceinline__ void skip_shot(int* cf, int* steps, int M, int t,
                                          int lane) {
  if (t != 0) return;
  for (int r = lane; r < M; r += 32) cf[r] = -1;
  if (lane == 0) *steps = 0;
}

// A column turned into the pivot's unit column (pq < 0: left as it is).
template <int R>
__device__ __forceinline__ void write_unit(unsigned* cp, int pq,
                                           unsigned pbit, int lane, int NR) {
  if (pq < 0) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = 32 * k + lane;
    if (k < R - 1 || q < NR) cp[q] = q == pq ? pbit : 0u;
  }
}

// K2's column step on one shot (K5 runs it on a pair's last shot): read
// column col, pick its pivot, take it into the row state; over this warp's
// groups g = t (mod T) from g_first on, read the pivot row's bits, 32
// columns a ballot, and XOR the column's other rows into each column the
// pivot row touches (an XOR never changes a pivot-row bit, so each batch of
// four groups is read before it is updated; column col itself is left to
// the unit write, as every warp of the team reads it in this step); the
// exit from registers; one team barrier; then column col's owner (warp
// gc_mod) writes it as the pivot's unit column, which no warp reads again.
// Returns true when the shot stops (rank reached, or no unused row r < m
// left with a residual bit under exit_on_valid).
template <int R>
__device__ __forceinline__ bool column_step(
    unsigned* H, int col, int g_first, int gc_mod, int W, int NR, int S,
    unsigned (&used)[R], unsigned (&sres)[R], const unsigned (&valid)[R],
    int& npiv, int* cf, int rank, int exit_on_valid, int team, int t, int T,
    int lane) {
  const int gc = col >> 5;
  unsigned cw[R];
  read_column(H + col * S, cw, lane, NR);
  int pq;         // the pivot's row word, -1 for none
  unsigned pbit;  // its bit in that word
  find_pivot(cw, used, valid, pq, pbit);
  int unit_q = -1;  // this warp turns column col into the pivot's unit
  if (pq >= 0) {
    const int pr = __ffs(pbit) - 1;
    pivot_rows(cw, sres, used, pq, pbit, lane);  // cw: the column's elim
    if (t == 0 && lane == (pq & 31)) cf[32 * pq + pr] = col;
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
        xor_columns<R>(H, base[u], masks[u], cw, lane, NR, S);
    }
    if (gc_mod == t) unit_q = pq;
    ++npiv;
  }
  const bool done =
      npiv >= rank || (exit_on_valid && !pending(sres, used, valid));
  team_sync(team, T);
  if (unit_q >= 0) {
    write_unit<R>(H + col * S, unit_q, pbit, lane, NR);
    __syncwarp();
  }
  return done;
}

// ---- host side ----

using ElimKernel = void (*)(int*, int*, const int*, int*, int*, int*,
                            const int*, int, int, int, int, int, int, int,
                            int, int, int, int);

// The kernel table of one eliminator by row words a lane and branch.
#define GF2_PICK(kernel)                                                  \
  ElimKernel pick(int R, bool dev) {                                      \
    switch (R) {                                                          \
      case 1: return dev ? kernel<1, true> : kernel<1, false>;            \
      case 2: return dev ? kernel<2, true> : kernel<2, false>;            \
      case 3: return dev ? kernel<3, true> : kernel<3, false>;            \
      case 4: return dev ? kernel<4, true> : kernel<4, false>;            \
      default: return nullptr;                                            \
    }                                                                     \
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

// One team's column bytes, the column stride in words, the row words a
// lane holds, and 1 when the columns stay in device memory: out[0..3].
int plan_sizes(const Plan& p, long long* out) {
  out[0] = p.team_bytes;
  out[1] = p.S;
  out[2] = p.R;
  out[3] = p.dev;
  return 0;
}

// The launch's registers and local (spill) bytes a thread, shots a block,
// dynamic shared memory a block, 1 on the device-memory branch, blocks,
// blocks resident per SM, and warps a team: out[0..7].
int plan_info(const Plan& p, ElimKernel k, int spt, int* out) {
  if (!k) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err == cudaSuccess) err = allow_smem(p, k);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = p.spb * spt;
  out[3] = p.smem;
  out[4] = p.dev;
  out[5] = p.grid;
  out[7] = p.T;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[6], k, 32 * p.T * p.spb, p.smem);
}

// `live`: a device int32 pair [lo, hi), the shots the launch runs (null:
// every shot); the grid covers all B shots whatever the pair holds, so the
// host never reads it. `hp`: the column layout, B shots of 32 W S words
// each, 16-byte aligned; on the device-memory branch it is eliminated in
// place. `hp_out` null: the reduced matrix is not written.
int plan_launch(const Plan& p, ElimKernel k, int* hp, int* hp_out,
                const int* s_in, int* s_out, int* colofrow, int* steps,
                const int* live, int B, int W, int M, int m, int K, int rank,
                int full_jordan, int exit_on_valid, void* stream) {
  if (!k || m > M || ((uintptr_t)hp & 15)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(p, k);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    k<<<p.grid, 32 * p.T * p.spb, p.smem, (cudaStream_t)stream>>>(
        hp, hp_out, s_in, s_out, colofrow, steps, live, B, W, M, m, K, rank,
        full_jordan, exit_on_valid, p.spb, p.T, p.S);
  }
  return (int)cudaGetLastError();
}

}  // namespace
