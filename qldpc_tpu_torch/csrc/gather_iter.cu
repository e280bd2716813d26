// Iterated gather along rows over a tile that stays on-chip, then a column
// sum: `iters` rounds of y = y[idx[r, l], l] + 1, out = sum over rows.
//
// Replaces: scripts/pallas_gather_bench.py::gather_kernel (the pallas_call
// in pallas_gather), the probe of how fast a dynamic gather runs inside a
// kernel whose data never leaves fast memory (the TPU's VMEM there, shared
// memory here). Its largest case, 35,280 rows, is the edge-slot grid of
// [[144,12,12]] that the flooding BP kernel gathers from every iteration.
//
// Bound on the H100: device memory is touched once (x and idx read, the
// tile and the sums written, 3.35 TB/s); every round reads one gathered
// element and writes one element of shared memory per tile element, so
// shared memory (one 128-byte wavefront a clock per SM) bounds the rounds.
// A random gather is not conflict-free: 32 lanes on uniform random words
// load the busiest of 32 banks ~3.5 times, so a float32 round of 35,280
// elements costs ~1,103 x 3.5 + 1,103 wavefronts, ~2.5 us at 1,980 MHz.
// Design:
// - Lane columns are independent, so a block owns L whole columns and keeps
//   them in shared memory for all rounds (the wrapper's plan picks L; L = 1
//   at 35,280 rows in float32: a 141 KB column).
// - The load and the store go through a thread-block cluster. A column is
//   strided in device memory (`lanes` elements between rows), so a block
//   reading its own column alone touches a 32-byte sector for each 4-byte
//   element. C blocks of a cluster own C x L adjacent lanes; block k of the
//   cluster reads row chunk k for all of the cluster's lanes and stores each
//   element, with its source offset, into the owning block's shared memory
//   over distributed shared memory; after the rounds it reads its chunk back
//   from every owner and writes whole row segments.
// - C is the widest cluster (at most 8, or the fewest blocks whose rows make
//   32 bytes) whose launch the card holds in one wave (the wrapper's plan
//   asks cudaOccupancyMaxActiveClusters). Tall columns need one SM each,
//   and the GPCs of an NVIDIA H100 80GB HBM3 hold 15 clusters of 8 such
//   blocks, 30 of 4 and 66 of 2: 128 lanes of 35,280 rows take clusters of
//   2, rows of 8 bytes in float32.
// - Tall tiles (L = 1, aligned rows) move G rows by P lanes an item: each
//   row's P lanes in one 4- to 16-byte access, and each owner's G rows,
//   consecutive in its tile, in one DSMEM store (see gi_tall_load). Other
//   tiles walk 16-byte slots of each row segment, with narrower accesses at
//   their edges (a row stride or a first lane off a 16-byte boundary, a
//   ragged last cluster), and move each element alone over DSMEM. Blocks
//   past the last lane own nothing but load and store their row chunk and
//   join every cluster barrier.
// - Indices are read once and stored as the uint16 shared-memory offset of
//   their source element (row * Lb + lane): a block's tile holds at most
//   GI_MAX_ELEMS = 36,864 elements, below 65,536. After the load each thread
//   keeps its E offsets in registers, two to a word, so a round makes only
//   the gathered read and the write.
// - In-place hazard: y[r] = y[idx[r]] + 1 may read an element another
//   thread writes in the same round, and two float32 tiles of 35,280 rows
//   do not fit in one block. Each thread gathers its E elements into
//   registers, the block waits, writes them back, waits. E is a template
//   argument, the smallest instance that holds the tile, so the offsets and
//   the staged values are register arrays indexed by constants. Registers
//   bound E: 1,024 threads (64 registers) stage up to 24 elements (36
//   spill), 512 threads (128 registers) up to 72; bf16 values are staged
//   two to a word.
// - bf16: the add is done in float32 and rounded once to bf16, as PyTorch
//   and XLA do; the sums accumulate in float32 and round once at the end.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define GI_MAX_ELEMS 36864      // tile elements of a block: uint16 offsets
#define GI_WIDE_THREADS 1024    // threads of a block whose E <= 24
#define GI_DEEP_THREADS 512     // threads of a block whose E > 24
#define GI_MAX_CLUSTER 8        // the portable cluster size

__device__ __forceinline__ float gi_to_f(float v) { return v; }
__device__ __forceinline__ float gi_to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T gi_from_f(float v);
template <> __device__ __forceinline__ float gi_from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 gi_from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The bits of one element, moved without arithmetic in the load and store.
template <int S> struct GiBits;
template <> struct GiBits<4> { typedef uint32_t type; };
template <> struct GiBits<2> { typedef uint16_t type; };
__device__ __forceinline__ uint32_t gi_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t gi_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// What every block of a launch shares about the cluster's row segments.
struct GiSegments {
  int lanes, L, C;
  int c0;     // first lane of this cluster
  int CL;     // lanes of this cluster
  int r0, r1; // this block's row chunk
  int ns;     // 16-byte slots a row segment spans (at most)
};

template <int V>
__device__ __forceinline__ GiSegments gi_segments(int rows, int lanes, int L,
                                                  int vec) {
  GiSegments s;
  cg::cluster_group cluster = cg::this_cluster();
  s.lanes = lanes;
  s.L = L;
  s.C = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  s.c0 = (int)(blockIdx.x - k) * L;
  s.CL = min(s.C * L, lanes - s.c0);
  const int rpb = ((rows + s.C - 1) / s.C + 3) & ~3;  // a multiple of 4
  s.r0 = min(rows, k * rpb);
  s.r1 = min(rows, s.r0 + rpb);
  // aligned segments start on a slot; otherwise a segment may straddle one
  // more slot than its length needs
  const bool aligned = vec && lanes % V == 0 && s.c0 % V == 0;
  s.ns = aligned ? (s.CL + V - 1) / V : (s.CL + 2 * V - 2) / V;
  return s;
}

// A work item of a block's row chunk is a slot of one row segment: dr rows
// (or row groups) into the chunk, sl slots into the row. A thread walks its
// items blockDim.x apart, carrying (dr, sl) instead of dividing.
struct GiWalk {
  int dr, sl, qs, rs, ns;
  __device__ __forceinline__ GiWalk(int w, int step, int ns_)
      : dr(w / ns_), sl(w - (w / ns_) * ns_), qs(step / ns_),
        rs(step - (step / ns_) * ns_), ns(ns_) {}
  __device__ __forceinline__ void next() {
    dr += qs;
    sl += rs;
    if (sl >= ns) {
      sl -= ns;
      ++dr;
    }
  }
};

// Slot (dr, sl): its row, the first element of the row segment, and the
// first element of the slot (a multiple of V).
struct GiSlot {
  int r;
  long long g0, e0;
};

template <int V>
__device__ __forceinline__ GiSlot gi_slot(const GiSegments& s, int dr,
                                          int sl) {
  GiSlot t;
  t.r = s.r0 + dr;
  t.g0 = (long long)t.r * s.lanes + s.c0;
  t.e0 = (t.g0 & ~(long long)(V - 1)) + (long long)sl * V;
  return t;
}

// Whether slot t lies inside its row segment, so one 16-byte access moves it.
template <int V>
__device__ __forceinline__ bool gi_full(int vec, const GiSlot& t, int CL) {
  return vec && t.e0 >= t.g0 && t.e0 + V <= t.g0 + CL;
}

// The owner of cluster lane q: its rank, lanes and element index of (r, q).
struct GiOwner {
  int b, j, Lo;
};

__device__ __forceinline__ GiOwner gi_owner(const GiSegments& s, int q) {
  GiOwner o;
  if (s.L == 1) {  // the tall tiles: no division
    o.b = q;
    o.j = 0;
    o.Lo = 1;
    return o;
  }
  o.b = q / s.L;
  o.j = q - o.b * s.L;
  o.Lo = min(s.L, s.lanes - (s.c0 + o.b * s.L));
  return o;
}

// NB bytes (4, 8, 16 or 32) between memory and 32-bit words.
template <int NB>
__device__ __forceinline__ void gi_ld(uint32_t* w, const void* p) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int h = 0; h < NB / 16; ++h) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[h];
      w[4 * h] = v.x;
      w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z;
      w[4 * h + 3] = v.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int NB>
__device__ __forceinline__ void gi_st(void* p, const uint32_t* w) {
  if constexpr (NB == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (NB == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// Element k of S bytes (4 or 2) in an array of 32-bit words.
template <int S>
__device__ __forceinline__ uint32_t gi_get(const uint32_t* w, int k) {
  if constexpr (S == 4)
    return w[k];
  else
    return (w[k >> 1] >> (16 * (k & 1))) & 0xffffu;
}

template <int S>
__device__ __forceinline__ void gi_set(uint32_t* w, int k, uint32_t v) {
  if constexpr (S == 4)
    w[k] = v;
  else if (k & 1)
    w[k >> 1] = (w[k >> 1] & 0xffffu) | (v << 16);
  else
    w[k >> 1] = (w[k >> 1] & 0xffff0000u) | v;
}

// Tall tiles (L = 1, aligned rows): a work item is G consecutive rows (4 at
// 512 threads, 2 at 1,024: registers) by P adjacent lanes of the cluster's
// row segment, P x itemsize = 4, 8 or 16 bytes. The loader reads each row's P
// lanes with one access and hands every owner its G rows, consecutive in
// the owner's tile, as one DSMEM store, and their offsets as another; the
// store phase reverses this. Chunks start on a multiple of 4 rows, so those
// stores are aligned; a chunk's last group may hold fewer rows.
struct GiTallItem {
  int rb, nr;    // first row, rows of the group
  long long e;   // element of (rb, the item's first lane)
};

template <int G>
__device__ __forceinline__ GiTallItem gi_tall_item(const GiSegments& s,
                                                   const GiWalk& at, int P) {
  GiTallItem t;
  t.rb = s.r0 + G * at.dr;
  t.nr = min(G, s.r1 - t.rb);
  t.e = (long long)t.rb * s.lanes + s.c0 + at.sl * P;
  return t;
}

template <typename W, int P, int G>
__device__ __forceinline__ void gi_tall_load(const GiSegments& s,
                                             const W* __restrict__ xw,
                                             const int* __restrict__ idx,
                                             W* Yw, uint16_t* src) {
  constexpr int S = sizeof(W);
  cg::cluster_group cluster = cg::this_cluster();
  const int slots = s.CL / P;
  const int work = (s.r1 - s.r0 + G - 1) / G * slots;
  GiWalk at(threadIdx.x, blockDim.x, slots);
  for (int w = threadIdx.x; w < work; w += blockDim.x, at.next()) {
    const GiTallItem t = gi_tall_item<G>(s, at, P);
    uint32_t xv[G][P * S / 4], iv[G][P];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= t.nr) break;
      gi_ld<P * S>(xv[h], xw + t.e + (long long)h * s.lanes);
      gi_ld<P * 4>(iv[h], idx + t.e + (long long)h * s.lanes);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      W* Yo = cluster.map_shared_rank(Yw, at.sl * P + p);
      uint16_t* so = cluster.map_shared_rank(src, at.sl * P + p);
      if (t.nr == G) {  // rows rb..rb+G-1 of lane p, and their offsets
        uint32_t yv[G * S / 4] = {}, ov[G / 2] = {};
#pragma unroll
        for (int h = 0; h < G; ++h) {
          gi_set<S>(yv, h, gi_get<S>(xv[h], p));
          gi_set<2>(ov, h, iv[h][p]);
        }
        gi_st<G * S>(Yo + t.rb, yv);
        gi_st<G * 2>(so + t.rb, ov);
      } else {
#pragma unroll
        for (int h = 0; h < G; ++h) {  // constant h: xv stays in registers
          if (h >= t.nr) break;
          Yo[t.rb + h] = (W)gi_get<S>(xv[h], p);
          so[t.rb + h] = (uint16_t)iv[h][p];
        }
      }
    }
  }
}

template <typename W, int P, int G>
__device__ __forceinline__ void gi_tall_store(const GiSegments& s,
                                              const W* Yw,
                                              W* __restrict__ tw) {
  constexpr int S = sizeof(W);
  cg::cluster_group cluster = cg::this_cluster();
  const int slots = s.CL / P;
  const int work = (s.r1 - s.r0 + G - 1) / G * slots;
  GiWalk at(threadIdx.x, blockDim.x, slots);
  for (int w = threadIdx.x; w < work; w += blockDim.x, at.next()) {
    const GiTallItem t = gi_tall_item<G>(s, at, P);
    uint32_t xv[G][P * S / 4] = {};
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const W* Yo = cluster.map_shared_rank(Yw, at.sl * P + p);
      if (t.nr == G) {
        uint32_t yv[G * S / 4];
        gi_ld<G * S>(yv, Yo + t.rb);
#pragma unroll
        for (int h = 0; h < G; ++h) gi_set<S>(xv[h], p, gi_get<S>(yv, h));
      } else {
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h >= t.nr) break;
          gi_set<S>(xv[h], p, Yo[t.rb + h]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= t.nr) break;
      gi_st<P * S>(tw + t.e + (long long)h * s.lanes, xv[h]);
    }
  }
}

template <typename T, int E, int NT>
__global__ void __launch_bounds__(NT, 1)
gather_iter_kernel(const T* __restrict__ x,      // (rows, lanes)
                   const int* __restrict__ idx,  // (rows, lanes) in [0, rows)
                   T* __restrict__ sum,          // (1, lanes) out
                   T* __restrict__ tile,         // (rows, lanes) out
                   int rows, int lanes, int L, int iters, unsigned y_bytes,
                   int vec) {
  typedef typename GiBits<sizeof(T)>::type W;
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte access moves
  // slots a thread keeps in flight in the load and the store: 16 elements
  // a thread at 512 threads, one slot at 1,024 (64 registers a thread)
  constexpr int U = NT == GI_DEEP_THREADS ? 16 / V : 1;
  constexpr int G = NT == GI_DEEP_THREADS ? 4 : 2;  // rows of a tall item
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int nt = E > 1 ? NT : (int)blockDim.x;
  const GiSegments s = gi_segments<V>(rows, lanes, L, vec);
  const int l0 = s.c0 + (int)cluster.block_rank() * L;
  const int Lb = max(0, min(L, lanes - l0));  // lanes of this block
  const int n = rows * Lb;                    // element i = row * Lb + lane
  T* Y = reinterpret_cast<T*>(smem);
  W* Yw = reinterpret_cast<W*>(smem);  // the same tile, as bits
  uint16_t* src = reinterpret_cast<uint16_t*>(smem + y_bytes);
  const W* xw = reinterpret_cast<const W*>(x);
  W* tw = reinterpret_cast<W*>(tile);
  const int work = (s.r1 - s.r0) * s.ns;
  const int step = U * (int)blockDim.x;

  // tall tiles move P lanes a row and G rows an owner store
  const int P = min(s.C, V);
  const bool tall = L == 1 && vec && P * (int)sizeof(T) >= 4 && lanes % P == 0;

  cluster.sync();  // every block of the cluster runs before any remote store

  // ---- load: row chunk k of the cluster's lanes -> owners' shared memory
  if (tall) {
    if (P == V)
      gi_tall_load<W, V, G>(s, xw, idx, Yw, src);
    else if (P == V / 2)
      gi_tall_load<W, V / 2, G>(s, xw, idx, Yw, src);
    else
      gi_tall_load<W, V / 4, G>(s, xw, idx, Yw, src);
  }
  GiWalk at(tid, blockDim.x, s.ns);
  for (int w0 = tid; !tall && w0 < work; w0 += step) {
    int dr[U], sl[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dr[u] = at.dr;
      sl[u] = at.sl;
      at.next();
    }
    __align__(16) W val[U][V];
    __align__(16) int ix[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load of the batch first
      if (w0 + u * (int)blockDim.x >= work) break;
      const GiSlot t = gi_slot<V>(s, dr[u], sl[u]);
      if (gi_full<V>(vec, t, s.CL)) {
        *reinterpret_cast<uint4*>(val[u]) =
            *reinterpret_cast<const uint4*>(xw + t.e0);
#pragma unroll
        for (int h = 0; h < V / 4; ++h)
          *reinterpret_cast<int4*>(ix[u] + 4 * h) =
              *reinterpret_cast<const int4*>(idx + t.e0 + 4 * h);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const long long e = t.e0 + v;
          if (e >= t.g0 && e < t.g0 + s.CL) {
            val[u][v] = xw[e];
            ix[u][v] = idx[e];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {  // then the remote stores
      if (w0 + u * (int)blockDim.x >= work) break;
      const GiSlot t = gi_slot<V>(s, dr[u], sl[u]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long q = t.e0 + v - t.g0;
        if (q < 0 || q >= s.CL) continue;
        const GiOwner o = gi_owner(s, (int)q);
        const int i = t.r * o.Lo + o.j;
        W* Yo = cluster.map_shared_rank(Yw, o.b);
        uint16_t* so = cluster.map_shared_rank(src, o.b);
        Yo[i] = val[u][v];
        so[i] = (uint16_t)(ix[u][v] * o.Lo + o.j);
      }
    }
  }
  cluster.sync();  // every owner's tile and offsets are in place

  // ---- offsets into registers, two to a word
  uint32_t off[(E + 1) / 2];
#pragma unroll
  for (int p = 0; p < (E + 1) / 2; ++p) {
    const int i0 = tid + 2 * p * nt, i1 = i0 + nt;
    const uint32_t a = i0 < n ? src[i0] : 0u;
    const uint32_t b = (2 * p + 1 < E && i1 < n) ? src[i1] : 0u;
    off[p] = a | (b << 16);
  }

  // ---- the rounds: gather into registers, wait, write back, wait. The
  // empty asm statements make the packed offsets and the bound look
  // changed every round, so the compiler unpacks them where they are used
  // instead of hoisting E unpacked addresses and E predicates out of the
  // loop (which spills).
  int left = n - tid;  // element e of this thread exists while e * nt < left
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < (E + 1) / 2; ++p) asm volatile("" : "+r"(off[p]));
    asm volatile("" : "+r"(left));
    uint32_t stage[sizeof(T) == 4 ? E : (E + 1) / 2];  // bf16: two a word
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t o = (off[e >> 1] >> (16 * (e & 1))) & 0xffffu;
      uint32_t v = 0;
      if (e * nt < left) v = gi_bits(gi_from_f<T>(gi_to_f(Y[o]) + 1.0f));
      if constexpr (sizeof(T) == 4)
        stage[e] = v;
      else if (e & 1)
        stage[e >> 1] |= v << 16;
      else
        stage[e >> 1] = v;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e * nt >= left) continue;
      if constexpr (sizeof(T) == 4)
        Yw[tid + e * nt] = stage[e];
      else
        Yw[tid + e * nt] = (W)(stage[e >> 1] >> (16 * (e & 1)));
    }
    __syncthreads();
  }

  // ---- column sums of this block's own lanes
  const int nw = (int)blockDim.x >> 5;
  for (int j = 0; j < Lb; ++j) {
    float acc = 0.f;
    for (int r = tid; r < rows; r += blockDim.x) acc += gi_to_f(Y[r * Lb + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((tid & 31) == 0) red[tid >> 5] = acc;
    __syncthreads();
    if (tid < 32) {
      float v = tid < nw ? red[tid] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (tid == 0) sum[l0 + j] = gi_from_f<T>(v);
    }
    __syncthreads();  // red is reused by the next column
  }

  cluster.sync();  // every block's rounds are done

  // ---- store: row chunk k of every owner's tile -> whole row segments
  if (tall) {
    if (P == V)
      gi_tall_store<W, V, G>(s, Yw, tw);
    else if (P == V / 2)
      gi_tall_store<W, V / 2, G>(s, Yw, tw);
    else
      gi_tall_store<W, V / 4, G>(s, Yw, tw);
  }
  GiWalk st(tid, blockDim.x, s.ns);
  for (int w0 = tid; !tall && w0 < work; w0 += step) {
    int dr[U], sl[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dr[u] = st.dr;
      sl[u] = st.sl;
      st.next();
    }
    __align__(16) W val[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every remote load of the batch first
      if (w0 + u * (int)blockDim.x >= work) break;
      const GiSlot t = gi_slot<V>(s, dr[u], sl[u]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long q = t.e0 + v - t.g0;
        if (q < 0 || q >= s.CL) continue;
        const GiOwner o = gi_owner(s, (int)q);
        const W* Yo = cluster.map_shared_rank(Yw, o.b);
        val[u][v] = Yo[t.r * o.Lo + o.j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {  // then the row segments
      if (w0 + u * (int)blockDim.x >= work) break;
      const GiSlot t = gi_slot<V>(s, dr[u], sl[u]);
      if (gi_full<V>(vec, t, s.CL)) {
        *reinterpret_cast<uint4*>(tw + t.e0) =
            *reinterpret_cast<const uint4*>(val[u]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const long long e = t.e0 + v;
          if (e >= t.g0 && e < t.g0 + s.CL) tw[e] = val[u][v];
        }
      }
    }
  }
  cluster.sync();  // no block exits while another still reads its tile
}

struct GiArgs {
  const void* x;
  const int* idx;
  void* sum;
  void* tile;
  int rows, lanes, L, C, iters, threads, vec;
  cudaStream_t stream;
};

// Launches one instance, or with `info` fills info[0..5] with the active
// clusters the launch can hold, registers and spilled bytes a thread, E,
// blocks of the grid and dynamic shared bytes a block, and launches nothing.
template <typename T, int E, int NT>
static int run(const GiArgs& a, int* info) {
  void (*kern)(const T*, const int*, T*, T*, int, int, int, int, unsigned,
               int) = gather_iter_kernel<T, E, NT>;
  const size_t y_bytes = ((size_t)a.rows * a.L * sizeof(T) + 15) & ~(size_t)15;
  const size_t smem = y_bytes + (size_t)a.rows * a.L * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.lanes + a.L - 1) / a.L;
  const int grid = (blocks + a.C - 1) / a.C * a.C;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid > 0 ? grid : a.C);
  cfg.blockDim = dim3(a.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    info[0] = clusters;
    info[1] = fa.numRegs;
    info[2] = (int)fa.localSizeBytes;
    info[3] = E;
    info[4] = grid;
    info[5] = (int)smem;
    return (int)err;
  }
  if (grid > 0 && a.rows > 0) {
    err = cudaLaunchKernelEx(&cfg, kern, (const T*)a.x, a.idx, (T*)a.sum,
                             (T*)a.tile, a.rows, a.lanes, a.L, a.iters,
                             (unsigned)y_bytes, a.vec);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The smallest instance whose E holds rows * L elements on a.threads.
template <typename T>
static int dispatch(const GiArgs& a, int* info) {
  const int n = a.rows * a.L;
  const int need = (n + a.threads - 1) / a.threads;
  if (a.C < 1 || a.C > GI_MAX_CLUSTER || n > GI_MAX_ELEMS)
    return (int)cudaErrorInvalidValue;
  if (a.threads == GI_DEEP_THREADS) {
#define GI_DEEP(e) \
  if (need <= e) return run<T, e, GI_DEEP_THREADS>(a, info);
    GI_DEEP(56) GI_DEEP(64) GI_DEEP(72)
#undef GI_DEEP
    return (int)cudaErrorInvalidValue;
  }
  if (need <= 1) return run<T, 1, GI_WIDE_THREADS>(a, info);
  if (a.threads != GI_WIDE_THREADS) return (int)cudaErrorInvalidValue;
#define GI_WIDE(e) \
  if (need <= e) return run<T, e, GI_WIDE_THREADS>(a, info);
  GI_WIDE(2) GI_WIDE(4) GI_WIDE(8) GI_WIDE(16) GI_WIDE(24)
#undef GI_WIDE
  return (int)cudaErrorInvalidValue;
}

static int entry(const void* x, const int* idx, void* sum, void* tile,
                 int rows, int lanes, int L, int C, int iters, int is_bf16,
                 int threads, void* stream, int* info) {
  const int vec =
      (((uintptr_t)x | (uintptr_t)idx | (uintptr_t)tile) & 15) == 0;
  const GiArgs a = {x, idx, sum, tile, rows, lanes, L, C, iters, threads,
                    vec, (cudaStream_t)stream};
  return is_bf16 ? dispatch<__nv_bfloat16>(a, info) : dispatch<float>(a, info);
}

// is_bf16: 0 -> float32 tile, 1 -> bfloat16 tile. The caller's plan
// guarantees rows * L <= GI_MAX_ELEMS, threads = 512 when that needs more
// than 24 elements a thread at 1024 threads (else 1024, or fewer when one
// element a thread holds the tile), 1 <= C <= 8, and that the tile plus its
// uint16 offsets fit the block's shared memory.
extern "C" int gather_iter_launch(const void* x, const int* idx, void* sum,
                                  void* tile, int rows, int lanes, int L,
                                  int C, int iters, int is_bf16, int threads,
                                  void* stream) {
  return entry(x, idx, sum, tile, rows, lanes, L, C, iters, is_bf16, threads,
               stream, nullptr);
}

// The launch gather_iter_launch would make for this plan, in info[0..5]:
// active clusters, registers, spilled bytes, E, grid blocks, shared bytes.
extern "C" int gather_iter_info(int rows, int lanes, int L, int C,
                                int is_bf16, int threads, int* info) {
  return entry(nullptr, nullptr, nullptr, nullptr, rows, lanes, L, C, 0,
               is_bf16, threads, nullptr, info);
}
