// The ELL of dense doc-topic counts for LDA training: theta (rows, K) int32
// -> counts and topics (rows, P) in the ELL's type (int16 or int32), and a
// flag a row for more than P non-zero topics.
//
// Replaces no TPU kernel: the JAX package leaves this step to lax.top_k
// (repro/core/updates.py::theta_to_ell), and the port's plain version
// (kernels/ell_select/ref.py) stable-sorts every whole row.  The kernel gives
// lax.top_k's order exactly (F1) — count descending, ties to the lower topic
// id, zero counts last in id order — and so the plain version's output bit
// for bit, padding included.
//
// Input contract: theta holds non-negative int32 counts, K a row, rows
// contiguous.  A negative count has no place in that order; nothing checks
// for one (a check would read theta again).
//
// Bound: bytes.  The least traffic reads theta once and writes the ELL once:
// rows x K x 4 bytes in, rows x P x 2 x (2 or 4) out; at NYTimes (299,752 x
// 1024, P = 512, int16) 1.23 GB + 0.61 GB, 0.55 ms at 3.35 TB/s.  The sort it
// replaces moved about 24 bytes of temporaries a (row, topic) besides.
//
// Design: a warp a row, one launch for all rows, nothing in device memory
// but the outputs.
//  * the row is read once, 16 bytes a lane (4 where K % 4 != 0 or theta is
//    not 16-byte aligned), kTile = 1024 topics at a time held in registers;
//    a longer row is taken in tiles and read a second time for the ranks.
//  * one warp scan per four vectors (their non-zero counts packed 8 bits
//    each into a word) gives each non-zero topic its place in id order:
//    the non-zeros are compacted into a per-warp list in shared memory (the
//    topic's place in the tile and its count in one word), and a zero topic
//    takes the rank nnz + the zero topics before it.
//  * a count below kBins is ranked by a stable counting sort, as K3 ranks
//    (fold_in.cu): the list is walked 32 entries at a time in id order;
//    the lanes of equal count are found by kBinBits ballots on the count's
//    bits (no __match_any_sync), and the group's lowest lane adds it to
//    the count's bin.  base[c] = the topics of a count above c (the bins'
//    suffix sums, plus the counts of kBins and more); a second walk gives
//    each entry base[c] plus the equal counts before it in its group, and
//    the group's highest lane moves base[c] past the group.
//  * a count of kBins or more: a row holds at most its length / kBins of
//    them.  A trained theta has them (a document gathers its tokens on a
//    few topics) where random topics over the same lengths have none.  The
//    warp ranks them one at a time, exactly: each lane counts the topics
//    that go before it in every 32nd vector of the row (a coalesced read
//    of the row from L1 or L2) and five shuffles sum the lanes.
//  * the first P ranks go into a per-warp staging area in shared memory
//    and then out in 16-byte stores (scattered 2-byte stores would write
//    partial sectors); where the staging area would not fit in a block, they
//    go straight to device memory.  A vector of zero topics whose first rank
//    is P or more ends the zero pass (ranks rise with the id).
//  * the walks are chains of dependent shared-memory and ballot steps, so
//    warps, not registers, hide their latency: 8 blocks of up to 4 warps
//    (rows) an SM, 64 registers a thread.  That cap spills (ptxas, CUDA
//    12.8, either ELL type): 148 B of stores and 168 B of loads a thread
//    with 16-byte loads (G = 4), 524 B / 656 B with 4-byte loads (G = 1);
//    unbounded, 98 registers at 14 warps an SM timed 20-25% slower at
//    G = 4 (PERF.md).  Rows a block: as many as keep the block within
//    48 KB of shared memory, at most 4 (4 at K = 1024, P = 512 or 256);
//    the shape follows from K, P and the ELL's type alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 1024;            // topics a warp holds at once
constexpr int kBinBits = 7;
constexpr int kBins = 1 << kBinBits;   // counts 1 .. kBins - 1 are binned
constexpr int kMaxWarps = 4;           // rows a block at most
constexpr int kBlocksPerSm = 8;        // 32 warps an SM, 64 registers each
constexpr int kBlockSmem = 48 * 1024;  // a block's shared memory, no opt-in
static_assert(kBins == 4 * 32, "the bins' suffix scan takes 4 bins a lane");
static_assert(kTile <= (1 << (31 - kBinBits)), "a list entry packs both");

constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// G consecutive counts of a row, a lane's share of one load; -1 past K
template <int G>
struct Vec;
template <>
struct Vec<4> {
  int4 v;
  __device__ __forceinline__ void load(const int* p, bool valid) {
    v = valid ? __ldg(reinterpret_cast<const int4*>(p))
              : make_int4(-1, -1, -1, -1);
  }
  __device__ __forceinline__ int operator[](int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<1> {
  int v;
  __device__ __forceinline__ void load(const int* p, bool valid) {
    v = valid ? __ldg(p) : -1;
  }
  __device__ __forceinline__ int operator[](int) const { return v; }
};

// The lanes whose c equals this lane's (0 <= c < kBins).
__device__ __forceinline__ unsigned equal_lanes(int c) {
  unsigned eq = kFull;
#pragma unroll
  for (int b = 0; b < kBinBits; ++b) {
    const bool bit = (c >> b) & 1;
    const unsigned m = __ballot_sync(kFull, bit);
    eq &= bit ? m : ~m;
  }
  return eq;
}

// A tile of the row (topics k0 .. k0 + kTile) into registers: vector i of
// lane l holds the tile's topics (32 i + l) G .. + G, so (i, lane, j) is id
// order.  before[i]: the tile's non-zeros ahead of this lane's vector i.
// Writes the tile's non-zeros, in id order, into list (place in the tile
// << kBinBits | count, the count 0 where it is kBins or more) and returns
// how many there are.
template <int G, int V>
__device__ __forceinline__ int take_tile(const int* src, int K, int k0,
                                         int lane, Vec<G> (&v)[V],
                                         int (&before)[V], int* list) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = k0 + (i * 32 + lane) * G;
    v[i].load(src + k, k < K);
  }
  // four vectors' counts a word, 8 bits each: a field sums to 32 G <= 128
  int run = 0;
#pragma unroll
  for (int q = 0; q < V; q += 4) {
    unsigned x = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int n = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) n += v[q + e][j] > 0;
      x |= (unsigned)n << (8 * e);
    }
    const unsigned mine = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const unsigned total = __shfl_sync(kFull, x, 31);
    const unsigned ahead = x - mine;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      before[q + e] = run + (int)((ahead >> (8 * e)) & 255u);
      run += (int)((total >> (8 * e)) & 255u);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    int pos = before[i];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int c = v[i][j];
      if (c > 0) {
        const int place = (i * 32 + lane) * G + j;
        list[pos++] = place << kBinBits | (c < kBins ? c : 0);
      }
    }
  }
  __syncwarp();
  return run;
}

// The tile's zero topics (topics k0 + place): rank nnz + the zeros ahead
// of them, written while below P (ranks rise with the id, so the first
// vector whose first rank is P or more ends it).
template <int G, int V, typename E>
__device__ __forceinline__ void write_zeros(const Vec<G> (&v)[V],
                                            const int (&before)[V], int lane,
                                            int k0, int zeros_ahead, int nnz,
                                            int P, E* oc, E* ot) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int first = i * 32 * G;     // the vector's first place
    if (nnz + zeros_ahead + first - __shfl_sync(kFull, before[i], 0) >= P)
      break;
    int nz_own = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int c = v[i][j];
      const int place = (i * 32 + lane) * G + j;
      if (c == 0) {
        const int r = nnz + zeros_ahead + place - before[i] - nz_own;
        if (r < P) {
          oc[r] = 0;
          ot[r] = (E)(k0 + place);
        }
      }
      nz_own += c > 0;
    }
  }
}

// The rank of topic k of count c >= kBins, the warp together: the row's
// topics of a larger count, and of an equal one at a lower id.  Each lane
// reads every 32nd vector of the row (coalesced, from L1 or L2: the warp
// has just read the row) and the warp sums the lanes' tallies.
template <int G>
__device__ __forceinline__ int rank_of_large(const int* src, int K, int c,
                                             int k, int lane) {
  int r = 0;
  for (int i = lane * G; i < K; i += 32 * G) {
    Vec<G> x;
    x.load(src + i, true);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int y = x[j];
      r += y > c || (y == c && i + j < k);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(kFull, r, o);
  return r;
}

template <int G, typename E>
__global__ void __launch_bounds__(kMaxWarps * 32, kBlocksPerSm)
    ell_select_kernel(const int* __restrict__ theta, int64_t rows, int K,
                      int P, E* __restrict__ counts, E* __restrict__ topics,
                      bool* __restrict__ over, int list_bytes,
                      int stage_bytes, bool vec_out) {
  constexpr int V = kTile / (32 * G);
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;            // no block barrier below

  char* own = reinterpret_cast<char*>(smem)
              + warp * (kBins * 4 + list_bytes + 2 * stage_bytes);
  int* bins = reinterpret_cast<int*>(own);
  int* list = bins + kBins;
  E* sc = reinterpret_cast<E*>(own + kBins * 4 + list_bytes);
  E* st = reinterpret_cast<E*>(own + kBins * 4 + list_bytes + stage_bytes);
  const int* src = theta + row * K;
  E* gc = counts + row * P;
  E* gt = topics + row * P;
  const bool staged = stage_bytes > 0;
  E* oc = staged ? sc : gc;           // where ranks below P are written
  E* ot = staged ? st : gt;

  for (int b = lane; b < kBins; b += 32) bins[b] = 0;
  __syncwarp();

  const int tiles = (K + kTile - 1) / kTile;
  Vec<G> v[V];
  int before[V];
  int tile_nz = 0;

  // ---- pass 1: the non-zeros and the histogram of their counts (a row of
  // one tile ranks its zero topics here too) ----
  int nnz = 0;
  for (int t = 0; t < tiles; ++t) {
    tile_nz = take_tile<G, V>(src, K, t * kTile, lane, v, before, list);
    if (tiles == 1)
      write_zeros<G, V, E>(v, before, lane, 0, 0, tile_nz, P, oc, ot);
    for (int q = 0; q < tile_nz; q += 32) {
      const int c = q + lane < tile_nz ? list[q + lane] & (kBins - 1) : 0;
      const unsigned eq = equal_lanes(c);
      if (c > 0 && lane == __ffs(eq) - 1) bins[c] += __popc(eq);
      __syncwarp();
    }
    nnz += tile_nz;
  }

  // ---- bins -> base[c]: the topics ranked ahead of every count c ----
  {
    int b[4], s = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b[e] = bins[4 * lane + e];
      s += b[e];
    }
    int x = s;                        // suffix sums over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFull, x, o);
      if (lane + o < 32) x += y;
    }
    const int binned = __shfl_sync(kFull, x, 0);
    int above = nnz - binned + x - s; // counts >= kBins, higher lanes' bins
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      bins[4 * lane + e] = above;
      above += b[e];
    }
    __syncwarp();
  }

  // ---- pass 2: every other rank below P ----
  const unsigned lanes_below = (1u << lane) - 1u;
  int nz_ahead = 0;                   // non-zeros of the earlier tiles
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    if (tiles > 1) {
      tile_nz = take_tile<G, V>(src, K, k0, lane, v, before, list);
      write_zeros<G, V, E>(v, before, lane, k0, k0 - nz_ahead, nnz, P, oc,
                           ot);
    }
    for (int q = 0; q < tile_nz; q += 32) {
      const bool live = q + lane < tile_nz;
      const int entry = live ? list[q + lane] : 0;
      const int c = entry & (kBins - 1);
      const int k = k0 + (entry >> kBinBits);
      const unsigned eq = equal_lanes(c);
      if (live && c > 0) {
        const int r = bins[c] + __popc(eq & lanes_below);
        if (r < P) {
          oc[r] = (E)c;
          ot[r] = (E)k;
        }
      }
      __syncwarp();
      if (live && c > 0 && lane == 31 - __clz(eq)) bins[c] += __popc(eq);
      // the group's counts of kBins or more, one at a time
      for (unsigned big_lanes = __ballot_sync(kFull, live && c == 0);
           big_lanes; big_lanes &= big_lanes - 1) {
        const int owner = __ffs(big_lanes) - 1;
        const int kb = __shfl_sync(kFull, k, owner);
        const int big = __ldg(src + kb);
        const int r = rank_of_large<G>(src, K, big, kb, lane);
        if (lane == owner && r < P) {
          oc[r] = (E)big;
          ot[r] = (E)kb;
        }
      }
      __syncwarp();
    }
    nz_ahead += tile_nz;
  }

  if (staged) {
    __syncwarp();
    if (vec_out) {
      const int n = P * (int)sizeof(E) / 16;
      const int4* a = reinterpret_cast<const int4*>(sc);
      const int4* b = reinterpret_cast<const int4*>(st);
      int4* ga = reinterpret_cast<int4*>(gc);
      int4* gb = reinterpret_cast<int4*>(gt);
      for (int i = lane; i < n; i += 32) {
        ga[i] = a[i];
        gb[i] = b[i];
      }
    } else {
      for (int i = lane; i < P; i += 32) {
        gc[i] = sc[i];
        gt[i] = st[i];
      }
    }
  }
  if (lane == 0) over[row] = nnz > P;
}

// The launch's shape from K, P and the ELL's element size alone.
struct Shape {
  int warps, list_bytes, stage_bytes;
  size_t smem;
};

Shape shape_for(int K, int P, int ell_bytes) {
  Shape s;
  s.list_bytes = round16((K < kTile ? K : kTile) * 4);
  const int fixed = kBins * 4 + s.list_bytes;
  const int stage = round16(P * ell_bytes);
  s.stage_bytes = fixed + 2 * stage <= kBlockSmem ? stage : 0;
  const int per_warp = fixed + 2 * s.stage_bytes;
  const int fit = kBlockSmem / per_warp;    // >= 1: per_warp <= 48 KB
  s.warps = fit > kMaxWarps ? kMaxWarps : fit;
  s.smem = (size_t)s.warps * per_warp;
  return s;
}

template <int G, typename E>
int launch(const int* theta, int64_t rows, int K, int P, void* counts,
           void* topics, bool* over, cudaStream_t stream) {
  const Shape s = shape_for(K, P, (int)sizeof(E));
  const bool vec_out = P * (int)sizeof(E) % 16 == 0
                       && reinterpret_cast<uintptr_t>(counts) % 16 == 0
                       && reinterpret_cast<uintptr_t>(topics) % 16 == 0;
  const int64_t blocks = (rows + s.warps - 1) / s.warps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ell_select_kernel<G, E><<<(unsigned)blocks, s.warps * 32, s.smem, stream>>>(
      theta, rows, K, P, static_cast<E*>(counts), static_cast<E*>(topics),
      over, s.list_bytes, s.stage_bytes, vec_out);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_e(const int* theta, int64_t rows, int K, int P, void* counts,
             void* topics, bool* over, cudaStream_t stream) {
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(theta) % 16 == 0)
    return launch<4, E>(theta, rows, K, P, counts, topics, over, stream);
  return launch<1, E>(theta, rows, K, P, counts, topics, over, stream);
}

}  // namespace

// Rows a block (warps) that a launch at (K, P, ELL element bytes) takes.
extern "C" int ell_select_rows_per_block(int K, int P, int ell_bytes) {
  return shape_for(K, P, ell_bytes).warps;
}

extern "C" int ell_select_launch(const int* theta, long long rows, int K,
                                 int P, void* counts, void* topics,
                                 bool* over, int ell_bytes, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (K <= 0 || P < 0 || P > K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ell_bytes == 2)
    return launch_e<int16_t>(theta, rows, K, P, counts, topics, over, s);
  if (ell_bytes == 4)
    return launch_e<int32_t>(theta, rows, K, P, counts, topics, over, s);
  return (int)cudaErrorInvalidValue;
}
