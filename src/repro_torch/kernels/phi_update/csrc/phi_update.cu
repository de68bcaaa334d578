// Word-row count updates of phi for LDA training.
//
// Replaces two Pallas TPU kernels of repro/kernels/phi_update/kernel.py:
//  * phi_delta_tiles (K2, body _delta_kernel): the per-iteration delta
//    counts(z_new) - counts(z_old) per word row, over masked tokens;
//  * phi_update_tiles (K4, body _kernel): counts(z) per word row, a full
//    rebuild.
// Both produce a (V, K) int32 matrix in which rows that no tile visits are 0.
// The output is zeroed up front (cudaMemsetAsync) and every count is an
// integer add, so the result is exact whatever order the adds land in.
//
// Bound: bytes.  The least traffic is reading z (and z_old), the mask and the
// tile words once, and writing the (V, K) int32 output once (416 MB at
// NYTimes width).
//
// K2 design (phi_delta_kernel).  The TPU kernel walks the tiles in order and
// keeps a word's (1, K) output block resident across the word's run of
// tiles, zeroing it on tile_first.  Here blocks run in parallel and in no
// order, so the run structure comes as a segment table built once per
// tiling (kernels/phi_update/ops.py::segment_table): rows (first tile,
// tiles, word, sole), each a stretch of at most kSegTiles consecutive tiles
// of one word, cut wherever the word changes or tile_first is set; `sole`
// marks a word that owns exactly one segment.
//  * one warp per segment, with its own K-bin histogram in shared memory
//    (per-warp sub-histograms: no other warp adds into it); a CTA's warps
//    take different segments, and the warps of the grid stride over the
//    table (a persistent grid sized to the card), so a warp zeroes its
//    histogram once and then resets only the bins it flushes.  A
//    segment's slots are contiguous: a lane takes 8 consecutive slots a
//    step, z and the mask read as 16- and 8-byte vectors in their stored
//    types (int16, C7, or int32), a whole 256-slot tile per warp step.
//  * a token whose topic did not move adds nothing; a moved one adds +1 at
//    z_new and -1 at z_old with shared atomics, one a moved token.
//    Aggregating a warp's equal bins with __match_any_sync first cost more
//    than it saved (the match is slow and the bins of 8 slots a lane
//    rarely meet; PERF.md).
//  * one flush per segment, not per tile: the warp scans its K bins once,
//    8 consecutive a lane.  A sole word's row (nothing else writes it) takes
//    every 32-byte sector that holds a count as two 16-byte stores, whole
//    and coalesced: scattered 4-byte stores of single bins cost more than
//    the row (partial sectors).  A heavy word's segments add their
//    non-zero bins with global atomics, kSegTiles tiles' worth of tokens
//    per atomic instead of one tile's, so the heaviest word's row takes
//    about 410 segments' adds at NYTimes size, not 52k tiles'.
//  * padding tiles (pad_tiles_to) alias the last word with an all-false
//    mask: they join its last segment and add nothing.
//
// K4 keeps the per-tile design of the first port (one CTA per tile, a
// shared K-bin histogram, non-zero bins added with global atomics): it
// runs once per training run, to rebuild or check phi.
//
// Build variants, for measurement only (kernel_probe.py builds them with
// -D): PHI_UPDATE_PROBE=1 builds K2's histograms but writes nothing to the
// output besides its memset (the bins are still reset); =2 reads the tokens
// and counts nothing.  Probe builds give wrong counts.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PHI_UPDATE_PROBE
#define PHI_UPDATE_PROBE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kSegTiles = 128;       // tiles a segment at most
constexpr int kProbe = PHI_UPDATE_PROBE;
constexpr int kSlots = 8;            // consecutive slots a lane takes a step
constexpr int kStep = 32 * kSlots;   // slots a warp takes a step
constexpr int kMaxSmem = 232448;     // a Hopper block's shared-memory limit
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- K2 ----

// Lane's 8 slots from s: their new and old topics, and a bit per slot whose
// topic moved (a real token with z_new != z_old).
template <typename Z>
__device__ __forceinline__ unsigned load_moves(
    const Z* __restrict__ z_new, const Z* __restrict__ z_old,
    const uint8_t* __restrict__ mask, int64_t s, int64_t end, bool vec,
    int (&kn)[kSlots], int (&ko)[kSlots]) {
  unsigned moved = 0;
  if (vec) {                    // s is a multiple of 8 and end - s >= 8
    constexpr int kVecs = kSlots * sizeof(Z) / 16;
    union { uint4 v[kVecs]; Z e[kSlots]; } a, b;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      a.v[i] = reinterpret_cast<const uint4*>(z_new + s)[i];
      b.v[i] = reinterpret_cast<const uint4*>(z_old + s)[i];
    }
    const uint2 m = *reinterpret_cast<const uint2*>(mask + s);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      kn[i] = (int)a.e[i];
      ko[i] = (int)b.e[i];
      const unsigned byte = ((i < 4 ? m.x : m.y) >> (8 * (i & 3))) & 0xffu;
      if (byte && kn[i] != ko[i]) moved |= 1u << i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      kn[i] = ko[i] = 0;
      if (s + i < end && mask[s + i]) {
        kn[i] = (int)z_new[s + i];
        ko[i] = (int)z_old[s + i];
        if (kn[i] != ko[i]) moved |= 1u << i;
      }
    }
  }
  return moved;
}

// hist[key] += sign (key < 0: nothing).
__device__ __forceinline__ void add_bin(int* hist, int key, int sign) {
  if (kProbe != 2 && key >= 0) atomicAdd(&hist[key], sign);
}

// Move the bins [k, k + n) that hold a count to the word's row and reset
// them: a sole word's row takes them as plain stores, a shared one adds
// them with atomics.
__device__ __forceinline__ void flush_bins(int* hist, int* row, int k, int n,
                                           bool sole) {
  for (int i = k; i < k + n; ++i) {
    const int v = hist[i];
    if (v == 0) continue;
    hist[i] = 0;
    if (kProbe != 0) continue;
    if (sole) {
      row[i] = v;
    } else {
      atomicAdd(&row[i], v);
    }
  }
}

template <typename Z>
__global__ void __launch_bounds__(kThreads)
phi_delta_kernel(const int4* __restrict__ segs,      // (S,) first, tiles,
                 int n_segs,                         //   word, sole
                 const Z* __restrict__ z_new,        // (n, t)
                 const Z* __restrict__ z_old,        // (n, t)
                 const uint8_t* __restrict__ mask,   // (n, t)
                 int* __restrict__ out,              // (V, K), pre-zeroed
                 int t, int K, bool vec) {
  extern __shared__ __align__(16) int hists[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int* hist = hists + (size_t)warp * K;
  for (int k = lane; k < K; k += 32) hist[k] = 0;
  __syncwarp();
  // rows as whole 32-byte sectors: a sector with a count is written whole
  const bool sectors = K % kSlots == 0;

  unsigned probe_moved = 0;     // probe 2: keeps the loads
  const int stride = gridDim.x * warps;
  for (int sg = blockIdx.x * warps + warp; sg < n_segs; sg += stride) {
    const int4 seg = segs[sg];
    const int64_t beg = (int64_t)seg.x * t;
    const int64_t end = beg + (int64_t)seg.y * t;
    for (int64_t s = beg + lane * kSlots; s < end + lane * kSlots;
         s += kStep) {
      int kn[kSlots], ko[kSlots];
      const unsigned moved =
          s < end ? load_moves(z_new, z_old, mask, s, end, vec, kn, ko) : 0u;
      probe_moved |= moved;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const bool m = (moved >> i) & 1u;
        add_bin(hist, m ? kn[i] : -1, 1);
        add_bin(hist, m ? ko[i] : -1, -1);
      }
    }
    __syncwarp();
    int* row = out + (int64_t)seg.z * K;
    const bool sole = seg.w != 0;
    if (sectors) {
      for (int k = lane * kSlots; k < K; k += kStep) {
        int4* h = reinterpret_cast<int4*>(hist + k);
        const int4 a = h[0], b = h[1];
        if (!(a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w)) continue;
        if (sole) {          // the row was zeroed: write the sector whole
          h[0] = h[1] = make_int4(0, 0, 0, 0);
          if (kProbe == 0) {
            reinterpret_cast<int4*>(row + k)[0] = a;
            reinterpret_cast<int4*>(row + k)[1] = b;
          }
        } else {
          flush_bins(hist, row, k, kSlots, false);
        }
      }
    } else {
      for (int k = lane; k < K; k += 32) flush_bins(hist, row, k, 1, sole);
    }
    __syncwarp();   // the histogram is clean before the next segment
  }
  if (kProbe == 2 && probe_moved == kFull) out[0] = 1;  // never: no counts
}

struct Grid {
  int blocks = 0, warps = 0;
};

// A persistent grid: as many CTAs as the card holds at once, each of as
// many warps (up to 8) as K-bin histograms fit its shared memory.
template <typename Z>
cudaError_t delta_grid(int K, int n_segs, Grid* g, size_t* smem) {
  const int warps = (int)(kMaxSmem / (sizeof(int) * (size_t)K));
  g->warps = warps < kThreads / 32 ? warps : kThreads / 32;
  if (g->warps < 1) return cudaErrorInvalidValue;
  *smem = sizeof(int) * (size_t)K * g->warps;
  cudaError_t e;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(phi_delta_kernel<Z>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, phi_delta_kernel<Z>, 32 * g->warps, *smem);
  if (e != cudaSuccess) return e;
  const int need = (n_segs + g->warps - 1) / g->warps;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  g->blocks = need < fit ? need : fit;
  return cudaSuccess;
}

template <typename Z>
int launch_delta(const int4* segs, int n_segs, const void* z_new,
                 const void* z_old, const uint8_t* mask, int* out, int t,
                 int V, int K, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)V * K, stream);
  if (e != cudaSuccess) return (int)e;
  if (n_segs <= 0) return (int)cudaSuccess;
  Grid g;
  size_t smem = 0;
  if ((e = delta_grid<Z>(K, n_segs, &g, &smem)) != cudaSuccess) return (int)e;
  const bool vec = t % kSlots == 0
                   && reinterpret_cast<uintptr_t>(z_new) % 16 == 0
                   && reinterpret_cast<uintptr_t>(z_old) % 16 == 0
                   && reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  phi_delta_kernel<Z><<<g.blocks, 32 * g.warps, smem, stream>>>(
      segs, n_segs, static_cast<const Z*>(z_new), static_cast<const Z*>(z_old),
      mask, out, t, K, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K4 ----

template <typename Z>
__global__ void __launch_bounds__(kThreads)
phi_update_kernel(const int* __restrict__ tile_word,   // (n,)
                  const Z* __restrict__ z,             // (n, t)
                  const uint8_t* __restrict__ mask,    // (n, t)
                  int* __restrict__ out,               // (V, K), pre-zeroed
                  int t, int K) {
  extern __shared__ int hist[];
  const int tile = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x) hist[k] = 0;
  __syncthreads();

  const int64_t base = (int64_t)tile * t;
  int real = 0;
  for (int s = threadIdx.x; s < t; s += blockDim.x) {
    if (!mask[base + s]) continue;
    atomicAdd(&hist[(int)z[base + s]], 1);
    real = 1;
  }
  if (!__syncthreads_or(real)) return;

  int* row = out + (int64_t)tile_word[tile] * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int h = hist[k];
    if (h != 0) atomicAdd(&row[k], h);
  }
}

template <typename Z>
int launch_update(const int* tile_word, const void* z, const uint8_t* mask,
                  int* out, int n, int t, int V, int K, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)V * K, stream);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(int) * (size_t)K;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(phi_update_kernel<Z>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  phi_update_kernel<Z><<<n, kThreads, smem, stream>>>(
      tile_word, static_cast<const Z*>(z), mask, out, t, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int phi_delta_segment_tiles() { return kSegTiles; }

extern "C" int phi_delta_tiles_launch(const int* segments, int n_segs,
                                      const void* z_new, const void* z_old,
                                      const uint8_t* mask, int* out, int t,
                                      int V, int K, int z_bytes,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* segs = reinterpret_cast<const int4*>(segments);
  if (z_bytes == 2)
    return launch_delta<int16_t>(segs, n_segs, z_new, z_old, mask, out, t, V,
                                 K, s);
  if (z_bytes == 4)
    return launch_delta<int32_t>(segs, n_segs, z_new, z_old, mask, out, t, V,
                                 K, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int phi_update_tiles_launch(const int* tile_word, const void* z,
                                       const uint8_t* mask, int* out, int n,
                                       int t, int V, int K, int z_bytes,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_bytes == 2)
    return launch_update<int16_t>(tile_word, z, mask, out, n, t, V, K, s);
  if (z_bytes == 4)
    return launch_update<int32_t>(tile_word, z, mask, out, n, t, V, K, s);
  return (int)cudaErrorInvalidValue;
}
