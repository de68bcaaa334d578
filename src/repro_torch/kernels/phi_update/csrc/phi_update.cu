// Word-row count updates of phi for LDA training.
//
// Replaces two Pallas TPU kernels of repro/kernels/phi_update/kernel.py:
//  * phi_delta_tiles (K2, body _delta_kernel): the per-iteration delta
//    counts(z_new) - counts(z_old) per word row, over masked tokens;
//  * phi_update_tiles (K4, body _kernel): counts(z) per word row, a full
//    rebuild.
// Both produce a (V, K) int32 matrix in which rows that no tile visits are 0,
// from one kernel body (phi_count_kernel) in two modes: a delta, and a full
// count, which is a delta with no z_old in which every real token counts.
// Every count is an integer add, so the result is exact whatever order the
// adds land in.
//
// Bound: bytes.  The least traffic is reading z (and z_old), the mask, the
// segment table (and K4's list of rows to zero) once, and writing the (V, K)
// int32 output once (416 MB at NYTimes width).
//
// The TPU kernels walk the tiles in order and keep a word's (1, K) output
// block resident across the word's run of tiles, zeroing it on tile_first.
// Here blocks run in parallel and in no order, so the run structure comes as
// a segment table built once per tiling (kernels/phi_update/ops.py::
// segment_table): rows (first tile, tiles, word, sole), each a stretch of at
// most kSegTiles consecutive tiles of one word, cut wherever the word changes
// or tile_first is set; `sole` marks a word that owns exactly one segment.
//  * one warp per segment, with its own K-bin histogram in shared memory
//    (per-warp sub-histograms: no other warp adds into it); a CTA's warps
//    take different segments, and the warps of the grid stride over the
//    table (a persistent grid sized to the card), so a warp zeroes its
//    histogram once and then resets only the bins it flushes.  A
//    segment's slots are contiguous: a lane takes 8 consecutive slots a
//    step, z and the mask read as 16- and 8-byte vectors in their stored
//    types (int16, C7, or int32), a whole 256-slot tile per warp step.
//  * K2: a token whose topic did not move adds nothing; a moved one adds +1
//    at z_new and -1 at z_old with shared atomics.  K4: every real token
//    adds +1 at its topic.  Aggregating a warp's equal bins with
//    __match_any_sync first cost more than it saved (the match is slow and
//    the bins of 8 slots a lane rarely meet; PERF.md).
//  * one flush per segment, not per tile: the warp scans its K bins once,
//    8 consecutive a lane.  A sole word's row (nothing else writes it) is
//    written as whole 32-byte sectors, two 16-byte stores each, coalesced:
//    scattered 4-byte stores of single bins cost more than the row
//    (partial sectors).  A heavy word's segments add their non-zero bins
//    with global atomics, kSegTiles tiles' worth of tokens per atomic
//    instead of one tile's, so the heaviest word's row takes about 410
//    segments' adds at NYTimes size, not 52k tiles'.
//  * padding tiles (pad_tiles_to) alias the last word with an all-false
//    mask: they join its last segment and add nothing.
//
// Zeroing, and why K4 writes each row once.  K2 zeroes the whole output
// first (cudaMemsetAsync) and a sole row takes only the sectors that hold a
// count: a delta leaves most of a row's sectors zero.  K4's output is phi
// itself, so a sole word's segment writes its whole row, zeros included, and
// that row needs no memset: the 416 MB are written once, not twice (the
// memset alone took 0.128 ms on an H100 80GB HBM3 at 700 W, over half K4's
// 0.228 ms bound; kernel_probe.py, PERF.md).  Only the rows that no sole
// segment writes are zeroed first, by one small launch on the same stream
// (zero_rows_kernel) from a row list built once per tiling (ops.py::
// rows_to_zero): the rows of words that own several segments, which the
// segments then add into with atomics, and the rows that no segment names
// (words with no tiles, and num_words beyond the tiles' words).  At NYTimes
// size that is 236 of 101,636 rows, under 1 MB (chip_smoke's train_prep).
//
// Build variants, for measurement only (kernel_probe.py builds them with
// -D): PHI_UPDATE_PROBE=1 builds the histograms but writes nothing to the
// output besides its zeroing (the bins are still reset); =2 reads the tokens
// and counts nothing; =3 launches K4's zeroing of the listed rows alone.
// Probe builds give wrong counts.

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

// Lane's 8 slots from s: their new (and, for a delta, old) topics, and a bit
// per slot that counts: for a delta a real token with z_new != z_old, for a
// full count every real token.
template <bool kDelta, typename Z>
__device__ __forceinline__ unsigned load_slots(
    const Z* __restrict__ z_new, const Z* __restrict__ z_old,
    const uint8_t* __restrict__ mask, int64_t s, int64_t end, bool vec,
    int (&kn)[kSlots], int (&ko)[kSlots]) {
  unsigned counted = 0;
  if (vec) {                    // s is a multiple of 8 and end - s >= 8
    constexpr int kVecs = kSlots * sizeof(Z) / 16;
    union { uint4 v[kVecs]; Z e[kSlots]; } a, b;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      a.v[i] = reinterpret_cast<const uint4*>(z_new + s)[i];
      if (kDelta) b.v[i] = reinterpret_cast<const uint4*>(z_old + s)[i];
    }
    const uint2 m = *reinterpret_cast<const uint2*>(mask + s);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      kn[i] = (int)a.e[i];
      ko[i] = kDelta ? (int)b.e[i] : 0;
      const unsigned byte = ((i < 4 ? m.x : m.y) >> (8 * (i & 3))) & 0xffu;
      if (byte && (!kDelta || kn[i] != ko[i])) counted |= 1u << i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      kn[i] = ko[i] = 0;
      if (s + i < end && mask[s + i]) {
        kn[i] = (int)z_new[s + i];
        if (kDelta) ko[i] = (int)z_old[s + i];
        if (!kDelta || kn[i] != ko[i]) counted |= 1u << i;
      }
    }
  }
  return counted;
}

// hist[key] += sign (key < 0: nothing).
__device__ __forceinline__ void add_bin(int* hist, int key, int sign) {
  if (kProbe != 2 && key >= 0) atomicAdd(&hist[key], sign);
}

// Move the bins [k, k + n) to the word's row and reset them: a sole word's
// row takes them as plain stores (every bin where `whole`, else the ones
// that hold a count), a shared one adds its non-zero bins with atomics.
__device__ __forceinline__ void flush_bins(int* hist, int* row, int k, int n,
                                           bool sole, bool whole) {
  for (int i = k; i < k + n; ++i) {
    const int v = hist[i];
    if (v == 0 && !whole) continue;
    if (v != 0) hist[i] = 0;
    if (kProbe != 0) continue;
    if (sole) {
      row[i] = v;
    } else {
      atomicAdd(&row[i], v);
    }
  }
}

template <typename Z, bool kDelta>
__global__ void __launch_bounds__(kThreads)
phi_count_kernel(const int4* __restrict__ segs,      // (S,) first, tiles,
                 int n_segs,                         //   word, sole
                 const Z* __restrict__ z_new,        // (n, t)
                 const Z* __restrict__ z_old,        // (n, t); delta only
                 const uint8_t* __restrict__ mask,   // (n, t)
                 int* __restrict__ out,              // (V, K)
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

  unsigned probe = 0;           // probe 2: keeps the loads
  const int stride = gridDim.x * warps;
  for (int sg = blockIdx.x * warps + warp; sg < n_segs; sg += stride) {
    const int4 seg = segs[sg];
    const int64_t beg = (int64_t)seg.x * t;
    const int64_t end = beg + (int64_t)seg.y * t;
    for (int64_t s = beg + lane * kSlots; s < end + lane * kSlots;
         s += kStep) {
      int kn[kSlots], ko[kSlots];
      const unsigned counted =
          s < end ? load_slots<kDelta>(z_new, z_old, mask, s, end, vec, kn, ko)
                  : 0u;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const bool c = (counted >> i) & 1u;
        if (kProbe == 2) probe ^= (unsigned)(kn[i] ^ ko[i]) << i;
        add_bin(hist, c ? kn[i] : -1, 1);
        if (kDelta) add_bin(hist, c ? ko[i] : -1, -1);
      }
      probe ^= counted;
    }
    __syncwarp();
    int* row = out + (int64_t)seg.z * K;
    const bool sole = seg.w != 0;
    // K4's sole row was not zeroed: all of it is written, zeros included
    const bool whole = !kDelta && sole;
    if (sectors) {
      for (int k = lane * kSlots; k < K; k += kStep) {
        int4* h = reinterpret_cast<int4*>(hist + k);
        const int4 a = h[0], b = h[1];
        const bool any = a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w;
        if (!any && !whole) continue;
        if (sole) {          // the sector is written whole
          if (any) h[0] = h[1] = make_int4(0, 0, 0, 0);
          if (kProbe == 0) {
            reinterpret_cast<int4*>(row + k)[0] = a;
            reinterpret_cast<int4*>(row + k)[1] = b;
          }
        } else {
          flush_bins(hist, row, k, kSlots, false, false);
        }
      }
    } else {
      for (int k = lane; k < K; k += 32)
        flush_bins(hist, row, k, 1, sole, whole);
    }
    __syncwarp();   // the histogram is clean before the next segment
  }
  if (kProbe == 2 && probe == 0x7fffffffu) out[0] = 1;  // never: no counts
}

// K4: zero the listed rows (below V), 16 bytes a store where rows allow.
__global__ void __launch_bounds__(kThreads)
zero_rows_kernel(const int* __restrict__ rows, int n_rows,
                 int* __restrict__ out, int V, int K, bool vec) {
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int w = rows[r];
    if (w < 0 || w >= V) continue;
    int* row = out + (int64_t)w * K;
    if (vec) {
      for (int k = threadIdx.x; k < K / 4; k += blockDim.x)
        reinterpret_cast<int4*>(row)[k] = make_int4(0, 0, 0, 0);
    } else {
      for (int k = threadIdx.x; k < K; k += blockDim.x) row[k] = 0;
    }
  }
}

struct Grid {
  int blocks = 0, warps = 0;
};

// A persistent grid: as many CTAs as the card holds at once, each of as
// many warps (up to 8) as K-bin histograms fit its shared memory.
template <typename Z, bool kDelta>
cudaError_t count_grid(int K, int n_segs, Grid* g, size_t* smem) {
  const int warps = (int)(kMaxSmem / (sizeof(int) * (size_t)K));
  g->warps = warps < kThreads / 32 ? warps : kThreads / 32;
  if (g->warps < 1) return cudaErrorInvalidValue;
  *smem = sizeof(int) * (size_t)K * g->warps;
  cudaError_t e;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(phi_count_kernel<Z, kDelta>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, phi_count_kernel<Z, kDelta>, 32 * g->warps, *smem);
  if (e != cudaSuccess) return e;
  const int need = (n_segs + g->warps - 1) / g->warps;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  g->blocks = need < fit ? need : fit;
  return cudaSuccess;
}

// K2 (kDelta): the whole output zeroed, then the segments.  K4: the listed
// rows zeroed, then the segments.
template <typename Z, bool kDelta>
int launch(const int4* segs, int n_segs, const int* rows, int n_rows,
           const void* z_new, const void* z_old, const uint8_t* mask,
           int* out, int t, int V, int K, cudaStream_t stream) {
  cudaError_t e;
  if (kDelta) {
    e = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)V * K, stream);
    if (e != cudaSuccess) return (int)e;
  } else if (n_rows > 0) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int blocks = n_rows < 8 * sms ? n_rows : 8 * sms;
    const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    zero_rows_kernel<<<blocks, kThreads, 0, stream>>>(rows, n_rows, out, V, K,
                                                      vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (n_segs <= 0 || kProbe == 3) return (int)cudaSuccess;
  Grid g;
  size_t smem = 0;
  if ((e = count_grid<Z, kDelta>(K, n_segs, &g, &smem)) != cudaSuccess)
    return (int)e;
  const bool vec = t % kSlots == 0
                   && reinterpret_cast<uintptr_t>(z_new) % 16 == 0
                   && (!kDelta || reinterpret_cast<uintptr_t>(z_old) % 16 == 0)
                   && reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  phi_count_kernel<Z, kDelta><<<g.blocks, 32 * g.warps, smem, stream>>>(
      segs, n_segs, static_cast<const Z*>(z_new), static_cast<const Z*>(z_old),
      mask, out, t, K, vec);
  return (int)cudaGetLastError();
}

template <bool kDelta>
int launch_z(int z_bytes, const int* segments, int n_segs, const int* rows,
             int n_rows, const void* z_new, const void* z_old,
             const uint8_t* mask, int* out, int t, int V, int K,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* segs = reinterpret_cast<const int4*>(segments);
  if (z_bytes == 2)
    return launch<int16_t, kDelta>(segs, n_segs, rows, n_rows, z_new, z_old,
                                   mask, out, t, V, K, s);
  if (z_bytes == 4)
    return launch<int32_t, kDelta>(segs, n_segs, rows, n_rows, z_new, z_old,
                                   mask, out, t, V, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int phi_delta_segment_tiles() { return kSegTiles; }

extern "C" int phi_delta_tiles_launch(const int* segments, int n_segs,
                                      const void* z_new, const void* z_old,
                                      const uint8_t* mask, int* out, int t,
                                      int V, int K, int z_bytes,
                                      void* stream) {
  return launch_z<true>(z_bytes, segments, n_segs, nullptr, 0, z_new, z_old,
                        mask, out, t, V, K, stream);
}

extern "C" int phi_update_tiles_launch(const int* segments, int n_segs,
                                       const int* zero_rows, int n_rows,
                                       const void* z, const uint8_t* mask,
                                       int* out, int t, int V, int K,
                                       int z_bytes, void* stream) {
  return launch_z<false>(z_bytes, segments, n_segs, zero_rows, n_rows, z,
                         nullptr, mask, out, t, V, K, stream);
}
