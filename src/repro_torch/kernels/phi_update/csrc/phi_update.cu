// Word-row count updates of phi for LDA training, one CTA per word tile.
//
// Replaces two Pallas TPU kernels of repro/kernels/phi_update/kernel.py:
//  * phi_delta_tiles (body _delta_kernel): the per-iteration delta
//    counts(z_new) - counts(z_old) per word row, over masked tokens;
//  * phi_update_tiles (body _kernel): counts(z) per word row, a full rebuild.
// Both produce a (V, K) int32 matrix in which rows that no tile visits are 0.
//
// Design (simple and right first; see PERF.md for its times):
//  * the TPU kernel walks the tiles in order and keeps a word's (1, K) output
//    block resident across that word's tiles, zeroing it on the word's first
//    tile.  Blocks here run in parallel and in no order, so the output is
//    zeroed up front (cudaMemsetAsync) and each tile adds into its word's row
//    with integer atomics: exact whatever the order, and independent of
//    tile_first (padding tiles have an all-false mask and add nothing).
//  * each CTA builds its tile's K-bin histogram in shared memory (+1 for
//    z_new, -1 for z_old; a token whose topic did not move adds nothing),
//    then flushes only the non-zero bins to device memory with atomicAdd.
//    A tile whose histogram is all zero (padding, or no token moved) skips
//    the flush.
//  * z is read in its stored type, int16 (C7) or int32; the mask as bytes.
//
// Bound: bytes.  The least traffic is reading z (and z_old), the mask and the
// tile words once, and writing the (V, K) int32 output once (416 MB at
// NYTimes width).  The atomics from the many tiles of one heavy word meet
// on the same row; a later version can reduce a word's run of tiles inside
// one CTA first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Z, bool kDelta>
__global__ void __launch_bounds__(kThreads)
phi_count_kernel(const int* __restrict__ tile_word,   // (n,)
                 const Z* __restrict__ z_new,         // (n, t)
                 const Z* __restrict__ z_old,         // (n, t), delta only
                 const uint8_t* __restrict__ mask,    // (n, t)
                 int* __restrict__ out,               // (V, K), pre-zeroed
                 int t, int K) {
  extern __shared__ int hist[];
  const int tile = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x) hist[k] = 0;
  __syncthreads();

  const int64_t base = (int64_t)tile * t;
  int moved = 0;
  for (int s = threadIdx.x; s < t; s += blockDim.x) {
    if (!mask[base + s]) continue;
    const int kn = (int)z_new[base + s];
    if (kDelta) {
      const int ko = (int)z_old[base + s];
      if (kn == ko) continue;
      atomicAdd(&hist[ko], -1);
    }
    atomicAdd(&hist[kn], 1);
    moved = 1;
  }
  if (!__syncthreads_or(moved)) return;

  int* row = out + (int64_t)tile_word[tile] * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int h = hist[k];
    if (h != 0) atomicAdd(&row[k], h);
  }
}

template <typename Z, bool kDelta>
int launch(const int* tile_word, const void* z_new, const void* z_old,
           const uint8_t* mask, int* out, int n, int t, int V, int K,
           cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)V * K, stream);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(int) * (size_t)K;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(phi_count_kernel<Z, kDelta>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  phi_count_kernel<Z, kDelta><<<n, kThreads, smem, stream>>>(
      tile_word, static_cast<const Z*>(z_new), static_cast<const Z*>(z_old),
      mask, out, t, K);
  return (int)cudaGetLastError();
}

template <bool kDelta>
int dispatch(const int* tile_word, const void* z_new, const void* z_old,
             const uint8_t* mask, int* out, int n, int t, int V, int K,
             int z_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_bytes == 2)
    return launch<int16_t, kDelta>(tile_word, z_new, z_old, mask, out, n, t,
                                   V, K, s);
  if (z_bytes == 4)
    return launch<int32_t, kDelta>(tile_word, z_new, z_old, mask, out, n, t,
                                   V, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int phi_delta_tiles_launch(const int* tile_word, const void* z_new,
                                      const void* z_old, const uint8_t* mask,
                                      int* out, int n, int t, int V, int K,
                                      int z_bytes, void* stream) {
  return dispatch<true>(tile_word, z_new, z_old, mask, out, n, t, V, K,
                        z_bytes, stream);
}

extern "C" int phi_update_tiles_launch(const int* tile_word, const void* z,
                                       const uint8_t* mask, int* out, int n,
                                       int t, int V, int K, int z_bytes,
                                       void* stream) {
  return dispatch<false>(tile_word, z, nullptr, mask, out, n, t, V, K,
                         z_bytes, stream);
}
