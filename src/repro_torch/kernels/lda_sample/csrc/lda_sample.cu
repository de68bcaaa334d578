// The S/Q training sweep of LDA (paper §6.1), one CTA per word tile.
//
// Replaces the Pallas TPU kernel repro/kernels/lda_sample/kernel.py::
// lda_sample_tiles (body _kernel).  Computes what it computes: one
// delayed-count sweep in which every token of a word tile is resampled
// against the frozen phi and its document's ELL slice of theta.  Per tile:
// p* = (phi + beta) / (phi_sum + beta V), the level-1 block sums of the
// two-level search and Q = alpha sum p*.  Per token: p1 = cnt p*[topic]
// over its document's ELL row, S = sum p1; the sparse side is taken when
// u1 (S + Q) < S and draws by a search over the P prefix sums, else the
// dense side draws by the blocked search over p*.  Outputs: z_new (the old
// topic on padding slots), the sparse flag and S/(S+Q) (0 on padding).
//
// Design (simple and right first; see PERF.md for its times):
//  * the TPU kernel stages a (C, K) int32 phi table for a chunk of C tiles:
//    256 KB at C = 64, K = 1024, above the 227 KB a block may use.  Here a
//    CTA takes one tile (the paper's layout): its word's p* (K floats), the
//    in-block prefix sums of p* (K floats) and the nb level-1 block prefix
//    sums live in shared memory, with the tile's doc ids, mask and
//    uniforms.
//  * one warp per token: the warp reads the token's ELL row from device
//    memory 32 entries at a time (coalesced), forms p1 and its prefix sums
//    with a warp scan and keeps them in a per-warp shared buffer.  ELL puts
//    zero counts last, so the row is read only up to its first zero; the
//    zero tail adds exactly 0 to the prefix sums and is counted as
//    entries whose prefix is S, so a search past every live entry lands on
//    min(count, P - 1), as the full-width search does.
//  * each search counts the entries whose prefix is <= its target (ballots),
//    as the reference does, rather than stopping at the first larger one.
//  * all float arithmetic uses _rn intrinsics (no fused multiply-add).  The
//    sums are taken in another order than torch.cumsum's (fault F2), so a
//    draw on a float boundary may differ from the plain version: the kernel
//    is held to a stated bound of flipped draws, not to bits.
//  * z is read and written in its stored type, int16 (C7) or int32.
//
// Bound: bytes.  Each token reads its document's live ELL entries (counts
// and topics, 8 bytes each) from device memory; the (D, P) ELL is far
// larger than L2, so those reads, with the (n, t, 2) uniforms and the
// per-token inputs and outputs, set the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive warp scan of v (Hillis-Steele), float adds rounded to nearest.
__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = __fadd_rn(v, y);
  }
  return v;
}

template <typename Z>
__global__ void __launch_bounds__(kThreads)
lda_sample_kernel(const int* __restrict__ tile_word,    // (n,)
                  const int* __restrict__ token_doc,    // (n, t)
                  const uint8_t* __restrict__ mask,     // (n, t)
                  const Z* __restrict__ z_old,          // (n, t)
                  const int* __restrict__ phi_vk,       // (V, K)
                  const int* __restrict__ phi_sum,      // (K,)
                  const int* __restrict__ ell_counts,   // (D, P)
                  const int* __restrict__ ell_topics,   // (D, P)
                  const float* __restrict__ uniforms,   // (n, t, 2)
                  Z* __restrict__ z_new,                // (n, t) out
                  uint8_t* __restrict__ sparse,         // (n, t) out
                  float* __restrict__ ssq,              // (n, t) out
                  int t, int K, int P, int bw, float alpha, float beta,
                  int num_words_total) {
  extern __shared__ float smem[];
  const int nb = K / bw;
  float* ps = smem;                                   // K: p*
  float* pc = ps + K;                                 // K: in-block prefix
  float* bcum = pc + K;                               // nb: block prefix
  float* pre = bcum + nb;                             // kWarps * P
  float* uni = pre + kWarps * P;                      // 2t
  int* tdoc = reinterpret_cast<int*>(uni + 2 * t);    // t
  int* tmask = tdoc + t;                              // t

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = (int64_t)tile * t;

  // ---- stage the tile: p*, token docs, mask, uniforms; padding slots ----
  const int* row = phi_vk + (int64_t)tile_word[tile] * K;
  const float vbeta = __fmul_rn(beta, (float)num_words_total);
  for (int k = tid; k < K; k += kThreads)
    ps[k] = __fdiv_rn(__fadd_rn((float)row[k], beta),
                      __fadd_rn((float)phi_sum[k], vbeta));
  for (int s = tid; s < t; s += kThreads) {
    const int m = mask[base + s] != 0;
    tmask[s] = m;
    tdoc[s] = token_doc[base + s];
    uni[2 * s] = uniforms[2 * (base + s)];
    uni[2 * s + 1] = uniforms[2 * (base + s) + 1];
    if (!m) {
      z_new[base + s] = z_old[base + s];
      sparse[base + s] = 0;
      ssq[base + s] = 0.f;
    }
  }
  __syncthreads();

  // ---- level 2: in-block inclusive prefix sums; level 1: block sums ----
  for (int b = warp; b < nb; b += kWarps) {
    float carry = 0.f;
    for (int c0 = 0; c0 < bw; c0 += 32) {
      const int i = c0 + lane;
      const float v = warp_inclusive_scan(i < bw ? ps[b * bw + i] : 0.f,
                                          lane);
      const float incl = __fadd_rn(carry, v);
      if (i < bw) pc[b * bw + i] = incl;
      carry = __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) bcum[b] = carry;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int b = 0; b < nb; ++b) {
      run = __fadd_rn(run, bcum[b]);
      bcum[b] = run;
    }
  }
  __syncthreads();
  const float total = bcum[nb - 1];
  const float Q = __fmul_rn(alpha, total);

  // ---- one warp per real token ----
  float* mypre = pre + warp * P;
  for (int s = warp; s < t; s += kWarps) {
    if (!tmask[s]) continue;
    const int64_t d = tdoc[s];
    const int* crow = ell_counts + d * P;
    const int* trow = ell_topics + d * P;

    // S: prefix sums of p1 over the live (non-zero) ELL entries
    int live = P;
    float carry = 0.f;
    for (int j0 = 0; j0 < P; j0 += 32) {
      const int j = j0 + lane;
      const int cnt = j < P ? crow[j] : 0;
      const float p1 = cnt > 0 ? __fmul_rn((float)cnt, ps[trow[j]]) : 0.f;
      const float incl = __fadd_rn(carry, warp_inclusive_scan(p1, lane));
      if (j < P) mypre[j] = incl;
      carry = __shfl_sync(kFull, incl, 31);
      const unsigned zero = __ballot_sync(kFull, j < P && cnt == 0);
      if (zero) {
        live = j0 + __ffs(zero) - 1;
        break;
      }
    }
    __syncwarp();
    const float S = live > 0 ? mypre[live - 1] : 0.f;
    const float u1 = uni[2 * s];
    const float u2 = uni[2 * s + 1];
    const bool use_sparse = __fmul_rn(u1, __fadd_rn(S, Q)) < S;

    int znew;
    if (use_sparse) {
      const float target = __fmul_rn(u2, S);
      int count = 0;
      for (int j0 = 0; j0 < live; j0 += 32) {
        const int j = j0 + lane;
        count += __popc(__ballot_sync(kFull, j < live && mypre[j] <= target));
      }
      if (S <= target) count += P - live;   // the zero tail's prefix is S
      znew = trow[min(count, P - 1)];
    } else {
      const float target = __fmul_rn(u2, total);
      int bi = 0;
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int b = b0 + lane;
        bi += __popc(__ballot_sync(kFull, b < nb && bcum[b] <= target));
      }
      bi = min(bi, nb - 1);
      const float prev = bi > 0 ? bcum[bi - 1] : 0.f;
      int in_b = 0;
      for (int c0 = 0; c0 < bw; c0 += 32) {
        const int i = c0 + lane;
        in_b += __popc(__ballot_sync(
            kFull, i < bw && __fadd_rn(pc[bi * bw + i], prev) <= target));
      }
      znew = bi * bw + min(in_b, bw - 1);
    }
    if (lane == 0) {
      z_new[base + s] = (Z)znew;
      sparse[base + s] = use_sparse;
      ssq[base + s] = __fdiv_rn(S, fmaxf(__fadd_rn(S, Q), 1e-30f));
    }
    __syncwarp();   // mypre is rewritten by the warp's next token
  }
}

}  // namespace

extern "C" size_t lda_sample_smem_bytes(int t, int K, int P, int bw) {
  return sizeof(float) * ((size_t)2 * K + K / bw + (size_t)kWarps * P + 2 * t)
         + sizeof(int) * (size_t)(2 * t);
}

extern "C" int lda_sample_tiles_launch(
    const int* tile_word, const int* token_doc, const uint8_t* mask,
    const void* z_old, const int* phi_vk, const int* phi_sum,
    const int* ell_counts, const int* ell_topics, const float* uniforms,
    void* z_new, uint8_t* sparse, float* ssq, int n, int t, int K, int P,
    int bw, int z_bytes, float alpha, float beta, int num_words_total,
    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (K % bw != 0 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = lda_sample_smem_bytes(t, K, P, bw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (z_bytes == 2) {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(lda_sample_kernel<int16_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    lda_sample_kernel<int16_t><<<n, kThreads, smem, st>>>(
        tile_word, token_doc, mask, static_cast<const int16_t*>(z_old),
        phi_vk, phi_sum, ell_counts, ell_topics, uniforms,
        static_cast<int16_t*>(z_new), sparse, ssq, t, K, P, bw, alpha, beta,
        num_words_total);
  } else if (z_bytes == 4) {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(lda_sample_kernel<int32_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    lda_sample_kernel<int32_t><<<n, kThreads, smem, st>>>(
        tile_word, token_doc, mask, static_cast<const int32_t*>(z_old),
        phi_vk, phi_sum, ell_counts, ell_topics, uniforms,
        static_cast<int32_t*>(z_new), sparse, ssq, t, K, P, bw, alpha, beta,
        num_words_total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
