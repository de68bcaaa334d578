// Fold-in sweeps for LDA serving, one CTA per request document.
//
// Replaces the Pallas TPU kernel repro/kernels/fold_in/kernel.py::fold_in_docs
// (body _kernel, ELL select _ell_topk).  Computes what that kernel computes:
// per doc, burn_in + samples delayed-count Gibbs sweeps against frozen phi
// rows, each sweep taking the ELL top-P of theta, choosing the sparse (S) or
// dense (Q) side per token, drawing by a prefix-sum search over the P ELL
// entries or by the two-level blocked search over p*, and recounting theta;
// the kept sweeps' theta, sparse-draw count and sum of S/(S+Q) are returned.
//
// Design (simple and right first; see PERF.md for its times):
//  * grid = B docs, one CTA each; the sweep loop stays inside the block, as
//    the TPU kernel's sequential grid step became a block.
//  * p* = (phi + beta) / denom[k] is NOT staged: its (L, K) f32 table is
//    1 MB at L = 256, K = 1024, far above the 227 KB a block may use.  It is
//    recomputed from the gathered phi rows (device memory / L2) each time it
//    is needed.  Shared memory holds denom, theta, the theta sum, the ELL
//    slice, Q, the level-1 block prefix sums and z (~26 KB at K = 1024,
//    L = 256, nb = 8).
//  * one thread per token; every prefix sum (p1 over P, the block sums over
//    nb, the in-block sum over the block width) is a sequential
//    left-to-right float32 sum with explicit _rn intrinsics, so no fused
//    multiply-add changes the rounding.  torch.cumsum sums in another order,
//    so a draw at a float boundary may differ from the plain version: the
//    kernel is held to a stated bound, not to bits.
//  * the ELL select gives lax.top_k's order exactly — count descending,
//    ties to the lower topic id, zero counts last in id order: a block scan
//    compacts the non-zero topics in id order, each is ranked against the
//    others (at most min(L, K) of them), and zero topics take the ranks
//    after them in id order.
//  * delayed counts: every token of a sweep reads the ELL of the theta from
//    the sweep's start; theta is recounted after a barrier with exact
//    shared-memory integer atomics.
//  * padded tokens (mask == 0) keep z0 and count nowhere; an all-padding
//    doc writes zeros.
//
// Bound: the work is per-token searches with data-dependent length (P + nb
// + the block width loads and compares per token and sweep), gathered from
// the (B, L, K) int32 rows; the bytes floor is reading those rows once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pstar_at(const int* __restrict__ row,
                                          const float* __restrict__ denom,
                                          float beta, int k) {
  return __fdiv_rn(__fadd_rn((float)row[k], beta), denom[k]);
}

// Exclusive block-wide scan of one int per thread; returns the prefix and
// writes the block total to *total.  Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* warp_buf, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_buf[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  int before = (warp > 0 ? warp_buf[warp - 1] : 0) + x - v;
  *total = warp_buf[nwarps - 1];
  __syncthreads();  // warp_buf is reused by the next call
  return before;
}

__global__ void __launch_bounds__(kThreads)
fold_in_docs_kernel(const int* __restrict__ phi_tok,   // (B, L, K)
                    const int* __restrict__ phi_sum,   // (K,)
                    const float* __restrict__ hyper,   // (2,) alpha, beta
                    const float* __restrict__ uniforms,  // (B, S, L, 2)
                    const int* __restrict__ mask,      // (B, L)
                    const int* __restrict__ z0,        // (B, L)
                    int* __restrict__ theta_sum,       // (B, K) out
                    int* __restrict__ sp_out,          // (B,) out
                    float* __restrict__ ssq_out,       // (B,) out
                    int* __restrict__ z_out,           // (B, L) out
                    int L, int K, int P, int burn_in, int samples,
                    int num_words_total, int bw) {
  extern __shared__ unsigned char smem_raw[];
  const int nb = K / bw;
  float* denom = reinterpret_cast<float*>(smem_raw);     // K
  int* theta = reinterpret_cast<int*>(denom + K);        // K
  int* tsum = theta + K;                                 // K
  int* nz_list = tsum + K;                               // min(L, K)
  int* ell_cnt = nz_list + (L < K ? L : K);              // P
  int* ell_tpc = ell_cnt + P;                            // P
  int* z = ell_tpc + P;                                  // L
  int* msk = z + L;                                      // L
  float* Q = reinterpret_cast<float*>(msk + L);          // L
  float* bcum = Q + L;                                   // L * nb
  __shared__ int warp_buf[32];
  __shared__ int red_i[kThreads / 32];
  __shared__ float red_f[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float alpha = hyper[0];
  const float beta = hyper[1];
  const float vbeta = __fmul_rn(beta, (float)num_words_total);
  const int n_sweeps = burn_in + samples;
  const int* rows = phi_tok + (int64_t)b * L * K;
  const float* uni = uniforms + (int64_t)b * n_sweeps * L * 2;

  for (int k = tid; k < K; k += blockDim.x) {
    denom[k] = __fadd_rn((float)phi_sum[k], vbeta);
    theta[k] = 0;
    tsum[k] = 0;
  }
  for (int l = tid; l < L; l += blockDim.x) {
    z[l] = z0[(int64_t)b * L + l];
    msk[l] = mask[(int64_t)b * L + l] != 0;
  }
  __syncthreads();

  // Q and the level-1 block prefix sums of every token's p*, once per doc.
  for (int l = tid; l < L; l += blockDim.x) {
    const int* row = rows + (int64_t)l * K;
    float q = 0.f, run = 0.f;
    for (int blk = 0; blk < nb; ++blk) {
      float bs = 0.f;
      for (int i = 0; i < bw; ++i) {
        float p = pstar_at(row, denom, beta, blk * bw + i);
        bs = __fadd_rn(bs, p);
        q = __fadd_rn(q, p);
      }
      run = __fadd_rn(run, bs);
      bcum[l * nb + blk] = run;
    }
    Q[l] = __fmul_rn(alpha, q);
    if (msk[l]) atomicAdd(&theta[z[l]], 1);
  }
  __syncthreads();

  // contiguous chunk of topic ids per thread, for the ELL compaction scan
  const int chunk = (K + blockDim.x - 1) / blockDim.x;
  const int k_lo = min(tid * chunk, K);
  const int k_hi = min(k_lo + chunk, K);

  int sp_acc = 0;
  float ssq_acc = 0.f;
  for (int s = 0; s < n_sweeps; ++s) {
    // ---- ELL top-P of theta, in lax.top_k order ----
    int my_nz = 0;
    for (int k = k_lo; k < k_hi; ++k) my_nz += theta[k] > 0;
    int nnz;
    int pos = block_exclusive_scan(my_nz, warp_buf, &nnz);
    for (int k = k_lo; k < k_hi; ++k) {
      int t = theta[k];
      if (t > 0) {
        nz_list[pos++] = k;
      } else {
        int r = nnz + (k - pos);  // zero topics before k: k - nonzeros before k
        if (r < P) {
          ell_cnt[r] = 0;
          ell_tpc[r] = k;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nnz; i += blockDim.x) {
      int k = nz_list[i];
      int t = theta[k];
      int r = 0;
      for (int j = 0; j < nnz; ++j) {
        int kj = nz_list[j];
        int tj = theta[kj];
        r += (tj > t) || (tj == t && kj < k);
      }
      if (r < P) {
        ell_cnt[r] = t;
        ell_tpc[r] = k;
      }
    }
    __syncthreads();

    // ---- draw every real token against the sweep-start theta ----
    // Entries at rank >= nnz have count 0: they add exactly 0 to every
    // prefix sum, so the sums stop at the live entries.  A search that
    // passes every live entry counts the zero tail too and lands on P - 1,
    // as the full-width search does.
    const bool keep = s >= burn_in;
    const int live = min(nnz, P);
    for (int l = tid; l < L; l += blockDim.x) {
      if (!msk[l]) continue;
      const int* row = rows + (int64_t)l * K;
      float S = 0.f;
      for (int j = 0; j < live; ++j) {
        float p1 = __fmul_rn((float)ell_cnt[j],
                             pstar_at(row, denom, beta, ell_tpc[j]));
        S = __fadd_rn(S, p1);
      }
      const float q = Q[l];
      const float u1 = uni[((int64_t)s * L + l) * 2];
      const float u2 = uni[((int64_t)s * L + l) * 2 + 1];
      const bool use_sparse = __fmul_rn(u1, __fadd_rn(S, q)) < S;
      int znew;
      if (use_sparse) {
        const float t = __fmul_rn(u2, S);
        float c = 0.f;
        int j = 0;
        for (; j < live; ++j) {
          c = __fadd_rn(c, __fmul_rn((float)ell_cnt[j],
                                     pstar_at(row, denom, beta, ell_tpc[j])));
          if (!(c <= t)) break;
        }
        znew = ell_tpc[j < live ? j : P - 1];
      } else {
        const float* bc = bcum + l * nb;
        const float t = __fmul_rn(u2, bc[nb - 1]);
        int bi = 0;
        while (bi < nb && bc[bi] <= t) ++bi;
        bi = min(bi, nb - 1);
        const float prev = bi > 0 ? bc[bi - 1] : 0.f;
        float c = 0.f;
        int i = 0;
        for (; i < bw; ++i) {
          c = __fadd_rn(c, pstar_at(row, denom, beta, bi * bw + i));
          if (!(__fadd_rn(c, prev) <= t)) break;
        }
        znew = bi * bw + min(i, bw - 1);
      }
      z[l] = znew;
      if (keep) {
        sp_acc += use_sparse;
        ssq_acc = __fadd_rn(ssq_acc, __fdiv_rn(S, fmaxf(__fadd_rn(S, q),
                                                         1e-30f)));
      }
    }
    __syncthreads();

    // ---- recount theta (exact integer atomics) ----
    for (int k = tid; k < K; k += blockDim.x) theta[k] = 0;
    __syncthreads();
    for (int l = tid; l < L; l += blockDim.x)
      if (msk[l]) atomicAdd(&theta[z[l]], 1);
    __syncthreads();
    if (keep)
      for (int k = tid; k < K; k += blockDim.x) tsum[k] += theta[k];
    // the next sweep's ELL scan reads theta only after its own barrier
  }
  __syncthreads();

  for (int k = tid; k < K; k += blockDim.x)
    theta_sum[(int64_t)b * K + k] = tsum[k];
  for (int l = tid; l < L; l += blockDim.x) z_out[(int64_t)b * L + l] = z[l];

  // block reductions of the sparse count and the S-share sum
  for (int o = 16; o > 0; o >>= 1) {
    sp_acc += __shfl_down_sync(0xffffffffu, sp_acc, o);
    ssq_acc = __fadd_rn(ssq_acc, __shfl_down_sync(0xffffffffu, ssq_acc, o));
  }
  if ((tid & 31) == 0) {
    red_i[tid >> 5] = sp_acc;
    red_f[tid >> 5] = ssq_acc;
  }
  __syncthreads();
  if (tid == 0) {
    int si = 0;
    float sf = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      si += red_i[w];
      sf = __fadd_rn(sf, red_f[w]);
    }
    sp_out[b] = si;
    ssq_out[b] = sf;
  }
}

}  // namespace

extern "C" size_t fold_in_docs_smem_bytes(int L, int K, int P, int bw) {
  const int nb = K / bw;
  const int nz = L < K ? L : K;
  return sizeof(float) * (size_t)K            // denom
         + sizeof(int) * (size_t)(2 * K)      // theta, tsum
         + sizeof(int) * (size_t)nz           // nz_list
         + sizeof(int) * (size_t)(2 * P)      // ell_cnt, ell_tpc
         + sizeof(int) * (size_t)(2 * L)      // z, msk
         + sizeof(float) * (size_t)L          // Q
         + sizeof(float) * (size_t)L * nb;    // bcum
}

extern "C" int fold_in_docs_launch(
    const int* phi_tok, const int* phi_sum, const float* hyper,
    const float* uniforms, const int* mask, const int* z0, int* theta_sum,
    int* sp, float* ssq, int* z_out, int B, int L, int K, int P,
    int burn_in, int samples, int num_words_total, int bw, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = fold_in_docs_smem_bytes(L, K, P, bw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fold_in_docs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fold_in_docs_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      phi_tok, phi_sum, hyper, uniforms, mask, z0, theta_sum, sp, ssq, z_out,
      L, K, P, burn_in, samples, num_words_total, bw);
  return (int)cudaGetLastError();
}
