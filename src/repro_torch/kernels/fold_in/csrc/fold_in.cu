// Fold-in sweeps for LDA serving, a thread-block cluster per request
// document.
//
// Replaces the Pallas TPU kernel repro/kernels/fold_in/kernel.py::fold_in_docs
// (body _kernel, ELL select _ell_topk).  Computes what that kernel computes:
// per doc, burn_in + samples delayed-count Gibbs sweeps against frozen phi
// rows, each sweep taking the ELL top-P of theta, choosing the sparse (S) or
// dense (Q) side per token, drawing by a prefix-sum search over the P ELL
// entries or by the two-level blocked search over p*, and recounting theta;
// the kept sweeps' theta, sparse-draw count and sum of S/(S+Q) are returned.
//
// Bound: the bytes floor is reading the gathered (B, L, K) int32 rows once
// (33.5 MB at B = 32, L = 256, K = 1024: ~10 us at 3.35 TB/s); the rows of
// a batch fit the 50 MB L2, where every sweep reads them again.  The time
// is the sweeps' dependent chain: 12 rounds of ELL select, draws and a
// recount, each waiting on the last (kernel_probe.py: on an H100 the draws
// take about half, the select, recount and barriers a third; PERF.md).
//
// Design:
//  * a cluster of C CTAs per doc (grid (C, B)) of up to 16 warps, both
//    chosen at launch (shape_for): the most warps on a doc's tokens with
//    which the batch's B clusters all run at once (the occupancy
//    calculator's count).  An H100's GPCs hold 30 clusters of 4 CTAs of 16
//    warps (128 registers a thread: one CTA an SM), so 32 documents at
//    L = 256 would run in two waves; they run in clusters of 7 CTAs of 8
//    warps (two an SM), 224 CTAs in one wave.
//    CTA r of a doc owns tokens [r Lc, (r + 1) Lc), Lc = ceil(L / C), and
//    kept theta's topics [r Ks, (r + 1) Ks).  Every CTA holds the doc's
//    whole theta: a token's new topic is added into each CTA's count array
//    through distributed shared memory (C remote atomics, one a lane),
//    double-buffered, and one cluster.sync() a sweep completes the counts,
//    so each CTA redoes the cheap ELL select itself and no CTA reads
//    another's counts (an all-reduce by loads cost C x K remote loads a
//    CTA and sweep).
//  * a warp per token, lanes across the row.  The per-doc p* pass (Q and
//    the level-1 block sums, bw = 128 and nb = 8 at K = 1024) reads a
//    token's row coalesced, 16 bytes a lane, and sums each block with a
//    butterfly; one lane adds the block sums in order.  Each sweep's S and
//    p1 prefix run with lanes across the live ELL entries (4 consecutive a
//    lane, their row gathers in flight together), a warp scan across
//    lanes; the dense side's in-block prefix likewise over the winning
//    block, whose row entries (known from u2 and the block sums before S
//    is) load while the sparse prefix is formed.  A prefix of up to 128
//    entries stays in the lanes' registers and is counted there, with no
//    store and no barrier (a longer one goes through shared memory).
//    Draws count the prefixes <= target warp-wide, as the reference counts
//    (torch (cumsum <= target).sum()), plus the zero tail's P - live
//    entries when S <= target.
//  * prefixes never decrease (F2, as in lda_sample.cu): in-lane sums in
//    order and a Kogge-Stone scan across lanes add in different orders, so
//    a lane's total can round below an earlier lane's; each entry is
//    clamped to its lane's total and a prefix whose live lanes dip is
//    lifted to its running maximum.  The block sums are added in order by
//    one lane.  Every float operation is an _rn intrinsic (no fused
//    multiply-add).  The sums are taken in another order than torch's, so
//    a draw on a float boundary may differ from the plain version: the
//    kernel is held to a stated bound.
//  * the ELL select gives lax.top_k's order exactly (F1) — count
//    descending, ties to the lower topic id, zero counts last in id order —
//    with a stable counting sort instead of ranking every non-zero topic
//    against every other: one block scan gives both where each non-zero
//    topic goes in id order (zero topics take ranks nnz + their index among
//    the zeros) and, over the count histogram (counts <= L), each count's
//    first rank; then one warp walks the compacted topics 32 at a time,
//    ranking equal counts in id order with __match_any_sync.
//  * a doc's sum of S/(S+Q) does not depend on the launch shape: each token
//    adds its kept sweeps' ratios in sweep order into its own slot, and one
//    warp sums the doc's slots in an order fixed by the token index alone
//    (lane j takes tokens j, j + 32, ... in turn, then a fixed tree over
//    the lanes).  So a doc gets the same bits in a batch of 32 and in a
//    V-sharded slice of 8 (serve/infer.py, comm="all2all"), which launch
//    with other CTAs a doc and warps a CTA.
//  * delayed counts: every token of a sweep reads the ELL of the theta from
//    the sweep's start.  A sweep's uniforms are copied into shared memory
//    with cp.async while the sweep before runs.  Padded tokens (mask == 0)
//    keep z0 and count nowhere; an all-padding doc writes zeros.
//  * no tensor cores, wgmma or TMA: there is no matrix product.
//
// Build variants, for measurement only (kernel_probe.py builds them with
// -D): FOLD_IN_PROBE is a bit mask, 1 skipping the per-doc pass over the
// rows (unit block sums and Q = 1 instead), 2 drawing no token (each sweep
// still counts theta, selects the ELL and recounts).  Probe builds give
// wrong results.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>
#include <type_traits>

#ifndef FOLD_IN_PROBE
#define FOLD_IN_PROBE 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;      // CTAs a doc at most

constexpr bool kNoPass = (FOLD_IN_PROBE & 1) != 0;   // probe builds only
constexpr bool kNoDraws = (FOLD_IN_PROBE & 2) != 0;
constexpr int kMaxWarps = 16;
constexpr int kMinTokens = 16;      // slots a CTA takes at least
constexpr int kE = 4;               // consecutive prefix entries a lane takes
constexpr size_t kMaxSmem = 232448 - 1024;  // a block's limit, less static
constexpr int kRowBatch = 8;        // row vectors a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

// Byte offsets of the dynamic shared memory of one CTA (4-byte entries).
struct Layout {
  size_t denom, part, tsum, nz, chist, base, ecnt, etpc, z, msk, Q, tssq,
      uni, bcum, pre, total;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int prefix_width(int P, int bw) {
  return cdiv(P > bw ? P : bw, 4) * 4;
}

__host__ __device__ inline Layout layout(int L, int K, int P, int bw,
                                         int warps, int C) {
  const int Lc = cdiv(L, C);
  const int nb = K / bw;
  Layout s;
  size_t o = 0;
  auto take = [&](size_t& at, size_t n) {
    at = o;
    o += 4 * n;
  };
  take(s.denom, K);
  take(s.part, 2 * (size_t)K);
  take(s.tsum, cdiv(K, C));
  take(s.nz, L < K ? L : K);
  take(s.chist, L + 1);
  take(s.base, L + 1);
  take(s.ecnt, P);
  take(s.etpc, P);
  take(s.z, Lc);
  take(s.msk, Lc);
  take(s.Q, Lc);
  take(s.tssq, Lc);
  take(s.uni, 4 * (size_t)Lc);       // two sweeps' (u1, u2)
  take(s.bcum, (size_t)Lc * nb);
  take(s.pre, (size_t)warps * prefix_width(P, bw));
  s.total = o;
  return s;
}

struct Params {
  const int* phi_tok;     // (B, L, K)
  const int* phi_sum;     // (K,)
  const float* hyper;     // (2,) alpha, beta
  const float* uniforms;  // (B, S, L, 2)
  const int* mask;        // (B, L)
  const int* z0;          // (B, L)
  int* theta_sum;         // (B, K) out
  int* sp_out;            // (B,) out
  float* ssq_out;         // (B,) out
  int* z_out;             // (B, L) out
  int L, K, P, burn_in, samples, num_words_total, bw;
  bool vec_rows;          // rows are 16-byte aligned (K % 4 == 0)
};

__device__ __forceinline__ float pstar(int count, float beta, float denom) {
  return __fdiv_rn(__fadd_rn((float)count, beta), denom);
}

// Inclusive warp scan (Kogge-Stone), float adds rounded to nearest.
__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = __fadd_rn(v, y);
  }
  return v;
}

__device__ __forceinline__ float warp_inclusive_max(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = fmaxf(v, y);
  }
  return v;
}

// a[0, n) lifted to its running maximum, so it never decreases.
__device__ void lift_to_running_max(float* a, int n, int lane) {
  float carry = 0.f;                  // the entries are sums of terms >= 0
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int j = c0 + lane;
    const float v =
        fmaxf(warp_inclusive_max(j < n ? a[j] : 0.f, lane), carry);
    if (j < n) a[j] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
}

// One chunk of an inclusive prefix of non-negative terms: x holds the
// lane's kE terms, entries [j, j + kE) of n (zeros past n); carry is the sum
// of the chunks before.  In-lane sums in order, a warp scan of the lanes'
// totals, each entry clamped to its lane's total; a live lane whose total
// rounds below the lane before it sets dip.  Returns the next carry.
__device__ __forceinline__ float prefix_chunk(float* pre, const float (&x)[kE],
                                              int j, int n, float carry,
                                              bool& dip, int lane) {
  float q[kE];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    sum = __fadd_rn(sum, x[i]);
    q[i] = sum;
  }
  const float incl = warp_inclusive_scan(sum, lane);
  const float excl = __shfl_up_sync(kFull, incl, 1);
  dip |= lane > 0 && j < n && excl > incl;
  const float lo = lane ? __fadd_rn(carry, excl) : carry;
  const float hi = __fadd_rn(carry, incl);
#pragma unroll
  for (int i = 0; i < kE; ++i)
    if (j + i < n) pre[j + i] = fminf(__fadd_rn(lo, q[i]), hi);
  return __shfl_sync(kFull, hi, 31);
}

// After the chunks: a prefix that dipped is lifted to its running maximum,
// so it never decreases; returns pre[n - 1] (0 when n == 0).
__device__ __forceinline__ float prefix_finish(float* pre, int n, bool dip,
                                               int lane) {
  __syncwarp();
  if (__any_sync(kFull, dip)) {
    lift_to_running_max(pre, n, lane);
    __syncwarp();
  }
  return n > 0 ? pre[n - 1] : 0.f;
}

// The inclusive prefix sums of n <= 32 kE non-negative terms, lane l's x
// being entries [l kE, (l + 1) kE), into the lane's registers v: the values
// prefix_chunk gives, kept out of shared memory, so a count needs no store
// and no barrier; a prefix that dips (rare) is lifted through pre.
// Returns entry n - 1 (0 when n == 0).  Whole warp.
__device__ float lane_prefix(const float (&x)[kE], int n, float* pre,
                             float (&v)[kE], int lane) {
  float q[kE];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    sum = __fadd_rn(sum, x[i]);
    q[i] = sum;
  }
  const int j = lane * kE;
  const float incl = warp_inclusive_scan(sum, lane);
  const float excl = __shfl_up_sync(kFull, incl, 1);
  const float lo = lane ? excl : 0.f;
#pragma unroll
  for (int i = 0; i < kE; ++i) v[i] = fminf(__fadd_rn(lo, q[i]), incl);
  if (__any_sync(kFull, lane > 0 && j < n && excl > incl)) {
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if (j + i < n) pre[j + i] = v[i];
    __syncwarp();
    lift_to_running_max(pre, n, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if (j + i < n) v[i] = pre[j + i];
    __syncwarp();
  }
  float last = 0.f;
#pragma unroll
  for (int i = 0; i < kE; ++i)
    if (j + i == n - 1) last = v[i];
  return n > 0 ? __shfl_sync(kFull, last, (n - 1) / kE) : 0.f;
}

// Entries of a lane_prefix that are <= target, offset by prev.  Whole warp.
__device__ __forceinline__ int lane_count_le(const float (&v)[kE], int n,
                                             float prev, float target,
                                             int lane) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < kE; ++i)
    c += lane * kE + i < n && __fadd_rn(v[i], prev) <= target;
  return __reduce_add_sync(kFull, c);
}

// Inclusive prefix sums of the non-negative terms f(0), ..., f(n - 1) into
// pre[0, n), kE consecutive entries a lane (their f's evaluated together),
// non-decreasing; returns pre[n - 1].  Whole warp.
template <typename F>
__device__ float warp_prefix(float* pre, int n, int lane, F f) {
  float carry = 0.f;
  bool dip = false;
  for (int c0 = 0; c0 < n; c0 += 32 * kE) {
    const int j = c0 + lane * kE;
    float x[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) x[i] = j + i < n ? f(j + i) : 0.f;
    carry = prefix_chunk(pre, x, j, n, carry, dip, lane);
  }
  return prefix_finish(pre, n, dip, lane);
}

// The number of i in [0, n) with key(i) <= target.  Whole warp.
template <typename Key>
__device__ __forceinline__ int warp_count_le(int n, float target, int lane,
                                             Key key) {
  int c = 0;
  for (int i = lane; i < n; i += 32) c += key(i) <= target;
  return __reduce_add_sync(kFull, c);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_buf[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_buf[warp - 1] : 0) + x - v;
  *total = warp_buf[nwarps - 1];
  __syncthreads();  // warp_buf is reused by the next call
  return before;
}

// One token's Q and level-1 block prefix sums over its row, G consecutive
// topics a lane (a 16-byte vector when G == 4).  Whole warp.
template <int G>
__device__ void doc_pass(const int* __restrict__ row,
                         const float* __restrict__ denom, float alpha,
                         float beta, int K, int bw, float* bcum, float* Q,
                         int lane) {
  using Vec = typename std::conditional<G == 4, int4, int>::type;
  const int nb = K / bw;
  const int lpb = bw / G;             // lanes a block spans within a chunk
  const int chunks = cdiv(K, 32 * G);
  float run = 0.f, acc = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += kRowBatch) {
    Vec v[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int k = ((c0 + i) * 32 + lane) * G;
      if (c0 + i < chunks && k < K)
        v[i] = *reinterpret_cast<const Vec*>(row + k);
    }
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int c = c0 + i;
      if (c >= chunks) break;
      const int k = (c * 32 + lane) * G;
      float s = 0.f;
      if (k < K) {
        const int* e = reinterpret_cast<const int*>(&v[i]);
#pragma unroll
        for (int g = 0; g < G; ++g)
          s = __fadd_rn(s, pstar(e[g], beta, denom[k + g]));
      }
      if (lpb >= 32) {                // a block spans lpb / 32 chunks
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
        acc = __fadd_rn(acc, s);
        if ((c + 1) % (lpb / 32) == 0) {
          run = __fadd_rn(run, acc);
          if (lane == 0) bcum[(c + 1) / (lpb / 32) - 1] = run;
          acc = 0.f;
        }
      } else {                        // a chunk holds 32 / lpb blocks
        for (int o = lpb >> 1; o > 0; o >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
        for (int g = 0; g < 32 / lpb; ++g) {
          const float bs = __shfl_sync(kFull, s, g * lpb);
          const int blk = c * (32 / lpb) + g;
          if (blk < nb) {
            run = __fadd_rn(run, bs);
            if (lane == 0) bcum[blk] = run;
          }
        }
      }
    }
  }
  if (lane == 0) *Q = __fmul_rn(alpha, run);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
fold_in_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_buf[32];
  __shared__ int red_i[kMaxWarps];
  __shared__ int cta_sp;
  cg::cluster_group cluster = cg::this_cluster();

  const int L = p.L, K = p.K, P = p.P, bw = p.bw, nb = K / bw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int C = (int)cluster.num_blocks();    // CTAs of this doc
  const Layout sl = layout(L, K, P, bw, warps, C);
  float* denom = reinterpret_cast<float*>(smem + sl.denom);
  int* part = reinterpret_cast<int*>(smem + sl.part);     // theta, 2 x K
  int* tsum = reinterpret_cast<int*>(smem + sl.tsum);     // this CTA's topics
  int* nz = reinterpret_cast<int*>(smem + sl.nz);
  int* chist = reinterpret_cast<int*>(smem + sl.chist);   // topics per count
  int* base = reinterpret_cast<int*>(smem + sl.base);     // first rank
  int* ecnt = reinterpret_cast<int*>(smem + sl.ecnt);
  int* etpc = reinterpret_cast<int*>(smem + sl.etpc);
  int* z = reinterpret_cast<int*>(smem + sl.z);
  int* msk = reinterpret_cast<int*>(smem + sl.msk);
  float* Q = reinterpret_cast<float*>(smem + sl.Q);
  float* tssq = reinterpret_cast<float*>(smem + sl.tssq);  // S/(S+Q) a token
  float* uni = reinterpret_cast<float*>(smem + sl.uni);
  float* bcum = reinterpret_cast<float*>(smem + sl.bcum);
  float* pre = reinterpret_cast<float*>(smem + sl.pre)
               + (size_t)warp * prefix_width(P, bw);

  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int Lc = cdiv(L, C);
  const int l0 = rank * Lc;
  const int nl = max(min(L - l0, Lc), 0);   // this CTA's tokens
  const int Ks = cdiv(K, C);
  const int k0 = rank * Ks;                   // this CTA's kept topics
  const float alpha = p.hyper[0];
  const float beta = p.hyper[1];
  const float vbeta = __fmul_rn(beta, (float)p.num_words_total);
  const int n_sweeps = p.burn_in + p.samples;
  const int* rows = p.phi_tok + ((int64_t)b * L + l0) * K;

  for (int k = tid; k < K; k += blockDim.x) {
    denom[k] = __fadd_rn((float)p.phi_sum[k], vbeta);
    part[k] = part[K + k] = 0;
  }
  for (int k = tid; k < Ks; k += blockDim.x) tsum[k] = 0;
  for (int c = tid; c <= L; c += blockDim.x) chist[c] = 0;
  for (int i = tid; i < nl; i += blockDim.x) {
    z[i] = p.z0[(int64_t)b * L + l0 + i];
    msk[i] = p.mask[(int64_t)b * L + l0 + i] != 0;
    tssq[i] = 0.f;
  }
  cluster.sync();        // every CTA's counts are zero before any adds
  // theta of z0: each token counts in every CTA of the doc's cluster
  for (int i = tid; i < nl; i += blockDim.x)
    if (msk[i])
      for (int r = 0; r < C; ++r)
        atomicAdd(cluster.map_shared_rank(part, r) + z[i], 1);

  // Q and the level-1 block prefix sums of every token's p*, once per doc.
  for (int i = warp; i < nl; i += warps) {
    if (!msk[i]) continue;
    if (kNoPass) {         // probe: no pass over the rows
      for (int blk = lane; blk < nb; blk += 32) bcum[i * nb + blk] = blk + 1.f;
      if (lane == 0) Q[i] = 1.f;
    } else if (p.vec_rows) {
      doc_pass<4>(rows + (int64_t)i * K, denom, alpha, beta, K, bw,
                  bcum + i * nb, Q + i, lane);
    } else {
      doc_pass<1>(rows + (int64_t)i * K, denom, alpha, beta, K, bw,
                  bcum + i * nb, Q + i, lane);
    }
  }

  // contiguous topics per thread, for the reduction and the compaction
  const int chunk = cdiv(K, blockDim.x);
  const int k_lo = min(tid * chunk, K), k_hi = min(k_lo + chunk, K);
  const int c_chunk = cdiv(L + 1, blockDim.x);   // counts L, L - 1, ..., 0
  const int j_lo = min(tid * c_chunk, L + 1);
  const int j_hi = min(j_lo + c_chunk, L + 1);
  const unsigned lanes_below = (1u << lane) - 1u;

  // each sweep's uniforms of this CTA's tokens, copied asynchronously into
  // a double buffer a sweep ahead
  auto stage_uniforms = [&](int sweep) {
    const float* src =
        p.uniforms + (((int64_t)b * n_sweeps + sweep) * L + l0) * 2;
    float* dst = uni + (sweep & 1) * 2 * Lc;
    for (int i = tid; i < 2 * nl; i += blockDim.x) cp_async4(dst + i, src + i);
    cp_async_commit();
  };
  if (n_sweeps > 0) stage_uniforms(0);

  int sp_acc = 0;        // lane 0 of each warp
  int buf = 0;
  for (int s = 0;; ++s) {
    // ---- theta: the doc's counts of the current z, added into every CTA
    // of the cluster by the tokens' warps; complete after the barrier ----
    const bool last = s == n_sweeps;
    cluster.sync();
    const bool kept = s > p.burn_in;          // theta after sweep s - 1
    int* theta = part + buf * K;
    int* nxt = part + (buf ^ 1) * K;          // zeroed a sweep ago
    int my_nz = 0;
    for (int k = k_lo; k < k_hi; ++k) {
      const int t = theta[k];
      if (kept && k >= k0 && k < k0 + Ks) tsum[k - k0] += t;
      if (t > 0 && !last) {
        ++my_nz;
        atomicAdd(&chist[t], 1);
      }
    }
    if (last) break;
    cp_async_wait_all();                      // this sweep's uniforms
    if (s + 1 < n_sweeps) stage_uniforms(s + 1);

    // ---- ELL top-P of theta, in lax.top_k order ----
    __syncthreads();                          // the count histogram is whole
    // one scan for both: the non-zero topics before this thread's (low
    // half) and the topics whose count is above its counts (high half);
    // neither total reaches 2^16 (K < 2^16), so no carry crosses
    int my_cnt = 0;
    for (int j = j_lo; j < j_hi; ++j) my_cnt += chist[L - j];
    int both;
    const int before = block_exclusive_scan(my_nz | my_cnt << 16, warp_buf,
                                            &both);
    const int nnz = both & 0xffff;
    int pos = before & 0xffff;
    for (int k = k_lo; k < k_hi; ++k) {
      if (theta[k] > 0) {
        nz[pos++] = k;
      } else {
        const int r = nnz + (k - pos);   // zero topics before k: k - pos
        if (r < P) {
          ecnt[r] = 0;
          etpc[r] = k;
        }
      }
    }
    // base[c]: topics with a count above c, counts taken from L down
    int above = before >> 16;
    for (int j = j_lo; j < j_hi; ++j) {
      base[L - j] = above;
      above += chist[L - j];
      chist[L - j] = 0;                // clean for the next sweep
    }
    __syncthreads();
    if (warp == 0) {                   // equal counts ranked in id order
      for (int i0 = 0; i0 < nnz; i0 += 32) {
        const int i = i0 + lane;
        const int k = i < nnz ? nz[i] : -1;
        const int c = k >= 0 ? theta[k] : -1;
        const unsigned peers = __match_any_sync(kFull, c);
        const int r = k >= 0 ? base[c] + __popc(peers & lanes_below) : P;
        __syncwarp();
        if (r < P) {
          ecnt[r] = c;
          etpc[r] = k;
        }
        if (k >= 0 && lane == 31 - __clz(peers)) base[c] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    // theta is read no more this sweep: zeroed, it takes the adds of the
    // sweep after next (the cluster barrier between orders the two)
    for (int k = k_lo; k < k_hi; ++k) theta[k] = 0;

    // ---- a warp per real token, against the sweep-start theta ----
    const bool keep = s >= p.burn_in;
    const float* us = uni + (s & 1) * 2 * Lc;
    const int live = min(nnz, P);
    for (int i = warp; i < nl; i += warps) {
      if (!msk[i]) continue;
      int znew = z[i];
      bool use_sparse = false;
      float ratio = 0.f;
      if (!kNoDraws) {
        const int* row = rows + (int64_t)i * K;
        const float u1 = us[2 * i], u2 = us[2 * i + 1];
        const int j = lane * kE;
        // the sparse side's row gathers go out first; the dense side's
        // block is known from u2 and the block sums before S is, so its
        // row entries load meanwhile and are used if it is drawn
        const bool one_chunk = live <= 32 * kE;   // the prefix in registers
        int raw[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e)
          raw[e] = one_chunk && j + e < live ? row[etpc[j + e]] : 0;
        const float* bc = bcum + i * nb;
        const float target_d = __fmul_rn(u2, bc[nb - 1]);
        const int bi = min(warp_count_le(nb, target_d, lane,
                                         [&](int b) { return bc[b]; }),
                           nb - 1);
        int dv[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e)
          dv[e] = j + e < bw ? row[bi * bw + j + e] : 0;
        float v[kE], S;
        if (one_chunk) {
          float x[kE];
#pragma unroll
          for (int e = 0; e < kE; ++e)
            x[e] = j + e < live
                       ? __fmul_rn((float)ecnt[j + e],
                                   pstar(raw[e], beta, denom[etpc[j + e]]))
                       : 0.f;
          S = lane_prefix(x, live, pre, v, lane);
        } else {
          S = warp_prefix(pre, live, lane, [&](int jj) {
            const int k = etpc[jj];
            return __fmul_rn((float)ecnt[jj], pstar(row[k], beta, denom[k]));
          });
        }
        const float q = Q[i];
        use_sparse = __fmul_rn(u1, __fadd_rn(S, q)) < S;
        if (use_sparse) {
          const float target = __fmul_rn(u2, S);
          int count = one_chunk
                          ? lane_count_le(v, live, 0.f, target, lane)
                          : warp_count_le(live, target, lane,
                                          [&](int jj) { return pre[jj]; });
          if (S <= target) count += P - live;   // the zero tail's prefix is S
          znew = etpc[min(count, P - 1)];
        } else {
          const float prev = bi > 0 ? bc[bi - 1] : 0.f;
          float x[kE];
#pragma unroll
          for (int e = 0; e < kE; ++e)
            x[e] = j + e < bw ? pstar(dv[e], beta, denom[bi * bw + j + e])
                              : 0.f;
          lane_prefix(x, bw, pre, v, lane);
          const int in_b = lane_count_le(v, bw, prev, target_d, lane);
          znew = bi * bw + min(in_b, bw - 1);
        }
        if (keep) ratio = __fdiv_rn(S, fmaxf(__fadd_rn(S, q), 1e-30f));
      }
      if (lane < C)               // the new topic counts in every CTA
        atomicAdd(cluster.map_shared_rank(nxt, lane) + znew, 1);
      if (lane == 0) {
        z[i] = znew;
        if (keep) {
          sp_acc += use_sparse;
          tssq[i] = __fadd_rn(tssq[i], ratio);   // its sweeps in order
        }
      }
      __syncwarp();   // pre is rewritten by the warp's next token
    }
    buf ^= 1;
  }

  // ---- outputs: kept theta (this CTA's topics), z, the doc's sums ----
  __syncthreads();
  for (int k = tid; k < Ks && k0 + k < K; k += blockDim.x)
    p.theta_sum[(int64_t)b * K + k0 + k] = tsum[k];
  for (int i = tid; i < nl; i += blockDim.x)
    p.z_out[(int64_t)b * L + l0 + i] = z[i];
  if (lane == 0) red_i[warp] = sp_acc;
  __syncthreads();
  if (tid == 0) {
    int si = 0;
    for (int w = 0; w < warps; ++w) si += red_i[w];
    cta_sp = si;
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
    // the doc's S/(S+Q) in an order set by the token index alone: lane j
    // adds tokens j, j + 32, ... (each from the CTA that holds it), then a
    // fixed tree over the lanes; padding slots hold 0
    float sf = 0.f;
    for (int l0 = lane; l0 < L; l0 += 32 * kRowBatch) {
      float v[kRowBatch];              // the loads in flight together
#pragma unroll
      for (int e = 0; e < kRowBatch; ++e) {
        const int l = l0 + 32 * e, r = l / Lc;
        v[e] = l < L ? *cluster.map_shared_rank(tssq + (l - r * Lc), r) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kRowBatch; ++e) sf = __fadd_rn(sf, v[e]);
    }
    for (int o = 16; o > 0; o >>= 1)
      sf = __fadd_rn(sf, __shfl_down_sync(kFull, sf, o));
    if (lane == 0) {
      int si = 0;
      for (int r = 0; r < C; ++r) si += *cluster.map_shared_rank(&cta_sp, r);
      p.sp_out[b] = si;
      p.ssq_out[b] = sf;
    }
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

// A launch's shape: C CTAs a doc, `warps` warps a CTA.
struct Shape {
  int C, warps;
};

int warps_for(int L, int C, int cap) {
  const int Lc = cdiv(L, C);
  return Lc < 4 ? 4 : (Lc > cap ? cap : Lc);
}

size_t smem_for(int L, int K, int P, int bw, Shape sh) {
  return layout(L, K, P, bw, sh.warps, sh.C).total;
}

// The launch: a (C, B) grid in clusters of C CTAs.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
};

cudaError_t configure(Launch* l, int B, int L, int K, int P, int bw,
                      Shape sh, cudaStream_t stream) {
  const size_t smem = smem_for(L, K, P, bw, sh);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;   // does not fit
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  l->cfg.gridDim = dim3(sh.C, B, 1);
  l->cfg.blockDim = dim3(32 * sh.warps, 1, 1);
  l->cfg.dynamicSmemBytes = smem;
  l->cfg.stream = stream;
  l->attr[0].id = cudaLaunchAttributeClusterDimension;
  l->attr[0].val.clusterDim.x = sh.C;
  l->attr[0].val.clusterDim.y = 1;
  l->attr[0].val.clusterDim.z = 1;
  l->cfg.attrs = l->attr;
  l->cfg.numAttrs = 1;
  return cudaSuccess;
}

// Clusters of this shape the card runs at once (occupancy calculator, kept
// per shape); -1 when the shape does not fit.
int max_clusters(int L, int K, int P, int bw, Shape sh) {
  static std::mutex mu;
  static std::map<std::array<int, 6>, int> known;
  const std::array<int, 6> key{L, K, P, bw, sh.C, sh.warps};
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it != known.end()) return it->second;
  Launch l;
  int n = -1;
  if (configure(&l, 1, L, K, P, bw, sh, nullptr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, fold_in_kernel, &l.cfg) !=
          cudaSuccess)
    n = -1;
  cudaGetLastError();   // a refused query leaves no error behind
  known[key] = n;
  return n;
}

// The launch's shape: of C <= kMaxCluster CTAs a doc (each at least
// kMinTokens slots) of up to 16 or 8 warps, the one that puts the most
// warps on a doc's tokens while the whole batch runs in one wave; ties go
// to fewer CTAs.  At B = 32 on an H100: L = 32 two CTAs of 16 warps, L = 64
// three of 16 (four do not fit: 30 clusters at once), L >= 128 seven of 8
// (two CTAs an SM).
Shape shape_for(int B, int L, int K, int P, int bw) {
  const int most = L / kMinTokens < kMaxCluster ? L / kMinTokens : kMaxCluster;
  Shape best{1, warps_for(L, 1, kMaxWarps)};
  int best_busy = 0;
  for (int cap = kMaxWarps; cap >= kMaxWarps / 2; cap /= 2) {
    for (int C = 1; C <= (most > 1 ? most : 1); ++C) {
      const Shape sh{C, warps_for(L, C, cap)};
      const int Lc = cdiv(L, C);
      const int busy = C * (sh.warps < Lc ? sh.warps : Lc);
      if (busy > best_busy && max_clusters(L, K, P, bw, sh) >= B) {
        best = sh;
        best_busy = busy;
      }
    }
  }
  return best;
}

}  // namespace

extern "C" void fold_in_docs_shape(int B, int L, int K, int P, int bw,
                                   int* C, int* warps) {
  const Shape sh = shape_for(B, L, K, P, bw);
  *C = sh.C;
  *warps = sh.warps;
}

extern "C" int fold_in_docs_launch(
    const int* phi_tok, const int* phi_sum, const float* hyper,
    const float* uniforms, const int* mask, const int* z0, int* theta_sum,
    int* sp, float* ssq, int* z_out, int B, int L, int K, int P,
    int burn_in, int samples, int num_words_total, int bw, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K % bw != 0 || bw > 32 * kE || K >= 1 << 16 || P < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = configure(&l, B, L, K, P, bw, shape_for(B, L, K, P, bw),
                            static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.phi_tok = phi_tok;
  p.phi_sum = phi_sum;
  p.hyper = hyper;
  p.uniforms = uniforms;
  p.mask = mask;
  p.z0 = z0;
  p.theta_sum = theta_sum;
  p.sp_out = sp;
  p.ssq_out = ssq;
  p.z_out = z_out;
  p.L = L;
  p.K = K;
  p.P = P;
  p.burn_in = burn_in;
  p.samples = samples;
  p.num_words_total = num_words_total;
  p.bw = bw;
  p.vec_rows = K % 4 == 0 && reinterpret_cast<uintptr_t>(phi_tok) % 16 == 0;
  e = cudaLaunchKernelEx(&l.cfg, fold_in_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
