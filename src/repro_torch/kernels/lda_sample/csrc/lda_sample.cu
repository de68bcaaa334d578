// The S/Q training sweep of LDA (paper §6.1) over word tiles.
//
// Replaces the Pallas TPU kernel repro/kernels/lda_sample/kernel.py:194
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
// Bound: bytes.  The (D, P) ELL is far larger than L2, so the ELL rows read
// from device memory set the floor; this design reads
//     sum over runs of live(doc) x 2 x sizeof(ELL element)
// plus, per slot, token_doc, mask, z_old, the two uniforms and the three
// outputs, plus one phi row (K int32) each time the word changes within a
// CTA's group of tiles.  A run is a maximal stretch of a tile's real slots
// with one document; the tiling sorts a word's tokens by document, so the
// tokens of a (word, doc) pair sit side by side.  The least work (each
// input once, S once per run) is bound by these bytes, not by operations.
// The kernel's time is not: build variants of this file (k1_probe.py,
// LDA_SAMPLE_PROBE below) show the row loads mostly hidden behind the
// per-run scan and draws, which take about four fifths of it on an H100
// (PERF.md).
//
// Design:
//  * a CTA takes kTilesPerCta consecutive tiles in turn.  Per tile its
//    word's p* (K floats), the in-block prefix sums of p* (K floats) and the
//    nb level-1 block prefix sums sit in shared memory, as in the paper's
//    layout (the TPU kernel's (C, K) chunk table is 256 KB at K = 1024,
//    above the 227 KB a block may use); a tile of the same word as the one
//    before keeps them (a heavy word spans thousands of tiles).
//  * one warp per run, not per token.  Under delayed counts p1 depends only
//    on the document's frozen ELL row and the tile's word, so S and the p1
//    prefix are the same for every token of a run: the warp reads the row
//    once, forms the prefix in its shared buffer, then draws every token of
//    the run from it, each with its own (u1, u2).  The runs are found once
//    per tile with ballots on a change of document (or a padding slot);
//    warp w takes runs w, w + 8, ...  Unsorted documents only make runs of
//    length 1.
//  * the ELL is read in its stored type, int16 (C7) or int32, and only its
//    live entries: the wrapper hands the (D,) live lengths, so no load waits
//    on the search for the first zero count.  Each row is copied into a
//    per-warp double buffer in shared memory with cp.async, 16 bytes a lane
//    (8 int16 or 4 int32 entries), and the next run's row is issued before
//    the current run is scanned and drawn; a tile's first rows go out
//    before its search sums are built.  cp.async rather than
//    cp.async.bulk: each lane issues its own vectors and a commit group per
//    run keeps the count, with no mbarrier phase to track, and nothing is
//    held in registers while it flies.  Little's law: 3.35 TB/s x ~1 us /
//    132 SMs ~ 25 KB in flight per SM; at P = 512 (int16) a CTA takes ~62 KB
//    of shared memory, three fit an SM, and 24 warps with a 0.6-1.1 KB row
//    each in flight (plus the one being scanned) come close.  Deeper
//    buffers (3 or 4 rows a warp) cost a CTA per SM and measured slower
//    (PERF.md).  A row is 16-byte aligned only when P is a multiple of the
//    vector width (and the arrays are); otherwise lanes copy the live
//    entries one element at a time (the same buffer, no overlap).
//  * the prefixes: a lane takes a vector of consecutive entries and sums
//    them in order, and a warp scan (Kogge-Stone) adds the lanes' totals.
//    The scan's lanes add in different orders, so one lane's total can
//    round below an earlier lane's where the terms span many orders of
//    magnitude.  Each entry's prefix is clamped to its lane's total; the
//    in-block sums of p* (built once per word) take a warp max-scan after
//    the sum scan, and a p1 prefix whose lane totals dip is lifted to its
//    running maximum after the scan (a max-scan inside the per-run scan
//    cost K1 5-10% on an H100, PERF.md).  So the p1 prefix, the in-block
//    sums and the block sums (added in order by one thread) never
//    decrease.
//  * the draws count prefixes <= target, as the reference does: the sparse
//    side over the live entries, plus the zero tail's P - live entries when
//    S <= target, clamped to P - 1; the dense side over the block sums, then
//    over the winning block's in-block sums.  A run of one or two tokens
//    (most runs) is drawn token by token by the whole warp (each lane
//    counts its share; a warp reduction or ballots add them); a longer run
//    gives each token a lane and a binary search, which returns the same
//    count because the prefixes never decrease: a token's draw does not
//    depend on the length of its run.
//  * all float arithmetic uses _rn intrinsics (no fused multiply-add).  The
//    sums are taken in another order than torch.cumsum's (fault F2), so a
//    draw on a float boundary may differ from the plain version: the kernel
//    is held to a stated bound of flipped draws, not to bits.
//  * z is read and written in its stored type, int16 (C7) or int32.
//  * no tensor cores, wgmma or TMA tiles: there is no matrix product; the
//    work is a gather, a scan and a search.
//
// Build variants, for measurement only (k1_probe.py builds them with -D):
// LDA_SAMPLE_TILES_PER_CTA sets the group of tiles a CTA takes (1: p* is
// rebuilt for every tile); LDA_SAMPLE_PROBE=1 reads no ELL row (each warp's
// buffers hold one valid row with hashed topics, scanned and drawn from as
// usual, so the scan and the draws stay and only the row loads go);
// LDA_SAMPLE_PROBE=2 does no per-run work (the tile staging, run finding
// and search sums stay).  Probe builds write wrong draws.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LDA_SAMPLE_TILES_PER_CTA
#define LDA_SAMPLE_TILES_PER_CTA 8
#endif
#ifndef LDA_SAMPLE_PROBE
#define LDA_SAMPLE_PROBE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilesPerCta = LDA_SAMPLE_TILES_PER_CTA;  // consecutive tiles
constexpr int kProbe = LDA_SAMPLE_PROBE;
constexpr int kWarpDraws = 2;       // runs this short: the warp draws each
constexpr int kPad = 8;             // P rounded up to this for buffer strides
constexpr unsigned kFull = 0xffffffffu;

// Byte offsets of the dynamic shared memory of one CTA.
struct Layout {
  size_t ebuf, pre, runs, ps, pc, bcum, uni, tdoc, tmask, wsum, total;
};

__host__ __device__ inline Layout layout(int t, int K, int P, int bw,
                                         int ell_bytes) {
  const size_t Pv = (size_t)(P + kPad - 1) / kPad * kPad;
  Layout L;
  size_t o = 0;
  L.ebuf = o;  o += (size_t)kWarps * 2 * 2 * Pv * ell_bytes;  // 2 rows a warp
  L.pre = o;   o += (size_t)kWarps * Pv * sizeof(float);
  L.runs = o;  o += (size_t)t * sizeof(int4);
  L.ps = o;    o += (size_t)K * sizeof(float);
  L.pc = o;    o += (size_t)K * sizeof(float);
  L.bcum = o;  o += (size_t)(K / bw) * sizeof(float);
  L.uni = o;   o += (size_t)2 * t * sizeof(float);
  L.tdoc = o;  o += (size_t)t * sizeof(int);
  L.tmask = o; o += (size_t)t * sizeof(int);
  L.wsum = o;  o += (size_t)2 * kWarps * sizeof(int);
  L.total = o;
  return L;
}

template <typename Z, typename E>
struct Params {
  const int* tile_word;     // (n,)
  const int* token_doc;     // (n, t)
  const uint8_t* mask;      // (n, t)
  const Z* z_old;           // (n, t)
  const int* phi_vk;        // (V, K)
  const int* phi_sum;       // (K,)
  const E* ell_counts;      // (D, P), zero counts last
  const E* ell_topics;      // (D, P)
  const int* ell_live;      // (D,) live (non-zero) entries per row
  const float* uniforms;    // (n, t, 2)
  Z* z_new;                 // (n, t) out
  uint8_t* sparse;          // (n, t) out
  float* ssq;               // (n, t) out
  int n, t, K, P, bw;
  float alpha, beta;
  int num_words_total;
  bool vec_rows;            // ELL rows are 16-byte aligned
};

// Inclusive warp scan of v (Kogge-Stone), float adds rounded to nearest.
__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = __fadd_rn(v, y);
  }
  return v;
}

// Inclusive warp max-scan.  Applied to the sums of non-negative terms that
// warp_inclusive_scan gives, it makes them non-decreasing across lanes: the
// lanes add in different orders, so one lane's sum can round below an
// earlier lane's.
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

// The number of i in [0, n) with key(i) <= target, for key non-decreasing.
template <typename Key>
__device__ __forceinline__ int count_le(int n, float target, Key key) {
  int lo = 0;
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1)
    if (lo + step <= n && key(lo + step - 1) <= target) lo += step;
  return lo;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy a row's first `live` counts and topics into a warp's buffers and
// commit them as one group.
template <typename E>
__device__ __forceinline__ void issue_row(E* bc, E* bt, const E* crow,
                                          const E* trow, int live, int lane,
                                          bool vec_rows) {
  constexpr int kVec = 16 / sizeof(E);
  if (vec_rows) {
    const int nvec = (live + kVec - 1) / kVec;
    for (int i = lane; i < nvec; i += 32) {
      cp_async16(bc + i * kVec, crow + i * kVec);
      cp_async16(bt + i * kVec, trow + i * kVec);
    }
  } else {
    for (int j = lane; j < live; j += 32) {
      bc[j] = crow[j];
      bt[j] = trow[j];
    }
  }
  cp_async_commit();
}

template <typename Z, typename E>
__global__ void __launch_bounds__(kThreads, 3)
lda_sample_kernel(const Params<Z, E> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(E);
  const int t = p.t, K = p.K, P = p.P, bw = p.bw, nb = K / bw;
  const Layout L = layout(t, K, P, bw, sizeof(E));
  const int Pv = (P + kPad - 1) / kPad * kPad;
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* pc = reinterpret_cast<float*>(smem + L.pc);
  float* bcum = reinterpret_cast<float*>(smem + L.bcum);
  float* uni = reinterpret_cast<float*>(smem + L.uni);
  int* tdoc = reinterpret_cast<int*>(smem + L.tdoc);
  int* tmask = reinterpret_cast<int*>(smem + L.tmask);
  int4* runs = reinterpret_cast<int4*>(smem + L.runs);  // beg, end, live, doc
  int* wsum = reinterpret_cast<int*>(smem + L.wsum);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const float vbeta = __fmul_rn(p.beta, (float)p.num_words_total);
  E* ebuf = reinterpret_cast<E*>(smem + L.ebuf) + (size_t)warp * 4 * Pv;
  float* mypre = reinterpret_cast<float*>(smem + L.pre) + (size_t)warp * Pv;
  auto issue = [&](int r, int stage) {
    if (kProbe == 1) {            // probe: no row loads
      cp_async_commit();
      return;
    }
    const int4 run = runs[r];
    E* bc = ebuf + (size_t)stage * 2 * Pv;
    issue_row(bc, bc + Pv, p.ell_counts + (int64_t)run.w * P,
              p.ell_topics + (int64_t)run.w * P, run.z, lane, p.vec_rows);
  };

  if (kProbe == 1) {
    // probe: one valid row in both buffers; hashed topics make the p*
    // gathers hit the banks as a real row's do
    for (int j = lane; j < 2 * Pv; j += 32) {
      E* row = ebuf + (j / Pv) * 2 * Pv;
      row[j % Pv] = (E)1;
      row[Pv + j % Pv] = (E)(((unsigned)(j % Pv) * 2654435761u >> 16) % K);
    }
    __syncwarp();
  }

  const int tile_end = min(p.n, (int)(blockIdx.x + 1) * kTilesPerCta);
  int prev_word = -1;
  for (int tile = blockIdx.x * kTilesPerCta; tile < tile_end; ++tile) {
    const int64_t base = (int64_t)tile * t;

    // ---- stage the tile: docs, mask, uniforms, p*; padding slots ----
    // Independent loads go out together: the word with the slots, then the
    // word's phi row with each slot's live length.
    const int word = p.tile_word[tile];
    const bool new_word = word != prev_word;   // else p* and its sums stay
    prev_word = word;
    int live0 = 0;                             // slot tid's live length
    for (int s = tid; s < t; s += kThreads) {
      const int m = p.mask[base + s] != 0;
      const int d = p.token_doc[base + s];
      tmask[s] = m;
      tdoc[s] = d;
      uni[2 * s] = p.uniforms[2 * (base + s)];
      uni[2 * s + 1] = p.uniforms[2 * (base + s) + 1];
      if (s == tid && m) live0 = p.ell_live[d];
      if (!m) {
        p.z_new[base + s] = p.z_old[base + s];
        p.sparse[base + s] = 0;
        p.ssq[base + s] = 0.f;
      }
    }
    if (new_word) {
      const int* row = p.phi_vk + (int64_t)word * K;
      for (int k = tid; k < K; k += kThreads)
        ps[k] = __fdiv_rn(__fadd_rn((float)row[k], p.beta),
                          __fadd_rn((float)p.phi_sum[k], vbeta));
    }
    __syncthreads();

    // ---- runs: maximal stretches of real slots with one document ----
    // The k-th run begins at the k-th slot that starts one and ends after
    // the k-th slot that ends one.
    int n_first = 0, n_last = 0;
    for (int s0 = 0; s0 < t; s0 += kThreads) {
      const int s = s0 + tid;
      const bool real = s < t && tmask[s];
      const int d = real ? tdoc[s] : -1;
      const bool first =
          real && (s == 0 || !tmask[s - 1] || tdoc[s - 1] != d);
      const bool last =
          real && (s == t - 1 || !tmask[s + 1] || tdoc[s + 1] != d);
      const unsigned bf = __ballot_sync(kFull, first);
      const unsigned bl = __ballot_sync(kFull, last);
      if (lane == 0) {
        wsum[warp] = __popc(bf);
        wsum[kWarps + warp] = __popc(bl);
      }
      __syncthreads();
      int of = n_first, ol = n_last;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) {
          of += wsum[w];
          ol += wsum[kWarps + w];
        }
        n_first += wsum[w];
        n_last += wsum[kWarps + w];
      }
      if (first) {
        int4& run = runs[of + __popc(bf & lanes_below)];
        run.x = s;
        run.z = min(max(s0 == 0 ? live0 : p.ell_live[d], 0), P);
        run.w = d;
      }
      if (last) runs[ol + __popc(bl & lanes_below)].y = s + 1;
      __syncthreads();   // wsum is rewritten by the next chunk of slots
    }
    const int n_runs = n_first;

    // ---- each warp's first row goes out before the search sums ----
    int cur = kProbe == 2 ? n_runs : warp;   // probe 2: no per-run work
    if (cur < n_runs) {
      issue(cur, 0);
    } else {
      cp_async_commit();
    }

    // ---- level 2: in-block inclusive prefix sums; level 1: block sums ----
    for (int b = warp; new_word && b < nb; b += kWarps) {
      float carry = 0.f;
      for (int c0 = 0; c0 < bw; c0 += 32) {
        const int i = c0 + lane;
        const float v = warp_inclusive_max(
            warp_inclusive_scan(i < bw ? ps[b * bw + i] : 0.f, lane), lane);
        const float incl = __fadd_rn(carry, v);
        if (i < bw) pc[b * bw + i] = incl;
        carry = __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) bcum[b] = carry;
    }
    __syncthreads();
    if (new_word && tid == 0) {
      float run = 0.f;
      for (int b = 0; b < nb; ++b) {
        run = __fadd_rn(run, bcum[b]);
        bcum[b] = run;
      }
    }
    __syncthreads();
    const float total = bcum[nb - 1];
    const float Q = __fmul_rn(p.alpha, total);

    // ---- one warp per run; the next run's row is in flight meanwhile ----
    int stage = 0;
    while (cur < n_runs) {
      const int nxt = cur + kWarps;
      if (nxt < n_runs) {
        issue(nxt, stage ^ 1);
      } else {
        cp_async_commit();
      }
      cp_async_wait_all_but_newest();   // this run's row has landed
      __syncwarp();
      const E* bc = ebuf + (size_t)stage * 2 * Pv;
      const E* bt = bc + Pv;
      const int4 run = runs[cur];
      const int live = run.z;
      const int64_t d = run.w;

      // p1 prefix over the live entries: in order inside a lane's vector,
      // a warp scan across lanes, each prefix clamped to its lane's total;
      // a live lane's total below the one before it (a dip) is noted, and
      // the rare run that has one is lifted to its running maximum
      // afterwards, which keeps the check off the scan's chain of shuffles
      // (lanes past the live entries dip by an ulp often, but hold no
      // entry)
      float carry = 0.f;
      bool dip = false;
      for (int c0 = 0; c0 < live; c0 += 32 * kVec) {
        const int j = c0 + lane * kVec;
        float q[kVec];
        float sum = 0.f;
        if (j < live) {
          union { uint4 v; E e[kVec]; } cv, tv;
          cv.v = *reinterpret_cast<const uint4*>(bc + j);
          tv.v = *reinterpret_cast<const uint4*>(bt + j);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            float x = 0.f;
            if (j + i < live)
              x = __fmul_rn((float)cv.e[i], ps[(int)tv.e[i]]);
            sum = __fadd_rn(sum, x);
            q[i] = sum;
          }
        }
        const float incl = warp_inclusive_scan(sum, lane);
        const float excl = __shfl_up_sync(kFull, incl, 1);
        dip |= lane > 0 && j < live && excl > incl;
        const float lo = lane ? __fadd_rn(carry, excl) : carry;
        const float hi = __fadd_rn(carry, incl);
        if (j < live) {
          float out[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            out[i] = fminf(__fadd_rn(lo, q[i]), hi);
#pragma unroll
          for (int i = 0; i < kVec; i += 4)
            *reinterpret_cast<float4*>(mypre + j + i) =
                make_float4(out[i], out[i + 1], out[i + 2], out[i + 3]);
        }
        carry = __shfl_sync(kFull, hi, 31);
      }
      __syncwarp();
      if (__any_sync(kFull, dip)) {
        lift_to_running_max(mypre, live, lane);
        __syncwarp();
      }
      const float S = live > 0 ? mypre[live - 1] : 0.f;
      const float ssq = __fdiv_rn(S, fmaxf(__fadd_rn(S, Q), 1e-30f));
      const int m = run.y - run.x;

      if (m <= kWarpDraws) {
        // few tokens: the whole warp counts for each token in turn
        int my_z = 0;
        bool my_sparse = false;
        for (int k = 0; k < m; ++k) {
          const int s = run.x + k;
          const float u2 = uni[2 * s + 1];
          const bool use_sparse =
              __fmul_rn(uni[2 * s], __fadd_rn(S, Q)) < S;
          int znew;
          if (use_sparse) {
            const float target = __fmul_rn(u2, S);
            int c = 0;
            for (int j = lane; j < live; j += 32) c += mypre[j] <= target;
            int count = __reduce_add_sync(kFull, c);
            if (S <= target) count += P - live;   // the zero tail's prefix is S
            const int idx = min(count, P - 1);
            znew = idx < live ? (int)bt[idx] : (int)p.ell_topics[d * P + idx];
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
            for (int i0 = 0; i0 < bw; i0 += 32) {
              const int i = i0 + lane;
              in_b += __popc(__ballot_sync(
                  kFull, i < bw && __fadd_rn(pc[bi * bw + i], prev) <= target));
            }
            znew = bi * bw + min(in_b, bw - 1);
          }
          if (lane == k) {
            my_z = znew;
            my_sparse = use_sparse;
          }
        }
        if (lane < m) {
          p.z_new[base + run.x + lane] = (Z)my_z;
          p.sparse[base + run.x + lane] = my_sparse;
          p.ssq[base + run.x + lane] = ssq;
        }
      } else {
        // more tokens: one lane per token, binary searches
        for (int s = run.x + lane; s < run.y; s += 32) {
          const float u2 = uni[2 * s + 1];
          const bool use_sparse =
              __fmul_rn(uni[2 * s], __fadd_rn(S, Q)) < S;
          int znew;
          if (use_sparse) {
            const float target = __fmul_rn(u2, S);
            int count =
                count_le(live, target, [&](int i) { return mypre[i]; });
            if (S <= target) count += P - live;
            const int idx = min(count, P - 1);
            znew = idx < live ? (int)bt[idx] : (int)p.ell_topics[d * P + idx];
          } else {
            const float target = __fmul_rn(u2, total);
            const int bi = min(
                count_le(nb, target, [&](int b) { return bcum[b]; }), nb - 1);
            const float prev = bi > 0 ? bcum[bi - 1] : 0.f;
            const float* blk = pc + bi * bw;
            const int in_b = count_le(
                bw, target, [&](int i) { return __fadd_rn(blk[i], prev); });
            znew = bi * bw + min(in_b, bw - 1);
          }
          p.z_new[base + s] = (Z)znew;
          p.sparse[base + s] = use_sparse;
          p.ssq[base + s] = ssq;
        }
      }
      __syncwarp();   // the buffer and mypre are rewritten by later runs
      cur = nxt;
      stage ^= 1;
    }
    __syncthreads();   // the next tile restages the shared arrays
  }
}

template <typename Z, typename E>
int launch(const Params<Z, E>& p, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lda_sample_kernel<Z, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (p.n + kTilesPerCta - 1) / kTilesPerCta;
  lda_sample_kernel<Z, E><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename Z, typename E>
int launch_typed(const int* tile_word, const int* token_doc,
                 const uint8_t* mask, const void* z_old, const int* phi_vk,
                 const int* phi_sum, const void* ell_counts,
                 const void* ell_topics, const int* ell_live,
                 const float* uniforms, void* z_new, uint8_t* sparse,
                 float* ssq, int n, int t, int K, int P, int bw,
                 float alpha, float beta,
                 int num_words_total, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(E);
  Params<Z, E> p;
  p.tile_word = tile_word;
  p.token_doc = token_doc;
  p.mask = mask;
  p.z_old = static_cast<const Z*>(z_old);
  p.phi_vk = phi_vk;
  p.phi_sum = phi_sum;
  p.ell_counts = static_cast<const E*>(ell_counts);
  p.ell_topics = static_cast<const E*>(ell_topics);
  p.ell_live = ell_live;
  p.uniforms = uniforms;
  p.z_new = static_cast<Z*>(z_new);
  p.sparse = sparse;
  p.ssq = ssq;
  p.n = n;
  p.t = t;
  p.K = K;
  p.P = P;
  p.bw = bw;
  p.alpha = alpha;
  p.beta = beta;
  p.num_words_total = num_words_total;
  p.vec_rows = P % kVec == 0
               && reinterpret_cast<uintptr_t>(ell_counts) % 16 == 0
               && reinterpret_cast<uintptr_t>(ell_topics) % 16 == 0;
  return launch(p, layout(t, K, P, bw, sizeof(E)).total, st);
}

}  // namespace

extern "C" size_t lda_sample_smem_bytes(int t, int K, int P, int bw,
                                        int ell_bytes) {
  return layout(t, K, P, bw, ell_bytes).total;
}

extern "C" int lda_sample_tiles_per_cta() { return kTilesPerCta; }

extern "C" int lda_sample_tiles_launch(
    const int* tile_word, const int* token_doc, const uint8_t* mask,
    const void* z_old, const int* phi_vk, const int* phi_sum,
    const void* ell_counts, const void* ell_topics, const int* ell_live,
    const float* uniforms, void* z_new, uint8_t* sparse, float* ssq, int n,
    int t, int K, int P, int bw, int z_bytes, int ell_bytes,
    float alpha, float beta, int num_words_total,
    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (K % bw != 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LDA_LAUNCH(Z, E)                                                    \
  return launch_typed<Z, E>(tile_word, token_doc, mask, z_old, phi_vk,     \
                            phi_sum, ell_counts, ell_topics, ell_live,     \
                            uniforms, z_new, sparse, ssq, n, t, K, P, bw,  \
                            alpha, beta, num_words_total, st)
  if (z_bytes == 2 && ell_bytes == 2) LDA_LAUNCH(int16_t, int16_t);
  if (z_bytes == 2 && ell_bytes == 4) LDA_LAUNCH(int16_t, int32_t);
  if (z_bytes == 4 && ell_bytes == 2) LDA_LAUNCH(int32_t, int16_t);
  if (z_bytes == 4 && ell_bytes == 4) LDA_LAUNCH(int32_t, int32_t);
#undef LDA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
