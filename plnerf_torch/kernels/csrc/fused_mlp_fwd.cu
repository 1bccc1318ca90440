// Fused NeRF-MLP forward for Hopper (sm_90a).
//
// Replaces the TPU kernel plnerf/kernels/fused_mlp.py `_kernel` (launched
// by `_forward` through pl.pallas_call): every pts layer, the skip layer
// and one of three head schedules (split viewdirs, folded viewdirs, plain
// output_linear), raw [N, 4] (rgb logits, density) out in fp32.
//
// Bound: operations.  The flagship 8x256 viewdirs MLP is 593,408 MACs per
// point in the split schedule and 527,872 in the folded one (1.19 / 1.06
// MFLOP) against ~96 input values and 4 outputs per point.  What bounds
// each path on this card, and what the design does about it:
//
// * float32 (`fp32_kernel`): true fp32 FMAs on the CUDA cores, no TF32,
//   mirroring the JAX package's Precision.HIGHEST.  A K = N = 256 layer
//   over points does 64 FLOP per byte even with its input and output in
//   device memory, above the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20
//   FLOP/B): the FMA pipes set the pace.  So every product is one launch
//   of the SGEMM core shared with the backward (sgemm_core.cuh: 128 x 128
//   tiles, 8 x 8 per thread, a 3-stage 16-byte cp.async ring of both
//   operands, 2 CTAs per SM), in layer order, bias and relu in its
//   epilogue: layer 0; layers 1 .. L-1 (the skip layer as two terms); the
//   head products.  Activations cross device memory between launches.
//   Without gradients they ping-pong through two fp32 buffers [points,
//   w_p] (the workspace).  In training (FusedMLPFunction) the caller gives
//   `acts` [points, Ca] instead (acts_layout.cuh): each product's kept
//   columns go to its own columns (relu_0 .. relu_{L-1}, then split:
//   feature, z_hv; folded: z_hv), the next product reads them there at a
//   row stride of Ca, and the backward (fused_mlp_bwd.cu) reads them
//   instead of recomputing the forward.  The same bytes reach device
//   memory either way.  The wrapper
//   (plnerf_torch/kernels/fused_mlp.py forward_cuda) walks the points in
//   chunks of at most FWD_CHUNK = 2^21 points, a whole number of view rows
//   (samples per ray), so the workspace stays at 2 x 2^21 x w_p x 4 B (4 GB
//   at w_p = 256) whatever the request (each chunk writes its own rows of
//   acts); each chunk is still 16,384 point tiles, many waves of 264 CTA
//   slots.  The feature|alpha head writes the features to a buffer and
//   alpha to raw[:, 3] from the same epilogue; rgb goes to raw[:, :3].
// * bfloat16 (`bf16_kernel`): one CTA maps 128 points through the whole
//   MLP, activations never leave the SM: a layer of 128 x 256 bf16
//   activations does 128 FLOP per byte if it crosses device memory, under
//   the bf16 ridge (295 FLOP/B).  Products on wgmma.mma_async m64nNk16
//   (bf16 operands, fp32 accumulators): two consumer warpgroups of 64 rows
//   each.  A product's columns that go only to raw (the alpha column's
//   32) run first, then the columns kept on chip as one pass of N <= 256
//   (feature|alpha 288 = 32 + 256, folded 160 = 32 + 128).  A
//   (activations) is read from shared memory: 128-row tiles of 32-column
//   chunks, each row 64 bytes in the 64-byte swizzle (16-byte group g of
//   row r stored at g ^ ((r >> 1) & 3)), K-major, so one descriptor form
//   serves x, the views and the activations.  One activation tile: the
//   last pass of a product holds all its kept columns in registers once
//   its wgmmas are done, so its epilogue overwrites its input in place,
//   which leaves room for the ring.  The epilogue is kept short, since
//   both warpgroups run it while the tensor cores wait: the accumulators
//   start at the bias (loaded before the pass's first wgmma), relu is on
//   all of a pass's columns or none, and each pair of columns is one
//   bf16x2 convert, one NaN-passing bf16x2 max and one 4-byte shared
//   store, conflict-free in the swizzle.  B
//   (weights) is streamed through an 8-stage ring of 16 KB stages in
//   shared memory by a producer warp with 1-D cp.async.bulk copies guarded
//   by mbarriers (full: the copy's bytes landed; empty: all 8 consumer
//   warps finished their wgmma reads): PackedMLP.flat packs every 32-row
//   k-slab of every pass ahead of time into its shared-memory image (W^T
//   rows of 64 bytes in the same swizzle: K-major B, no transpose), in the
//   order the kernel consumes them, so the producer streams one buffer
//   front to back.  Each warpgroup's rows are its own: a layer boundary
//   costs a fence.proxy.async and 128-thread barriers, never a CTA
//   barrier.  The weight stream is 1.2 MB per 128 points from L2 (125 FLOP
//   per L2 byte at 8x256).  Shared memory at 8x256: activations 64 KB, x
//   16 KB, views 8 KB, ring 128 KB (222,336 B with alignment and barriers
//   of the 232,448 a CTA may use).  The wgmma, mbarrier and bulk-copy
//   helpers and the swizzle live in wgmma_core.cuh, shared with the shape
//   and mosaic probes of dot_probe.cu.
//
// Two calls on the same inputs give bit-identical results in both paths
// (no atomics, a fixed order of every sum).
//
// Packed layout (built by plnerf_torch/kernels/fused_mlp.py pack_weights).
// Every block is [K, N] with K and N padded to multiples of 32 and zeros
// in the padding, all concatenated in this order into one weight buffer
// and one fp32 bias buffer:
//   pts layer i:  fed by [x | h] (bit i of skip_mask): Wx [in_p, w_p],
//                 Wh [w_p, w_p]; otherwise W [K_i, w_p] (K_0 = in_p);
//                 bias [w_p]
//   split head:   Waf [w_p, w_p + 32] (feature | alpha in column w_p),
//                 bias [w_p + 32]; Wvf [w_p, h_p], Wvv [v_p, h_p],
//                 bias [h_p]; Wr [h_p, 32], bias [32]
//   folded head:  Wfa [w_p, h_p + 32] (Wf @ Wv1[:W] | alpha in column
//                 h_p), bias [h_p + 32]; Wvv [v_p, h_p + 32];
//                 Wr [h_p, 32], bias [32]
//   plain head:   Wo [w_p, 32], bias [32]
// fp32 blocks are row-major.  bf16 blocks are the wgmma stream: for each
// product in order (`build_plan`), each pass of NP columns [c0, c0 + NP)
// in `for_each_pass` order, each term, each k-slab [k0, k0 + 32): the
// image of W[k0:k0+32, c0:c0+NP] transposed, NP rows of 32 values (64
// bytes), the 16-byte group g of row n at position g ^ ((n >> 1) & 3).
// x is [N, in_p]; v is [N / v_div, v_p] (point p reads view row
// p / v_div, so per-ray views need no broadcast over samples).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "acts_layout.cuh"
#include "sgemm_core.cuh"
#include "wgmma_core.cuh"

namespace {

constexpr int ALIGN = 32;     // K / N granularity of every packed block
constexpr int MAX_LAYERS = 16;
constexpr int MAX_PRODS = MAX_LAYERS + 3;

enum Head { SPLIT = 0, FOLDED = 1, PLAIN = 2 };
// operand tiles of a product: x, the views, the two activation buffers
enum Tile { T_NONE = -1, T_X = 0, T_V = 1, T_B0 = 2, T_B1 = 3 };

typedef __nv_bfloat16 bf16;

// One product  out = sum_t A_t @ W_t + bias  of the walk.  A_t: tile
// src[t], K[t] columns; W_t: the row-major [K[t], N] block at woff[t]
// (fp32 path).  Columns [0, out_cols) go to tile dst (relu on
// c < relu_cols), columns [raw_col0, raw_col0 + raw_ncol), before any
// relu, to raw[:, raw_dst + c - raw_col0].
struct Prod {
  int nterms;
  int src[2], K[2];
  long long woff[2];
  int N, boff, dst, out_cols, relu_cols, raw_col0, raw_ncol, raw_dst;
};
struct Plan {
  Prod p[MAX_PRODS];
  int n;
};

// The walk of the packed layout above, in order; 0 for a layout the
// kernels do not take.
int build_plan(Plan* pl, int L, unsigned skip_mask, int in_p, int w_p,
               int v_p, int h_p, int head) {
  if (L < 1 || L > MAX_LAYERS || (skip_mask & 1u) || head < SPLIT ||
      head > PLAIN || h_p > w_p)
    return 0;
  *pl = Plan{};
  long long off = 0;
  int boff = 0;
  auto prod = [&](int N, int dst, int out_cols, int relu_cols) -> Prod& {
    Prod& q = pl->p[pl->n++];
    q.N = N; q.boff = boff; boff += N;
    q.dst = dst; q.out_cols = out_cols; q.relu_cols = relu_cols;
    return q;
  };
  auto term = [&](Prod& q, int src, int K) {
    const int t = q.nterms++;
    q.src[t] = src; q.K[t] = K; q.woff[t] = off;
    off += (long long)K * q.N;
  };
  auto to_raw = [](Prod& q, int col0, int ncol, int dst) {
    q.raw_col0 = col0; q.raw_ncol = ncol; q.raw_dst = dst;
  };
  int cur = T_X, curK = in_p, nxt = T_B0;
  for (int i = 0; i < L; ++i) {
    Prod& q = prod(w_p, nxt, w_p, w_p);
    if ((skip_mask >> i) & 1u) {  // fed by the [x | h] concat
      term(q, T_X, in_p);
      term(q, cur, w_p);
    } else {
      term(q, cur, curK);
    }
    cur = nxt;
    curK = w_p;
    nxt = cur == T_B0 ? T_B1 : T_B0;
  }
  if (head == SPLIT) {
    // feature | alpha; the features to nxt, alpha to raw[:, 3]
    Prod& fa = prod(w_p + ALIGN, nxt, w_p, 0);
    term(fa, cur, w_p);
    to_raw(fa, w_p, 1, 3);
    // views: relu(feature @ Wvf + v @ Wvv + bv) into the free buffer
    Prod& hv = prod(h_p, cur, h_p, h_p);
    term(hv, nxt, w_p);
    term(hv, T_V, v_p);
    Prod& rgb = prod(ALIGN, T_NONE, 0, 0);
    term(rgb, cur, h_p);
    to_raw(rgb, 0, 3, 0);
  } else if (head == FOLDED) {
    // relu(h @ Wfv + v @ Wvv + bfv) | alpha
    Prod& t = prod(h_p + ALIGN, nxt, h_p, h_p);
    term(t, cur, w_p);
    term(t, T_V, v_p);
    to_raw(t, h_p, 1, 3);
    Prod& rgb = prod(ALIGN, T_NONE, 0, 0);
    term(rgb, nxt, h_p);
    to_raw(rgb, 0, 3, 0);
  } else {
    Prod& o = prod(ALIGN, T_NONE, 0, 0);
    term(o, cur, w_p);
    to_raw(o, 0, 4, 0);
  }
  return 1;
}

// ---------------------------------------------------------------- fp32 --

// One launch per product: (point tiles, column tiles) of 128 x 128.
__global__ void __launch_bounds__(FTHREADS, 2)
fp32_kernel(const FOp op, long long n) {
  sgemm_tile<true>(op, n);
}

// The products of one chunk of n points.  Without acts, ws holds two
// [n, w_p] buffers that the products ping-pong through; with acts [n, Ca]
// (acts_layout.cuh) the k-th kept product writes its own columns of acts.
int launch_f32(const Plan& pl, const float* x, const float* v,
               long long v_div, const float* w, const float* b, float* raw,
               float* ws, float* acts, long long Ca, long long n, int in_p,
               int w_p, int v_p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e != cudaSuccess) return (int)e;
  // where tiles T_B0 and T_B1 hold their last product, and its row stride
  float* bufs[2] = {ws, ws ? ws + n * w_p : nullptr};
  long long lds[2] = {w_p, w_p};
  int kept = 0;
  for (int i = 0; i < pl.n; ++i) {
    const Prod& q = pl.p[i];
    FOp o{};
    o.nterms = q.nterms;
    for (int t = 0; t < q.nterms; ++t) {
      FTerm& ft = o.t[t];
      const int s = q.src[t];
      ft.a = s == T_X ? x : s == T_V ? v : bufs[s - T_B0];
      ft.lda = s == T_X ? in_p : s == T_V ? v_p : lds[s - T_B0];
      ft.a_div = s == T_V ? v_div : 1;
      ft.K = q.K[t];
      ft.b = w + q.woff[t];
      ft.ldb = q.N;
    }
    if (acts && q.dst != T_NONE) {
      bufs[q.dst - T_B0] = acts + acts_col(kept++, w_p);
      lds[q.dst - T_B0] = Ca;
    }
    o.N = q.N;
    o.bias = b + q.boff;
    o.relu_cols = q.relu_cols;
    o.out = q.dst == T_NONE ? nullptr : bufs[q.dst - T_B0];
    o.out_ld = q.dst == T_NONE ? w_p : lds[q.dst - T_B0];
    o.out_cols = q.out_cols;
    o.raw = raw;
    o.raw_col0 = q.raw_col0;
    o.raw_ncol = q.raw_ncol;
    o.raw_dst = q.raw_dst;
    const dim3 grid((unsigned)((n + FBM - 1) / FBM),
                    (unsigned)((q.N + FBN - 1) / FBN));
    fp32_kernel<<<grid, FTHREADS, F_SMEM, stream>>>(o, n);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return (int)le;
  }
  return 0;
}

// ---------------------------------------------------------------- bf16 --

constexpr int HBM = 128;                 // points per CTA
constexpr int HCONS = 256;               // two consumer warpgroups
constexpr int HTHREADS = HCONS + 32;     // and one producer warp
constexpr int KC = 32;                   // k rows per slab: 64-byte rows
constexpr int MAX_PASS = 256;            // widest wgmma N
constexpr int NSTAGE = 8;
constexpr int STAGE_BYTES = MAX_PASS * KC * 2;  // 16 KB
constexpr int CHUNK_BYTES = HBM * KC * 2;  // 32 columns of a 128-row tile
constexpr int CONSUMER_WARPS = HCONS / 32;

// Runs f(c0, width, kept) over the column passes of product q in the
// bf16 kernel's order: the columns that go to raw only ([out_cols, N): the
// alpha column's block, the rgb or output block) 32 at a time first, then
// the kept columns [0, out_cols) as one pass, the last to read the
// product's inputs, so that its epilogue may overwrite them.
template <typename F>
__device__ __forceinline__ void for_each_pass(const Prod& q, F&& f) {
  for (int c0 = q.out_cols; c0 < q.N; c0 += ALIGN) f(c0, ALIGN, false);
  if (q.out_cols > 0) f(0, q.out_cols, true);
}

// Shared-memory addresses of the CTA's tiles and barriers.
// T_B0 and T_B1 (the fp32 path's two buffers) are one tile here.
struct Smem {
  uint32_t x, v, act, ring, full, empty;
  __device__ __forceinline__ uint32_t tile(int t) const {
    return t == T_X ? x : t == T_V ? v : act;
  }
};

// One pass of NP output columns [c0, c0 + NP) of product q for warpgroup
// wg (rows 64 wg .. + 64): the accumulators start at the bias, then every
// k-slab of every term from the ring (slab: the ring's running slab
// count, as the producer counts it), then the epilogue.  Each slab is
// released once this warp's wgmma reads of it are done (wait_group 1
// after the next slab's commit).  KEPT: the pass of the columns kept on
// chip (c0 = 0, relu on all of them or none), written in place as bf16;
// otherwise a pass of columns bound for raw only.
template <int NP, bool KEPT>
__device__ __forceinline__ void wg_pass(
    const Prod& q, int c0, const Smem& sm, int& slab, int wg,
    const float* __restrict__ bias, float* __restrict__ raw,
    long long row0, long long n) {
  const int lane = threadIdx.x & 31;
  // accumulator fragment: warp w of the warpgroup holds rows 16 w + lane / 4
  // (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
  float acc[NP / 2];
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(
        bias + c0 + 8 * j + 2 * (lane & 3)));
    acc[4 * j] = acc[4 * j + 2] = b.x;
    acc[4 * j + 1] = acc[4 * j + 3] = b.y;
  }
  const int first = slab;
#pragma unroll 1
  for (int t = 0; t < q.nterms; ++t) {
    const uint32_t a0 = sm.tile(q.src[t]) + wg * 64 * 64;
    const int nk = q.K[t] / KC;
#pragma unroll 1
    for (int kc = 0; kc < nk; ++kc, ++slab) {
      const int st = slab % NSTAGE;
      mbar_wait(sm.full + 8 * st, (slab / NSTAGE) & 1);
      const uint64_t da = sw64_desc(a0 + kc * CHUNK_BYTES);
      const uint64_t db = sw64_desc(sm.ring + st * STAGE_BYTES);
      wgmma_fence();
      wgmma_k16<NP>(acc, da, db);
      wgmma_k16<NP>(acc, da + 2, db + 2);  // +32 bytes: k 16 .. 31
      wgmma_commit();
      if (slab > first) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(sm.empty + 8 * ((slab - 1) % NSTAGE));
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) reg_fence(acc[i]);
  if (lane == 0) mbar_arrive(sm.empty + 8 * ((slab - 1) % NSTAGE));

  const int r_lo = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  if (!KEPT) {  // at most 8 columns from c0 on (raw_col0 = c0): j = 0
    const int rc = c0 + 2 * (lane & 3) - q.raw_col0;
    float* const out = raw + q.raw_dst + rc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = row0 + r_lo + 8 * h;
      if (p >= n) continue;
      if (rc < q.raw_ncol) out[p * 4] = acc[2 * h];
      if (rc + 1 < q.raw_ncol) out[p * 4 + 1] = acc[2 * h + 1];
    }
    return;
  }
  // in place: every warp of the warpgroup must be past its reads
  wg_sync(wg);
  // (r, 8 j + 2 (lane % 4)) in the 64-byte swizzle: 16-byte group j & 3
  // of chunk j / 4, stored at group (j & 3) ^ ((r >> 1) & 3)
  const uint32_t dst = sm.tile(q.dst) + (lane & 3) * 4;
  const bool relu = q.relu_cols > 0;  // all kept columns or none
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      __nv_bfloat162 v =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      // relu after rounding is rounding after relu; NaN passes, as
      // jnp.maximum(x, 0) lets it
      if (relu) v = __hmax2_nan(v, zero);
      st_shared_u32(dst + (j >> 2) * CHUNK_BYTES + r * 64 +
                        (((j & 3) ^ ((r >> 1) & 3)) << 4),
                    *reinterpret_cast<const uint32_t*>(&v));
    }
}

__global__ void __launch_bounds__(HTHREADS, 1)
bf16_kernel(const __grid_constant__ Plan plan, const bf16* __restrict__ x,
            const bf16* __restrict__ v, long long v_div,
            const unsigned char* __restrict__ wstream,
            const float* __restrict__ bbuf, float* __restrict__ raw,
            long long n, int in_p, int w_p, int v_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;  // swizzle atoms
  unsigned char* gbase = smem_raw + (base - raw_base);
  Smem sm;
  sm.act = base;  // one activation tile, overwritten in place
  sm.x = sm.act + HBM * w_p * 2;
  sm.v = sm.x + HBM * in_p * 2;
  sm.ring = sm.v + HBM * v_p * 2;
  sm.full = sm.ring + NSTAGE * STAGE_BYTES;
  sm.empty = sm.full + 8 * NSTAGE;
  const long long row0 = (long long)blockIdx.x * HBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer: the weight stream, in order
    if (lane != 0) return;
    int slab = 0;
    long long off = 0;
    for (int i = 0; i < plan.n; ++i) {
      const Prod& q = plan.p[i];
      for_each_pass(q, [&](int, int np, bool) {
        const uint32_t bytes = (uint32_t)np * KC * 2;
        for (int t = 0; t < q.nterms; ++t)
          for (int kc = 0; kc < q.K[t] / KC; ++kc, ++slab) {
            const int st = slab % NSTAGE;
            mbar_wait(sm.empty + 8 * st, ((slab / NSTAGE) & 1) ^ 1);
            mbar_expect_tx(sm.full + 8 * st, bytes);
            bulk_copy(sm.ring + st * STAGE_BYTES, wstream + off, bytes,
                      sm.full + 8 * st);
            off += bytes;
          }
      });
    }
    // stay until the consumers have released the last stages
    for (int k = 0; k < NSTAGE && slab > 0; ++k, ++slab)
      mbar_wait(sm.empty + 8 * (slab % NSTAGE), ((slab / NSTAGE) & 1) ^ 1);
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 64 of every tile
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  auto stage_rows = [&](uint32_t tile, const bf16* src, int cols,
                        long long div) {
    const int ch = cols / 8;
    for (int e = tid; e < 64 * ch; e += 128) {
      const int r = wg * 64 + e / ch;
      const int c = (e % ch) * 8;
      const long long p = row0 + r;
      const bool ok = p < n;
      const long long sr = ok ? (div == 1 ? p : p / div) : 0;
      cp_async16(gbase + (tile - base) + sw64<HBM>(r, c), src + sr * cols + c,
                 ok);
    }
  };
  stage_rows(sm.x, x, in_p, 1);
  if (v_p > 0) stage_rows(sm.v, v, v_p, v_div);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  wg_sync(wg);

  int slab = 0;
#pragma unroll 1
  for (int i = 0; i < plan.n; ++i) {
    const Prod& q = plan.p[i];
    const float* bias = bbuf + q.boff;
    for_each_pass(q, [&](int c0, int np, bool kept) {
      if (!kept) {
        wg_pass<ALIGN, false>(q, c0, sm, slab, wg, bias, raw, row0, n);
        return;
      }
      switch (np) {
#define PLNERF_PASS(NP)                                           \
  case NP:                                                        \
    wg_pass<NP, true>(q, c0, sm, slab, wg, bias, raw, row0, n); \
    break;
        PLNERF_PASS(256) PLNERF_PASS(224) PLNERF_PASS(192) PLNERF_PASS(160)
        PLNERF_PASS(128) PLNERF_PASS(96) PLNERF_PASS(64) PLNERF_PASS(32)
#undef PLNERF_PASS
      }
    });
    if (q.dst != T_NONE) {  // the next product reads it through wgmma
      fence_proxy_async();
      wg_sync(wg);
    }
  }
}

long long smem_bf16(int in_p, int w_p, int v_p) {
  return 1024LL + 2LL * HBM * (w_p + in_p + v_p) +
         (long long)NSTAGE * STAGE_BYTES + 16LL * NSTAGE;
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper checks it against
// the device's opt-in limit before launching).  v_p = 0: no views.
long long plnerf_fused_mlp_fwd_smem(int in_p, int w_p, int v_p,
                                    int use_bf16) {
  return use_bf16 ? smem_bf16(in_p, w_p, v_p) : (long long)F_SMEM;
}

// Workspace bytes for one call of n points without acts: fp32, two
// activation buffers [n, w_p]; bf16, none.
long long plnerf_fused_mlp_fwd_workspace(long long n, int w_p,
                                         int use_bf16) {
  return use_bf16 ? 0 : 2LL * n * w_p * 4;
}

// Launches on `stream` and returns cudaGetLastError() of the first launch
// that fails (0 on success).  v_p = 0 and v = null for the plain head.
// acts (fp32 viewdirs only; null: none): [n, Ca] fp32 in the layout of
// acts_layout.cuh, which keeps every activation for the backward to read;
// ws is then not read.
int plnerf_fused_mlp_fwd(const void* x, const void* v, long long v_div,
                         const void* w, const void* b, void* raw, void* ws,
                         void* acts, long long n, int n_layers,
                         unsigned skip_mask, int in_p, int w_p, int v_p,
                         int h_p, int head, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  Plan pl;
  if (in_p % ALIGN || w_p % ALIGN || v_p % ALIGN || h_p % ALIGN ||
      (use_bf16 && (w_p > MAX_PASS || acts)) || (acts && head == PLAIN) ||
      v_div < 1 ||
      (head != PLAIN && v_p == 0) ||
      !build_plan(&pl, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_bf16) {
    if ((n + FBM - 1) / FBM > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    return launch_f32(pl, static_cast<const float*>(x),
                      static_cast<const float*>(v), v_div,
                      static_cast<const float*>(w),
                      static_cast<const float*>(b), static_cast<float*>(raw),
                      static_cast<float*>(ws), static_cast<float*>(acts),
                      acts ? acts_width(n_layers, head == SPLIT, w_p, h_p) : 0,
                      n, in_p, w_p, v_p, s);
  }
  const long long grid = (n + HBM - 1) / HBM;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bf16(in_p, w_p, v_p);
  cudaError_t e = cudaFuncSetAttribute(
      bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bf16_kernel<<<(unsigned)grid, HTHREADS, smem, s>>>(
      pl, static_cast<const bf16*>(x), static_cast<const bf16*>(v), v_div,
      static_cast<const unsigned char*>(w), static_cast<const float*>(b),
      static_cast<float*>(raw), n, in_p, w_p, v_p);
  return (int)cudaGetLastError();
}

const char* plnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
