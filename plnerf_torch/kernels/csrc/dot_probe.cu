// Dot-walk probes for Hopper (sm_90a): the fused forward kernel's products
// alone, with nothing else in the way.
//
// Four entry points, one for each TPU probe kernel they replace:
//   shape_kernel   tools/dot_decompose.py `make_shape_kernel` (run_shape):
//                  out[N, n] = sum_{i < reps} x @ W_i, x [N, K], W_i [K, n]
//   mixed_kernel   tools/dot_decompose.py `make_mixed_kernel` (run_mixed):
//                  the forward's 13-dot walk, no bias or relu, bf16 between
//                  dots, skip and views layers as two split blocks each
//   merged_kernel  tools/dot_decompose.py `make_merged_kernel` (run_merged):
//                  the 11-dot walk, skip and views each one dot on a
//                  [T, 384] operand, either a scratch buffer that the
//                  previous layer writes in place (x in its last 128
//                  columns, staged once) or a fresh concatenation per use
//                  (h and x copied into it before each of the two dots)
//   mosaic_kernel  tools/mosaic_probe.py `make_kernel` (run): 13 [T, 256] @
//                  [256, 256] dots, chained, independent (summed) or
//                  MLP-like (chained, +0.01 and relu after each)
// All take bf16 x and weights ([K, n] row-major for mixed and merged; for
// shape and mosaic the same weights packed by the wrapper as one stream of
// slab images, below) and write fp32 out; mixed and merged write rgb to
// out[:, :128] and the alpha block to out[:, 128:].
//
// Bound: operations.  At N = 2,629,632 rows the walks do 3.62 TFLOP (mixed
// and merged) and 4.48 TFLOP (mosaic, shape (256, 256) x 13) against
// 0.7 to 3.4 GB of x and out: 1,000 to 5,000 FLOP per byte, far above the
// card's ridge (about 295 FLOP per byte in bf16).  At the H100 SXM's 989
// TFLOP/s dense bf16 peak the 4.48 TFLOP take 4.53 ms.
//
// shape and mosaic (wgmma, sharing wgmma_core.cuh with the bf16 fused
// forward).  One CTA owns a row tile of BM = 64, 128 or 256 rows (mosaic
// chained and mlp: 64 or 128): one consumer warpgroup per 64 rows and one
// producer warp.  The row tile stays in shared memory as bf16, K-major in
// the 64-byte swizzle (32-column chunks of BM rows of 64 bytes), staged
// once by cp.async.  The 1.7 MB of weights fit in no SM, so every CTA
// streams them from L2: the wrapper packs them into the shared-memory
// images wgmma reads as B (dot_probe.probe_stream: W^T rows of 64 bytes in
// the same swizzle, one 32-row k-slab per image, in the order the kernel
// consumes them), and the producer copies them front to back with 1-D
// cp.async.bulk into a ring of 4 to 12 stages (as many as fit beside the
// tile) guarded by mbarriers; the consumers release a slab after
// wgmma_wait<1>, so no CTA-wide barrier stops the mainloop.  Each weight
// byte crosses from L2 once per CTA: BM FLOP per L2 byte, so the 256-row
// tile halves the stream of the 128-row one.
//   shape: every slab of all reps x K / 32 goes into one set of fp32
//   accumulators per column pass of NP columns (NP = 256, or 128 at BM =
//   256 where four warpgroups hold 64 accumulators a thread; n = 384 runs
//   as 256 + 128 at BM <= 128); no epilogue until the pass is done, then
//   one fp32 store to out.  mosaic independent is shape at (256, 256) x 13.
//   mosaic chained and mlp: the fused forward's layer loop at K = N = 256,
//   one 256-column pass per warpgroup and dot, the activation tile
//   overwritten in place (its own 64 rows, after a warpgroup barrier); the
//   epilogue is the forward's short one: accumulators started at 0 or at
//   0.01 (mlp), one bf16x2 convert per column pair, for mlp a NaN-passing
//   bf16x2 max, one 4-byte shared store; the last dot stores fp32.
//
// mixed and merged (mma.sync).  One CTA of 256 threads (8 warps) owns a
// row tile of BM = 64 or 128 rows, the counterpart of the TPU's T.  Its
// activations stay in shared memory as bf16 for the whole walk ([BM][K +
// 8] rows: ldmatrix reads them without bank conflicts); each dot's output
// leaves the accumulators either rounded to bf16 into another shared
// buffer or as fp32 straight to device memory.  The weights stream from
// L2 through a double-buffered shared-memory ring of 32-row k-slabs
// (cp.async, 16 bytes a thread), shared by all its warps.  Products run
// on mma.sync m16n8k16 (bf16 operands, fp32 accumulators); each warp owns
// 64 rows and NT 8-column blocks of a column pass, with NT chosen so that
// all 8 warps work on every width (at BM = 128 a 384-wide dot runs as two
// passes of 192 columns, holding 96 accumulators a thread).  Shared memory
// (bytes, ring included): mixed BM 1328; merged scratch BM 1312; merged
// concat BM 2112; plus a ring of 50,176 (BM = 64) or 33,792 (BM = 128).
// Merged with concat needs 304 KB at BM = 128, over the 227 KB a CTA may
// use, so it takes BM = 64 only.
//
// Rows must be a multiple of BM (the wrapper raises otherwise: the TPU
// grid N // T leaves a ragged tail unwritten).  Two calls on the same
// inputs give bit-identical results (no atomics, a fixed order of every
// sum).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int KS = 32;        // k rows of one weight slab
constexpr int PAD = 8;        // bf16 values of padding per shared row
constexpr int MAX_W = 13;     // weights of the longest walk
constexpr int W = 256;        // hidden width of every walk
constexpr int XK = 128;       // x width of mixed and merged
constexpr int CAT = 384;      // [h | x] operand width of merged

enum Variant { CHAINED = 0, INDEPENDENT = 1, MLP = 2 };

struct Weights {
  const bf16* w[MAX_W];
};

// A ring stage holds KS rows of the widest column pass of the tile.
__host__ __device__ constexpr int ring_cols(int bm) {
  return bm == 64 ? 384 : 256;
}
__host__ __device__ constexpr int stage_elems(int bm) {
  return KS * (ring_cols(bm) + PAD);
}

// One summand A @ W of a dot: A [BM, k] in shared memory (row stride lda),
// W [k, n] row-major in device memory.
struct Term {
  const bf16* a;
  int lda;
  int k;
  const bf16* w;
};

// Where a dot's output goes: columns < smem_cols to `smem` as bf16,
// the rest to gout[(row0 + row) * gld + col + gshift] as fp32.  With
// `relu`, every value is max(v + add, 0) first (NaN passes, as
// jnp.maximum(x, 0) lets it).
struct Epilogue {
  bf16* smem;
  int ldd;
  int smem_cols;
  float* gout;
  long long row0;
  int gld;
  int gshift;
  float add;
  int relu;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W[k0 : k0 + KS, c0 : c0 + np] (row stride n) -> stage [KS][np + PAD]
__device__ __forceinline__ void load_slab(bf16* stage,
                                          const bf16* __restrict__ w, int n,
                                          int k0, int c0, int np) {
  const int chunks = np / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < KS * chunks; e += THREADS) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    cp_async16(stage + r * (np + PAD) + c, w + (size_t)(k0 + r) * n + c0 + c);
  }
}

// out[BM, n] = sum_t A_t @ W_t, handed to the epilogue.  Warps split the
// tile into (BM / 64) x WC warp tiles of 64 rows x 8 NT columns; the
// columns go in passes of NP, each pass streaming W_t[:, pass] slab by
// slab through the two ring stages (the load of slab s + 1 overlaps the
// products of slab s).  Ends with every warp past its last ring read.
template <int BM, int NT>
__device__ void product_nt(const Term* terms, int nterms, int n, bf16* ring,
                           const Epilogue& ep) {
  constexpr int WC = (THREADS / 32) / (BM / 64);  // warps along columns
  constexpr int NP = NT * 8 * WC;                 // columns per pass
  constexpr int LDW = NP + PAD;
  constexpr int STAGE = stage_elems(BM);
  static_assert(NP <= ring_cols(BM), "column pass wider than the ring");
  static_assert(NT % 2 == 0, "B fragments load in pairs of n blocks");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp / WC, wc = warp - wr * WC;
  const int g = lane >> 2, t = lane & 3;
  int slabs = 0;
  for (int i = 0; i < nterms; ++i) slabs += terms[i].k / KS;

#pragma unroll 1
  for (int c0 = 0; c0 < n; c0 += NP) {
    float acc[4][NT][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

    int lt = 0, lk = 0;  // next slab to load: term, k row
    int ct = 0, ck = 0;  // slab to multiply: term, k row
    load_slab(ring, terms[0].w, n, 0, c0, NP);
    cp_async_commit();
    lk = KS;
    if (lk == terms[0].k) { lt = 1; lk = 0; }

#pragma unroll 1
    for (int s = 0; s < slabs; ++s) {
      if (s + 1 < slabs) {
        load_slab(ring + ((s + 1) & 1) * STAGE, terms[lt].w, n, lk, c0, NP);
        cp_async_commit();
        lk += KS;
        if (lk == terms[lt].k) { ++lt; lk = 0; }
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* stage = ring + (s & 1) * STAGE;
      const bf16* a = terms[ct].a;
      const int lda = terms[ct].lda;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        uint32_t af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], a + (wr * 64 + mi * 16 + (lane & 15)) * lda +
                                  ck + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < NT; nj += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, stage + (kk + (lane & 15)) * LDW +
                                    wc * NT * 8 + nj * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][nj], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][nj + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
      ck += KS;
      if (ck == terms[ct].k) { ++ct; ck = 0; }
      __syncthreads();  // the stage is refilled two slabs on
    }

#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int c = c0 + wc * NT * 8 + nj * 8 + 2 * t;  // columns c, c + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wr * 64 + mi * 16 + g + 8 * h;
          float v0 = acc[mi][nj][2 * h];
          float v1 = acc[mi][nj][2 * h + 1];
          if (ep.relu) {
            v0 += ep.add;
            v1 += ep.add;
            v0 = v0 < 0.f ? 0.f : v0;
            v1 = v1 < 0.f ? 0.f : v1;
          }
          // smem_cols is a multiple of 8: c and c + 1 go the same way
          if (c < ep.smem_cols)
            *reinterpret_cast<uint32_t*>(ep.smem + row * ep.ldd + c) =
                pack_bf16x2(v0, v1);
          else
            *reinterpret_cast<float2*>(
                ep.gout + (ep.row0 + row) * ep.gld + c + ep.gshift) =
                make_float2(v0, v1);
        }
      }
  }
}

// NT by tile and output width: every warp busy, at most 128 accumulators
// a thread.
template <int BM>
__device__ void product(const Term* terms, int nterms, int n, bf16* ring,
                        const Epilogue& ep) {
  if constexpr (BM == 64) {
    if (n == 128) product_nt<64, 2>(terms, nterms, n, ring, ep);
    else if (n == 256) product_nt<64, 4>(terms, nterms, n, ring, ep);
    else product_nt<64, 6>(terms, nterms, n, ring, ep);
  } else {
    if (n == 128) product_nt<128, 4>(terms, nterms, n, ring, ep);
    else if (n == 256) product_nt<128, 8>(terms, nterms, n, ring, ep);
    else product_nt<128, 6>(terms, nterms, n, ring, ep);
  }
}

// x[row0 : row0 + BM, :k] -> dst [BM][ld], waited for and visible to all
template <int BM>
__device__ void stage_rows(bf16* dst, int ld, const bf16* __restrict__ x,
                           int k, long long row0) {
  const int chunks = k / 8;
  for (int e = threadIdx.x; e < BM * chunks; e += THREADS) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    cp_async16(dst + r * ld + c, x + (row0 + r) * k + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ Term term(const bf16* a, int lda, int k,
                                     const bf16* w) {
  return Term{a, lda, k, w};
}

__device__ __forceinline__ Epilogue to_smem(bf16* dst, int ldd, int cols) {
  return Epilogue{dst, ldd, cols, nullptr, 0, 0, 0, 0.f, 0};
}

__device__ __forceinline__ Epilogue to_global(float* out, long long row0,
                                              int gld, int gshift) {
  return Epilogue{nullptr, 0, 0, out, row0, gld, gshift, 0.f, 0};
}

// ------------------------------------------------------------- kernels --

template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
mixed_kernel(const bf16* __restrict__ x, Weights ws,
             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LX = XK + PAD, LH = W + PAD;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* xs = ring + 2 * stage_elems(BM);
  bf16* h0 = xs + BM * LX;
  bf16* h1 = h0 + BM * LH;
  const long long row0 = (long long)blockIdx.x * BM;
  const bf16* const* w = ws.w;
  stage_rows<BM>(xs, LX, x, XK, row0);

  Term tm[2];
  tm[0] = term(xs, LX, XK, w[0]);  // L0
  product<BM>(tm, 1, W, ring, to_smem(h0, LH, W));
  bf16* src = h0;
  bf16* dst = h1;
  for (int i = 1; i < 5; ++i) {  // L1-L4
    tm[0] = term(src, LH, W, w[i]);
    product<BM>(tm, 1, W, ring, to_smem(dst, LH, W));
    bf16* tmp = src; src = dst; dst = tmp;
  }
  // src = h0 holds L4; skip: x @ W5 + h @ W6
  tm[0] = term(xs, LX, XK, w[5]);
  tm[1] = term(h0, LH, W, w[6]);
  product<BM>(tm, 2, W, ring, to_smem(h1, LH, W));
  tm[0] = term(h1, LH, W, w[7]);  // L6
  product<BM>(tm, 1, W, ring, to_smem(h0, LH, W));
  tm[0] = term(h0, LH, W, w[8]);  // L7
  product<BM>(tm, 1, W, ring, to_smem(h1, LH, W));
  // feature | alpha head: feature to h0 (bf16), alpha block to out[:, 128:]
  Epilogue head = to_global(out, row0, W, -128);
  head.smem = h0;
  head.ldd = LH;
  head.smem_cols = W;
  tm[0] = term(h1, LH, W, w[9]);
  product<BM>(tm, 1, CAT, ring, head);
  // views: feature @ W10 + x @ W11
  tm[0] = term(h0, LH, W, w[10]);
  tm[1] = term(xs, LX, XK, w[11]);
  product<BM>(tm, 2, 128, ring, to_smem(h1, LH, 128));
  tm[0] = term(h1, LH, 128, w[12]);  // rgb to out[:, :128]
  product<BM>(tm, 1, 128, ring, to_global(out, row0, W, 0));
}

// cat[:, :256] = h, cat[:, 256:] = x: a fresh [BM, 384] operand
template <int BM>
__device__ void concat(bf16* cat, const bf16* h, const bf16* xs) {
  constexpr int LC = CAT + PAD, LH = W + PAD, LX = XK + PAD;
  constexpr int chunks = CAT / 8;
  __syncthreads();  // h was written by other warps' epilogues
  for (int e = threadIdx.x; e < BM * chunks; e += THREADS) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    const bf16* src = c < W ? h + r * LH + c : xs + r * LX + (c - W);
    *reinterpret_cast<uint4*>(cat + r * LC + c) =
        *reinterpret_cast<const uint4*>(src);
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
merged_kernel(const bf16* __restrict__ x, Weights ws, int use_concat,
              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LC = CAT + PAD, LH = W + PAD, LX = XK + PAD;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const long long row0 = (long long)blockIdx.x * BM;
  const bf16* const* w = ws.w;
  Term tm[1];
  Epilogue head = to_global(out, row0, W, -128);

  if (!use_concat) {
    // buf [BM][392]: h in columns 0..255, written in place by the layer
    // before each use; x in 256..383, staged once.  h0 [BM][264].
    bf16* buf = ring + 2 * stage_elems(BM);
    bf16* h0 = buf + BM * LC;
    stage_rows<BM>(buf + W, LC, x, XK, row0);
    tm[0] = term(buf + W, LC, XK, w[0]);  // L0
    product<BM>(tm, 1, W, ring, to_smem(buf, LC, W));
    tm[0] = term(buf, LC, W, w[1]);  // L1
    product<BM>(tm, 1, W, ring, to_smem(h0, LH, W));
    tm[0] = term(h0, LH, W, w[2]);  // L2
    product<BM>(tm, 1, W, ring, to_smem(buf, LC, W));
    tm[0] = term(buf, LC, W, w[3]);  // L3
    product<BM>(tm, 1, W, ring, to_smem(h0, LH, W));
    tm[0] = term(h0, LH, W, w[4]);  // L4 into the scratch buffer
    product<BM>(tm, 1, W, ring, to_smem(buf, LC, W));
    tm[0] = term(buf, LC, CAT, w[5]);  // skip, one [BM, 384] dot
    product<BM>(tm, 1, W, ring, to_smem(h0, LH, W));
    tm[0] = term(h0, LH, W, w[6]);  // L6
    product<BM>(tm, 1, W, ring, to_smem(buf, LC, W));
    tm[0] = term(buf, LC, W, w[7]);  // L7
    product<BM>(tm, 1, W, ring, to_smem(h0, LH, W));
    head.smem = buf;  // feature into the scratch buffer, x kept
    head.ldd = LC;
    head.smem_cols = W;
    tm[0] = term(h0, LH, W, w[8]);
    product<BM>(tm, 1, CAT, ring, head);
    tm[0] = term(buf, LC, CAT, w[9]);  // views, one [BM, 384] dot
    product<BM>(tm, 1, 128, ring, to_smem(h0, LH, 128));
    tm[0] = term(h0, LH, 128, w[10]);  // rgb
    product<BM>(tm, 1, 128, ring, to_global(out, row0, W, 0));
    return;
  }

  // xs [BM][136], ha and hb [BM][264], cat [BM][392]
  bf16* xs = ring + 2 * stage_elems(BM);
  bf16* ha = xs + BM * LX;
  bf16* hb = ha + BM * LH;
  bf16* cat = hb + BM * LH;
  stage_rows<BM>(xs, LX, x, XK, row0);
  tm[0] = term(xs, LX, XK, w[0]);  // L0
  product<BM>(tm, 1, W, ring, to_smem(ha, LH, W));
  bf16* src = ha;
  bf16* dst = hb;
  for (int i = 1; i < 5; ++i) {  // L1-L4
    tm[0] = term(src, LH, W, w[i]);
    product<BM>(tm, 1, W, ring, to_smem(dst, LH, W));
    bf16* tmp = src; src = dst; dst = tmp;
  }
  concat<BM>(cat, ha, xs);  // ha holds L4
  tm[0] = term(cat, LC, CAT, w[5]);
  product<BM>(tm, 1, W, ring, to_smem(hb, LH, W));
  tm[0] = term(hb, LH, W, w[6]);  // L6
  product<BM>(tm, 1, W, ring, to_smem(ha, LH, W));
  tm[0] = term(ha, LH, W, w[7]);  // L7
  product<BM>(tm, 1, W, ring, to_smem(hb, LH, W));
  head.smem = ha;
  head.ldd = LH;
  head.smem_cols = W;
  tm[0] = term(hb, LH, W, w[8]);
  product<BM>(tm, 1, CAT, ring, head);
  concat<BM>(cat, ha, xs);  // [feature | x]
  tm[0] = term(cat, LC, CAT, w[9]);
  product<BM>(tm, 1, 128, ring, to_smem(hb, LH, 128));
  tm[0] = term(hb, LH, 128, w[10]);
  product<BM>(tm, 1, 128, ring, to_global(out, row0, W, 0));
}

// ----------------------------------------- wgmma: shape and mosaic --

constexpr int SLAB_K = 32;        // k rows of one weight slab: 64-byte rows
constexpr int MAX_STAGES = 12;    // ring depth, at most
constexpr int SMEM_LIMIT = 232448;  // shared memory a CTA may use
constexpr int SMEM_ALIGN = 1024;    // slack to align the tiles' swizzle atoms

// Tile geometry by row tile: one consumer warpgroup per 64 rows, one
// producer warp; the widest column pass (wgmma N) keeps the accumulators
// at NPMAX / 2 registers a thread (the 256-row tile has four consumer
// warpgroups, so 64 a thread).
template <int BM>
struct Geo {
  static constexpr int NWG = BM / 64;
  static constexpr int CONS = NWG * 128;
  static constexpr int THREADS = CONS + 32;
  static constexpr int NPMAX = BM == 256 ? 128 : 256;
  static constexpr int STAGE = NPMAX * SLAB_K * 2;  // bytes of one slab
  static constexpr int CHUNK = BM * SLAB_K * 2;     // 32 columns of a tile
};

// Shared-memory addresses: the tile (x, or mosaic's activations), the
// ring, its full and empty barriers.
struct WSmem {
  uint32_t tile, ring, full, empty;
  unsigned char* gtile;  // the tile as a generic pointer (cp.async)
};

// Lays out and initialises the CTA's shared memory: a 1024-aligned tile
// of tile_bytes, nstage ring stages, 2 x nstage barriers.
template <int BM>
__device__ __forceinline__ WSmem wg_smem(unsigned char* smem_raw,
                                         int tile_bytes, int nstage) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  WSmem sm;
  sm.tile = base;
  sm.gtile = smem_raw + (base - raw);
  sm.ring = base + tile_bytes;
  sm.full = sm.ring + nstage * Geo<BM>::STAGE;
  sm.empty = sm.full + 8 * nstage;
  if (threadIdx.x == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, Geo<BM>::CONS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return sm;
}

// A position in the ring: stage and the parity of its current use.
struct Ring {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int nstage) {
    if (++st == nstage) { st = 0; ph ^= 1; }
  }
};

// The producer (one thread): `slabs` slab images of `bytes` each, front
// to back from the packed stream, each into the next ring stage once its
// consumers have released it; then waits for them to release the last
// stages, so that no copy is in flight when it exits.
__device__ __forceinline__ void produce(const WSmem& sm, int nstage,
                                       int stage_bytes,
                                       const unsigned char* __restrict__ w,
                                       int slabs, uint32_t bytes, Ring& r,
                                       long long& off) {
  for (int s = 0; s < slabs; ++s, r.next(nstage)) {
    mbar_wait(sm.empty + 8 * r.st, r.ph ^ 1);
    mbar_expect_tx(sm.full + 8 * r.st, bytes);
    bulk_copy(sm.ring + r.st * stage_bytes, w + off, bytes,
              sm.full + 8 * r.st);
    off += bytes;
  }
}

__device__ __forceinline__ void drain(const WSmem& sm, int nstage, Ring r) {
  for (int k = 0; k < nstage; ++k, r.next(nstage))
    mbar_wait(sm.empty + 8 * r.st, r.ph ^ 1);
}

// x[row0 + 64 wg .. + 64, :k] -> warpgroup wg's rows of the tile, in the
// 64-byte swizzle; waited for and visible to wgmma.
template <int BM>
__device__ __forceinline__ void stage_x(const WSmem& sm,
                                        const bf16* __restrict__ x, int k,
                                        long long row0, int wg) {
  const int ch = k / 8;
  for (int e = threadIdx.x & 127; e < 64 * ch; e += 128) {
    const int r = wg * 64 + e / ch;
    const int c = (e % ch) * 8;
    cp_async16(sm.gtile + sw64<BM>(r, c), x + (row0 + r) * k + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  wg_sync(wg);
}

// acc[64 x NP] += the warpgroup's 64 rows of the tile (k columns) @ `reps`
// weights, one slab of 32 k rows at a time from the ring: every slab's two
// k16 wgmmas go into the same accumulators (one fp32 sum over all reps x k
// rows).  A slab is released once this warp's wgmma reads of it are done
// (wait_group 1 after the next slab's commit).  Ends with the
// accumulators complete.
template <int BM, int NP>
__device__ __forceinline__ void mainloop(float* acc, const WSmem& sm,
                                         int nstage, int reps, int k, int wg,
                                         Ring& r) {
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = sm.tile + wg * 64 * 64;
  const int kch = k / SLAB_K;
  int prev = -1;
#pragma unroll 1
  for (int i = 0; i < reps; ++i) {
#pragma unroll 1
    for (int kc = 0; kc < kch; ++kc, r.next(nstage)) {
      mbar_wait(sm.full + 8 * r.st, r.ph);
      const uint64_t da = sw64_desc(a0 + kc * Geo<BM>::CHUNK);
      const uint64_t db = sw64_desc(sm.ring + r.st * Geo<BM>::STAGE);
      wgmma_fence();
      wgmma_k16<NP>(acc, da, db);
      wgmma_k16<NP>(acc, da + 2, db + 2);  // +32 bytes: k 16 .. 31
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(sm.empty + 8 * prev);
      }
      prev = r.st;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NP / 2; ++j) reg_fence(acc[j]);
  if (lane == 0) mbar_arrive(sm.empty + 8 * prev);
}

// row (within the tile) of accumulator registers 4 j + 2 h, 4 j + 2 h + 1
__device__ __forceinline__ int acc_row(int wg, int h) {
  return wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * h;
}

// acc [64 x NP] (columns c0 ..) -> out rows, fp32; relu: max(v, 0) with
// NaN passing, as jnp.maximum lets it
template <int NP>
__device__ __forceinline__ void store_out(const float* acc,
                                          float* __restrict__ out, int ld,
                                          long long row0, int c0, int wg,
                                          bool relu) {
  const int col = c0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = out + (row0 + acc_row(wg, h)) * ld + col;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (relu) {
        v0 = v0 < 0.f ? 0.f : v0;
        v1 = v1 < 0.f ? 0.f : v1;
      }
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(v0, v1);
    }
  }
}

template <int BM, int NP>
__device__ __forceinline__ void shape_pass(const WSmem& sm, int nstage,
                                           int reps, int k, int n, int c0,
                                           int wg, Ring& r,
                                           float* __restrict__ out,
                                           long long row0) {
  float acc[NP / 2];
#pragma unroll
  for (int j = 0; j < NP / 2; ++j) acc[j] = 0.f;
  mainloop<BM, NP>(acc, sm, nstage, reps, k, wg, r);
  store_out<NP>(acc, out, n, row0, c0, wg, false);
}

// tools/dot_decompose.py `make_shape_kernel`: out[BM rows, n] =
// sum_{i < reps} x @ W_i, fp32 sums.  The weights arrive as one
// stream of slab images (dot_probe.probe_stream): for each column pass
// [c0, c0 + np), np = min(NPMAX, n - c0), each W_i, each 32-row k-slab,
// the image of W_i[k0 : k0 + 32, c0 : c0 + np] (W^T rows of 64 bytes in
// the 64-byte swizzle).
template <int BM>
__global__ void __launch_bounds__(Geo<BM>::THREADS, 1)
shape_kernel(int nstage, const bf16* __restrict__ x,
             const unsigned char* __restrict__ wstream, int reps, int k,
             int n, float* __restrict__ out) {
  using G = Geo<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WSmem sm = wg_smem<BM>(smem_raw, BM * k * 2, nstage);
  const long long row0 = (long long)blockIdx.x * BM;
  const int wg = threadIdx.x >> 7;
  Ring r;

  if (wg == G::NWG) {  // producer warp
    if ((threadIdx.x & 31) != 0) return;
    long long off = 0;
    for (int c0 = 0; c0 < n; c0 += G::NPMAX) {
      const int np = min(G::NPMAX, n - c0);
      produce(sm, nstage, G::STAGE, wstream, reps * (k / SLAB_K),
              (uint32_t)np * SLAB_K * 2, r, off);
    }
    drain(sm, nstage, r);
    return;
  }
  stage_x<BM>(sm, x, k, row0, wg);
  for (int c0 = 0; c0 < n; c0 += G::NPMAX) {
    if constexpr (G::NPMAX == 256) {
      if (n - c0 >= 256) {
        shape_pass<BM, 256>(sm, nstage, reps, k, n, c0, wg, r, out, row0);
        continue;
      }
    }
    shape_pass<BM, 128>(sm, nstage, reps, k, n, c0, wg, r, out, row0);
  }
}

// tools/mosaic_probe.py `make_kernel`, chained and mlp (independent is
// shape_kernel): 13 dots [BM, 256] @ [256, 256], each
// warpgroup's 64 rows of the activation tile overwritten in place by the
// next dot's result (bf16), the last dot's result to out (fp32).  mlp:
// the accumulators start at 0.01 and every result passes max(v, 0).
// The weight stream is shape_kernel's at (256, 256) x 13.
template <int BM>
__global__ void __launch_bounds__(Geo<BM>::THREADS, 1)
mosaic_kernel(int nstage, const bf16* __restrict__ x,
              const unsigned char* __restrict__ wstream, int relu,
              float* __restrict__ out) {
  using G = Geo<BM>;
  static_assert(G::NPMAX == W, "one pass of the full width per dot");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WSmem sm = wg_smem<BM>(smem_raw, BM * W * 2, nstage);
  const long long row0 = (long long)blockIdx.x * BM;
  const int wg = threadIdx.x >> 7;
  Ring r;

  if (wg == G::NWG) {  // producer warp
    if ((threadIdx.x & 31) != 0) return;
    long long off = 0;
    produce(sm, nstage, G::STAGE, wstream, MAX_W * (W / SLAB_K),
            (uint32_t)W * SLAB_K * 2, r, off);
    drain(sm, nstage, r);
    return;
  }
  stage_x<BM>(sm, x, W, row0, wg);
  const float start = relu ? 0.01f : 0.f;  // mlp: the +0.01 as the start
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  // (r, 8 j + 2 (lane % 4)) in the 64-byte swizzle: 16-byte group j & 3
  // of chunk j / 4, stored at group (j & 3) ^ ((r >> 1) & 3)
  const uint32_t dst = sm.tile + (threadIdx.x & 3) * 4;
#pragma unroll 1
  for (int i = 0; i < MAX_W; ++i) {
    float acc[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) acc[j] = start;
    mainloop<BM, W>(acc, sm, nstage, 1, W, wg, r);
    if (i + 1 == MAX_W) {
      store_out<W>(acc, out, W, row0, 0, wg, relu);
      return;
    }
    wg_sync(wg);  // in place: every warp of the warpgroup past its reads
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = acc_row(wg, h);
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                 acc[4 * j + 2 * h + 1]);
        // relu after rounding is rounding after relu; NaN passes
        if (relu) v = __hmax2_nan(v, zero);
        st_shared_u32(dst + (j >> 2) * G::CHUNK + row * 64 +
                          (((j & 3) ^ ((row >> 1) & 3)) << 4),
                      *reinterpret_cast<const uint32_t*>(&v));
      }
    fence_proxy_async();  // the next dot reads the tile through wgmma
    wg_sync(wg);
  }
}

// ---------------------------------------------------------------- host --

constexpr size_t ring_bytes(int bm) { return 2 * stage_elems(bm) * 2; }

template <typename Kern, typename... Args>
int launch(Kern kern, long long rows, int tile, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)(rows / tile), threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool width_ok(int v) { return v == 128 || v == 256 || v == 384; }

// tiles 64 and 128, and 256 where max_tile is 256
bool rows_ok(long long rows, int tile, int max_tile = 128) {
  return (tile == 64 || tile == 128 || (tile == 256 && max_tile == 256)) &&
         rows > 0 && rows % tile == 0 && rows / tile <= 0x7fffffffLL;
}

// Ring depth of a wgmma kernel: as many stages as fit beside a tile of
// tile_bytes, at most MAX_STAGES; 0 if fewer than 4 fit.
template <int BM>
int ring_stages(long long tile_bytes) {
  const long long left = SMEM_LIMIT - SMEM_ALIGN - tile_bytes;
  const long long n = left / (Geo<BM>::STAGE + 16);
  return n < 4 ? 0 : (int)(n < MAX_STAGES ? n : MAX_STAGES);
}

// Launches a wgmma kernel of row tile BM: (nstage, args...) with a ring
// of as many stages as fit beside its tile of tile_bytes.
template <int BM, typename Kern, typename... Args>
int launch_wg(Kern kern, long long tile_bytes, long long rows,
              cudaStream_t stream, Args... args) {
  const int nstage = ring_stages<BM>(tile_bytes);
  if (nstage == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(SMEM_ALIGN + tile_bytes +
                               (long long)nstage * (Geo<BM>::STAGE + 16));
  return launch(kern, rows, BM, Geo<BM>::THREADS, smem, stream, nstage,
                args...);
}

int shape(const void* x, const void* w, int reps, int k, int n, void* out,
          long long rows, int tile, void* stream) {
  if (!rows_ok(rows, tile, 256) || reps < 1 || reps > MAX_W || !width_ok(k) ||
      !width_ok(n))
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const unsigned char* wp = static_cast<const unsigned char*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes = (long long)k * 2;
  if (tile == 64)
    return launch_wg<64>(shape_kernel<64>, 64 * row_bytes, rows, s, xp, wp,
                         reps, k, n, o);
  if (tile == 128)
    return launch_wg<128>(shape_kernel<128>, 128 * row_bytes, rows, s, xp,
                          wp, reps, k, n, o);
  return launch_wg<256>(shape_kernel<256>, 256 * row_bytes, rows, s, xp, wp,
                        reps, k, n, o);
}

Weights weights(const void* const* w, int count) {
  Weights ws{};
  for (int i = 0; i < count; ++i) ws.w[i] = static_cast<const bf16*>(w[i]);
  return ws;
}

}  // namespace

extern "C" {

// Each launcher takes device pointers, launches on `stream` and returns
// cudaGetLastError() (0 on success).  mixed and merged take w: a host
// array of the weights' device pointers, each [K, n] bf16 row-major.

// shape and mosaic take w: the weights packed as one stream of slab images
// (dot_probe.probe_stream), 16-byte aligned.
int plnerf_probe_shape(const void* x, const void* w, int reps, int k, int n,
                       void* out, long long rows, int tile, void* stream) {
  return shape(x, w, reps, k, n, out, rows, tile, stream);
}

int plnerf_probe_mixed(const void* x, const void* const* w, void* out,
                       long long rows, int tile, void* stream) {
  if (!rows_ok(rows, tile)) return (int)cudaErrorInvalidValue;
  const Weights ws = weights(w, 13);
  const bf16* xp = static_cast<const bf16*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      ring_bytes(tile) + (size_t)tile * (XK + PAD + 2 * (W + PAD)) * 2;
  if (tile == 64)
    return launch(mixed_kernel<64>, rows, tile, THREADS, smem, s, xp, ws, o);
  return launch(mixed_kernel<128>, rows, tile, THREADS, smem, s, xp, ws, o);
}

int plnerf_probe_merged(const void* x, const void* const* w, int use_concat,
                        void* out, long long rows, int tile, void* stream) {
  if (!rows_ok(rows, tile) || (use_concat && tile != 64))
    return (int)cudaErrorInvalidValue;
  const Weights ws = weights(w, 11);
  const bf16* xp = static_cast<const bf16*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t per_row =
      use_concat ? (XK + PAD) + 2 * (W + PAD) + (CAT + PAD)
                 : (CAT + PAD) + (W + PAD);
  const size_t smem = ring_bytes(tile) + (size_t)tile * per_row * 2;
  if (tile == 64)
    return launch(merged_kernel<64>, rows, tile, THREADS, smem, s, xp, ws,
                  use_concat, o);
  return launch(merged_kernel<128>, rows, tile, THREADS, smem, s, xp, ws,
                use_concat, o);
}

// independent runs shape_kernel at (256, 256) x 13 and takes its tiles;
// chained and mlp take 64 and 128.
int plnerf_probe_mosaic(const void* x, const void* w, int variant, void* out,
                        long long rows, int tile, void* stream) {
  if (variant == INDEPENDENT)
    return shape(x, w, MAX_W, W, W, out, rows, tile, stream);
  if (!rows_ok(rows, tile) || (variant != CHAINED && variant != MLP))
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const unsigned char* wp = static_cast<const unsigned char*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int relu = variant == MLP;
  if (tile == 64)
    return launch_wg<64>(mosaic_kernel<64>, 64LL * W * 2, rows, s, xp, wp,
                         relu, o);
  return launch_wg<128>(mosaic_kernel<128>, 128LL * W * 2, rows, s, xp, wp,
                        relu, o);
}

const char* plnerf_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
