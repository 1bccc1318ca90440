// Fused NeRF-MLP backward for Hopper (sm_90a).
//
// Replaces the TPU kernel plnerf/kernels/fused_mlp.py `_bwd_kernel`
// (launched by `_backward` through pl.pallas_call) for the viewdirs
// topology, split and folded head schedules.  Given the packed weights
// (row-major [K, N] blocks at the forward's offsets, see fused_mlp_fwd.cu),
// x [N, in_p], v [N / v_div, v_p] and the cotangent g of raw [N, 4], it
// writes dx [N, in_p] and dv [N, v_p] (fp32, dv per point) and the fp32
// grads of every packed weight block and bias, in the packed order, into
// one buffer.
//
// Bound: operations.  The backward does 3.56 MFLOP per point split, 3.17
// folded (recompute, data grads, weight grads: chip_smoke.py
// bwd_flops_per_point) against ~1 KB per point of x, v, g, dx and dv; at
// one fine pass of a 1024-ray step (196,608 points) that is 10.4 / 9.3 ms
// at the H100's 67 TFLOP/s in fp32 and 0.71 / 0.63 ms at 989 in bf16.
// What bounds each pass on this card:
//  - fp32 data pass: a K = N = 256 product over points does 64 FLOP per
//    byte even with its input and output in device memory, above the fp32
//    ridge of 20 FLOP/B (67 TFLOP/s over 3.35 TB/s).  The FMA pipes set the
//    pace, so every layer is its own launch of one SGEMM core and nothing
//    has to stay on chip from layer to layer.
//  - bf16 data pass: the same product is 128 FLOP/B, under the bf16 ridge
//    (295 FLOP/B); per-layer launches would wait on device memory, so the
//    walk from layer to layer stays in shared memory.
//  - weight pass (both): A^T @ dA over the points, 128 x 128 tiles whose
//    operands stream from L2 at 32 (fp32) or 64 (bf16) FLOP per byte, so
//    the FMA pipes (fp32) or the tensor cores (bf16).
//
// Passes on one stream, no floating-point atomics, so two calls on the
// same inputs give bit-identical results:
//
// 0. transpose_kernel writes every weight block transposed ([N, K] at
//    its offset) into the workspace (`wt`), cot_data_kernel d_rgb and the
//    d_alpha block of the cotangent.
// 1. The data pass recomputes the forward (every relu output to `acts`:
//    8 x 256 x 128 points is 1 MB in fp32, more than a CTA holds), then
//    backpropagates through the heads and the layers (every pre-relu grad
//    to `dacts`); dx and dv are written per point.  Each data grad
//    da @ W^T reads the transposed blocks (`wt`), so it is the same
//    [K, N] row-major product as the recompute.
//    fp32: one launch of sgemm_data_kernel per product, in order:
//    recompute (bias and relu, to acts), heads, data grads (relu mask read
//    from acts as 16-byte rows, to dacts), dx (the first skip layer's x
//    block writes it, later x blocks and layer 0 add to it in that fixed
//    order), dv.  The core (sgemm_core.cuh, shared with the forward's
//    fp32 path): a CTA tile of 128 points x 128 columns, 256
//    threads with an 8 x 8 outer product each, k-slabs of 16 through a
//    3-stage ring of 16-byte cp.async copies (both operands, so each
//    weight byte is fetched once per CTA), every FMA operand read by
//    LDS.128, ragged points and columns masked; 2 CTAs per SM.
//    bf16: data_kernel, one CTA of 8 warps per 128-point tile, the walk
//    of dot_probe.cu: activations in shared memory as bf16 rows padded by
//    8 (ldmatrix without bank conflicts), weight k-slabs of 32 rows
//    streamed from L2 through a 2-stage cp.async ring shared by the
//    warps, mma.sync m16n8k16 with fp32 accumulators.  Relu outputs and
//    da leave the shared tile for acts / dacts as 16-byte rows after each
//    layer's barrier; each data grad's mask (the relu output it needs)
//    comes back from acts as 16-byte rows by cp.async into its output
//    tile before the product, and the epilogue multiplies in place; dx
//    and dv go from the fragments to device memory (no fp32 dx
//    accumulator).
// 2. weight_kernel: every dW block is A^T @ dA over the points (A the
//    block's input: x, v, a relu output, the feature; dA its output
//    grad), both point-major in the workspace.  One CTA computes a
//    128 x 128 tile of one block over one chunk of points (the product's
//    k) and writes it to its own slot of a partial buffer (on the TPU the
//    sequential grid accumulated in place); the chunks are sized so that
//    the grid is whole waves of 2 CTAs per SM; the CTAs holding dW rows
//    0..127 of the block that owns a db also sum its dA columns.  fp32 on
//    the SGEMM core with both operands k-major (no transposing); bf16 on
//    mma.sync with 32-point stages copied as contiguous point rows and
//    read by ldmatrix.trans.  Only live CTAs are launched.
// 3. reduce_kernel sums the partials over the chunks in chunk order.
//
// Shared memory per CTA (8x256 MLP, input 64, views 32): fp32 cores
// 55,296 B (3 stages of 128 x 20 + 16 x 128 floats); bf16 weight_kernel
// 52,224 B (3 stages of 2 x 32 x 136 bf16); data_kernel 224,256 B of the
// 232,448 a CTA may use: weight ring 2 x 32 x 264 bf16 (33,792), two
// activation buffers 128 x 296 bf16 (151,552; 296 = [dfeat | d_alpha]
// + 8), x 128 x 72 (18,432), views 128 x 40 (10,240), d_rgb 128 x 40
// (10,240).  A wider MLP than w_p = 256 does not fit; the wrapper raises.
//
// Registers (ptxas -v for sm_90a, chip_smoke.py's env line): no
// spills anywhere.  sgemm_data_kernel 128 (__launch_bounds__(256, 2));
// data_kernel 255, one CTA per SM (shared memory bounds it anyway), its
// column-pass routine `dense` compiled as one call without spills;
// weight_kernel 128 (fp32) / 124 (bf16), 2 CTAs per SM; transpose_kernel
// 32, cot_data_kernel 12, reduce_kernel 28.
//
// Workspace (one buffer, size from plnerf_fused_mlp_bwd_workspace):
//   wt    [n_w] compute dtype: the weight blocks transposed
//   acts  [N, Ca] compute dtype: relu_0 .. relu_{L-1} (w_p each), then
//         split: feature (w_p), z_hv (h_p); folded: z_hv (h_p)
//   dacts [N, Cd] compute dtype: da_0 .. da_{L-1} (w_p each), then
//         split: [dfeat | d_alpha] (w_p + 32), da_v (h_p), d_rgb (32);
//         folded: [da_v | d_alpha] (h_p + 32), d_rgb (32)
//   partials [n_chunks, n_grad] fp32
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "sgemm_core.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps in every kernel
constexpr int ALIGN = 32;     // K / N granularity of every packed block
constexpr int MAX_LAYERS = 16;
constexpr int MAX_BLK = 2 * MAX_LAYERS + 4;
constexpr int MAX_BIAS = MAX_LAYERS + 3;
// Weight-pass grid: point chunks so that the tiles fill WAVES waves of
// two CTAs on each of the H100's 132 SMs (a fixed count: the chunking,
// and so the summation order, depends on n and the layout only)
constexpr int SMS = 132, WEIGHT_CTAS_PER_SM = 2, WAVES = 4;
constexpr int MIN_CHUNK = 256;

enum Head { SPLIT = 0, FOLDED = 1 };

typedef __nv_bfloat16 bf16;

// Offsets (elements) of the packed blocks and the workspace sections.
// woff / boff index the grad buffer [weights | biases], so a bias's offset
// in the bias buffer is boff - n_w.
struct Layout {
  int L, in_p, w_p, v_p, h_p, head;
  unsigned skip_mask;
  int n_blk, n_bias;
  long long woff[MAX_BLK];
  int wk[MAX_BLK], wn[MAX_BLK];
  long long boff[MAX_BIAS];
  int bn[MAX_BIAS];
  int blk_x[MAX_LAYERS], blk_h[MAX_LAYERS];  // blk_x = -1: no skip input
  int hb;               // first head block; head biases follow the L layers
  int act[MAX_LAYERS], feat, zhv, Ca;
  int da[MAX_LAYERS], dcat, dalpha, dav, drgb, Cd;
  long long n_w, n_grad;  // weight elements, weight + bias elements
};

int build_layout(Layout* y, int L, unsigned skip_mask, int in_p, int w_p,
                 int v_p, int h_p, int head) {
  if (L < 1 || L > MAX_LAYERS || (skip_mask & 1u) ||
      (head != SPLIT && head != FOLDED))
    return 0;
  *y = Layout{};
  y->L = L; y->in_p = in_p; y->w_p = w_p; y->v_p = v_p; y->h_p = h_p;
  y->head = head; y->skip_mask = skip_mask;
  long long off = 0;
  auto blk = [&](int k, int n) {
    y->woff[y->n_blk] = off; y->wk[y->n_blk] = k; y->wn[y->n_blk] = n;
    off += (long long)k * n;
    return y->n_blk++;
  };
  for (int i = 0; i < L; ++i) {
    if ((skip_mask >> i) & 1u) {
      y->blk_x[i] = blk(in_p, w_p);
      y->blk_h[i] = blk(w_p, w_p);
    } else {
      y->blk_x[i] = -1;
      y->blk_h[i] = blk(i == 0 ? in_p : w_p, w_p);
    }
  }
  y->hb = y->n_blk;
  if (head == SPLIT) {
    blk(w_p, w_p + ALIGN); blk(w_p, h_p); blk(v_p, h_p); blk(h_p, ALIGN);
  } else {
    blk(w_p, h_p + ALIGN); blk(v_p, h_p + ALIGN); blk(h_p, ALIGN);
  }
  y->n_w = off;
  auto bias = [&](int n) {
    y->boff[y->n_bias] = off; y->bn[y->n_bias++] = n; off += n;
  };
  for (int i = 0; i < L; ++i) bias(w_p);
  if (head == SPLIT) {
    bias(w_p + ALIGN); bias(h_p); bias(ALIGN);
  } else {
    bias(h_p + ALIGN); bias(ALIGN);
  }
  y->n_grad = off;
  int c = 0;
  for (int i = 0; i < L; ++i) { y->act[i] = c; c += w_p; }
  y->feat = c; if (head == SPLIT) c += w_p;
  y->zhv = c; c += h_p;
  y->Ca = c;
  c = 0;
  for (int i = 0; i < L; ++i) { y->da[i] = c; c += w_p; }
  y->dcat = c; c += (head == SPLIT ? w_p : h_p) + ALIGN;
  y->dalpha = y->dcat + (head == SPLIT ? w_p : h_p);
  y->dav = head == SPLIT ? c : y->dcat; if (head == SPLIT) c += h_p;
  y->drgb = c; c += ALIGN;
  y->Cd = c;
  return 1;
}

// ------------------------------------------ transpose, cotangent -------

// wt: block j of w ([K, N] row-major) as [N, K] at the same offset, one
// 32 x 32 tile per CTA through shared memory.  U: the element's bits.
template <typename U>
__global__ void __launch_bounds__(THREADS)
transpose_kernel(const U* __restrict__ w, U* __restrict__ wt,
                 const Layout y) {
  __shared__ U tile[32][33];
  int t = blockIdx.x, j = 0;
  for (; j + 1 < y.n_blk; ++j) {
    const int tiles = (y.wk[j] / 32) * (y.wn[j] / 32);
    if (t < tiles) break;
    t -= tiles;
  }
  const int K = y.wk[j], N = y.wn[j];
  const int k0 = (t / (N / 32)) * 32, n0 = (t % (N / 32)) * 32;
  const U* src = w + y.woff[j];
  U* dst = wt + y.woff[j];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += THREADS / 32)
    tile[r][tx] = src[(long long)(k0 + r) * N + n0 + tx];
  __syncthreads();
  for (int r = ty; r < 32; r += THREADS / 32)
    dst[(long long)(n0 + r) * K + k0 + tx] = tile[tx][r];
}


// d_rgb = [g0 g1 g2 0 ..] (32 columns) and the d_alpha block
// [g3 0 ..] (32 columns, the last of dcat) into dacts
template <typename T>
__global__ void __launch_bounds__(THREADS)
cot_data_kernel(const float* __restrict__ g, T* __restrict__ dacts,
                long long n, int Cd, int drgb, int dalpha) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n * 2 * ALIGN) return;
  const long long r = e / (2 * ALIGN);
  const int c = (int)(e - r * 2 * ALIGN);
  float val;
  int col;
  if (c < ALIGN) {
    val = c < 3 ? g[r * 4 + c] : 0.f;
    col = drgb + c;
  } else {
    val = c == ALIGN ? g[r * 4 + 3] : 0.f;
    col = dalpha + c - ALIGN;
  }
  if (sizeof(T) == 4)
    reinterpret_cast<float*>(dacts)[r * Cd + col] = val;
  else
    reinterpret_cast<bf16*>(dacts)[r * Cd + col] = __float2bfloat16_rn(val);
}

// ---------------------------------------------- fp32 SGEMM core -------

// One launch per data-pass product (sgemm_core.cuh).
__global__ void __launch_bounds__(THREADS, 2)
sgemm_data_kernel(const FOp op, long long n) {
  sgemm_tile<false>(op, n);
}

// ------------------------------------------ bf16 fused data pass --------

constexpr int BM = 128, KS = 32, PAD = 8;
constexpr int RING_LD = 256 + PAD;  // widest column pass 256
constexpr int RING_STAGE = KS * RING_LD;

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ bool bf16_pos(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)bits)) > 0.f;
}

// One summand A @ W: A [BM, K] in shared memory (row stride lda), W [K, *]
// row-major in device memory (row stride ldw).
struct HTerm {
  const bf16* a;
  int lda, K;
  const bf16* w;
  int ldw;
};

// Where a product's output goes.  dst: bf16 into shared memory, after
// + bias[c] and relu on c < relu_cols; with mask, 0 unless the value
// dst already holds there is > 0 (the relu output, staged beforehand).
// gout (dst null): fp32 rows < n_valid to device memory, old + value with
// accumulate.
struct HEp {
  bf16* dst;
  int ld;
  const float* bias;
  int relu_cols, mask;
  float* gout;
  long long gld;
  int accumulate, n_valid;
};

// Output columns [c0, c0 + NP) of t0 (+ t1): warps in WR rows of MT
// 16-row blocks and 8 / WR columns of NT 8-column blocks.  Slab s + 1
// loads while slab s multiplies; ends with every warp past its last ring
// read.  cp.async groups committed before the call are waited for by the
// first slab's wait.
template <int WR, int MT, int NT>
__device__ __forceinline__ void mma_product(const HTerm& t0, const HTerm& t1,
                                            int nterms, int c0, bf16* ring,
                                            const HEp& ep) {
  constexpr int WC = 8 / WR;
  constexpr int NP = WC * NT * 8;
  constexpr int LDW = NP + PAD;
  static_assert(WR * MT * 16 == BM, "warp rows must cover the tile");
  static_assert(NT % 2 == 0, "B fragments load in pairs of n blocks");
  static_assert(NP <= 256, "column pass wider than the ring");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WC, wc = warp - wr * WC;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = t0.K / KS;
  const int slabs = s0 + (nterms > 1 ? t1.K / KS : 0);

  auto load = [&](int s, bf16* stage) {
    const bool first = s < s0;
    const bf16* w = first ? t0.w : t1.w;
    const int ldw = first ? t0.ldw : t1.ldw;
    const int k0 = (first ? s : s - s0) * KS;
    constexpr int CH = NP / 8;  // 16-byte chunks per slab row
    for (int e = threadIdx.x; e < KS * CH; e += THREADS) {
      const int r = e / CH;
      const int c = (e - r * CH) * 8;
      cp_async16(stage + r * LDW + c, w + (size_t)(k0 + r) * ldw + c0 + c,
                 true);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

  load(0, ring);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) {
      load(s + 1, ring + ((s + 1) & 1) * RING_STAGE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* stage = ring + (s & 1) * RING_STAGE;
    const bool first = s < s0;
    const bf16* a = first ? t0.a : t1.a;
    const int lda = first ? t0.lda : t1.lda;
    const int ck = (first ? s : s - s0) * KS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(af[mi], a + (wr * MT * 16 + mi * 16 + (lane & 15)) * lda +
                                ck + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NT; nj += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, stage + (kk + (lane & 15)) * LDW +
                                   wc * NT * 8 + nj * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][nj], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled two slabs on
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      const int c = c0 + wc * NT * 8 + nj * 8 + 2 * t;  // columns c, c + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr * MT * 16 + mi * 16 + g + 8 * h;
        float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (!ep.dst) {
          if (row < ep.n_valid) {
            float2* o = reinterpret_cast<float2*>(ep.gout + row * ep.gld + c);
            if (ep.accumulate) {
              const float2 q = *o;
              v0 = q.x + v0;
              v1 = q.y + v1;
            }
            *o = make_float2(v0, v1);
          }
          continue;
        }
        if (ep.bias) {
          v0 += __ldg(ep.bias + c);
          v1 += __ldg(ep.bias + c + 1);
        }
        if (c < ep.relu_cols) {  // relu_cols is a multiple of 32
          v0 = v0 < 0.f ? 0.f : v0;
          v1 = v1 < 0.f ? 0.f : v1;
        }
        uint32_t* d = reinterpret_cast<uint32_t*>(ep.dst + row * ep.ld + c);
        uint32_t out = pack_bf16x2(v0, v1);
        if (ep.mask) {
          const uint32_t m = *d;
          out = (bf16_pos(m) ? out & 0xffffu : 0u) |
                (bf16_pos(m >> 16) ? out & 0xffff0000u : 0u);
        }
        *d = out;
      }
    }
}

// Columns [0, N) of t0 (+ t1), in passes of 256, 128, 64 and 32 columns.
__device__ __noinline__ void dense(const HTerm t0, const HTerm t1, int nterms,
                                   int N, bf16* ring, const HEp ep) {
  int c0 = 0;
  while (c0 < N) {
    const int rem = N - c0;
    if (rem >= 256) {
      mma_product<2, 4, 8>(t0, t1, nterms, c0, ring, ep);
      c0 += 256;
    } else if (rem >= 128) {
      mma_product<2, 4, 4>(t0, t1, nterms, c0, ring, ep);
      c0 += 128;
    } else if (rem >= 64) {
      mma_product<4, 2, 4>(t0, t1, nterms, c0, ring, ep);
      c0 += 64;
    } else {
      mma_product<8, 1, 4>(t0, t1, nterms, c0, ring, ep);
      c0 += 32;
    }
  }
}

// rows (row0 + r) / div of src (row stride sld), columns [0, cols), into
// dst [BM][ld] by cp.async; zeros for r >= n_valid.  The caller commits.
__device__ void get_rows(bf16* dst, int ld, const bf16* __restrict__ src,
                         long long sld, long long row0, long long div,
                         int cols, int n_valid) {
  const int ch = cols / 8;
  for (int e = threadIdx.x; e < BM * ch; e += THREADS) {
    const int r = e / ch;
    const int c = (e - r * ch) * 8;
    const bool ok = r < n_valid;
    const long long sr = ok ? (div == 1 ? row0 + r : (row0 + r) / div) : 0;
    cp_async16(dst + r * ld + c, src + sr * sld + c, ok);
  }
}

// rows [0, n_valid), columns [0, cols) of src [BM][ld] to dst (row
// stride dld), 16 bytes a thread
__device__ void put_rows(bf16* __restrict__ dst, long long dld,
                         const bf16* src, int ld, int cols, int n_valid) {
  const int ch = cols / 8;
  for (int e = threadIdx.x; e < n_valid * ch; e += THREADS) {
    const int r = e / ch;
    const int c = (e - r * ch) * 8;
    *reinterpret_cast<uint4*>(dst + r * dld + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

__device__ __forceinline__ HTerm term(const bf16* a, int lda, int K,
                                      const bf16* w, int ldw) {
  return HTerm{a, lda, K, w, ldw};
}

__device__ __forceinline__ HEp to_smem(bf16* dst, int ld) {
  return HEp{dst, ld, nullptr, 0, 0, nullptr, 0, 0, 0};
}

__device__ __forceinline__ HEp to_global(float* out, long long gld,
                                         int accumulate, int n_valid) {
  return HEp{nullptr, 0, nullptr, 0, 0, out, gld, accumulate, n_valid};
}

long long data_smem_bf16(int in_p, int w_p, int v_p) {
  const long long wide = w_p + ALIGN;  // h_p <= w_p
  return 2LL * (2 * RING_STAGE + 2 * BM * (wide + PAD)) +
         2LL * BM * ((in_p + PAD) + (v_p + PAD) + (ALIGN + PAD));
}

template <int HEAD>
__global__ void __launch_bounds__(THREADS, 1)
data_kernel(const bf16* __restrict__ x, const bf16* __restrict__ v,
            long long v_div, const bf16* __restrict__ w,
            const bf16* __restrict__ wt, const float* __restrict__ bbuf,
            bf16* acts, bf16* dacts, float* __restrict__ dx,
            float* __restrict__ dv, long long n, const Layout y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int in_p = y.in_p, w_p = y.w_p, v_p = y.v_p, h_p = y.h_p;
  const int ldh = w_p + ALIGN + PAD, ldx = in_p + PAD, ldv = v_p + PAD,
            ldr = ALIGN + PAD;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf0 = ring + 2 * RING_STAGE;
  bf16* buf1 = buf0 + BM * ldh;
  bf16* xs = buf1 + BM * ldh;
  bf16* vs = xs + BM * ldx;
  bf16* rs = vs + BM * ldv;

  const long long row0 = (long long)blockIdx.x * BM;
  const int n_valid = (int)min((long long)BM, n - row0);
  bf16* arow = acts + row0 * y.Ca;
  bf16* drow = dacts + row0 * y.Cd;
  const float* bias = bbuf - y.n_w;  // indexed by boff
  auto W = [&](int j) { return w + y.woff[j]; };
  auto WT = [&](int j) { return wt + y.woff[j]; };
  const HTerm none = term(nullptr, 0, 0, nullptr, 0);

  get_rows(xs, ldx, x, in_p, row0, 1, in_p, n_valid);
  get_rows(vs, ldv, v, v_p, row0, v_div, v_p, n_valid);
  get_rows(rs, ldr, dacts + y.drgb, y.Cd, row0, 1, ALIGN, n_valid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- forward recompute: relu outputs to the shared ping-pong, then
  // to acts as 16-byte rows
  const bf16* h = xs;
  int hk = in_p, hld = ldx;
  bf16* dst = buf0;
  for (int i = 0; i < y.L; ++i) {
    HEp ep = to_smem(dst, ldh);
    ep.bias = bias + y.boff[i];
    ep.relu_cols = w_p;
    const int bx = y.blk_x[i], bh = y.blk_h[i];
    if (bx >= 0)
      dense(term(xs, ldx, in_p, W(bx), w_p), term(h, hld, w_p, W(bh), w_p),
            2, w_p, ring, ep);
    else
      dense(term(h, hld, hk, W(bh), w_p), none, 1, w_p, ring, ep);
    __syncthreads();
    put_rows(arow + y.act[i], y.Ca, dst, ldh, w_p, n_valid);
    h = dst;
    hk = w_p;
    hld = ldh;
    dst = (dst == buf0) ? buf1 : buf0;
  }
  bf16* X = const_cast<bf16*>(h);  // relu_{L-1}
  bf16* Y = dst;
  const int hb = y.hb, hbias = y.L;
  if (HEAD == SPLIT) {
    // feature = h @ Waf[:, :w_p] + baf -> Y, acts.feat
    HEp ep = to_smem(Y, ldh);
    ep.bias = bias + y.boff[hbias];
    dense(term(X, ldh, w_p, W(hb), w_p + ALIGN), none, 1, w_p, ring, ep);
    __syncthreads();
    put_rows(arow + y.feat, y.Ca, Y, ldh, w_p, n_valid);
    get_rows(Y + w_p, ldh, dacts + y.dalpha, y.Cd, row0, 1, ALIGN, n_valid);
    cp_async_commit();
    // z_hv = relu(feature @ Wvf + v @ Wvv + bv) -> X, acts.zhv
    ep = to_smem(X, ldh);
    ep.bias = bias + y.boff[hbias + 1];
    ep.relu_cols = h_p;
    dense(term(Y, ldh, w_p, W(hb + 1), h_p), term(vs, ldv, v_p, W(hb + 2), h_p),
          2, h_p, ring, ep);
    __syncthreads();
    put_rows(arow + y.zhv, y.Ca, X, ldh, h_p, n_valid);
    // ---- backward.  da_v = [z_hv > 0] (d_rgb @ Wr^T), in place in X
    ep = to_smem(X, ldh);
    ep.mask = 1;
    dense(term(rs, ldr, ALIGN, WT(hb + 3), h_p), none, 1, h_p, ring, ep);
    __syncthreads();
    put_rows(drow + y.dav, y.Cd, X, ldh, h_p, n_valid);
    // dv = da_v @ Wvv^T
    dense(term(X, ldh, h_p, WT(hb + 2), v_p), none, 1, v_p, ring,
          to_global(dv + row0 * v_p, v_p, 0, n_valid));
    // dfeat = da_v @ Wvf^T -> Y[:, :w_p]; Y[:, w_p:] holds d_alpha
    dense(term(X, ldh, h_p, WT(hb + 1), w_p), none, 1, w_p, ring,
          to_smem(Y, ldh));
    __syncthreads();
    put_rows(drow + y.dcat, y.Cd, Y, ldh, w_p, n_valid);
    // da_{L-1} = [relu_{L-1} > 0] ([dfeat | d_alpha] @ Waf^T) -> X
    get_rows(X, ldh, acts + y.act[y.L - 1], y.Ca, row0, 1, w_p, n_valid);
    cp_async_commit();
    ep = to_smem(X, ldh);
    ep.mask = 1;
    dense(term(Y, ldh, w_p + ALIGN, WT(hb), w_p), none, 1, w_p, ring, ep);
  } else {
    // z_hv = relu((h @ Wfa + v @ Wvv + bfa)[:, :h_p]) -> Y, acts.zhv;
    // the d_alpha block into Y[:, h_p:]
    get_rows(Y + h_p, ldh, dacts + y.dalpha, y.Cd, row0, 1, ALIGN, n_valid);
    cp_async_commit();
    HEp ep = to_smem(Y, ldh);
    ep.bias = bias + y.boff[hbias];
    ep.relu_cols = h_p;
    dense(term(X, ldh, w_p, W(hb), h_p + ALIGN),
          term(vs, ldv, v_p, W(hb + 1), h_p + ALIGN), 2, h_p, ring, ep);
    __syncthreads();
    put_rows(arow + y.zhv, y.Ca, Y, ldh, h_p, n_valid);
    // ---- backward.  da_v = [z_hv > 0] (d_rgb @ Wr^T), in place in Y
    ep = to_smem(Y, ldh);
    ep.mask = 1;
    dense(term(rs, ldr, ALIGN, WT(hb + 2), h_p), none, 1, h_p, ring, ep);
    __syncthreads();
    put_rows(drow + y.dcat, y.Cd, Y, ldh, h_p, n_valid);
    // dv = [da_v | d_alpha] @ Wvv^T
    dense(term(Y, ldh, h_p + ALIGN, WT(hb + 1), v_p), none, 1, v_p, ring,
          to_global(dv + row0 * v_p, v_p, 0, n_valid));
    // da_{L-1} = [relu_{L-1} > 0] ([da_v | d_alpha] @ Wfa^T) -> X
    get_rows(X, ldh, acts + y.act[y.L - 1], y.Ca, row0, 1, w_p, n_valid);
    cp_async_commit();
    ep = to_smem(X, ldh);
    ep.mask = 1;
    dense(term(Y, ldh, h_p + ALIGN, WT(hb), w_p), none, 1, w_p, ring, ep);
  }
  __syncthreads();
  put_rows(drow + y.da[y.L - 1], y.Cd, X, ldh, w_p, n_valid);

  // ---- pts layers, last to first.  dx: the first x block met writes
  // it, every later one and layer 0 add to it, in that fixed order.
  bf16* cur = X;
  int dx_set = 0;
  float* dxr = dx + row0 * in_p;
  for (int i = y.L - 1; i >= 0; --i) {
    bf16* other = (cur == buf0) ? buf1 : buf0;
    const int bx = y.blk_x[i], bh = y.blk_h[i];
    if (bx >= 0) {  // dx (+)= da_i @ Wx_i^T
      dense(term(cur, ldh, w_p, WT(bx), in_p), none, 1, in_p, ring,
            to_global(dxr, in_p, dx_set, n_valid));
      dx_set = 1;
    }
    if (i > 0) {  // da_{i-1} = [relu_{i-1} > 0] (da_i @ Wh_i^T)
      get_rows(other, ldh, acts + y.act[i - 1], y.Ca, row0, 1, w_p, n_valid);
      cp_async_commit();
      HEp ep = to_smem(other, ldh);
      ep.mask = 1;
      dense(term(cur, ldh, w_p, WT(bh), w_p), none, 1, w_p, ring, ep);
      __syncthreads();
      put_rows(drow + y.da[i - 1], y.Cd, other, ldh, w_p, n_valid);
      cur = other;
    } else {  // dx (+)= da_0 @ W_0^T
      dense(term(cur, ldh, w_p, WT(bh), in_p), none, 1, in_p, ring,
            to_global(dxr, in_p, dx_set, n_valid));
    }
  }
}

// --------------------------------------------------- weight pass -------

constexpr int WBM = 128, WBN = 128;

struct Job {
  const void* a;
  long long lda, a_div;
  int K;               // dW rows (A columns)
  const void* d;
  long long ldd;
  int N;               // dW columns (dA columns)
  long long out;       // dW offset in a partial row
  long long bias_out;  // db offset in a partial row, -1: none
  int tiles_n, tile0;  // column tiles; first tile in the grid
};
struct Jobs {
  Job j[MAX_BLK];
  int n, tiles;
  long long chunk;
};

// fp32: both operands k-major in shared memory (As[FBK][128] points x dW
// rows, Bs[FBK][128] points x columns); lane (lm, ln) of warp w owns dW
// rows 32 (w & 3) + 4 lm .. + 4 and + 16, columns as in the data kernel.
__device__ void weight_tile(const Job& jb, long long r_lo, long long r_hi,
                            int m0, int n0, bool with_db, float* out, float) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int lm = lane & 3, ln = lane >> 2;
  const float* A = static_cast<const float*>(jb.a);
  const float* D = static_cast<const float*>(jb.d);
  const long long pts = r_hi > r_lo ? r_hi - r_lo : 0;
  const int slabs = (int)((pts + FBK - 1) / FBK);

  auto load = [&](int s, int st) {
    float* As = fsm + st * F_STAGE;
    float* Bs = As + FBK * WBM;
    const long long p0 = r_lo + (long long)s * FBK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * THREADS;
      const int r = e >> 5, c = (e & 31) * 4;
      const long long p = p0 + r;
      const bool ok_p = p < r_hi;
      const bool oka = ok_p && m0 + c < jb.K;
      const long long ar = oka ? (jb.a_div == 1 ? p : p / jb.a_div) : 0;
      cp_async16(As + r * WBM + c, A + ar * jb.lda + (oka ? m0 + c : 0), oka);
      const bool okd = ok_p && n0 + c < jb.N;
      cp_async16(Bs + r * WBN + c, D + (okd ? p : 0) * jb.ldd +
                                       (okd ? n0 + c : 0), okd);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float db = 0.f;

#pragma unroll
  for (int s = 0; s < FST - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<FST - 2>();
    __syncthreads();
    if (s + FST - 1 < slabs) load(s + FST - 1, (s + FST - 1) % FST);
    cp_async_commit();
    const float* As = fsm + (s % FST) * F_STAGE;
    const float* Bs = As + FBK * WBM;
    if (with_db && tid < WBN)
#pragma unroll
      for (int k = 0; k < FBK; ++k) db += Bs[k * WBN + tid];
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          As + k * WBM + wm * 32 + lm * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(
          As + k * WBM + wm * 32 + 16 + lm * 4);
      const float* brow = Bs + k * WBN + wn * 64 + ln * 4;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wm * 32 + (i >> 2) * 16 + lm * 4 + (i & 3);
    if (m >= jb.K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + wn * 64 + h * 32 + ln * 4;
      if (c < jb.N)
        *reinterpret_cast<float4*>(out + jb.out + (long long)m * jb.N + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
  if (with_db && tid < WBN && n0 + tid < jb.N)
    out[jb.bias_out + n0 + tid] = db;
}

// bf16: stages of HBK points, As[HBK][136] and Bs[HBK][136] copied as
// contiguous point rows; A fragments by ldmatrix.trans from the [point][dW
// row] tile, B fragments by ldmatrix.trans from [point][column].  Warp w
// owns dW rows 64 (w & 1) .. + 64 and columns 32 (w >> 1) .. + 32.
constexpr int HBK = 32, HLD = 128 + PAD, HST = 3;
constexpr int H_STAGE = 2 * HBK * HLD;  // bf16 elements per stage

__device__ void weight_tile(const Job& jb, long long r_lo, long long r_hi,
                            int m0, int n0, bool with_db, float* out, bf16) {
  extern __shared__ __align__(16) unsigned char wsm_raw[];
  bf16* wsm = reinterpret_cast<bf16*>(wsm_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const bf16* A = static_cast<const bf16*>(jb.a);
  const bf16* D = static_cast<const bf16*>(jb.d);
  const long long pts = r_hi > r_lo ? r_hi - r_lo : 0;
  const int slabs = (int)((pts + HBK - 1) / HBK);

  auto load = [&](int s, int st) {
    bf16* As = wsm + st * H_STAGE;
    bf16* Bs = As + HBK * HLD;
    const long long p0 = r_lo + (long long)s * HBK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * THREADS;
      const int r = e >> 4, c = (e & 15) * 8;
      const long long p = p0 + r;
      const bool ok_p = p < r_hi;
      const bool oka = ok_p && m0 + c < jb.K;
      const long long ar = oka ? (jb.a_div == 1 ? p : p / jb.a_div) : 0;
      cp_async16(As + r * HLD + c, A + ar * jb.lda + (oka ? m0 + c : 0), oka);
      const bool okd = ok_p && n0 + c < jb.N;
      cp_async16(Bs + r * HLD + c, D + (okd ? p : 0) * jb.ldd +
                                       (okd ? n0 + c : 0), okd);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
  float db = 0.f;

#pragma unroll
  for (int s = 0; s < HST - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<HST - 2>();
    __syncthreads();
    if (s + HST - 1 < slabs) load(s + HST - 1, (s + HST - 1) % HST);
    cp_async_commit();
    const bf16* As = wsm + (s % HST) * H_STAGE;
    const bf16* Bs = As + HBK * HLD;
    if (with_db && tid < WBN)
#pragma unroll
      for (int k = 0; k < HBK; ++k) db += __bfloat162float(Bs[k * HLD + tid]);
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], As + (kk + (lane >> 4) * 8 + (lane & 7)) *
                                           HLD +
                                       wm * 64 + mi * 16 +
                                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, Bs + (kk + (lane & 15)) * HLD + wn * 32 +
                                   nj * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][nj], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int c = n0 + wn * 32 + nj * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (m < jb.K && c < jb.N)
          *reinterpret_cast<float2*>(out + jb.out + (long long)m * jb.N + c) =
              make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
  if (with_db && tid < WBN && n0 + tid < jb.N)
    out[jb.bias_out + n0 + tid] = db;
}

template <typename T>
constexpr int weight_smem() {
  return sizeof(T) == 4 ? F_SMEM : HST * H_STAGE * 2;
}

// grid (tiles, chunks): CTA (tile, chunk) writes its tile of its job's
// block, summed over the chunk's points, to partial row `chunk`.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
weight_kernel(const Jobs jobs, long long n, long long n_grad,
              float* __restrict__ partial) {
  const int bid = blockIdx.x;
  int ji = 0;
  while (ji + 1 < jobs.n && bid >= jobs.j[ji + 1].tile0) ++ji;
  const Job jb = jobs.j[ji];
  const int tile = bid - jb.tile0;
  const int mt = tile / jb.tiles_n, nt = tile - mt * jb.tiles_n;
  const long long r_lo = (long long)blockIdx.y * jobs.chunk;
  const long long r_hi = min(n, r_lo + jobs.chunk);
  weight_tile(jb, r_lo, r_hi, mt * WBM, nt * WBN,
              jb.bias_out >= 0 && mt == 0, partial + blockIdx.y * n_grad,
              T());
}

// ----------------------------------------------------------- reduce ----

__global__ void reduce_kernel(const float* __restrict__ partial,
                              long long n_chunks, long long n_grad,
                              float* __restrict__ grads) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_grad) return;
  float s = 0.f;
  for (long long c = 0; c < n_chunks; ++c) s += partial[c * n_grad + e];
  grads[e] = s;
}

// ------------------------------------------------------------- host ------

long long align256(long long b) { return (b + 255) / 256 * 256; }

Jobs make_jobs(const Layout& y, long long n, const void* x, const void* v,
               long long v_div, const unsigned char* acts,
               const unsigned char* dacts, int esize) {
  Jobs js;
  js.n = 0;
  js.tiles = 0;
  auto act = [&](int col) {
    return (const void*)(acts + (long long)col * esize);
  };
  auto dac = [&](int col) {
    return (const void*)(dacts + (long long)col * esize);
  };
  auto add = [&](const void* a, long long lda, long long a_div, int K,
                 const void* d, int N, long long out, long long bias_out) {
    Job& j = js.j[js.n++];
    j.a = a; j.lda = lda; j.a_div = a_div; j.K = K;
    j.d = d; j.ldd = y.Cd; j.N = N; j.out = out; j.bias_out = bias_out;
    j.tiles_n = (N + WBN - 1) / WBN;
    j.tile0 = js.tiles;
    js.tiles += ((K + WBM - 1) / WBM) * j.tiles_n;
  };
  for (int i = 0; i < y.L; ++i) {
    const void* da = dac(y.da[i]);
    if (y.blk_x[i] >= 0)
      add(x, y.in_p, 1, y.in_p, da, y.w_p, y.woff[y.blk_x[i]], -1);
    const int bh = y.blk_h[i];
    if (i == 0)
      add(x, y.in_p, 1, y.in_p, da, y.w_p, y.woff[bh], y.boff[i]);
    else
      add(act(y.act[i - 1]), y.Ca, 1, y.w_p, da, y.w_p, y.woff[bh],
          y.boff[i]);
  }
  const int hb = y.hb, L = y.L;
  const void* last = act(y.act[L - 1]);
  const void* zhv = act(y.zhv);
  const void* drgb = dac(y.drgb);
  const void* dcat = dac(y.dcat);
  if (y.head == SPLIT) {
    const void* dav = dac(y.dav);
    add(last, y.Ca, 1, y.w_p, dcat, y.w_p + ALIGN, y.woff[hb], y.boff[L]);
    add(act(y.feat), y.Ca, 1, y.w_p, dav, y.h_p, y.woff[hb + 1],
        y.boff[L + 1]);
    add(v, y.v_p, v_div, y.v_p, dav, y.h_p, y.woff[hb + 2], -1);
    add(zhv, y.Ca, 1, y.h_p, drgb, ALIGN, y.woff[hb + 3], y.boff[L + 2]);
  } else {
    add(last, y.Ca, 1, y.w_p, dcat, y.h_p + ALIGN, y.woff[hb], y.boff[L]);
    add(v, y.v_p, v_div, y.v_p, dcat, y.h_p + ALIGN, y.woff[hb + 1], -1);
    add(zhv, y.Ca, 1, y.h_p, drgb, ALIGN, y.woff[hb + 2], y.boff[L + 1]);
  }
  // point chunks: at most WAVES whole waves of the grid, chunks of a
  // multiple of 32 points and at least MIN_CHUNK
  const long long target = (long long)SMS * WEIGHT_CTAS_PER_SM * WAVES;
  const long long want = target / js.tiles > 0 ? target / js.tiles : 1;
  long long chunk = (n + want - 1) / want;
  chunk = (chunk + 31) / 32 * 32;
  js.chunk = chunk < MIN_CHUNK ? MIN_CHUNK : chunk;
  return js;
}

struct Workspace {
  long long wt, acts, dacts, partial, total;  // byte offsets, total bytes
  long long n_chunks;
};

Workspace workspace(const Layout& y, long long n, int esize) {
  Workspace w;
  const Jobs js = make_jobs(y, n, nullptr, nullptr, 1, nullptr, nullptr,
                            esize);
  w.n_chunks = (n + js.chunk - 1) / js.chunk;
  w.wt = 0;
  w.acts = align256(y.n_w * esize);
  w.dacts = w.acts + align256(n * y.Ca * esize);
  w.partial = w.dacts + align256(n * y.Cd * esize);
  w.total = w.partial + align256(w.n_chunks * y.n_grad * 4);
  return w;
}

template <typename T>
int weight_and_reduce(const Layout& y, long long n, const void* x,
                      const void* v, long long v_div, const T* acts,
                      const T* dacts, float* partial, long long n_chunks,
                      float* grads, cudaStream_t stream) {
  const Jobs js = make_jobs(y, n, x, v, v_div,
                            reinterpret_cast<const unsigned char*>(acts),
                            reinterpret_cast<const unsigned char*>(dacts),
                            sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      weight_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      weight_smem<T>());
  if (e != cudaSuccess) return (int)e;
  weight_kernel<T><<<dim3(js.tiles, (unsigned)n_chunks), THREADS,
                     weight_smem<T>(), stream>>>(js, n, y.n_grad, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(unsigned)((y.n_grad + 255) / 256), 256, 0, stream>>>(
      partial, n_chunks, y.n_grad, grads);
  return (int)cudaGetLastError();
}

// the transposed weights and the cotangent's workspace columns
template <typename T>
int launch_prologue(const Layout& y, const T* w, T* wt, const float* g,
                    T* dacts, long long n, cudaStream_t stream) {
  typedef typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type
      U;
  transpose_kernel<U><<<(unsigned)(y.n_w / (32 * 32)), THREADS, 0,
                        stream>>>(reinterpret_cast<const U*>(w),
                                  reinterpret_cast<U*>(wt), y);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = n * 2 * ALIGN;
  cot_data_kernel<T><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                       0, stream>>>(g, dacts, n, y.Cd, y.drgb, y.dalpha);
  return (int)cudaGetLastError();
}

// fp32: the data pass as one launch of sgemm_data_kernel per product
int launch_f32(const float* x, const float* v, long long v_div,
               const float* g, const float* w, const float* b, float* grads,
               float* dx, float* dv, unsigned char* ws, long long n,
               const Layout& y, cudaStream_t stream) {
  const Workspace wl = workspace(y, n, 4);
  float* wt = reinterpret_cast<float*>(ws + wl.wt);
  float* acts = reinterpret_cast<float*>(ws + wl.acts);
  float* dacts = reinterpret_cast<float*>(ws + wl.dacts);
  float* partial = reinterpret_cast<float*>(ws + wl.partial);
  int rc = launch_prologue<float>(y, w, wt, g, dacts, n, stream);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      sgemm_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F_SMEM);
  if (e != cudaSuccess) return (int)e;
  const float* bias = b - y.n_w;  // indexed by boff
  const int in_p = y.in_p, w_p = y.w_p, v_p = y.v_p, h_p = y.h_p;
  const long long Ca = y.Ca, Cd = y.Cd;
  auto Wb = [&](int j) { return FTerm{nullptr, 0, 1, 0, w + y.woff[j],
                                      y.wn[j]}; };
  auto WTb = [&](int j) { return FTerm{nullptr, 0, 1, 0, wt + y.woff[j],
                                       y.wk[j]}; };
  // t: the B operand (Wb / WTb) with A rows a (lda, a_div) of width K
  auto with = [](FTerm t, const float* a, long long lda, int K,
                 long long a_div = 1) {
    t.a = a; t.lda = lda; t.K = K; t.a_div = a_div;
    return t;
  };
  auto op = [](int N, float* out, long long ld) {
    FOp o{};
    o.nterms = 1; o.N = N; o.out = out; o.out_ld = ld;
    return o;
  };
  auto run = [&](const FOp& o) {
    const dim3 grid((unsigned)((n + FBM - 1) / FBM),
                    (unsigned)((o.N + FBN - 1) / FBN));
    sgemm_data_kernel<<<grid, THREADS, F_SMEM, stream>>>(o, n);
    return (int)cudaGetLastError();
  };
  const float* A = acts;
  float* D = dacts;

  // forward recompute
  for (int i = 0; i < y.L; ++i) {
    FOp o = op(w_p, acts + y.act[i], Ca);
    o.bias = bias + y.boff[i];
    o.relu_cols = w_p;
    const int bx = y.blk_x[i], bh = y.blk_h[i];
    const float* h = i == 0 ? x : A + y.act[i - 1];
    const long long hld = i == 0 ? in_p : Ca;
    if (bx >= 0) {
      o.t[0] = with(Wb(bx), x, in_p, in_p);
      o.t[1] = with(Wb(bh), h, hld, w_p);
      o.nterms = 2;
    } else {
      o.t[0] = with(Wb(bh), h, hld, i == 0 ? in_p : w_p);
    }
    if ((rc = run(o))) return rc;
  }
  const int hb = y.hb, L = y.L;
  const float* last = A + y.act[L - 1];
  if (y.head == SPLIT) {
    FOp o = op(w_p, acts + y.feat, Ca);  // feature
    o.bias = bias + y.boff[L];
    o.t[0] = with(Wb(hb), last, Ca, w_p);
    if ((rc = run(o))) return rc;
    o = op(h_p, acts + y.zhv, Ca);  // z_hv
    o.bias = bias + y.boff[L + 1];
    o.relu_cols = h_p;
    o.t[0] = with(Wb(hb + 1), A + y.feat, Ca, w_p);
    o.t[1] = with(Wb(hb + 2), v, v_p, v_p, v_div);
    o.nterms = 2;
    if ((rc = run(o))) return rc;
    o = op(h_p, D + y.dav, Cd);  // da_v
    o.mask = A + y.zhv;
    o.mask_ld = Ca;
    o.t[0] = with(WTb(hb + 3), D + y.drgb, Cd, ALIGN);
    if ((rc = run(o))) return rc;
    o = op(v_p, dv, v_p);  // dv
    o.t[0] = with(WTb(hb + 2), D + y.dav, Cd, h_p);
    if ((rc = run(o))) return rc;
    o = op(w_p, D + y.dcat, Cd);  // dfeat
    o.t[0] = with(WTb(hb + 1), D + y.dav, Cd, h_p);
    if ((rc = run(o))) return rc;
    o = op(w_p, D + y.da[L - 1], Cd);  // da_{L-1}
    o.mask = last;
    o.mask_ld = Ca;
    o.t[0] = with(WTb(hb), D + y.dcat, Cd, w_p + ALIGN);
    if ((rc = run(o))) return rc;
  } else {
    FOp o = op(h_p, acts + y.zhv, Ca);  // z_hv
    o.bias = bias + y.boff[L];
    o.relu_cols = h_p;
    o.t[0] = with(Wb(hb), last, Ca, w_p);
    o.t[1] = with(Wb(hb + 1), v, v_p, v_p, v_div);
    o.nterms = 2;
    if ((rc = run(o))) return rc;
    o = op(h_p, D + y.dcat, Cd);  // da_v
    o.mask = A + y.zhv;
    o.mask_ld = Ca;
    o.t[0] = with(WTb(hb + 2), D + y.drgb, Cd, ALIGN);
    if ((rc = run(o))) return rc;
    o = op(v_p, dv, v_p);  // dv
    o.t[0] = with(WTb(hb + 1), D + y.dcat, Cd, h_p + ALIGN);
    if ((rc = run(o))) return rc;
    o = op(w_p, D + y.da[L - 1], Cd);  // da_{L-1}
    o.mask = last;
    o.mask_ld = Ca;
    o.t[0] = with(WTb(hb), D + y.dcat, Cd, h_p + ALIGN);
    if ((rc = run(o))) return rc;
  }
  int dx_set = 0;
  for (int i = L - 1; i >= 0; --i) {
    const int bx = y.blk_x[i], bh = y.blk_h[i];
    const float* da = D + y.da[i];
    if (bx >= 0) {
      FOp o = op(in_p, dx, in_p);
      o.accumulate = dx_set;
      o.t[0] = with(WTb(bx), da, Cd, w_p);
      if ((rc = run(o))) return rc;
      dx_set = 1;
    }
    FOp o = i > 0 ? op(w_p, D + y.da[i - 1], Cd) : op(in_p, dx, in_p);
    if (i > 0) {
      o.mask = A + y.act[i - 1];
      o.mask_ld = Ca;
    } else {
      o.accumulate = dx_set;
    }
    o.t[0] = with(WTb(bh), da, Cd, w_p);
    if ((rc = run(o))) return rc;
  }
  return weight_and_reduce<float>(y, n, x, v, v_div, acts, dacts, partial,
                                  wl.n_chunks, grads, stream);
}

template <int HEAD>
int launch_bf16(const bf16* x, const bf16* v, long long v_div,
                const float* g, const bf16* w, const float* b, float* grads,
                float* dx, float* dv, unsigned char* ws, long long n,
                const Layout& y, cudaStream_t stream) {
  const Workspace wl = workspace(y, n, 2);
  bf16* wt = reinterpret_cast<bf16*>(ws + wl.wt);
  bf16* acts = reinterpret_cast<bf16*>(ws + wl.acts);
  bf16* dacts = reinterpret_cast<bf16*>(ws + wl.dacts);
  float* partial = reinterpret_cast<float*>(ws + wl.partial);
  int rc = launch_prologue<bf16>(y, w, wt, g, dacts, n, stream);
  if (rc) return rc;
  const int smem = (int)data_smem_bf16(y.in_p, y.w_p, y.v_p);
  cudaError_t e = cudaFuncSetAttribute(
      data_kernel<HEAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  data_kernel<HEAD><<<(unsigned)((n + BM - 1) / BM), THREADS, smem,
                      stream>>>(x, v, v_div, w, wt, b, acts, dacts, dx, dv,
                                n, y);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return weight_and_reduce<bf16>(y, n, x, v, v_div, acts, dacts, partial,
                                 wl.n_chunks, grads, stream);
}

}  // namespace

extern "C" {

// Shared memory one CTA of the data pass needs, in bytes.
long long plnerf_fused_mlp_bwd_smem(int in_p, int w_p, int v_p,
                                    int use_bf16) {
  return use_bf16 ? data_smem_bf16(in_p, w_p, v_p) : (long long)F_SMEM;
}

// Workspace bytes for n points (0: a layout the kernel does not take).
long long plnerf_fused_mlp_bwd_workspace(long long n, int n_layers,
                                         unsigned skip_mask, int in_p,
                                         int w_p, int v_p, int h_p, int head,
                                         int use_bf16) {
  Layout y;
  if (n < 1 ||
      !build_layout(&y, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
    return 0;
  return workspace(y, n, use_bf16 ? 2 : 4).total;
}

// Number of fp32 grads written (packed weights, then packed biases).
long long plnerf_fused_mlp_bwd_n_grad(int n_layers, unsigned skip_mask,
                                      int in_p, int w_p, int v_p, int h_p,
                                      int head) {
  Layout y;
  if (!build_layout(&y, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
    return 0;
  return y.n_grad;
}

// Launches the passes on `stream`; returns cudaGetLastError() of the
// first that fails (0 on success).  w: packed weights, every block [K, N]
// row-major; b: packed biases; g: [n, 4] fp32.
int plnerf_fused_mlp_bwd(const void* x, const void* v, long long v_div,
                         const void* g, const void* w, const void* b,
                         void* grads, void* dx, void* dv,
                         void* workspace_buf, long long n, int n_layers,
                         unsigned skip_mask, int in_p, int w_p, int v_p,
                         int h_p, int head, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  Layout y;
  if (in_p % ALIGN || w_p % ALIGN || v_p % ALIGN || h_p % ALIGN ||
      h_p > w_p || v_div < 1 || (n + FBM - 1) / FBM > 0x7fffffffLL ||
      !build_layout(&y, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float* gr = static_cast<float*>(grads);
  float* dxf = static_cast<float*>(dx);
  float* dvf = static_cast<float*>(dv);
  unsigned char* ws = static_cast<unsigned char*>(workspace_buf);
  if (use_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* wb = static_cast<const bf16*>(w);
    return head == SPLIT
               ? launch_bf16<SPLIT>(xb, vb, v_div, gf, wb, bf, gr, dxf, dvf,
                                    ws, n, y, s)
               : launch_bf16<FOLDED>(xb, vb, v_div, gf, wb, bf, gr, dxf, dvf,
                                     ws, n, y, s);
  }
  return launch_f32(static_cast<const float*>(x),
                    static_cast<const float*>(v), v_div, gf,
                    static_cast<const float*>(w), bf, gr, dxf, dvf, ws, n, y,
                    s);
}

const char* plnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
