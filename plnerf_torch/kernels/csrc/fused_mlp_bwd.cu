// Fused NeRF-MLP backward for Hopper (sm_90a).
//
// Replaces the TPU kernel plnerf/kernels/fused_mlp.py `_bwd_kernel`
// (launched by `_backward` through pl.pallas_call) for the viewdirs
// topology, split and folded head schedules.  Given the packed weights
// (row-major [K, N] blocks at the forward's offsets, see fused_mlp_fwd.cu;
// bf16 also as the data pass's weight stream), x [N, in_p], v [N / v_div,
// v_p] and the cotangent g of raw [N, 4], it writes dx [N, in_p] and dv
// [N, v_p] (fp32, dv per point) and the fp32 grads of every packed weight
// block and bias, in the packed order, into one buffer.
//
// Only bf16 recomputes the forward (its forward keeps its activations on
// chip and stores none).  fp32 is given the forward's activations `acts`
// [N, Ca] (acts_layout.cuh): in training the fp32 forward writes them
// (fused_mlp_fwd.cu, FusedMLPFunction), and a standalone call
// (fused_mlp.py backward_cuda) runs that forward first.  The fp32
// workspace holds no acts.
//
// Bound: operations.  The fp32 backward does 2.37 MFLOP per point split,
// 2.11 folded (the data and weight grads, twice the forward's 1.19 /
// 1.06), bf16 3.56 / 3.17 with its recompute (chip_smoke.py
// bwd_flops_per_point), against ~1 KB per point of x, v, g, dx and dv; at
// one fine pass of a 1024-ray step (196,608 points) that is 7.0 / 6.2 ms
// at the H100's 67 TFLOP/s in fp32 and 0.71 / 0.63 ms at 989 in bf16.
// Both dtypes keep their intermediates in a workspace in device memory
// (below); in bf16 that traffic, ~11 KB per point written and read once,
// is a floor of ~1.2 ms (chip_smoke.py bwd_byte_floor), above the
// operation bound.  What bounds each pass on this card:
//  - fp32 data pass: a K = N = 256 product over points does 64 FLOP per
//    byte even with its input and output in device memory, above the fp32
//    ridge of 20 FLOP/B (67 TFLOP/s over 3.35 TB/s).  The FMA pipes set the
//    pace, so every layer is its own launch of one SGEMM core and nothing
//    has to stay on chip from layer to layer.
//  - bf16 data pass: the same product is 128 FLOP/B, under the bf16 ridge
//    (295 FLOP/B), so the walk from layer to layer stays in shared memory
//    and only its results leave, by bulk stores off the critical path.
//    The tensor cores wait while a product's epilogue runs (bias, relu,
//    the relu masks, the bf16 stores into the tile): that and the weight
//    stream from L2 set its pace.
//  - weight pass: A^T @ dA over the points.  fp32 on the FMA pipes; bf16
//    on the tensor cores at 87 FLOP per byte read, so bound by reading the
//    two images (from L2, and once from device memory).
//
// Passes on one stream, no floating-point atomics, so two calls on the
// same inputs give bit-identical results:
//
// fp32:
// 0. transpose_kernel writes every weight block transposed ([N, K] at
//    its offset) into the workspace (`wt`), cot_data_kernel d_rgb and the
//    d_alpha block of the cotangent.
// 1. The data pass backpropagates through the heads and the layers from
//    the forward's activations (every pre-relu grad to `dacts`); dx and
//    dv are written per point.  Each data grad da @ W^T reads the
//    transposed blocks (`wt`), so it is the same [K, N] row-major product
//    as the forward's.  One launch of sgemm_data_kernel per product, in
//    order: heads, data grads (relu mask read from acts as 16-byte rows,
//    to dacts), dx (the first skip layer's x block writes it, later x
//    blocks and layer 0 add to it in that fixed order), dv.  The core
//    (sgemm_core.cuh, shared with the forward's fp32 path): a CTA tile of
//    128 points x 128 columns, 256 threads with an 8 x 8 outer product
//    each, k-slabs of 16 through a 3-stage ring of 16-byte cp.async copies
//    (both operands, so each weight byte is fetched once per CTA), every
//    FMA operand read by LDS.128, ragged points and columns masked; 2 CTAs
//    per SM.
// 2. weight_kernel(Jobs): every dW block is A^T @ dA over the points (A
//    the block's input: x, v, a relu output, the feature; dA its output
//    grad), both point-major in the workspace, on the SGEMM core with both
//    operands k-major (no transposing).  One CTA computes a 128 x 128 tile
//    of one block over one chunk of points and writes it to its own slot
//    of a partial buffer (on the TPU the sequential grid accumulated in
//    place); the chunks are sized so that the grid is whole waves of 2
//    CTAs per SM; the CTAs holding dW rows 0..127 of the block that owns a
//    db also sum its dA columns.  Only live CTAs are launched.
// 3. reduce_kernel sums the partials over the chunks in chunk order.
//
// bf16, all products on wgmma.mma_async (wgmma_core.cuh):
// 1. data_kernel: one CTA of two consumer warpgroups (64 points each)
//    and a producer warp per 128 points walks the plan of build_dplan:
//    the forward recomputed (every relu output kept in the tile and its
//    mask as bits), then the heads' and layers' data grads, dx and dv.
//    A is the tile in shared memory ([warpgroup][32-column chunk][64
//    rows][64 bytes], the 64-byte swizzle, K-major), B a slab of the
//    weight stream (python fused_mlp.bwd_stream: per product, term and
//    32-row k-slab the image of W for the recompute, of W^T for a data
//    grad), streamed through an mbarrier ring by 1-D bulk copies as the
//    forward's bf16_kernel streams its own.  Each product is one pass of
//    N <= 256 columns: its epilogue overwrites its input in place (bias
//    at the accumulators' start; relu and the mask bits recorded, or the
//    recorded bits applied, in the accumulators' fragment order, so a
//    thread reads back only its own words; then bf16 stores), and one
//    thread of the warpgroup stores the new tile to the workspace image
//    by one bulk store, which the next product's wgmmas overlap.  dx and
//    dv go from the
//    accumulators to device memory (the dx written earlier is the later
//    product's accumulator start).  The cotangent's d_rgb, then d_alpha,
//    take the views tile once v is no longer read.  Padded points (past
//    n in the last tile) have zero cotangent, so every grad of theirs is
//    0 and they add nothing to the weight pass.
// 2. weight_kernel(WJobs): every dW = A^T @ dA with both operands read
//    MN-major (transposed wgmma operands, `sw64_mn_desc`) straight from
//    the images: no transposing copy.  One CTA per tile of 128 dW rows
//    by <= 256 columns of a block, over one chunk of 64-point row blocks,
//    each row block one stage of a 4-deep ring filled by two bulk copies;
//    the CTAs of a block that owns a db share out the sums of its dA
//    columns, from the same stages while the wgmmas run; the chunks give
//    8 waves of one CTA per SM.
// 3. reduce_kernel, as fp32.
//
// Shared memory per CTA (8x256 MLP, input 64, views 32; chip_smoke.py's
// env line): fp32 cores 55,296 B (3 stages of 128 x 20 + 16 x 128
// floats); bf16 data_kernel 226,400 B of the 232,448 a CTA may use: the
// activation tile 65,536 (256 columns; no padding rows in the swizzle),
// x 16,384, views / d_rgb / d_alpha 8,192, relu-mask bits 36,864 (9
// slots x 4 words x 256 threads), a 6-stage ring of 16 KB stages (as many
// stages as fit, 2 to 8; fewer than 2 and the wrapper raises), 1,024 of
// alignment, barriers; bf16 weight_kernel 205,888 B (4 stages of 48 KB,
// 8 KB of db sums).
//
// Registers (ptxas -v for sm_90a, chip_smoke.py's env line): no
// spills anywhere.  sgemm_data_kernel 128 (__launch_bounds__(256, 2));
// weight_kernel(Jobs) 128, 2 CTAs per SM; data_kernel 168 and
// weight_kernel(WJobs) 167 (__launch_bounds__(288, 1), one CTA per SM);
// transpose_kernel 32, cot_data_kernel 12, reduce_kernel 28.
//
// Workspace (one buffer, size from plnerf_fused_mlp_bwd_workspace):
// fp32 (acts, the forward's, are given: acts_layout.cuh)
//   wt    [n_w]: the weight blocks transposed
//   dacts [N, Cd]: da_0 .. da_{L-1} (w_p each), then split: [dfeat |
//         d_alpha] (w_p + 32), da_v (h_p), d_rgb (32); folded: [da_v |
//         d_alpha] (h_p + 32), d_rgb (32)
// bf16, images of whole 128-point tiles, [row block of 64 points][32-
// column chunk][64 rows][64 bytes] in the 64-byte swizzle
//   acts  [x | v per point | the fp32 acts' columns]
//   dacts the fp32 dacts' columns
// both
//   partials [n_chunks, n_grad] fp32
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "acts_layout.cuh"
#include "sgemm_core.cuh"
#include "wgmma_core.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps in every fp32 kernel
constexpr int ALIGN = 32;     // K / N granularity of every packed block
constexpr int MAX_LAYERS = 16;
constexpr int MAX_BLK = 2 * MAX_LAYERS + 4;
constexpr int MAX_BIAS = MAX_LAYERS + 3;
// fp32 weight-pass grid: point chunks so that the tiles fill WAVES waves
// of two CTAs on each of the H100's 132 SMs (a fixed count: the chunking,
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
  const bool split = head == SPLIT;  // the acts: acts_layout.cuh
  for (int i = 0; i < L; ++i) y->act[i] = (int)acts_col(i, w_p);
  y->feat = (int)acts_col(L, w_p);
  y->zhv = (int)acts_col(acts_kept(L, split) - 1, w_p);
  y->Ca = (int)acts_width(L, split, w_p, h_p);
  int c = 0;
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
// 32 x 32 tile per CTA through shared memory (fp32).
__global__ void __launch_bounds__(THREADS)
transpose_kernel(const float* __restrict__ w, float* __restrict__ wt,
                 const Layout y) {
  __shared__ float tile[32][33];
  int t = blockIdx.x, j = 0;
  for (; j + 1 < y.n_blk; ++j) {
    const int tiles = (y.wk[j] / 32) * (y.wn[j] / 32);
    if (t < tiles) break;
    t -= tiles;
  }
  const int K = y.wk[j], N = y.wn[j];
  const int k0 = (t / (N / 32)) * 32, n0 = (t % (N / 32)) * 32;
  const float* src = w + y.woff[j];
  float* dst = wt + y.woff[j];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += THREADS / 32)
    tile[r][tx] = src[(long long)(k0 + r) * N + n0 + tx];
  __syncthreads();
  for (int r = ty; r < 32; r += THREADS / 32)
    dst[(long long)(n0 + r) * K + k0 + tx] = tile[tx][r];
}


// d_rgb = [g0 g1 g2 0 ..] (32 columns) and the d_alpha block
// [g3 0 ..] (32 columns, the last of dcat) into dacts (fp32)
__global__ void __launch_bounds__(THREADS)
cot_data_kernel(const float* __restrict__ g, float* __restrict__ dacts,
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
  dacts[r * Cd + col] = val;
}

// ---------------------------------------------- fp32 SGEMM core -------

// One launch per data-pass product (sgemm_core.cuh).
__global__ void __launch_bounds__(THREADS, 2)
sgemm_data_kernel(const FOp op, long long n) {
  sgemm_tile<false>(op, n);
}

// ------------------------------------------ bf16 data pass (wgmma) -----

constexpr int DBM = 128;                 // points per CTA, 64 a warpgroup
constexpr int DCONS = 256;               // two consumer warpgroups
constexpr int DTHREADS = DCONS + 32;     // and one producer warp
constexpr int CONSUMER_WARPS = DCONS / 32;
constexpr int KC = 32;                   // k rows per weight slab
constexpr int MAX_NP = 256;              // widest wgmma N
constexpr int STAGE_BYTES = MAX_NP * KC * 2;  // 16 KB
constexpr int CHUNK = 64 * 64;           // 32 columns of 64 rows, bytes
constexpr int MASK_WORDS = MAX_NP / 64;  // relu-mask words a thread keeps
constexpr int MAX_STAGES = 8;
constexpr int MAX_DPRODS = 3 * MAX_LAYERS + 8;

// A product's operand tiles.  S_V holds v, then (once the views layer is
// recomputed) d_rgb, then (once da_v is out) d_alpha.
enum Src { S_X = 0, S_V = 1, S_T = 2 };
// where its output goes: in place into T (bf16, then a workspace image),
// or fp32 rows of dx / dv in device memory
enum Out { O_T = 0, O_DX = 1, O_DV = 2 };
enum Img { I_ACTS = 0, I_DACTS = 1 };
enum Fill { F_NONE = 0, F_RGB = 1, F_ALPHA = 2 };
// an epilogue into T: relu and its mask bits recorded, the recorded mask
// bits of an earlier product applied, or neither
enum Mode { M_PLAIN = 0, M_RECORD = 1, M_APPLY = 2 };

// One product of the walk:  out = sum_t A_t @ B_t  over np columns, one
// wgmma pass.  A_t: tile src[t], K[t] columns; B_t: K[t] / 32 slabs of
// the weight stream.  Accumulators start at bias (element offset in the
// bias buffer, -1: none), or at the dx written before (acc), or at 0.
// O_T: with mset >= 0 relu, its mask bits recorded in slot mset; with
// mget >= 0 the mask bits of slot mget applied; written in place into T
// and stored to image img at column col; then fill (F_RGB / F_ALPHA)
// writes the cotangent's block into the S_V tile and stores it to the
// dacts image at column fcol.
struct DProd {
  short nterms, src[2], K[2], np, out, mset, mget, img, col, acc, fill,
      fcol;
  int bias;
};
struct DPlan {
  DProd p[MAX_DPRODS];
  int n, slots;      // products; relu-mask slots (L layers and z_hv)
  long long stream;  // weight-stream elements the walk reads
};

// The bf16 data pass as one walk (the weight stream follows it: python
// fused_mlp._bwd_products).  Image columns: acts [x | v | relu_0 ..
// relu_{L-1} | (split) feature | z_hv], dacts the Layout's Cd columns.
void build_dplan(DPlan* pl, const Layout& y) {
  *pl = DPlan{};
  const int in_p = y.in_p, w_p = y.w_p, v_p = y.v_p, h_p = y.h_p, L = y.L;
  const int a0 = in_p + v_p;  // first relu output in the acts image
  pl->slots = L + 1;
  auto prod = [&](int np) -> DProd& {
    DProd& q = pl->p[pl->n++];
    q.np = (short)np;
    q.mset = q.mget = -1;
    q.bias = -1;
    return q;
  };
  auto term = [&](DProd& q, int src, int K) {
    q.src[q.nterms] = (short)src;
    q.K[q.nterms++] = (short)K;
    pl->stream += (long long)K * q.np;
  };
  auto img = [](DProd& q, int which, int col) {
    q.img = (short)which;
    q.col = (short)col;
  };
  auto bias = [&](DProd& q, int i) { q.bias = (int)(y.boff[i] - y.n_w); };
  auto fill = [](DProd& q, int f, int col) {
    q.fill = (short)f;
    q.fcol = (short)col;
  };
  // forward recompute: each relu output to T and acts, its mask bits kept
  for (int i = 0; i < L; ++i) {
    DProd& q = prod(w_p);
    q.mset = (short)i;
    bias(q, i);
    img(q, I_ACTS, a0 + y.act[i]);
    if (y.blk_x[i] >= 0) {
      term(q, S_X, in_p);
      term(q, S_T, w_p);
    } else {
      term(q, i == 0 ? S_X : S_T, i == 0 ? in_p : w_p);
    }
  }
  if (y.head == SPLIT) {
    DProd& f = prod(w_p);  // feature
    bias(f, L);
    img(f, I_ACTS, a0 + y.feat);
    term(f, S_T, w_p);
    DProd& z = prod(h_p);  // z_hv = relu(feature @ Wvf + v @ Wvv + bv)
    z.mset = (short)L;
    bias(z, L + 1);
    img(z, I_ACTS, a0 + y.zhv);
    fill(z, F_RGB, y.drgb);
    term(z, S_T, w_p);
    term(z, S_V, v_p);
    // ---- backward.  da_v = [z_hv > 0] (d_rgb @ Wr^T)
    DProd& dav = prod(h_p);
    dav.mget = (short)L;
    img(dav, I_DACTS, y.dav);
    fill(dav, F_ALPHA, y.dalpha);
    term(dav, S_V, ALIGN);
    DProd& dvp = prod(v_p);  // dv = da_v @ Wvv^T
    dvp.out = O_DV;
    term(dvp, S_T, h_p);
    DProd& df = prod(w_p);  // dfeat = da_v @ Wvf^T
    img(df, I_DACTS, y.dcat);
    term(df, S_T, h_p);
    DProd& d = prod(w_p);  // da_{L-1} = [relu > 0] ([dfeat | d_alpha] Waf^T)
    d.mget = (short)(L - 1);
    img(d, I_DACTS, y.da[L - 1]);
    term(d, S_T, w_p);
    term(d, S_V, ALIGN);
  } else {
    DProd& z = prod(h_p);  // z_hv = relu((h @ Wfa + v @ Wvv + bfa)[:, :h_p])
    z.mset = (short)L;
    bias(z, L);
    img(z, I_ACTS, a0 + y.zhv);
    fill(z, F_RGB, y.drgb);
    term(z, S_T, w_p);
    term(z, S_V, v_p);
    DProd& dav = prod(h_p);  // da_v = [z_hv > 0] (d_rgb @ Wr^T)
    dav.mget = (short)L;
    img(dav, I_DACTS, y.dcat);
    fill(dav, F_ALPHA, y.dalpha);
    term(dav, S_V, ALIGN);
    DProd& dvp = prod(v_p);  // dv = [da_v | d_alpha] @ Wvv^T
    dvp.out = O_DV;
    term(dvp, S_T, h_p);
    term(dvp, S_V, ALIGN);
    DProd& d = prod(w_p);  // da_{L-1} = [relu > 0] ([da_v | d_alpha] Wfa^T)
    d.mget = (short)(L - 1);
    img(d, I_DACTS, y.da[L - 1]);
    term(d, S_T, h_p);
    term(d, S_V, ALIGN);
  }
  // pts layers, last to first.  dx: the first x block met writes it, every
  // later one and layer 0 add to it, in that fixed order.
  int dx_set = 0;
  for (int i = L - 1; i >= 0; --i) {
    if (y.blk_x[i] >= 0) {  // dx (+)= da_i @ Wx_i^T
      DProd& q = prod(in_p);
      q.out = O_DX;
      q.acc = (short)dx_set;
      term(q, S_T, w_p);
      dx_set = 1;
    }
    if (i > 0) {  // da_{i-1} = [relu_{i-1} > 0] (da_i @ Wh_i^T)
      DProd& q = prod(w_p);
      q.mget = (short)(i - 1);
      img(q, I_DACTS, y.da[i - 1]);
      term(q, S_T, w_p);
    } else {  // dx (+)= da_0 @ W_0^T
      DProd& q = prod(in_p);
      q.out = O_DX;
      q.acc = (short)dx_set;
      term(q, S_T, w_p);
    }
  }
}

// Shared-memory addresses: the tiles (each [warpgroup][chunk][64 rows][64
// bytes], a warpgroup's rows `*w` bytes), the ring and its barriers.
struct DSmem {
  uint32_t t, x, v, ring, full, empty;
  uint32_t tw, xw, vw;
  __device__ __forceinline__ uint32_t tile(int s, int wg) const {
    return s == S_T ? t + wg * tw : s == S_X ? x + wg * xw : v + wg * vw;
  }
};

// What one consumer thread of the walk needs.
struct DCtx {
  DSmem sm;
  uint32_t* mask;            // relu-mask words [slot][word][thread]
  int nstage, wg, tid;       // tid: thread of the warpgroup
  long long row0, n, rb;     // the warpgroup's first point; points; row block
  const float* bias;
  float* dx;
  float* dv;
  int in_p, v_p;
  unsigned char* acts;       // the images
  unsigned char* dacts;
  long long acts_rb, dacts_rb;  // their bytes per row block
  float4 g;                  // the cotangent of point row0 + tid / 2
};

// One product for the calling warpgroup (rows 64 wg .. + 64): every
// k-slab of every term from the ring (slab: the ring's running count, as
// the producer counts it), released once this warp's wgmma reads of it
// are done, then the epilogue.  The epilogue into T runs in place: all
// np output columns are in registers once the wgmmas are done, and each
// warpgroup reads and writes only its own rows.  MODE: the product's
// Mode (its mset / mget), so that each epilogue runs only its own mask
// code.
template <int NP, int MODE>
__device__ __forceinline__ void dpass(const DProd& q, const DCtx& c,
                                      int& slab) {
  const int lane = c.tid & 31;
  // accumulator fragment: rows r_lo (registers 4 j, 4 j + 1) and r_lo + 8
  // (4 j + 2, 4 j + 3), columns 8 j + cq and 8 j + cq + 1
  const int r_lo = ((c.tid >> 5) << 4) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[NP / 2];
  if (q.bias >= 0) {
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const float2 b = __ldg(
          reinterpret_cast<const float2*>(c.bias + q.bias + 8 * j + cq));
      acc[4 * j] = acc[4 * j + 2] = b.x;
      acc[4 * j + 1] = acc[4 * j + 3] = b.y;
    }
  } else if (q.acc) {  // the dx this thread wrote in an earlier product
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = c.row0 + r_lo + 8 * h;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        float2 o = make_float2(0.f, 0.f);
        if (p < c.n)
          o = *reinterpret_cast<const float2*>(c.dx + p * c.in_p + 8 * j + cq);
        acc[4 * j + 2 * h] = o.x;
        acc[4 * j + 2 * h + 1] = o.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  }
  const int first = slab;
#pragma unroll 1
  for (int t = 0; t < q.nterms; ++t) {
    const uint32_t a0 = c.sm.tile(q.src[t], c.wg);
    const int nk = q.K[t] / KC;
#pragma unroll 1
    for (int kc = 0; kc < nk; ++kc, ++slab) {
      const int st = slab % c.nstage;
      mbar_wait(c.sm.full + 8 * st, (slab / c.nstage) & 1);
      const uint64_t da = sw64_desc(a0 + kc * CHUNK);
      const uint64_t db = sw64_desc(c.sm.ring + st * STAGE_BYTES);
      wgmma_fence();
      wgmma_k16<NP>(acc, da, db);
      wgmma_k16<NP>(acc, da + 2, db + 2);  // +32 bytes: k 16 .. 31
      wgmma_commit();
      if (slab > first) {
        wgmma_wait<1>();
        if (lane == 0)
          mbar_arrive(c.sm.empty + 8 * ((slab - 1) % c.nstage));
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) reg_fence(acc[i]);
  if (lane == 0) mbar_arrive(c.sm.empty + 8 * ((slab - 1) % c.nstage));

  if (q.out != O_T) {  // fp32 rows of dx or dv, points < n
    float* const out = q.out == O_DX ? c.dx : c.dv;
    const int ld = q.out == O_DX ? c.in_p : c.v_p;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = c.row0 + r_lo + 8 * h;
      if (p >= c.n) continue;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
        *reinterpret_cast<float2*>(out + p * ld + 8 * j + cq) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    return;
  }
  // in place: this warpgroup's wgmma reads of T are over, and so are the
  // bulk stores' reads of what T held (one thread issued them)
  if (c.tid == 0) bulk_wait_read<0>();
  wg_sync(c.wg);
  // relu-mask bits in fragment order: bit 4 j + 2 h + e of the thread's
  // word j / 8 is column 8 j + cq + e of row r_lo + 8 h
  constexpr int WORDS = (NP + 63) / 64;
  uint32_t* const mine = c.mask + c.wg * 128 + c.tid;
  uint32_t keep[WORDS], pos[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    keep[w] = MODE == M_APPLY ? mine[(q.mget * MASK_WORDS + w) * DCONS] : 0u;
    pos[w] = 0u;
  }
  const uint32_t dst = c.sm.t + c.wg * c.sm.tw + (lane & 3) * 4;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      const int b = (4 * j + 2 * h) & 31;
      float lo = acc[4 * j + 2 * h], hi = acc[4 * j + 2 * h + 1];
      if (MODE == M_APPLY) {
        // where(relu output > 0, grad, 0), then rounded, as the reference
        const uint32_t k = keep[j >> 3] >> b;
        lo = (k & 1u) ? lo : 0.f;
        hi = (k & 2u) ? hi : 0.f;
      }
      // the relu output rounds to a bf16 value > 0 iff z > 2^-134 (half
      // the least bf16 subnormal rounds to 0 under round-to-nearest-even;
      // NaN compares false)
      if (MODE == M_RECORD)
        pos[j >> 3] |= (lo > 0x1p-134f ? 1u << b : 0u) |
                       (hi > 0x1p-134f ? 2u << b : 0u);
      __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      // relu after rounding is rounding after relu; NaN passes, as
      // jnp.maximum(x, 0) lets it
      if (MODE == M_RECORD) v = __hmax2_nan(v, zero);
      const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
      // (r, 8 j + cq) in the 64-byte swizzle: 16-byte group j & 3 of
      // chunk j / 4, stored at group (j & 3) ^ ((r >> 1) & 3)
      st_shared_u32(dst + (j >> 2) * CHUNK + r * 64 +
                        (((j & 3) ^ ((r >> 1) & 3)) << 4),
                    u);
    }
  if (MODE == M_RECORD)
#pragma unroll
    for (int w = 0; w < WORDS; ++w) mine[(q.mset * MASK_WORDS + w) * DCONS] =
        pos[w];
  if (q.fill != F_NONE) {  // [g0 g1 g2 0 ..] or [g3 0 ..] into S_V, 32 wide
    const int r = c.tid >> 1;
    const uint32_t row = c.sm.v + c.wg * c.sm.vw + r * 64;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gi = (c.tid & 1) * 2 + e;
      uint32_t w0 = 0u, w1 = 0u;
      if (gi == 0) {
        w0 = q.fill == F_RGB ? pack_bf16x2(c.g.x, c.g.y)
                             : pack_bf16x2(c.g.w, 0.f);
        w1 = q.fill == F_RGB ? pack_bf16x2(c.g.z, 0.f) : 0u;
      }
      const uint32_t a = row + ((gi ^ ((r >> 1) & 3)) << 4);
      st_shared_u32(a, w0);
      st_shared_u32(a + 4, w1);
      st_shared_u32(a + 8, 0u);
      st_shared_u32(a + 12, 0u);
    }
  }
  // the next product reads T (and S_V) through wgmma, the bulk stores
  // through the copy engine
  fence_proxy_async();
  wg_sync(c.wg);
  if (c.tid == 0) {
    unsigned char* const row = q.img == I_ACTS ? c.acts + c.rb * c.acts_rb
                                               : c.dacts + c.rb * c.dacts_rb;
    bulk_store(row + (long long)q.col * 128, c.sm.t + c.wg * c.sm.tw,
               NP * 128);
    if (q.fill != F_NONE)
      bulk_store(c.dacts + c.rb * c.dacts_rb + (long long)q.fcol * 128,
                 c.sm.v + c.wg * c.sm.vw, KC * 128);
    bulk_commit();
  }
}

// Shared memory of one data-pass CTA without its ring.
long long data_smem_fixed(const Layout& y) {
  return 1024LL + 256LL * (y.w_p + y.in_p + y.v_p) +
         (long long)(y.L + 1) * MASK_WORDS * DCONS * 4;
}

// One CTA per 128 points: the walk of `plan` on two consumer warpgroups
// of 64 rows, the weight stream through an nstage-deep ring filled by a
// producer warp.  ca, cd: columns of the acts and dacts images.
__global__ void __launch_bounds__(DTHREADS, 1)
data_kernel(const __grid_constant__ DPlan plan, const bf16* __restrict__ x,
            const bf16* __restrict__ v, long long v_div,
            const unsigned char* __restrict__ wstream,
            const float* __restrict__ bbuf, const float* __restrict__ g,
            unsigned char* acts, unsigned char* dacts,
            float* __restrict__ dx, float* __restrict__ dv, long long n,
            int in_p, int w_p, int v_p, int ca, int cd, int nstage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;  // swizzle atoms
  unsigned char* gbase = smem_raw + (base - raw_base);
  DCtx c;
  c.sm.tw = w_p * 128;
  c.sm.xw = in_p * 128;
  c.sm.vw = v_p * 128;
  c.sm.t = base;
  c.sm.x = c.sm.t + 2 * c.sm.tw;
  c.sm.v = c.sm.x + 2 * c.sm.xw;
  const uint32_t mask = c.sm.v + 2 * c.sm.vw;
  c.mask = reinterpret_cast<uint32_t*>(gbase + (mask - base));
  c.sm.ring = mask + plan.slots * MASK_WORDS * DCONS * 4;
  c.sm.full = c.sm.ring + nstage * STAGE_BYTES;
  c.sm.empty = c.sm.full + 8 * nstage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(c.sm.full + 8 * s, 1);
      mbar_init(c.sm.empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer: the weight stream, in order
    if (lane != 0) return;
    int slab = 0;
    long long off = 0;
    for (int i = 0; i < plan.n; ++i) {
      const DProd& q = plan.p[i];
      const uint32_t bytes = (uint32_t)q.np * KC * 2;
      for (int t = 0; t < q.nterms; ++t)
        for (int kc = 0; kc < q.K[t] / KC; ++kc, ++slab) {
          const int st = slab % nstage;
          mbar_wait(c.sm.empty + 8 * st, ((slab / nstage) & 1) ^ 1);
          mbar_expect_tx(c.sm.full + 8 * st, bytes);
          bulk_copy(c.sm.ring + st * STAGE_BYTES, wstream + off, bytes,
                    c.sm.full + 8 * st);
          off += bytes;
        }
    }
    // stay until the consumers have released the last stages
    for (int k = 0; k < nstage && slab > 0; ++k, ++slab)
      mbar_wait(c.sm.empty + 8 * (slab % nstage),
                ((slab / nstage) & 1) ^ 1);
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 64 of every tile
  c.nstage = nstage;
  c.wg = threadIdx.x >> 7;
  c.tid = threadIdx.x & 127;
  c.row0 = (long long)blockIdx.x * DBM + c.wg * 64;
  c.n = n;
  c.rb = 2LL * blockIdx.x + c.wg;
  c.bias = bbuf;
  c.dx = dx;
  c.dv = dv;
  c.in_p = in_p;
  c.v_p = v_p;
  c.acts = acts;
  c.dacts = dacts;
  c.acts_rb = (long long)ca * 128;
  c.dacts_rb = (long long)cd * 128;
  c.g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c.row0 + (c.tid >> 1) < n)
    c.g = __ldg(reinterpret_cast<const float4*>(g) + c.row0 + (c.tid >> 1));
  auto stage_rows = [&](uint32_t tile, const bf16* src, int cols,
                        long long div) {
    const int ch = cols / 8;
    for (int e = c.tid; e < 64 * ch; e += 128) {
      const int r = e / ch;
      const int col = (e % ch) * 8;
      const long long p = c.row0 + r;
      const bool ok = p < n;
      const long long sr = ok ? (div == 1 ? p : p / div) : 0;
      cp_async16(gbase + (tile - base) + sw64<64>(r, col),
                 src + sr * cols + col, ok);
    }
  };
  stage_rows(c.sm.tile(S_X, c.wg), x, in_p, 1);
  stage_rows(c.sm.tile(S_V, c.wg), v, v_p, v_div);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  wg_sync(c.wg);
  if (c.tid == 0) {  // x and the per-point views head the acts image
    unsigned char* row = acts + c.rb * c.acts_rb;
    bulk_store(row, c.sm.tile(S_X, c.wg), in_p * 128);
    bulk_store(row + (long long)in_p * 128, c.sm.tile(S_V, c.wg),
               v_p * 128);
    bulk_commit();
  }

  int slab = 0;
#pragma unroll 1
  for (int i = 0; i < plan.n; ++i) {
    const DProd& q = plan.p[i];
    const int mode = q.mset >= 0 ? M_RECORD : q.mget >= 0 ? M_APPLY : M_PLAIN;
    switch (q.np) {
#define PLNERF_DPASS(NP)                                       \
  case NP:                                                     \
    if (mode == M_RECORD) dpass<NP, M_RECORD>(q, c, slab);     \
    else if (mode == M_APPLY) dpass<NP, M_APPLY>(q, c, slab);  \
    else dpass<NP, M_PLAIN>(q, c, slab);                       \
    break;
      PLNERF_DPASS(256) PLNERF_DPASS(224) PLNERF_DPASS(192)
      PLNERF_DPASS(160) PLNERF_DPASS(128) PLNERF_DPASS(96)
      PLNERF_DPASS(64) PLNERF_DPASS(32)
#undef PLNERF_DPASS
    }
  }
  if (c.tid == 0) bulk_wait_all();  // the images are in device memory
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
                            int m0, int n0, bool with_db, float* out) {
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

// grid (tiles, chunks): CTA (tile, chunk) writes its tile of its job's
// block, summed over the chunk's points, to partial row `chunk`.
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
              jb.bias_out >= 0 && mt == 0, partial + blockIdx.y * n_grad);
}

// bf16: every dW = A^T @ dA on wgmma, both operands read MN-major
// straight from the images the data pass stored (`sw64_mn_desc`): a
// stage is one row block of 64 points, its A columns [m0, m0 + Mw) and dA
// columns [n0, n0 + Nw), two bulk copies.  One CTA per tile of 128 dW
// rows (64 a consumer warpgroup; a second warpgroup only where the block
// has more than 64 rows) by at most 256 columns, over one chunk of row
// blocks; the CTAs of a block that owns a db share out the sums of its
// dA columns, from the same stages, while the wgmmas run.
constexpr int WM = 128, WN = 256, WSTAGES = 4;
constexpr int W_A = WM * 128;           // 128 A columns of 64 points: 16 KB
constexpr int W_STAGE = W_A + WN * 128;  // + 256 dA columns: 48 KB
constexpr int W_DB = DCONS * 8 * 4;     // db partial sums, 8 per thread
constexpr int W_SMEM = 1024 + WSTAGES * W_STAGE + W_DB + 16 * WSTAGES;
constexpr int W_WAVES = 8;              // the grid: whole waves of 1 CTA/SM

struct WJob {
  long long acol, dcol;  // first column of A (acts image), of dA (dacts)
  int K, N;              // dW rows (A columns), dW columns (dA columns)
  long long out;         // dW offset in a partial row
  long long bias_out;    // db offset in a partial row, -1: none
  int n_tiles, tile0;    // column tiles; first tile in the grid
};
struct WJobs {
  WJob j[MAX_BLK];
  int n, tiles;
  long long chunk;  // row blocks per chunk
};

// Columns [n0, n0 + NW) of the CTA's tile.  nst: stages (row blocks);
// db: the sums of its dA columns [n0 + d0, n0 + d0 + dn) (dn a multiple
// of 8, 0: none).
template <int NW>
__device__ __forceinline__ void wpass(const WJob& jb, int m0, int n0,
                                      int nwg, int d0, int dn, int nst,
                                      uint32_t ring, uint32_t full,
                                      uint32_t empty,
                                      const unsigned char* ringp,
                                      float* scratch, float* out) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  // db: thread t < nrs G sums the 8 columns of group t % G over rows
  // t / G + k nrs
  const int G = dn / 8 > 0 ? dn / 8 : 1;
  const int nthr = nwg * 128, ct = threadIdx.x;
  const int gi = ct % G, rs = ct / G, nrs = nthr / G;
  const bool summer = dn > 0 && rs < nrs;
  const int gc = d0 / 8 + gi;  // the group's 8 columns in the tile
  float db[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) db[e] = 0.f;
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    const int st = s % WSTAGES;
    mbar_wait(full + 8 * st, (s / WSTAGES) & 1);
    const uint32_t a = ring + st * W_STAGE + wg * 2 * CHUNK;
    const uint32_t d = ring + st * W_STAGE + W_A;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 points: 16 rows, 1024 bytes
      wgmma_k16<NW, 1>(acc, sw64_mn_desc(a + kk * 1024, CHUNK),
                       sw64_mn_desc(d + kk * 1024, CHUNK));
    wgmma_commit();
    if (summer) {
      const unsigned char* dp = ringp + st * W_STAGE + W_A + (gc >> 2) * CHUNK;
#pragma unroll 1
      for (int r = rs; r < 64; r += nrs) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            dp + r * 64 + (((gc & 3) ^ ((r >> 1) & 3)) << 4));
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          db[2 * e] += f.x;
          db[2 * e + 1] += f.y;
        }
      }
    }
    if (s > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % WSTAGES));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) reg_fence(acc[i]);
  if (nst > 0 && lane == 0) mbar_arrive(empty + 8 * ((nst - 1) % WSTAGES));

  const int r_lo = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r_lo + 8 * h;
    if (m >= jb.K) continue;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < jb.N)
        *reinterpret_cast<float2*>(out + jb.out + (long long)m * jb.N + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if (dn > 0) {  // the row sets' sums, added in row-set order
    if (summer)
#pragma unroll
      for (int e = 0; e < 8; ++e) scratch[rs * dn + 8 * gi + e] = db[e];
    asm volatile("bar.sync 3, %0;\n" ::"r"(nthr) : "memory");
    for (int col = ct; col < dn && n0 + d0 + col < jb.N; col += nthr) {
      float sum = 0.f;
      for (int k = 0; k < nrs; ++k) sum += scratch[k * dn + col];
      out[jb.bias_out + n0 + d0 + col] = sum;
    }
  }
}

// grid (tiles, chunks): CTA (tile, chunk) writes its tile of its job's
// block, summed over the chunk's row blocks, to partial row `chunk`.
// a_rb, d_rb: bytes per row block of the acts and dacts images; nrb: row
// blocks holding points.
__global__ void __launch_bounds__(DTHREADS, 1)
weight_kernel(const __grid_constant__ WJobs jobs,
              const unsigned char* __restrict__ acts,
              const unsigned char* __restrict__ dacts, long long a_rb,
              long long d_rb, long long nrb, long long n_grad,
              float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  const unsigned char* ringp = smem_raw + (base - raw_base);
  float* scratch = reinterpret_cast<float*>(smem_raw + (base - raw_base) +
                                            WSTAGES * W_STAGE);
  const uint32_t ring = base;
  const uint32_t full = base + WSTAGES * W_STAGE + W_DB;
  const uint32_t empty = full + 8 * WSTAGES;
  const int bid = blockIdx.x;
  int ji = 0;
  while (ji + 1 < jobs.n && bid >= jobs.j[ji + 1].tile0) ++ji;
  const WJob& jb = jobs.j[ji];
  const int tile = bid - jb.tile0;
  const int mt = tile / jb.n_tiles, nt = tile - mt * jb.n_tiles;
  const int m0 = mt * WM, n0 = nt * WN;
  const int Mw = min(WM, jb.K - m0), Nw = min(WN, jb.N - n0);
  const int nwg = Mw > 64 ? 2 : 1;
  const long long rb_lo = (long long)blockIdx.y * jobs.chunk;
  const int nst = (int)max(0LL, min(nrb, rb_lo + jobs.chunk) - rb_lo);
  // a block's db: its dA columns shared out among its row tiles' CTAs
  const int mts = (jb.K + WM - 1) / WM, gs = Nw / 8;
  const int d0 = jb.bias_out >= 0 ? gs * mt / mts * 8 : 0;
  const int dn = jb.bias_out >= 0 ? gs * (mt + 1) / mts * 8 - d0 : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * nwg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer: A and dA of each row block
    if (lane != 0) return;
    const uint32_t bytes = (uint32_t)(Mw + Nw) * 128;
    int s = 0;
    for (; s < nst; ++s) {
      const int st = s % WSTAGES;
      const long long rb = rb_lo + s;
      mbar_wait(empty + 8 * st, ((s / WSTAGES) & 1) ^ 1);
      mbar_expect_tx(full + 8 * st, bytes);
      bulk_copy(ring + st * W_STAGE,
                acts + rb * a_rb + (jb.acol + m0) * 128, Mw * 128,
                full + 8 * st);
      bulk_copy(ring + st * W_STAGE + W_A,
                dacts + rb * d_rb + (jb.dcol + n0) * 128, Nw * 128,
                full + 8 * st);
    }
    for (int k = 0; k < WSTAGES && s > 0; ++k, ++s)
      mbar_wait(empty + 8 * (s % WSTAGES), ((s / WSTAGES) & 1) ^ 1);
    return;
  }
  if ((threadIdx.x >> 7) >= nwg) return;  // no dW rows for this warpgroup

  float* out = partial + blockIdx.y * n_grad;
  switch (Nw) {
#define PLNERF_WPASS(NW)                                                    \
  case NW:                                                                  \
    wpass<NW>(jb, m0, n0, nwg, d0, dn, nst, ring, full, empty, ringp,       \
              scratch, out);                                                \
    break;
    PLNERF_WPASS(256) PLNERF_WPASS(224) PLNERF_WPASS(192) PLNERF_WPASS(160)
    PLNERF_WPASS(128) PLNERF_WPASS(96) PLNERF_WPASS(64) PLNERF_WPASS(32)
#undef PLNERF_WPASS
  }
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

Jobs make_jobs(const Layout& y, long long n, const float* x,
               const float* v, long long v_div, const float* acts,
               const float* dacts) {
  Jobs js;
  js.n = 0;
  js.tiles = 0;
  auto act = [&](int col) { return (const void*)(acts + col); };
  auto dac = [&](int col) { return (const void*)(dacts + col); };
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
  long long wt, dacts, partial, total;  // byte offsets, total bytes
  long long n_chunks;
};

// fp32 workspace
Workspace workspace(const Layout& y, long long n) {
  Workspace w;
  const Jobs js = make_jobs(y, n, nullptr, nullptr, 1, nullptr, nullptr);
  w.n_chunks = (n + js.chunk - 1) / js.chunk;
  w.wt = 0;
  w.dacts = align256(y.n_w * 4);
  w.partial = w.dacts + align256(n * y.Cd * 4);
  w.total = w.partial + align256(w.n_chunks * y.n_grad * 4);
  return w;
}

// fp32: weight_kernel over the chunks, then reduce_kernel
int weight_and_reduce(const Layout& y, long long n, const float* x,
                      const float* v, long long v_div, const float* acts,
                      const float* dacts, float* partial, long long n_chunks,
                      float* grads, cudaStream_t stream) {
  const Jobs js = make_jobs(y, n, x, v, v_div, acts, dacts);
  // the overload of weight_kernel that takes Jobs
  void (*const wk)(const Jobs, long long, long long, float*) = weight_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      wk, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e != cudaSuccess) return (int)e;
  weight_kernel<<<dim3(js.tiles, (unsigned)n_chunks), THREADS, F_SMEM,
                  stream>>>(js, n, y.n_grad, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(unsigned)((y.n_grad + 255) / 256), 256, 0, stream>>>(
      partial, n_chunks, y.n_grad, grads);
  return (int)cudaGetLastError();
}

// fp32: the transposed weights and the cotangent's workspace columns
int launch_prologue(const Layout& y, const float* w, float* wt,
                    const float* g, float* dacts, long long n,
                    cudaStream_t stream) {
  transpose_kernel<<<(unsigned)(y.n_w / (32 * 32)), THREADS, 0, stream>>>(
      w, wt, y);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = n * 2 * ALIGN;
  cot_data_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                    stream>>>(g, dacts, n, y.Cd, y.drgb, y.dalpha);
  return (int)cudaGetLastError();
}

// fp32: the data pass as one launch of sgemm_data_kernel per product,
// from the forward's activations A [n, Ca]
int launch_f32(const float* x, const float* v, long long v_div,
               const float* g, const float* w, const float* A, float* grads,
               float* dx, float* dv, unsigned char* ws, long long n,
               const Layout& y, cudaStream_t stream) {
  const Workspace wl = workspace(y, n);
  float* wt = reinterpret_cast<float*>(ws + wl.wt);
  float* dacts = reinterpret_cast<float*>(ws + wl.dacts);
  float* partial = reinterpret_cast<float*>(ws + wl.partial);
  int rc = launch_prologue(y, w, wt, g, dacts, n, stream);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      sgemm_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int in_p = y.in_p, w_p = y.w_p, v_p = y.v_p, h_p = y.h_p;
  const long long Ca = y.Ca, Cd = y.Cd;
  auto WTb = [&](int j) { return FTerm{nullptr, 0, 1, 0, wt + y.woff[j],
                                       y.wk[j]}; };
  // t: the B operand (WTb) with A rows a (lda, a_div) of width K
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
  float* D = dacts;
  const int hb = y.hb, L = y.L;
  const float* last = A + y.act[L - 1];

  if (y.head == SPLIT) {
    FOp o = op(h_p, D + y.dav, Cd);  // da_v
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
    FOp o = op(h_p, D + y.dcat, Cd);  // da_v
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
  return weight_and_reduce(y, n, x, v, v_div, A, dacts, partial,
                           wl.n_chunks, grads, stream);
}

// bf16: the weight pass's jobs over the images of build_dplan, and its
// chunks of row blocks: at most W_WAVES whole waves of the grid, at
// least MIN_CHUNK points (the chunking, and so the summation order,
// depends on n and the layout only).
WJobs make_wjobs(const Layout& y, long long n) {
  WJobs js{};
  const long long a0 = y.in_p + y.v_p, xcol = 0, vcol = y.in_p;
  auto add = [&](long long acol, int K, long long dcol, int N, long long out,
                 long long bias_out) {
    WJob& j = js.j[js.n++];
    j.acol = acol; j.K = K; j.dcol = dcol; j.N = N;
    j.out = out; j.bias_out = bias_out;
    j.n_tiles = (N + WN - 1) / WN;
    j.tile0 = js.tiles;
    js.tiles += ((K + WM - 1) / WM) * j.n_tiles;
  };
  for (int i = 0; i < y.L; ++i) {
    if (y.blk_x[i] >= 0)
      add(xcol, y.in_p, y.da[i], y.w_p, y.woff[y.blk_x[i]], -1);
    add(i == 0 ? xcol : a0 + y.act[i - 1], i == 0 ? y.in_p : y.w_p,
        y.da[i], y.w_p, y.woff[y.blk_h[i]], y.boff[i]);
  }
  const int hb = y.hb, L = y.L;
  const long long last = a0 + y.act[L - 1], zhv = a0 + y.zhv;
  if (y.head == SPLIT) {
    add(last, y.w_p, y.dcat, y.w_p + ALIGN, y.woff[hb], y.boff[L]);
    add(a0 + y.feat, y.w_p, y.dav, y.h_p, y.woff[hb + 1], y.boff[L + 1]);
    add(vcol, y.v_p, y.dav, y.h_p, y.woff[hb + 2], -1);
    add(zhv, y.h_p, y.drgb, ALIGN, y.woff[hb + 3], y.boff[L + 2]);
  } else {
    add(last, y.w_p, y.dcat, y.h_p + ALIGN, y.woff[hb], y.boff[L]);
    add(vcol, y.v_p, y.dcat, y.h_p + ALIGN, y.woff[hb + 1], -1);
    add(zhv, y.h_p, y.drgb, ALIGN, y.woff[hb + 2], y.boff[L + 1]);
  }
  const long long nrb = (n + 63) / 64;
  const long long target = (long long)SMS * W_WAVES;
  const long long want = target / js.tiles > 0 ? target / js.tiles : 1;
  const long long chunk = (nrb + want - 1) / want;
  js.chunk = chunk < MIN_CHUNK / 64 ? MIN_CHUNK / 64 : chunk;
  return js;
}

// bf16 workspace: the acts and dacts images ([row block][column chunk][64
// points][64 bytes], whole 128-point tiles), then the partials.
struct BWorkspace {
  long long acts, dacts, partial, total;  // byte offsets, total bytes
  long long n_chunks, ca, cd;             // image columns
};

BWorkspace bworkspace(const Layout& y, long long n) {
  BWorkspace w;
  const long long rbs = 2 * ((n + DBM - 1) / DBM);
  const WJobs js = make_wjobs(y, n);
  w.n_chunks = ((n + 63) / 64 + js.chunk - 1) / js.chunk;
  w.ca = y.in_p + y.v_p + y.Ca;
  w.cd = y.Cd;
  w.acts = 0;
  w.dacts = align256(rbs * w.ca * 128);
  w.partial = w.dacts + align256(rbs * w.cd * 128);
  w.total = w.partial + align256(w.n_chunks * y.n_grad * 4);
  return w;
}

// Ring stages of the data pass that fit beside its tiles (0: fewer than
// two fit).
int data_stages(const Layout& y) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const long long st = (optin - data_smem_fixed(y)) / (STAGE_BYTES + 16);
  return st < 2 ? 0 : (int)(st < MAX_STAGES ? st : MAX_STAGES);
}

// bf16: the data pass as one launch of data_kernel, the weight pass as
// one launch of the wgmma weight_kernel, then reduce_kernel.
int launch_bf16(const bf16* x, const bf16* v, long long v_div,
                const float* g, const unsigned char* wstream,
                long long stream_len, const float* b, float* grads,
                float* dx, float* dv, unsigned char* ws, long long n,
                const Layout& y, cudaStream_t stream) {
  DPlan pl;
  build_dplan(&pl, y);
  if (stream_len != pl.stream) return (int)cudaErrorInvalidValue;
  const int nstage = data_stages(y);
  if (nstage == 0) return (int)cudaErrorInvalidValue;
  const BWorkspace wl = bworkspace(y, n);
  unsigned char* acts = ws + wl.acts;
  unsigned char* dacts = ws + wl.dacts;
  float* partial = reinterpret_cast<float*>(ws + wl.partial);
  const int smem =
      (int)(data_smem_fixed(y) + (long long)nstage * (STAGE_BYTES + 16));
  cudaError_t e = cudaFuncSetAttribute(
      data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  data_kernel<<<(unsigned)((n + DBM - 1) / DBM), DTHREADS, smem, stream>>>(
      pl, x, v, v_div, wstream, b, g, acts, dacts, dx, dv, n, y.in_p, y.w_p,
      y.v_p, (int)wl.ca, (int)wl.cd, nstage);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const WJobs js = make_wjobs(y, n);
  // the overload of weight_kernel that takes WJobs
  void (*const wk)(const WJobs, const unsigned char*, const unsigned char*,
                   long long, long long, long long, long long, float*) =
      weight_kernel;
  e = cudaFuncSetAttribute(wk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           W_SMEM);
  if (e != cudaSuccess) return (int)e;
  weight_kernel<<<dim3(js.tiles, (unsigned)wl.n_chunks), DTHREADS, W_SMEM,
                  stream>>>(
      js, acts, dacts, wl.ca * 128, wl.cd * 128, (n + 63) / 64, y.n_grad,
      partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(unsigned)((y.n_grad + 255) / 256), 256, 0, stream>>>(
      partial, wl.n_chunks, y.n_grad, grads);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

// Shared memory one CTA of the data pass takes, in bytes.  bf16: its
// tiles and the ring stages that fit the current device (two stages, more
// than the device allows, where fewer fit).
long long plnerf_fused_mlp_bwd_smem(int n_layers, int in_p, int w_p,
                                    int v_p, int use_bf16) {
  if (!use_bf16) return (long long)F_SMEM;
  Layout y{};
  y.L = n_layers; y.in_p = in_p; y.w_p = w_p; y.v_p = v_p;
  const int st = data_stages(y);
  return data_smem_fixed(y) + (long long)(st ? st : 2) * (STAGE_BYTES + 16);
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
  return use_bf16 ? bworkspace(y, n).total : workspace(y, n).total;
}

// Ca: columns of the fp32 forward's activations that the data pass reads
// (acts_layout.cuh), 0 for a layout the kernel does not take.
long long plnerf_fused_mlp_bwd_acts_cols(int n_layers, unsigned skip_mask,
                                         int in_p, int w_p, int v_p, int h_p,
                                         int head) {
  Layout y;
  if (!build_layout(&y, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
    return 0;
  return y.Ca;
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

// Elements of the bf16 data pass's weight stream (python
// fused_mlp.bwd_stream), 0 for a layout the kernel does not take.
long long plnerf_fused_mlp_bwd_stream_len(int n_layers, unsigned skip_mask,
                                          int in_p, int w_p, int v_p,
                                          int h_p, int head) {
  Layout y;
  if (!build_layout(&y, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
    return 0;
  DPlan pl;
  build_dplan(&pl, y);
  return pl.stream;
}

// Launches the passes on `stream`; returns cudaGetLastError() of the
// first that fails (0 on success).  w: packed weights, every block [K, N]
// row-major (fp32); wstream: bf16, the data pass's weight stream of
// stream_len elements; b: packed biases (bf16 only); g: [n, 4] fp32; acts
// (fp32 only, and needed there): the forward's activations [n, Ca]
// (acts_layout.cuh).
int plnerf_fused_mlp_bwd(const void* x, const void* v, long long v_div,
                         const void* g, const void* w, const void* wstream,
                         long long stream_len, const void* b,
                         const void* acts, void* grads, void* dx, void* dv,
                         void* workspace_buf, long long n, int n_layers,
                         unsigned skip_mask, int in_p, int w_p, int v_p,
                         int h_p, int head, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  Layout y;
  if (in_p % ALIGN || w_p % ALIGN || v_p % ALIGN || h_p % ALIGN ||
      h_p > w_p || v_div < 1 || (n + FBM - 1) / FBM > 0x7fffffffLL ||
      (use_bf16 && (w_p > MAX_NP || in_p > MAX_NP || v_p > MAX_NP || acts)) ||
      (!use_bf16 && !acts) ||
      !build_layout(&y, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float* gr = static_cast<float*>(grads);
  float* dxf = static_cast<float*>(dx);
  float* dvf = static_cast<float*>(dv);
  unsigned char* ws = static_cast<unsigned char*>(workspace_buf);
  if (use_bf16)
    return launch_bf16(static_cast<const bf16*>(x),
                       static_cast<const bf16*>(v), v_div, gf,
                       static_cast<const unsigned char*>(wstream),
                       stream_len, bf, gr, dxf, dvf, ws, n, y, s);
  return launch_f32(static_cast<const float*>(x),
                    static_cast<const float*>(v), v_div, gf,
                    static_cast<const float*>(w),
                    static_cast<const float*>(acts), gr, dxf, dvf, ws, n, y,
                    s);
}

const char* plnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
