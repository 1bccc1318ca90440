// Fused NeRF-MLP backward for Hopper (sm_90a).
//
// Replaces the TPU kernel plnerf/kernels/fused_mlp.py `_bwd_kernel`
// (launched by `_backward` through pl.pallas_call) for the viewdirs
// topology, split and folded head schedules.  Given the packed weights
// (the forward's layout, see fused_mlp_fwd.cu), x [N, in_p], v [N / v_div,
// v_p] and the cotangent g of raw [N, 4], it writes dx [N, in_p] and dv
// [N, v_p] (fp32, dv per point) and the fp32 grads of every packed weight
// block and bias, in the packed order, into one buffer.
//
// Bound: operations.  Recompute + data grads + weight grads are about three
// times the forward's multiply-adds (~1.78 M MACs per point split, ~1.58 M
// folded, at 8x256), against ~100 values read and ~100 written per point.
//
// Three passes on one stream, no floating-point atomics, so two calls on
// the same inputs give bit-identical results:
//
// 1. `data_kernel` (one CTA per 64-point tile): recomputes the forward,
//    writing every layer's relu output to a global workspace `acts` in the
//    compute dtype (the recompute lists of the TPU kernel do not fit in 227
//    KB of shared memory: 8 x 256 x 64 points is 512 KB in fp32), then
//    backpropagates through the heads and layers.  Each product of the data
//    grads, da @ W^T, reads a transposed copy of the weights (`wt`, packed
//    by the wrapper), so it is the same [K, N] product as the forward's.
//    Relu masks are read back from `acts`; every pre-relu grad `da` goes to
//    a second workspace `dacts`.  dx and dv are written per point.
// 2. `weight_kernel`: every dW block is A^T @ dA over the points, where A
//    is the block's input (x, v, a relu output, the feature) and dA its
//    output grad, both read from global memory; every db is the column sum
//    of dA.  One CTA computes a 64 x 64 tile of one block, or 64 columns of
//    one db, over one chunk of 2,048 points and writes it to its own slot
//    of a partial buffer (on the TPU the sequential grid accumulated in
//    place).
// 3. `reduce_kernel` sums the partials over the chunks in chunk order.
//
// Paths: float32 runs true fp32 FMAs on the CUDA cores (no TF32, as the
// JAX package's Precision.HIGHEST); bfloat16 runs mma.sync m16n8k16 with
// fp32 accumulation, activations and pre-relu grads stored in bf16 (the
// next product rounds them to bf16 anyway, as in the JAX kernel).
// wgmma, TMA and keeping the workspace out of device memory come later.
//
// Workspace (one buffer, size from plnerf_fused_mlp_bwd_workspace):
//   acts  [N, Ca] compute dtype: relu_0 .. relu_{L-1} (w_p each), then
//         split: feature (w_p), z_hv (h_p); folded: z_hv (h_p)
//   dacts [N, Cd] compute dtype: da_0 .. da_{L-1} (w_p each), then
//         split: [dfeat | d_alpha] (w_p + 32), da_v (h_p), d_rgb (32);
//         folded: [da_v | d_alpha] (h_p + 32), d_rgb (32)
//   partials [n_chunks, n_grad] fp32
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // points per CTA of the data kernel
constexpr int THREADS = 256;  // 8 warps
constexpr int ALIGN = 32;     // K / N granularity of every packed block
constexpr int LDF = BM + 4;   // fp32 k-major row
constexpr int PADB = 8;       // bf16 row padding
constexpr int CHUNK = 2048;   // points per weight-grad partial
constexpr int MAX_LAYERS = 16;
constexpr int MAX_BLK = 2 * MAX_LAYERS + 4;
constexpr int MAX_BIAS = MAX_LAYERS + 3;
constexpr int MAX_JOBS = MAX_BLK + MAX_BIAS;

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
  int da[MAX_LAYERS], dcat, dav, drgb, Cd;
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
  y->dav = head == SPLIT ? c : y->dcat; if (head == SPLIT) c += h_p;
  y->drgb = c; c += ALIGN;
  y->Cd = c;
  return 1;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Weight element type of the kernel's buffers: fp32 row-major, bf16 in
// mma fragment order (4 values per uint2).
template <typename T> struct WType { typedef float type; };
template <> struct WType<bf16> { typedef uint2 type; };
__device__ __forceinline__ const float* wptr(const float* w, long long off) {
  return w + off;
}
__device__ __forceinline__ const uint2* wptr(const uint2* w, long long off) {
  return w + off / 4;
}

// What happens to one output element (row, c) of a product:
//   x += bias[c]; relu on c < relu_cols; where mask is set,
//   x = mask[row][c] > 0 ? x : 0 (NaN x passes, as jnp.where);
//   rows < n_valid go to gout (compute dtype) and fout (fp32) where set.
// The caller then stores x to the shared buffer `smem` (c < smem_cols)
// and/or adds it to the shared fp32 accumulator `acc`.
template <typename T>
struct Ep {
  const float* bias;
  int relu_cols;
  const T* mask;
  long long mask_ld;
  T* smem;
  int smem_ld, smem_cols;
  float* acc;
  int acc_ld;
  T* gout;
  long long g_ld;
  int g_cols;
  float* fout;
  long long f_ld;
  int f_cols;
  int n_valid;

  __device__ float value(int row, int c, float x) const {
    if (bias) x += bias[c];
    if (c < relu_cols && x < 0.f) x = 0.f;
    if (mask)
      x = (row < n_valid && to_f(mask[row * mask_ld + c]) > 0.f) ? x : 0.f;
    if (row < n_valid) {
      if (gout && c < g_cols) gout[row * g_ld + c] = from_f<T>(x);
      if (fout && c < f_cols) fout[row * f_ld + c] = x;
    }
    return x;
  }
};

template <typename T>
__device__ Ep<T> ep_none(int n_valid) {
  Ep<T> e;
  e.bias = nullptr; e.relu_cols = 0; e.mask = nullptr; e.mask_ld = 0;
  e.smem = nullptr; e.smem_ld = 0; e.smem_cols = 0; e.acc = nullptr;
  e.acc_ld = 0; e.gout = nullptr; e.g_ld = 0; e.g_cols = 0;
  e.fout = nullptr; e.f_ld = 0; e.f_cols = 0; e.n_valid = n_valid;
  return e;
}

// ---------------------------------------------------------------- fp32 --
// Shared activations are k-major [K][LDF]; `acc` is k-major too.

// out columns n0 .. n0 + 32J of A1 @ W1 + A2 @ W2 (W row stride ldw)
template <int J>
__device__ __forceinline__ void f32_pass(
    const float* A1, int K1, const float* __restrict__ W1, const float* A2,
    int K2, const float* __restrict__ W2, int ldw, int n0,
    const Ep<float>& ep) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;  // warp ty owns points 8ty..8ty+7
  float acc[8][J];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    const float* A = s ? A2 : A1;
    const int K = s ? K2 : K1;
    const float* W = s ? W2 : W1;
    if (K == 0) continue;
    const float* a_ptr = A + ty * 8;
    const float* w_ptr = W + n0 + tx;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float w[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        w[j] = __ldg(w_ptr + (size_t)k * ldw + 32 * j);
      const float4 u = *reinterpret_cast<const float4*>(a_ptr + k * LDF);
      const float4 q = *reinterpret_cast<const float4*>(a_ptr + k * LDF + 4);
      const float a[8] = {u.x, u.y, u.z, u.w, q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = n0 + tx + 32 * j;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = ep.value(ty * 8 + i, c, acc[i][j]);
    if (ep.smem && c < ep.smem_cols) {
      float* p = ep.smem + c * LDF + ty * 8;
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
    if (ep.acc) {
      float4* p = reinterpret_cast<float4*>(ep.acc + c * LDF + ty * 8);
      float4 s0 = p[0], s1 = p[1];
      s0.x += v[0]; s0.y += v[1]; s0.z += v[2]; s0.w += v[3];
      s1.x += v[4]; s1.y += v[5]; s1.z += v[6]; s1.w += v[7];
      p[0] = s0;
      p[1] = s1;
    }
  }
}

// Columns [0, N) of A1 @ W1 + A2 @ W2, widest passes first.
__device__ void dense(const float* A1, int, int K1, const float* W1,
                      const float* A2, int, int K2, const float* W2, int N,
                      int ldw, const Ep<float>& ep) {
  int n0 = 0;
  while (n0 < N) {
    const int rem = (N - n0) / 32;
    if (rem >= 8) {
      f32_pass<8>(A1, K1, W1, A2, K2, W2, ldw, n0, ep);
      n0 += 256;
    } else if (rem >= 4) {
      f32_pass<4>(A1, K1, W1, A2, K2, W2, ldw, n0, ep);
      n0 += 128;
    } else if (rem >= 2) {
      f32_pass<2>(A1, K1, W1, A2, K2, W2, ldw, n0, ep);
      n0 += 64;
    } else {
      f32_pass<1>(A1, K1, W1, A2, K2, W2, ldw, n0, ep);
      n0 += 32;
    }
  }
}

// dst[k][r] = src[(row0 + r) / div][k]
__device__ void stage(float* dst, int, const float* __restrict__ src,
                      int cols, long long row0, long long div, int n_valid) {
  for (int e = threadIdx.x; e < BM * cols; e += THREADS) {
    const int r = e / cols;
    const int k = e - r * cols;
    dst[k * LDF + r] = (r < n_valid) ? src[((row0 + r) / div) * cols + k]
                                     : 0.f;
  }
}

__device__ __forceinline__ void put(float* buf, int, int r, int c, float x) {
  buf[c * LDF + r] = x;
}

// ---------------------------------------------------------------- bf16 --
// Shared activations are row-major [BM][ld] bf16; `acc` is row-major fp32.

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp tile: rows r0 .. r0 + 16 MT, columns c0 .. c0 + 32 of
// A1 @ W1 + A2 @ W2 (W blocks ldw columns wide, fragment order)
template <int MT>
__device__ __forceinline__ void bf16_tile(
    const bf16* A1, int lda1, int K1, const uint2* __restrict__ W1,
    const bf16* A2, int lda2, int K2, const uint2* __restrict__ W2, int ldw,
    int r0, int c0, const Ep<bf16>& ep) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NB = ldw / 8;
  float acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    const bf16* A = s ? A2 : A1;
    const int lda = s ? lda2 : lda1;
    const int K = s ? K2 : K1;
    if (K == 0) continue;
    const uint2* W = (s ? W2 : W1) + (size_t)(c0 / 8) * 32 + lane;
#pragma unroll 2
    for (int kb = 0; kb < K / 16; ++kb) {
      uint2 b[4];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        b[nj] = __ldg(W + ((size_t)kb * NB + nj) * 32);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const bf16* p = A + (r0 + mi * 16 + g) * lda + kb * 16 + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(p);
        a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
        a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a, b[nj].x,
                                                b[nj].y);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int c = c0 + nj * 8 + 2 * t;  // columns c, c + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + mi * 16 + g + 8 * h;
        const float v0 = ep.value(row, c, acc[mi][nj][2 * h]);
        const float v1 = ep.value(row, c + 1, acc[mi][nj][2 * h + 1]);
        // smem_cols is a multiple of 32: c and c + 1 agree
        if (ep.smem && c < ep.smem_cols)
          *reinterpret_cast<uint32_t*>(ep.smem + row * ep.smem_ld + c) =
              pack_bf16x2(v0, v1);
        if (ep.acc) {
          ep.acc[row * ep.acc_ld + c] += v0;
          ep.acc[row * ep.acc_ld + c + 1] += v1;
        }
      }
    }
}

// Columns [0, N) spread over the 8 warps (as in the forward kernel).
__device__ void dense(const bf16* A1, int lda1, int K1, const uint2* W1,
                      const bf16* A2, int lda2, int K2, const uint2* W2,
                      int N, int ldw, const Ep<bf16>& ep) {
  const int warp = threadIdx.x >> 5;
  const int groups = N / 32;
  const int full = groups & ~7;
  for (int it = warp; it < full; it += 8)
    bf16_tile<4>(A1, lda1, K1, W1, A2, lda2, K2, W2, ldw, 0, it * 32, ep);
  const int rem = groups - full;
  if (rem >= 4) {
    for (int it = warp; it < rem * 2; it += 8)
      bf16_tile<2>(A1, lda1, K1, W1, A2, lda2, K2, W2, ldw, (it & 1) * 32,
                   (full + (it >> 1)) * 32, ep);
  } else if (rem > 0) {
    for (int it = warp; it < rem * 4; it += 8)
      bf16_tile<1>(A1, lda1, K1, W1, A2, lda2, K2, W2, ldw, (it & 3) * 16,
                   (full + (it >> 2)) * 32, ep);
  }
}

// dst[r][:] = src[(row0 + r) / div][:], 16 bytes at a time
__device__ void stage(bf16* dst, int ldd, const bf16* __restrict__ src,
                      int cols, long long row0, long long div, int n_valid) {
  const int vec = cols / 8;
  for (int e = threadIdx.x; e < BM * vec; e += THREADS) {
    const int r = e / vec;
    const int c = (e - r * vec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      val = *reinterpret_cast<const uint4*>(src + ((row0 + r) / div) * cols +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

__device__ __forceinline__ void put(bf16* buf, int ld, int r, int c,
                                    float x) {
  buf[r * ld + c] = __float2bfloat16_rn(x);
}

// ----------------------------------------------------------- pass 1 ------

// The cotangent columns [g0, g0 + 3) (or the one column 3) into 32 shared
// columns at `col` of `buf` and into the workspace section `dsec`; the
// other columns are zero.
template <typename T>
__device__ void stage_g(T* buf, int ld, int col, T* dsec, long long Cd,
                        const float* __restrict__ g, long long row0,
                        int n_valid, int g0, int n_g) {
  for (int e = threadIdx.x; e < BM * ALIGN; e += THREADS) {
    const int r = e / ALIGN;
    const int k = e - r * ALIGN;
    const float val =
        (k < n_g && r < n_valid) ? g[(row0 + r) * 4 + g0 + k] : 0.f;
    put(buf, ld, r, col + k, val);
    if (r < n_valid) dsec[r * Cd + k] = from_f<T>(val);
  }
}

template <typename T>
struct Smem;
template <>
struct Smem<float> {  // k-major fp32 buffers and dx accumulator
  __host__ __device__ static long long rows_bytes(int cols) {
    return (long long)cols * LDF * 4;
  }
  __host__ __device__ static int ld(int) { return LDF; }
  __host__ __device__ static int acc_floats(int in_p) { return in_p * LDF; }
  __device__ static float acc_at(const float* a, int, int r, int k) {
    return a[k * LDF + r];
  }
};
template <>
struct Smem<bf16> {  // row-major bf16 buffers, row-major fp32 accumulator
  __host__ __device__ static long long rows_bytes(int cols) {
    return (long long)BM * (cols + PADB) * 2;
  }
  __host__ __device__ static int ld(int cols) { return cols + PADB; }
  __host__ __device__ static int acc_floats(int in_p) {
    return BM * (in_p + 4);
  }
  __device__ static float acc_at(const float* a, int ld, int r, int k) {
    return a[r * ld + k];
  }
};

template <typename T>
long long data_smem(int in_p, int w_p, int v_p) {
  return 2 * Smem<T>::rows_bytes(w_p + ALIGN) + Smem<T>::rows_bytes(in_p) +
         Smem<T>::rows_bytes(v_p) + Smem<T>::rows_bytes(ALIGN) +
         (long long)Smem<T>::acc_floats(in_p) * 4;  // fp32 dx accumulator
}

template <typename T, int HEAD>
__global__ void __launch_bounds__(THREADS)
data_kernel(const T* __restrict__ x, const T* __restrict__ v, long long v_div,
            const float* __restrict__ g,
            const typename WType<T>::type* __restrict__ wbuf,
            const typename WType<T>::type* __restrict__ wtbuf,
            const float* __restrict__ bbuf, T* acts, T* dacts,
            float* __restrict__ dx,
            float* __restrict__ dv, long long n, const Layout y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int in_p = y.in_p, w_p = y.w_p, v_p = y.v_p, h_p = y.h_p;
  const int wide = w_p + ALIGN;
  const int ldh = Smem<T>::ld(wide), ldx = Smem<T>::ld(in_p),
            ldv = Smem<T>::ld(v_p), ldr = Smem<T>::ld(ALIGN);
  unsigned char* s = smem_raw;
  T* buf0 = reinterpret_cast<T*>(s); s += Smem<T>::rows_bytes(wide);
  T* buf1 = reinterpret_cast<T*>(s); s += Smem<T>::rows_bytes(wide);
  T* xs = reinterpret_cast<T*>(s); s += Smem<T>::rows_bytes(in_p);
  T* vs = reinterpret_cast<T*>(s); s += Smem<T>::rows_bytes(v_p);
  T* rs = reinterpret_cast<T*>(s); s += Smem<T>::rows_bytes(ALIGN);
  float* dxs = reinterpret_cast<float*>(s);
  const int dx_ld = in_p + 4;  // row-major accumulator (bf16 path)

  const long long row0 = (long long)blockIdx.x * BM;
  const int n_valid = (int)min((long long)BM, n - row0);
  T* arow = acts + row0 * y.Ca;
  T* drow = dacts + row0 * y.Cd;
  stage(xs, ldx, x, in_p, row0, 1, n_valid);
  stage(vs, ldv, v, v_p, row0, v_div, n_valid);
  for (int e = threadIdx.x; e < Smem<T>::acc_floats(in_p); e += THREADS)
    dxs[e] = 0.f;
  __syncthreads();

  // ---- forward recompute: relu outputs to shared ping-pong and to acts
  const T* h = xs;
  int hk = in_p, ldin = ldx;
  T* outb = buf0;
  for (int i = 0; i < y.L; ++i) {
    Ep<T> ep = ep_none<T>(n_valid);
    ep.bias = bbuf - y.n_w + y.boff[i];
    ep.relu_cols = w_p;
    ep.smem = outb; ep.smem_ld = ldh; ep.smem_cols = w_p;
    ep.gout = arow + y.act[i]; ep.g_ld = y.Ca; ep.g_cols = w_p;
    const int bh = y.blk_h[i];
    if (y.blk_x[i] >= 0)
      dense(xs, ldx, in_p, wptr(wbuf, y.woff[y.blk_x[i]]), h, ldh, w_p,
            wptr(wbuf, y.woff[bh]), w_p, w_p, ep);
    else
      dense(h, ldin, hk, wptr(wbuf, y.woff[bh]), nullptr, 0, 0, nullptr, w_p,
            w_p, ep);
    __syncthreads();
    h = outb;
    hk = w_p;
    ldin = ldh;
    outb = (outb == buf0) ? buf1 : buf0;
  }
  const int hb = y.hb, hbias = y.L;
  T* cur;  // the shared buffer holding da of the last pts layer
  if (HEAD == SPLIT) {
    // feature = h @ Waf[:, :w_p] + baf (no relu) -> outb, acts.feat
    Ep<T> ep = ep_none<T>(n_valid);
    ep.bias = bbuf - y.n_w + y.boff[hbias];
    ep.smem = outb; ep.smem_ld = ldh; ep.smem_cols = w_p;
    ep.gout = arow + y.feat; ep.g_ld = y.Ca; ep.g_cols = w_p;
    dense(h, ldh, w_p, wptr(wbuf, y.woff[hb]), nullptr, 0, 0, nullptr, w_p,
          w_p + ALIGN, ep);
    __syncthreads();
    // z_hv = relu(feature @ Wvf + v @ Wvv + bv) -> acts.zhv
    ep = ep_none<T>(n_valid);
    ep.bias = bbuf - y.n_w + y.boff[hbias + 1];
    ep.relu_cols = h_p;
    ep.gout = arow + y.zhv; ep.g_ld = y.Ca; ep.g_cols = h_p;
    dense(outb, ldh, w_p, wptr(wbuf, y.woff[hb + 1]), vs, ldv, v_p,
          wptr(wbuf, y.woff[hb + 2]), h_p, h_p, ep);
    stage_g(rs, ldr, 0, drow + y.drgb, y.Cd, g, row0, n_valid, 0, 3);
    __syncthreads();
    // ---- backward.  da_v = [z_hv > 0] (d_rgb @ Wr^T) -> buf0, dacts.dav
    ep = ep_none<T>(n_valid);
    ep.mask = arow + y.zhv; ep.mask_ld = y.Ca;
    ep.smem = buf0; ep.smem_ld = ldh; ep.smem_cols = h_p;
    ep.gout = drow + y.dav; ep.g_ld = y.Cd; ep.g_cols = h_p;
    dense(rs, ldr, ALIGN, wptr(wtbuf, y.woff[hb + 3]), nullptr, 0, 0,
          nullptr, h_p, h_p, ep);
    __syncthreads();
    // dv = da_v @ Wvv^T
    ep = ep_none<T>(n_valid);
    ep.fout = dv + row0 * v_p; ep.f_ld = v_p; ep.f_cols = v_p;
    dense(buf0, ldh, h_p, wptr(wtbuf, y.woff[hb + 2]), nullptr, 0, 0,
          nullptr, v_p, v_p, ep);
    // [dfeat | d_alpha] -> buf1, dacts.dcat;  dfeat = da_v @ Wvf^T
    ep = ep_none<T>(n_valid);
    ep.smem = buf1; ep.smem_ld = ldh; ep.smem_cols = w_p;
    ep.gout = drow + y.dcat; ep.g_ld = y.Cd; ep.g_cols = w_p;
    dense(buf0, ldh, h_p, wptr(wtbuf, y.woff[hb + 1]), nullptr, 0, 0,
          nullptr, w_p, w_p, ep);
    stage_g(buf1, ldh, w_p, drow + y.dcat + w_p, y.Cd, g, row0, n_valid, 3,
            1);
    __syncthreads();
    // da_{L-1} = [relu_{L-1} > 0] ([dfeat | d_alpha] @ Waf^T) -> buf0
    ep = ep_none<T>(n_valid);
    ep.mask = arow + y.act[y.L - 1]; ep.mask_ld = y.Ca;
    ep.smem = buf0; ep.smem_ld = ldh; ep.smem_cols = w_p;
    ep.gout = drow + y.da[y.L - 1]; ep.g_ld = y.Cd; ep.g_cols = w_p;
    dense(buf1, ldh, w_p + ALIGN, wptr(wtbuf, y.woff[hb]), nullptr, 0, 0,
          nullptr, w_p, w_p, ep);
    __syncthreads();
    cur = buf0;
  } else {
    // z_hv = relu((h @ Wfa + v @ Wvv + bfa)[:, :h_p]) -> acts.zhv
    Ep<T> ep = ep_none<T>(n_valid);
    ep.bias = bbuf - y.n_w + y.boff[hbias];
    ep.relu_cols = h_p;
    ep.gout = arow + y.zhv; ep.g_ld = y.Ca; ep.g_cols = h_p;
    dense(h, ldh, w_p, wptr(wbuf, y.woff[hb]), vs, ldv, v_p,
          wptr(wbuf, y.woff[hb + 1]), h_p, h_p + ALIGN, ep);
    stage_g(rs, ldr, 0, drow + y.drgb, y.Cd, g, row0, n_valid, 0, 3);
    __syncthreads();
    // ---- backward.  [da_v | d_alpha] -> outb, dacts.dcat
    T* dva = outb;
    ep = ep_none<T>(n_valid);
    ep.mask = arow + y.zhv; ep.mask_ld = y.Ca;
    ep.smem = dva; ep.smem_ld = ldh; ep.smem_cols = h_p;
    ep.gout = drow + y.dcat; ep.g_ld = y.Cd; ep.g_cols = h_p;
    dense(rs, ldr, ALIGN, wptr(wtbuf, y.woff[hb + 2]), nullptr, 0, 0,
          nullptr, h_p, h_p, ep);
    stage_g(dva, ldh, h_p, drow + y.dcat + h_p, y.Cd, g, row0, n_valid, 3,
            1);
    __syncthreads();
    // dv = [da_v | d_alpha] @ Wvv^T
    ep = ep_none<T>(n_valid);
    ep.fout = dv + row0 * v_p; ep.f_ld = v_p; ep.f_cols = v_p;
    dense(dva, ldh, h_p + ALIGN, wptr(wtbuf, y.woff[hb + 1]), nullptr, 0, 0,
          nullptr, v_p, v_p, ep);
    // da_{L-1} = [relu_{L-1} > 0] ([da_v | d_alpha] @ Wfa^T)
    cur = (dva == buf0) ? buf1 : buf0;
    ep = ep_none<T>(n_valid);
    ep.mask = arow + y.act[y.L - 1]; ep.mask_ld = y.Ca;
    ep.smem = cur; ep.smem_ld = ldh; ep.smem_cols = w_p;
    ep.gout = drow + y.da[y.L - 1]; ep.g_ld = y.Cd; ep.g_cols = w_p;
    dense(dva, ldh, h_p + ALIGN, wptr(wtbuf, y.woff[hb]), nullptr, 0, 0,
          nullptr, w_p, w_p, ep);
    __syncthreads();
  }

  // ---- pts layers, last to first: dx accumulates in dxs
  for (int i = y.L - 1; i >= 0; --i) {
    T* other = (cur == buf0) ? buf1 : buf0;
    const int bx = y.blk_x[i], bh = y.blk_h[i];
    Ep<T> ea = ep_none<T>(n_valid);
    ea.acc = dxs; ea.acc_ld = dx_ld;
    if (bx >= 0)  // dx += da_i @ Wx_i^T
      dense(cur, ldh, w_p, wptr(wtbuf, y.woff[bx]), nullptr, 0, 0, nullptr,
            in_p, in_p, ea);
    if (i > 0) {  // da_{i-1} = [relu_{i-1} > 0] (da_i @ Wh_i^T)
      Ep<T> ep = ep_none<T>(n_valid);
      ep.mask = arow + y.act[i - 1]; ep.mask_ld = y.Ca;
      ep.smem = other; ep.smem_ld = ldh; ep.smem_cols = w_p;
      ep.gout = drow + y.da[i - 1]; ep.g_ld = y.Cd; ep.g_cols = w_p;
      dense(cur, ldh, w_p, wptr(wtbuf, y.woff[bh]), nullptr, 0, 0, nullptr,
            w_p, w_p, ep);
    } else {  // dx += da_0 @ W_0^T
      dense(cur, ldh, w_p, wptr(wtbuf, y.woff[bh]), nullptr, 0, 0, nullptr,
            in_p, in_p, ea);
    }
    __syncthreads();
    cur = other;
  }
  for (int e = threadIdx.x; e < n_valid * in_p; e += THREADS) {
    const int r = e / in_p;
    const int k = e - r * in_p;
    dx[(row0 + r) * in_p + k] = Smem<T>::acc_at(dxs, dx_ld, r, k);
  }
}

// ----------------------------------------------------------- pass 2 ------

// One dW block A^T @ D, or (a == nullptr) one db block, the column sums
// of D
struct Job {
  const void* a;
  long long lda, a_div;
  int K;
  const void* d;
  long long ldd;
  int N;
  long long out;  // element offset in a partial row
};
struct Jobs {
  Job j[MAX_JOBS];
  int n;
};

// Weight-grad tile: 64 dW rows x 64 columns, 32 points per step.  (A
// 128 x 128 fp32 tile with 8 x 8 per thread took 147 registers, so one
// CTA per SM, and was slower on the H100 than this one at 64.)
constexpr int TK = 64, TN = 64, TP = 32;

template <typename T>
__device__ __forceinline__ float job_a(const Job& jb, long long row, int k) {
  const long long r = jb.a_div == 1 ? row : row / jb.a_div;
  return to_f(static_cast<const T*>(jb.a)[r * jb.lda + k]);
}

// fp32: CUDA-core FMAs; thread (ty, tx) owns dW rows k0 + 4ty .. + 4 and
// columns n0 + 4tx .. + 4 of the 64 x 64 tile.
__device__ void weight_tile(const Job& jb, long long r_lo, long long r_hi,
                            int k0, int n0, float* out, float) {
  __shared__ __align__(16) float As[TP][TK + 4];
  __shared__ __align__(16) float Ds[TP][TN + 4];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  const float* D = static_cast<const float*>(jb.d);
  for (long long p0 = r_lo; p0 < r_hi; p0 += TP) {
    for (int e = threadIdx.x; e < TP * TK; e += THREADS) {
      const int pr = e / TK, kk = e - pr * TK;
      const long long row = p0 + pr;
      const bool ok = row < r_hi;
      As[pr][kk] = (ok && k0 + kk < jb.K) ? job_a<float>(jb, row, k0 + kk)
                                          : 0.f;
      Ds[pr][kk] = (ok && n0 + kk < jb.N) ? D[row * jb.ldd + n0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pr = 0; pr < TP; ++pr) {
      const float4 a = *reinterpret_cast<const float4*>(&As[pr][ty * 4]);
      const float4 d = *reinterpret_cast<const float4*>(&Ds[pr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float dvv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dvv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (k < jb.K && c < jb.N) out[jb.out + (long long)k * jb.N + c] =
          acc[i][j];
    }
}

// bf16: mma.sync m16n8k16 over the points; warp w owns dW rows
// k0 + 16 (w % 4) .. + 16 and columns n0 + 32 (w / 4) .. + 32.
// Shared tiles are transposed (At[k][p], Dt[n][p]) so that both operands'
// fragments are pairs along the points.
__device__ void weight_tile(const Job& jb, long long r_lo, long long r_hi,
                            int k0, int n0, float* out, bf16) {
  __shared__ __align__(16) bf16 At[TK][TP + PADB];
  __shared__ __align__(16) bf16 Dt[TN][TP + PADB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mr = (warp & 3) * 16, nc = (warp >> 2) * 32;
  float acc[4][4] = {};
  const bf16* D = static_cast<const bf16*>(jb.d);
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (long long p0 = r_lo; p0 < r_hi; p0 += TP) {
    for (int e = threadIdx.x; e < TP * TK; e += THREADS) {
      const int pr = e / TK, kk = e - pr * TK;
      const long long row = p0 + pr;
      const bool ok = row < r_hi;
      At[kk][pr] = (ok && k0 + kk < jb.K)
                       ? __float2bfloat16_rn(job_a<bf16>(jb, row, k0 + kk))
                       : zero;
      Dt[kk][pr] = (ok && n0 + kk < jb.N) ? D[row * jb.ldd + n0 + kk] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < TP / 16; ++kb) {
      const bf16* p = &At[mr + g][kb * 16 + 2 * t];
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(p);
      a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * (TP + PADB));
      a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * (TP + PADB) + 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const bf16* q = &Dt[nc + nj * 8 + g][kb * 16 + 2 * t];
        mma_bf16(acc[nj], a, *reinterpret_cast<const uint32_t*>(q),
                 *reinterpret_cast<const uint32_t*>(q + 8));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + mr + g + 8 * (q >> 1);
      const int c = n0 + nc + nj * 8 + 2 * t + (q & 1);
      if (k < jb.K && c < jb.N) out[jb.out + (long long)k * jb.N + c] =
          acc[nj][q];
    }
}

// db (a job with a == nullptr): the column sums of D over the chunk, for
// the tn columns from n0.  THREADS / tn threads per column each sum an
// interleaved share of the points; their partials are added in a fixed
// order.
template <typename T>
__device__ void bias_tile(const Job& jb, long long r_lo, long long r_hi,
                          int n0, int tn, float* out) {
  __shared__ float part[THREADS];
  const int per = THREADS / tn;
  const int c = threadIdx.x % tn, q = threadIdx.x / tn;
  const T* D = static_cast<const T*>(jb.d);
  float s = 0.f;
  if (n0 + c < jb.N)
    for (long long row = r_lo + q; row < r_hi; row += per)
      s += to_f(D[row * jb.ldd + n0 + c]);
  part[threadIdx.x] = s;
  __syncthreads();
  if (q == 0 && n0 + c < jb.N) {
    float t = 0.f;
    for (int i = 0; i < per; ++i) t += part[i * tn + c];
    out[jb.out + n0 + c] = t;
  }
}

// grid (tiles, jobs, chunks): CTA (tile, job, chunk) writes its tile of
// the job's block, summed over the chunk's points, to partial row `chunk`.
// (at most 64 registers: four CTAs per SM)
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
weight_kernel(const Jobs jobs, long long n, long long n_grad,
              float* __restrict__ partial) {
  const Job& jb = jobs.j[blockIdx.y];
  const int tiles_n = (jb.N + TN - 1) / TN;
  const int tiles = ((jb.K + TK - 1) / TK) * tiles_n;
  if ((int)blockIdx.x >= tiles) return;
  const int k0 = (blockIdx.x / tiles_n) * TK, n0 = (blockIdx.x % tiles_n) * TN;
  const long long r_lo = (long long)blockIdx.z * CHUNK;
  const long long r_hi = min(n, r_lo + CHUNK);
  float* out = partial + blockIdx.z * n_grad;
  if (jb.a == nullptr)
    bias_tile<T>(jb, r_lo, r_hi, n0, TN, out);
  else
    weight_tile(jb, r_lo, r_hi, k0, n0, out, T());
}

// ----------------------------------------------------------- pass 3 ------

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

struct Workspace {
  long long acts, dacts, partial, total;  // byte offsets, total bytes
};

Workspace workspace(const Layout& y, long long n, int esize) {
  Workspace w;
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  w.acts = 0;
  w.dacts = align256(n * y.Ca * esize);
  w.partial = w.dacts + align256(n * y.Cd * esize);
  w.total = w.partial + align256(n_chunks * y.n_grad * 4);
  return w;
}

Jobs make_jobs(const Layout& y, const void* x, const void* v, long long v_div,
               const unsigned char* acts, const unsigned char* dacts,
               int esize) {
  Jobs js;
  js.n = 0;
  auto act = [&](int col) {
    return (const void*)(acts + (long long)col * esize);
  };
  auto dac = [&](int col) {
    return (const void*)(dacts + (long long)col * esize);
  };
  auto add = [&](const void* a, long long lda, long long a_div, int K,
                 const void* d, int N, long long out) {
    Job& j = js.j[js.n++];
    j.a = a; j.lda = lda; j.a_div = a_div; j.K = K;
    j.d = d; j.ldd = y.Cd; j.N = N; j.out = out;
  };
  for (int i = 0; i < y.L; ++i) {
    const void* da = dac(y.da[i]);
    if (y.blk_x[i] >= 0)
      add(x, y.in_p, 1, y.in_p, da, y.w_p, y.woff[y.blk_x[i]]);
    const int bh = y.blk_h[i];
    if (i == 0)
      add(x, y.in_p, 1, y.in_p, da, y.w_p, y.woff[bh]);
    else
      add(act(y.act[i - 1]), y.Ca, 1, y.w_p, da, y.w_p, y.woff[bh]);
    add(nullptr, 0, 1, 1, da, y.w_p, y.boff[i]);
  }
  const int hb = y.hb, L = y.L;
  const void* last = act(y.act[L - 1]);
  const void* zhv = act(y.zhv);
  const void* drgb = dac(y.drgb);
  if (y.head == SPLIT) {
    const void* dcat = dac(y.dcat);
    const void* dav = dac(y.dav);
    add(last, y.Ca, 1, y.w_p, dcat, y.w_p + ALIGN, y.woff[hb]);
    add(act(y.feat), y.Ca, 1, y.w_p, dav, y.h_p, y.woff[hb + 1]);
    add(v, y.v_p, v_div, y.v_p, dav, y.h_p, y.woff[hb + 2]);
    add(zhv, y.Ca, 1, y.h_p, drgb, ALIGN, y.woff[hb + 3]);
    add(nullptr, 0, 1, 1, dcat, y.w_p + ALIGN, y.boff[L]);
    add(nullptr, 0, 1, 1, dav, y.h_p, y.boff[L + 1]);
    add(nullptr, 0, 1, 1, drgb, ALIGN, y.boff[L + 2]);
  } else {
    const void* dcat = dac(y.dcat);
    add(last, y.Ca, 1, y.w_p, dcat, y.h_p + ALIGN, y.woff[hb]);
    add(v, y.v_p, v_div, y.v_p, dcat, y.h_p + ALIGN, y.woff[hb + 1]);
    add(zhv, y.Ca, 1, y.h_p, drgb, ALIGN, y.woff[hb + 2]);
    add(nullptr, 0, 1, 1, dcat, y.h_p + ALIGN, y.boff[L]);
    add(nullptr, 0, 1, 1, drgb, ALIGN, y.boff[L + 1]);
  }
  return js;
}

template <typename T, int HEAD>
int launch(const void* x, const void* v, long long v_div, const float* g,
           const void* w, const void* wt, const float* b, float* grads,
           float* dx, float* dv, unsigned char* ws, long long n,
           const Layout& y, cudaStream_t stream) {
  typedef typename WType<T>::type WT;
  const Workspace wl = workspace(y, n, sizeof(T));
  T* acts = reinterpret_cast<T*>(ws + wl.acts);
  T* dacts = reinterpret_cast<T*>(ws + wl.dacts);
  float* partial = reinterpret_cast<float*>(ws + wl.partial);

  const size_t smem = (size_t)data_smem<T>(y.in_p, y.w_p, y.v_p);
  auto kern = data_kernel<T, HEAD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)((n + BM - 1) / BM), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), v_div, g,
      static_cast<const WT*>(w), static_cast<const WT*>(wt), b, acts, dacts,
      dx, dv, n, y);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const Jobs js = make_jobs(y, x, v, v_div,
                            reinterpret_cast<const unsigned char*>(acts),
                            reinterpret_cast<const unsigned char*>(dacts),
                            sizeof(T));
  int max_tiles = 1;
  for (int j = 0; j < js.n; ++j) {
    const int t = ((js.j[j].K + TK - 1) / TK) * ((js.j[j].N + TN - 1) / TN);
    max_tiles = t > max_tiles ? t : max_tiles;
  }
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  weight_kernel<T><<<dim3(max_tiles, js.n, (unsigned)n_chunks), THREADS, 0,
                     stream>>>(js, n, y.n_grad, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  reduce_kernel<<<(unsigned)((y.n_grad + 255) / 256), 256, 0, stream>>>(
      partial, n_chunks, y.n_grad, grads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA of the data kernel needs, in bytes.
long long plnerf_fused_mlp_bwd_smem(int in_p, int w_p, int v_p,
                                    int use_bf16) {
  return use_bf16 ? data_smem<bf16>(in_p, w_p, v_p)
                  : data_smem<float>(in_p, w_p, v_p);
}

// Workspace bytes for n points (0: a layout the kernel does not take).
long long plnerf_fused_mlp_bwd_workspace(long long n, int n_layers,
                                         unsigned skip_mask, int in_p,
                                         int w_p, int v_p, int h_p, int head,
                                         int use_bf16) {
  Layout y;
  if (!build_layout(&y, n_layers, skip_mask, in_p, w_p, v_p, h_p, head))
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

// Launches the three passes on `stream`; returns cudaGetLastError() of the
// first that fails (0 on success).  w: packed weights, wt: the same blocks
// transposed ([N, K] each, same offsets), b: packed biases, g: [n, 4] fp32.
int plnerf_fused_mlp_bwd(const void* x, const void* v, long long v_div,
                         const void* g, const void* w, const void* wt,
                         const void* b, void* grads, void* dx, void* dv,
                         void* workspace_buf, long long n, int n_layers,
                         unsigned skip_mask, int in_p, int w_p, int v_p,
                         int h_p, int head, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  Layout y;
  if (in_p % ALIGN || w_p % ALIGN || v_p % ALIGN || h_p % ALIGN ||
      v_div < 1 || (n + CHUNK - 1) / CHUNK > 65535 ||
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
    return head == SPLIT
               ? launch<bf16, SPLIT>(x, v, v_div, gf, w, wt, bf, gr, dxf, dvf,
                                     ws, n, y, s)
               : launch<bf16, FOLDED>(x, v, v_div, gf, w, wt, bf, gr, dxf,
                                      dvf, ws, n, y, s);
  return head == SPLIT
             ? launch<float, SPLIT>(x, v, v_div, gf, w, wt, bf, gr, dxf, dvf,
                                    ws, n, y, s)
             : launch<float, FOLDED>(x, v, v_div, gf, w, wt, bf, gr, dxf, dvf,
                                     ws, n, y, s);
}

const char* plnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
