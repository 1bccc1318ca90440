// Fused NeRF-MLP forward for Hopper (sm_90a).
//
// Replaces the TPU kernel plnerf/kernels/fused_mlp.py `_kernel` (launched
// by `_forward` through pl.pallas_call).  One CTA maps a tile of BM = 64
// points through every pts layer, the skip layer and one of three head
// schedules (split viewdirs, folded viewdirs, plain output_linear) and
// writes raw [N, 4] (rgb logits, density) straight to device memory.
//
// Bound: operations.  The flagship 8x256 viewdirs MLP is 593,408 MACs per
// point in the split schedule and 527,872 in the folded one (1.19 / 1.06
// MFLOP), against ~96 input values and 4 outputs per point: hundreds of
// FLOPs per byte, far above the card's ridge point in fp32 and in bf16.
//
// What the design does about it: no [N, 256] activation ever leaves the
// SM.  Activations ping-pong between two buffers in shared memory, each
// layer reads its weights from L1/L2 (every CTA reads the same weights)
// and only raw [N, 4] is written.  Two paths:
//
// * float32 (`fp32_kernel`): true fp32 on the CUDA cores, no TF32,
//   mirroring the JAX package's Precision.HIGHEST.  Activations are
//   k-major ([K][BM + 4]), so a thread's 8 points at one k are one 16-byte
//   shared load that its warp shares by broadcast; each of the 256 threads
//   owns an 8-point x 8-column register tile (fewer on a narrow tail),
//   and each warp reads one weight row per k, coalesced along the output
//   dimension (lane tx takes columns tx + 32j).
// * bfloat16 (`bf16_kernel`): tensor cores through mma.sync m16n8k16
//   (bf16 operands, fp32 accumulation).  Activations are row-major bf16
//   ([BM][K + 8]: the fragment loads and the epilogue's stores are
//   bank-conflict free); the weights are stored in mma fragment order
//   (one coalesced 8-byte load per lane per 16x8 block).  Each warp owns
//   a 64x32 (or, for narrow layers, 32x32 / 16x32) output tile.
//
// wgmma, TMA and weight staging through shared memory are left for later.
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
// fp32 blocks are row-major.  bf16 blocks are in mma fragment order: for
// each 16-row k block kb and 8-column n block nb (n blocks innermost),
// 32 lanes x 4 values, lane l = 4g + t holding W[k0][n], W[k0+1][n],
// W[k0+8][n], W[k0+9][n] with k0 = 16kb + 2t, n = 8nb + g.
// x is [N, in_p]; v is [N / v_div, v_p] (point p reads view row p / v_div,
// so per-ray views need no broadcast over samples).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // points per CTA
constexpr int THREADS = 256;  // 8 warps
constexpr int ALIGN = 32;     // K / N granularity of every packed block
constexpr int LDF = BM + 4;   // fp32 k-major row: 272 bytes
constexpr int PADB = 8;       // bf16 row padding: rows of K + 8 values

enum Head { SPLIT = 0, FOLDED = 1, PLAIN = 2 };

typedef __nv_bfloat16 bf16;

// Where a layer's outputs go: columns [0, n_smem) to the shared buffer
// `out` (relu on columns < relu_cols), columns [g_col0, g_col0 + g_ncol)
// to raw[:, g_dst + c - g_col0] before any relu.
struct Epilogue {
  int n_smem, relu_cols;
  float* raw;
  long long row0;
  int n_valid, g_col0, g_ncol, g_dst;

  __device__ void to_global(int row, int c, float val) const {
    if (c >= g_col0 && c < g_col0 + g_ncol && row < n_valid)
      raw[(row0 + row) * 4 + g_dst + (c - g_col0)] = val;
  }
  __device__ float relu(int c, float val) const {
    // NaN passes, as jnp.maximum(x, 0) lets it
    return (c < relu_cols && val < 0.f) ? 0.f : val;
  }
};

// ---------------------------------------------------------------- fp32 --

// One pass over 32*J output columns starting at n0:
//   out = A1 @ W1 + A2 @ W2 + bias   (A k-major [K][LDF] in shared memory)
template <int J>
__device__ __forceinline__ void fp32_pass(
    const float* A1, int K1, const float* __restrict__ W1,
    const float* A2, int K2, const float* __restrict__ W2,
    int N, int n0, const float* __restrict__ bias, float* out,
    const Epilogue& ep) {
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
      for (int j = 0; j < J; ++j) w[j] = __ldg(w_ptr + (size_t)k * N + 32 * j);
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
    const float bj = bias[c];
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = acc[i][j] + bj;
      ep.to_global(ty * 8 + i, c, v[i]);
      v[i] = ep.relu(c, v[i]);
    }
    if (c < ep.n_smem) {
      float* p = out + c * LDF + ty * 8;
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// A whole layer: widest passes first (J = 8, 4, 2, 1 columns per thread),
// so a narrow tail (the alpha slot, the rgb head) costs only its width.
__device__ void fp32_dense(const float* A1, int K1, const float* W1,
                           const float* A2, int K2, const float* W2, int N,
                           const float* bias, float* out, const Epilogue& ep) {
  int n0 = 0;
  while (n0 < N) {
    const int rem = (N - n0) / 32;
    if (rem >= 8) {
      fp32_pass<8>(A1, K1, W1, A2, K2, W2, N, n0, bias, out, ep);
      n0 += 256;
    } else if (rem >= 4) {
      fp32_pass<4>(A1, K1, W1, A2, K2, W2, N, n0, bias, out, ep);
      n0 += 128;
    } else if (rem >= 2) {
      fp32_pass<2>(A1, K1, W1, A2, K2, W2, N, n0, bias, out, ep);
      n0 += 64;
    } else {
      fp32_pass<1>(A1, K1, W1, A2, K2, W2, N, n0, bias, out, ep);
      n0 += 32;
    }
  }
}

// dst[k][r] = src[(row0 + r) / div][k]: k-major copy of a row tile
__device__ void fp32_stage(float* dst, const float* __restrict__ src,
                           int cols, long long row0, long long div,
                           int n_valid) {
  for (int e = threadIdx.x; e < BM * cols; e += THREADS) {
    const int r = e / cols;
    const int k = e - r * cols;
    dst[k * LDF + r] = (r < n_valid) ? src[((row0 + r) / div) * cols + k]
                                     : 0.f;
  }
}

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One warp tile: rows r0 .. r0 + 16*MT, columns c0 .. c0 + 32 of
//   out = A1 @ W1 + A2 @ W2 + bias   (A row-major [BM][lda] bf16)
template <int MT>
__device__ __forceinline__ void bf16_tile(
    const bf16* A1, int lda1, int K1, const uint2* __restrict__ W1,
    const bf16* A2, int lda2, int K2, const uint2* __restrict__ W2,
    int N, int r0, int c0, const float* __restrict__ bias, bf16* out,
    int ldo, const Epilogue& ep) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NB = N / 8;
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
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a, b[nj]);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int c = c0 + nj * 8 + 2 * t;  // columns c, c + 1
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + mi * 16 + g + 8 * h;
        float v0 = acc[mi][nj][2 * h] + b0;
        float v1 = acc[mi][nj][2 * h + 1] + b1;
        ep.to_global(row, c, v0);
        ep.to_global(row, c + 1, v1);
        // n_smem and relu_cols are multiples of 32: c and c + 1 agree
        if (c < ep.n_smem)
          *reinterpret_cast<uint32_t*>(out + row * ldo + c) =
              pack_bf16x2(ep.relu(c, v0), ep.relu(c + 1, v1));
      }
    }
}

// A whole layer, spread over the 8 warps: 32-column groups of all 64 rows
// while there are 8 groups per warp round, then the remaining groups cut
// into 32-row (MT = 2) or 16-row (MT = 1) tiles so narrow layers and the
// alpha slot still occupy every warp.
__device__ void bf16_dense(const bf16* A1, int lda1, int K1, const uint2* W1,
                           const bf16* A2, int lda2, int K2, const uint2* W2,
                           int N, const float* bias, bf16* out, int ldo,
                           const Epilogue& ep) {
  const int warp = threadIdx.x >> 5;
  const int groups = N / 32;
  const int full = groups & ~7;
  for (int it = warp; it < full; it += 8)
    bf16_tile<4>(A1, lda1, K1, W1, A2, lda2, K2, W2, N, 0, it * 32, bias,
                 out, ldo, ep);
  const int rem = groups - full;
  if (rem >= 4) {
    for (int it = warp; it < rem * 2; it += 8)
      bf16_tile<2>(A1, lda1, K1, W1, A2, lda2, K2, W2, N, (it & 1) * 32,
                   (full + (it >> 1)) * 32, bias, out, ldo, ep);
  } else if (rem > 0) {
    for (int it = warp; it < rem * 4; it += 8)
      bf16_tile<1>(A1, lda1, K1, W1, A2, lda2, K2, W2, N, (it & 3) * 16,
                   (full + (it >> 2)) * 32, bias, out, ldo, ep);
  }
}

// dst[r][:] = src[(row0 + r) / div][:], 16 bytes at a time
__device__ void bf16_stage(bf16* dst, int ldd, const bf16* __restrict__ src,
                           int cols, long long row0, long long div,
                           int n_valid) {
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

// ------------------------------------------------------------- kernels --

template <int HEAD>
__global__ void __launch_bounds__(THREADS)
fp32_kernel(const float* __restrict__ x, const float* __restrict__ v,
            long long v_div, const float* __restrict__ wbuf,
            const float* __restrict__ bbuf, float* __restrict__ raw,
            long long n, int n_layers, unsigned skip_mask, int in_p,
            int w_p, int v_p, int h_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf0 = reinterpret_cast<float*>(smem_raw);
  float* buf1 = buf0 + w_p * LDF;
  float* xs = buf1 + w_p * LDF;
  float* vs = xs + in_p * LDF;

  const long long row0 = (long long)blockIdx.x * BM;
  const int n_valid = (int)min((long long)BM, n - row0);
  fp32_stage(xs, x, in_p, row0, 1, n_valid);
  if (HEAD != PLAIN) fp32_stage(vs, v, v_p, row0, v_div, n_valid);
  __syncthreads();

  Epilogue ep{w_p, w_p, raw, row0, n_valid, 0, 0, 0};
  const float* w = wbuf;
  const float* b = bbuf;
  const float* h = xs;
  int hk = in_p;
  float* outb = buf0;
  for (int i = 0; i < n_layers; ++i) {
    if ((skip_mask >> i) & 1u) {  // fed by the [x | h] concat
      const float* wx = w;
      w += (size_t)in_p * w_p;
      fp32_dense(xs, in_p, wx, h, w_p, w, w_p, b, outb, ep);
      w += (size_t)w_p * w_p;
    } else {
      fp32_dense(h, hk, w, nullptr, 0, nullptr, w_p, b, outb, ep);
      w += (size_t)hk * w_p;
    }
    b += w_p;
    __syncthreads();
    h = outb;
    hk = w_p;
    outb = (outb == buf0) ? buf1 : buf0;
  }
  float* hbuf = const_cast<float*>(h);  // free once the first head ran

  if (HEAD == SPLIT) {
    const int nfa = w_p + ALIGN;  // feature | alpha; alpha to raw[:, 3]
    ep = Epilogue{w_p, 0, raw, row0, n_valid, w_p, 1, 3};
    fp32_dense(h, w_p, w, nullptr, 0, nullptr, nfa, b, outb, ep);
    w += (size_t)w_p * nfa;
    b += nfa;
    __syncthreads();
    const float* wvf = w;  // views: relu(feature @ Wvf + v @ Wvv + bv)
    w += (size_t)w_p * h_p;
    ep = Epilogue{h_p, h_p, raw, row0, n_valid, 0, 0, 0};
    fp32_dense(outb, w_p, wvf, vs, v_p, w, h_p, b, hbuf, ep);
    w += (size_t)v_p * h_p;
    b += h_p;
    __syncthreads();
    ep = Epilogue{0, 0, raw, row0, n_valid, 0, 3, 0};
    fp32_dense(hbuf, h_p, w, nullptr, 0, nullptr, ALIGN, b, nullptr, ep);
  } else if (HEAD == FOLDED) {
    const int nt = h_p + ALIGN;  // relu(h @ Wfv + v @ Wvv + bfv) | alpha
    const float* wfa = w;
    w += (size_t)w_p * nt;
    ep = Epilogue{h_p, h_p, raw, row0, n_valid, h_p, 1, 3};
    fp32_dense(h, w_p, wfa, vs, v_p, w, nt, b, outb, ep);
    w += (size_t)v_p * nt;
    b += nt;
    __syncthreads();
    ep = Epilogue{0, 0, raw, row0, n_valid, 0, 3, 0};
    fp32_dense(outb, h_p, w, nullptr, 0, nullptr, ALIGN, b, nullptr, ep);
  } else {
    ep = Epilogue{0, 0, raw, row0, n_valid, 0, 4, 0};
    fp32_dense(h, w_p, w, nullptr, 0, nullptr, ALIGN, b, nullptr, ep);
  }
}

template <int HEAD>
__global__ void __launch_bounds__(THREADS)
bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ v,
            long long v_div, const uint2* __restrict__ wbuf,
            const float* __restrict__ bbuf, float* __restrict__ raw,
            long long n, int n_layers, unsigned skip_mask, int in_p,
            int w_p, int v_p, int h_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = w_p + PADB, ldx = in_p + PADB, ldv = v_p + PADB;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + BM * ldh;
  bf16* xs = buf1 + BM * ldh;
  bf16* vs = xs + BM * ldx;

  const long long row0 = (long long)blockIdx.x * BM;
  const int n_valid = (int)min((long long)BM, n - row0);
  bf16_stage(xs, ldx, x, in_p, row0, 1, n_valid);
  if (HEAD != PLAIN) bf16_stage(vs, ldv, v, v_p, row0, v_div, n_valid);
  __syncthreads();

  // weight blocks: K * N bf16 = K * N / 4 uint2
  Epilogue ep{w_p, w_p, raw, row0, n_valid, 0, 0, 0};
  const uint2* w = wbuf;
  const float* b = bbuf;
  const bf16* h = xs;
  int hk = in_p, ldin = ldx;
  bf16* outb = buf0;
  for (int i = 0; i < n_layers; ++i) {
    if ((skip_mask >> i) & 1u) {
      const uint2* wx = w;
      w += (size_t)in_p * w_p / 4;
      bf16_dense(xs, ldx, in_p, wx, h, ldh, w_p, w, w_p, b, outb, ldh, ep);
      w += (size_t)w_p * w_p / 4;
    } else {
      bf16_dense(h, ldin, hk, w, nullptr, 0, 0, nullptr, w_p, b, outb, ldh,
                 ep);
      w += (size_t)hk * w_p / 4;
    }
    b += w_p;
    __syncthreads();
    h = outb;
    hk = w_p;
    ldin = ldh;
    outb = (outb == buf0) ? buf1 : buf0;
  }
  bf16* hbuf = const_cast<bf16*>(h);

  if (HEAD == SPLIT) {
    const int nfa = w_p + ALIGN;
    ep = Epilogue{w_p, 0, raw, row0, n_valid, w_p, 1, 3};
    bf16_dense(h, ldh, w_p, w, nullptr, 0, 0, nullptr, nfa, b, outb, ldh, ep);
    w += (size_t)w_p * nfa / 4;
    b += nfa;
    __syncthreads();
    const uint2* wvf = w;
    w += (size_t)w_p * h_p / 4;
    ep = Epilogue{h_p, h_p, raw, row0, n_valid, 0, 0, 0};
    bf16_dense(outb, ldh, w_p, wvf, vs, ldv, v_p, w, h_p, b, hbuf, ldh, ep);
    w += (size_t)v_p * h_p / 4;
    b += h_p;
    __syncthreads();
    ep = Epilogue{0, 0, raw, row0, n_valid, 0, 3, 0};
    bf16_dense(hbuf, ldh, h_p, w, nullptr, 0, 0, nullptr, ALIGN, b, nullptr,
               0, ep);
  } else if (HEAD == FOLDED) {
    const int nt = h_p + ALIGN;
    const uint2* wfa = w;
    w += (size_t)w_p * nt / 4;
    ep = Epilogue{h_p, h_p, raw, row0, n_valid, h_p, 1, 3};
    bf16_dense(h, ldh, w_p, wfa, vs, ldv, v_p, w, nt, b, outb, ldh, ep);
    w += (size_t)v_p * nt / 4;
    b += nt;
    __syncthreads();
    ep = Epilogue{0, 0, raw, row0, n_valid, 0, 3, 0};
    bf16_dense(outb, ldh, h_p, w, nullptr, 0, 0, nullptr, ALIGN, b, nullptr,
               0, ep);
  } else {
    ep = Epilogue{0, 0, raw, row0, n_valid, 0, 4, 0};
    bf16_dense(h, ldh, w_p, w, nullptr, 0, 0, nullptr, ALIGN, b, nullptr, 0,
               ep);
  }
}

long long smem_bytes(int in_p, int w_p, int v_p, bool bf16_path) {
  if (bf16_path)
    return (long long)BM * (2 * (w_p + PADB) + in_p + PADB + v_p + PADB) * 2;
  return (long long)(2 * w_p + in_p + v_p) * LDF * 4;
}

template <typename KernelFn, typename T, typename WT>
int launch(KernelFn kern, const void* x, const void* v, long long v_div,
           const void* w, const void* b, void* raw, long long n,
           int n_layers, unsigned skip_mask, int in_p, int w_p, int v_p,
           int h_p, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((n + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), v_div,
      static_cast<const WT*>(w), static_cast<const float*>(b),
      static_cast<float*>(raw), n, n_layers, skip_mask, in_p, w_p, v_p, h_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper checks it against
// the device's opt-in limit before launching).
long long plnerf_fused_mlp_fwd_smem(int in_p, int w_p, int v_p,
                                    int use_bf16) {
  return smem_bytes(in_p, w_p, v_p, use_bf16 != 0);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int plnerf_fused_mlp_fwd(const void* x, const void* v, long long v_div,
                         const void* w, const void* b, void* raw,
                         long long n, int n_layers, unsigned skip_mask,
                         int in_p, int w_p, int v_p, int h_p, int head,
                         int use_bf16, void* stream) {
  if (n <= 0) return 0;
  if (in_p % ALIGN || w_p % ALIGN || v_p % ALIGN || h_p % ALIGN ||
      v_div < 1 || head < SPLIT || head > PLAIN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes(in_p, w_p, v_p, use_bf16 != 0);
#define PLNERF_LAUNCH(K, T, WT)                                           \
  return launch<decltype(&K), T, WT>(&K, x, v, v_div, w, b, raw, n,       \
                                     n_layers, skip_mask, in_p, w_p, v_p, \
                                     h_p, smem, s)
  if (use_bf16) {
    if (head == SPLIT) PLNERF_LAUNCH(bf16_kernel<SPLIT>, bf16, uint2);
    if (head == FOLDED) PLNERF_LAUNCH(bf16_kernel<FOLDED>, bf16, uint2);
    PLNERF_LAUNCH(bf16_kernel<PLAIN>, bf16, uint2);
  }
  if (head == SPLIT) PLNERF_LAUNCH(fp32_kernel<SPLIT>, float, float);
  if (head == FOLDED) PLNERF_LAUNCH(fp32_kernel<FOLDED>, float, float);
  PLNERF_LAUNCH(fp32_kernel<PLAIN>, float, float);
#undef PLNERF_LAUNCH
}

const char* plnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
