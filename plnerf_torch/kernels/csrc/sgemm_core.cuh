// fp32 SGEMM core shared by the fused-MLP forward (fused_mlp_fwd.cu,
// `fp32_kernel`) and backward (fused_mlp_bwd.cu, `sgemm_data_kernel`).
//
// One CTA computes a 128-point x 128-column tile of
//   out[p][c] = epilogue(sum_t A_t[p] @ B_t),  c < N
// in true fp32 FMAs on the CUDA cores (no TF32, no tensor cores: the JAX
// package's Precision.HIGHEST).  256 threads with an 8 x 8 outer product
// each; k-slabs of 16 through a 3-stage ring of 16-byte cp.async copies
// of both operands (each weight byte is fetched once per CTA); every FMA
// operand read by LDS.128; ragged points and columns masked.  128
// registers, 2 CTAs per SM (__launch_bounds__(256, 2) on the kernels that
// call it).  A K = N = 256 product over points does 64 FLOP per byte with
// its input and output in device memory, above the fp32 ridge of 20
// FLOP/B, so the FMA pipes set the pace and a layer can be one launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FBM = 128, FBN = 128, FBK = 16, FST = 3;
constexpr int FTHREADS = 256;
constexpr int FLDA = FBK + 4;                  // point-major A row [BM][20]
constexpr int F_STAGE = FBM * FLDA + FBK * FBN;  // floats per ring stage
constexpr int F_SMEM = FST * F_STAGE * 4;      // 55,296 B
// each thread copies two 16-byte chunks of each operand per slab
static_assert(FBM * FBK == 8 * FTHREADS && FBK * FBN == 8 * FTHREADS,
              "two chunks a thread");

// ------------------------------------------------------------ copies ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------ the core -------

// One summand A @ B of a product: A rows (point p reads row p / a_div,
// lda apart), columns [0, K); B [K, *] row-major, ldb apart.
struct FTerm {
  const float* a;
  long long lda, a_div;
  int K;
  const float* b;
  int ldb;
};

// out[p][c] = epilogue(sum_t A_t @ B_t), c < N:  + bias[c]; relu on
// c < relu_cols; where mask is set, 0 unless mask[p][c] > 0 (NaN passes,
// as jnp.where); with accumulate, the old out[p][c] + the value.  With
// the RAW epilogue (the forward's heads) only columns c < out_cols go to
// out, and columns [raw_col0, raw_col0 + raw_ncol) also go, before any
// relu, to raw[p][raw_dst + c - raw_col0] (raw [n, 4]).
struct FOp {
  FTerm t[2];
  int nterms, N;
  const float* bias;
  int relu_cols;
  const float* mask;
  long long mask_ld;
  float* out;
  long long out_ld;
  int accumulate;
  int out_cols;
  float* raw;
  int raw_col0, raw_ncol, raw_dst;
};

// A point-major (k contiguous): As[BM][FLDA].  Warp w owns points
// 32 (w & 3) .. + 32 and columns 64 (w >> 2) .. + 64; lane (lm, ln) the
// points 4 i + lm and the columns 4 ln .. + 4 and 32 + 4 ln .. + 4.  The
// four lm rows of one read are 20 words apart: four bank quads, no
// conflict.  Tile (blockIdx.x, blockIdx.y) of points x columns.
template <bool RAW>
__device__ __forceinline__ void sgemm_tile(const FOp& op, long long n) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int lm = lane & 3, ln = lane >> 2;
  const long long row0 = (long long)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;
  const int s0 = op.t[0].K / FBK;
  const int slabs = s0 + (op.nterms > 1 ? op.t[1].K / FBK : 0);

  auto load = [&](int s, int st) {
    const bool first = s < s0;
    const float* a = first ? op.t[0].a : op.t[1].a;
    const long long lda = first ? op.t[0].lda : op.t[1].lda;
    const long long a_div = first ? op.t[0].a_div : op.t[1].a_div;
    const float* b = first ? op.t[0].b : op.t[1].b;
    const int ldb = first ? op.t[0].ldb : op.t[1].ldb;
    const int k0 = (first ? s : s - s0) * FBK;
    float* As = fsm + st * F_STAGE;
    float* Bs = As + FBM * FLDA;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * FTHREADS;
      const int r = e >> 2, c = (e & 3) * 4;
      const long long p = row0 + r;
      const bool ok = p < n;
      const long long ar = ok ? (a_div == 1 ? p : p / a_div) : 0;
      cp_async16(As + r * FLDA + c, a + ar * lda + k0 + c, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * FTHREADS;
      const int r = e >> 5, c = (e & 31) * 4;
      const bool ok = n0 + c < op.N;
      cp_async16(Bs + r * FBN + c,
                 b + (long long)(k0 + r) * ldb + (ok ? n0 + c : 0), ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < FST - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<FST - 2>();
    __syncthreads();  // slab s landed; stage (s - 1) % FST is free
    if (s + FST - 1 < slabs) load(s + FST - 1, (s + FST - 1) % FST);
    cp_async_commit();
    const float* As = fsm + (s % FST) * F_STAGE;
    const float* Bs = As + FBM * FLDA;
#pragma unroll
    for (int k4 = 0; k4 < FBK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            As + (wm * 32 + lm + 4 * i) * FLDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (k4 + kk) * FBN + wn * 64 + ln * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = row0 + wm * 32 + lm + 4 * i;
    if (p >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + wn * 64 + h * 32 + ln * 4;
      if (c >= op.N) continue;
      float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                    acc[i][4 * h + 3]};
      if (op.bias) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(op.bias + c));
        v[0] += b.x; v[1] += b.y; v[2] += b.z; v[3] += b.w;
      }
      if (RAW) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rc = c + q - op.raw_col0;
          if (rc >= 0 && rc < op.raw_ncol)
            op.raw[p * 4 + op.raw_dst + rc] = v[q];
        }
        if (c >= op.out_cols) continue;  // out_cols is a multiple of 4
      }
      if (c < op.relu_cols)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = v[q] < 0.f ? 0.f : v[q];
      if (op.mask) {
        const float4 m = *reinterpret_cast<const float4*>(
            op.mask + p * op.mask_ld + c);
        v[0] = m.x > 0.f ? v[0] : 0.f;
        v[1] = m.y > 0.f ? v[1] : 0.f;
        v[2] = m.z > 0.f ? v[2] : 0.f;
        v[3] = m.w > 0.f ? v[3] : 0.f;
      }
      float4* o = reinterpret_cast<float4*>(op.out + p * op.out_ld + c);
      if (op.accumulate) {
        const float4 q = *o;
        v[0] = q.x + v[0]; v[1] = q.y + v[1];
        v[2] = q.z + v[2]; v[3] = q.w + v[3];
      }
      *o = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace
