// Dot-walk probes for Hopper (sm_90a): the fused forward kernel's products
// alone, with nothing else in the way.
//
// Four entry points, one for each TPU probe kernel they replace:
//   shape   tools/dot_decompose.py `make_shape_kernel` (run_shape):
//           out[N, n] = sum_{i < reps} x @ W_i, x [N, K], W_i [K, n]
//   mixed   tools/dot_decompose.py `make_mixed_kernel` (run_mixed): the
//           forward's 13-dot walk, no bias or relu, bf16 between dots,
//           skip and views layers as two split blocks each
//   merged  tools/dot_decompose.py `make_merged_kernel` (run_merged): the
//           11-dot walk, skip and views each one dot on a [T, 384]
//           operand, either a scratch buffer that the previous layer
//           writes in place (x in its last 128 columns, staged once) or a
//           fresh concatenation per use (h and x copied into it before
//           each of the two dots)
//   mosaic  tools/mosaic_probe.py `make_kernel` (run): 13 [T, 256] @
//           [256, 256] dots, chained, independent (summed) or MLP-like
//           (chained, +0.01 and relu after each)
// All take bf16 x and the weights packed by the wrapper as one stream of
// slab images (below), and write fp32 out; mixed and merged write rgb to
// out[:, :128] and the alpha block to out[:, 128:].
//
// Bound: operations.  At N = 2,629,632 rows the walks do 3.62 TFLOP (mixed
// and merged) and 4.48 TFLOP (mosaic, shape (256, 256) x 13) against
// 0.7 to 3.4 GB of x and out: 1,000 to 5,000 FLOP per byte, far above the
// card's ridge (about 295 FLOP per byte in bf16).  At the H100 SXM's 989
// TFLOP/s dense bf16 peak the 4.48 TFLOP take 4.53 ms.
//
// One product engine, wgmma, shared with the bf16 fused forward
// (wgmma_core.cuh).  One CTA owns a row tile of BM = 64, 128 or 256 rows
// (256: shape and mosaic independent only): one consumer warpgroup per 64
// rows and one producer warp.  The activations stay in shared memory as
// bf16, K-major in the 64-byte swizzle (32-column chunks of BM rows of 64
// bytes), x staged once by cp.async.  The 1.4 to 1.7 MB of weights fit in
// no SM, so every CTA streams them from L2: the wrapper packs them into
// the shared-memory images wgmma reads as B (dot_probe.probe_stream and
// walk_stream: W^T rows of 64 bytes in the same swizzle, one 32-row k-slab
// per image, in the order the kernel consumes them), and the producer
// copies them front to back with 1-D cp.async.bulk into a ring of 4 to 12
// stages (as many as fit beside the tiles) guarded by mbarriers; the
// consumers release a slab after wgmma_wait<1>, so no CTA-wide barrier
// stops the mainloop.  Each weight byte crosses from L2 once per CTA: BM
// FLOP per L2 byte, so the 256-row tile halves the stream of the 128-row
// one.
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
//   mixed and merged (walk_kernel): the 12 column passes of WALK, each
//   summing every k-slab of its product into one set of accumulators.
//   One activation tile of 384 columns holds h in chunks 0-7 and x in
//   chunks 8-11: merged's [T, 384] scratch buffer.  A product's passes
//   bound for out (the alpha block, rgb) store fp32; its kept pass (first
//   column 0, at most 256 columns) comes last and overwrites its own
//   input in place, after a warpgroup barrier, as mosaic chained does.
//   mixed's skip and views layers are two-term products taken h term
//   first: over the tile's chunks 0-11 that is merged's one K = 384
//   product with the two weights stacked, so mixed runs merged's kernel
//   on its own stream.  merged with concat keeps x, h and a fresh [T, 384]
//   operand cat in three tiles; before the skip and views products each
//   warpgroup copies its 64 rows of h and x into cat (the swizzle depends
//   on the row alone: a copy of 64-byte rows).  BM = 256 stays out: a
//   kept pass of 256 columns needs 128 accumulators a thread.  Shared
//   memory: tiles of BM x 768 bytes (concat: 1,536), beside a ring of 11
//   (BM = 64) or 8 stages of 16 KB; concat at BM = 128 would need 192 KB
//   of tiles, so it takes BM = 64 only.
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

constexpr int MAX_W = 13;     // weights of the longest walk
constexpr int W = 256;        // hidden width of every walk
constexpr int XK = 128;       // x width of mixed and merged
constexpr int CAT = 384;      // [h | x] operand width of merged

enum Variant { CHAINED = 0, INDEPENDENT = 1, MLP = 2 };

constexpr int SLAB_K = 32;        // k rows of one weight slab: 64-byte rows
constexpr int MAX_STAGES = 12;    // ring depth, at most
constexpr int SMEM_LIMIT = 232448;  // shared memory a CTA may use
constexpr int SMEM_ALIGN = 1024;    // slack to align the tiles' swizzle atoms

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

// Shared-memory addresses: the tiles (x, or the activations), the ring,
// its full and empty barriers.
struct WSmem {
  uint32_t tile, ring, full, empty;
  unsigned char* gtile;  // the tiles as a generic pointer
};

// Lays out and initialises the CTA's shared memory: 1024-aligned tiles of
// tile_bytes, nstage ring stages, 2 x nstage barriers.
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
// consumers have released it.
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

// Waits for the consumers to release the last stages, so that no copy is
// in flight when the producer exits.
__device__ __forceinline__ void drain(const WSmem& sm, int nstage, Ring r) {
  for (int k = 0; k < nstage; ++k, r.next(nstage))
    mbar_wait(sm.empty + 8 * r.st, r.ph ^ 1);
}

// x[row0 + 64 wg .. + 64, :k] -> warpgroup wg's rows of the tile at `dst`,
// in the 64-byte swizzle; waited for and visible to wgmma.
template <int BM>
__device__ __forceinline__ void stage_x(unsigned char* dst,
                                        const bf16* __restrict__ x, int k,
                                        long long row0, int wg) {
  const int ch = k / 8;
  for (int e = threadIdx.x & 127; e < 64 * ch; e += 128) {
    const int r = wg * 64 + e / ch;
    const int c = (e % ch) * 8;
    cp_async16(dst + sw64<BM>(r, c), x + (row0 + r) * k + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  wg_sync(wg);
}

// acc[64 x NP] += the warpgroup's 64 rows of the tile at `tile` (k
// columns) @ `reps` weights, one slab of 32 k rows at a time from the
// ring: every slab's two k16 wgmmas go into the same accumulators (one
// fp32 sum over all reps x k rows).  A slab is released once this warp's
// wgmma reads of it are done (wait_group 1 after the next slab's commit).
// Ends with the accumulators complete.
template <int BM, int NP>
__device__ __forceinline__ void mainloop(float* acc, uint32_t tile,
                                         const WSmem& sm, int nstage,
                                         int reps, int k, int wg, Ring& r) {
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = tile + wg * 64 * 64;
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

// acc [64 x NP] -> columns 0 .. NP of warpgroup wg's rows of the tile at
// `tile`, bf16, in place: waits until every warp of the warpgroup is past
// its wgmma reads of the tile, stores, and makes the stores visible to the
// next wgmma.  relu: max(v, 0) after rounding, which is rounding after
// relu; NaN passes.
template <int BM, int NP>
__device__ __forceinline__ void store_tile(const float* acc, uint32_t tile,
                                           int wg, bool relu) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  // (r, 8 j + 2 (lane % 4)) in the 64-byte swizzle: 16-byte group j & 3
  // of chunk j / 4, stored at group (j & 3) ^ ((r >> 1) & 3)
  const uint32_t dst = tile + (threadIdx.x & 3) * 4;
  wg_sync(wg);
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = acc_row(wg, h);
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                               acc[4 * j + 2 * h + 1]);
      if (relu) v = __hmax2_nan(v, zero);
      st_shared_u32(dst + (j >> 2) * Geo<BM>::CHUNK + row * 64 +
                        (((j & 3) ^ ((row >> 1) & 3)) << 4),
                    *reinterpret_cast<const uint32_t*>(&v));
    }
  fence_proxy_async();
  wg_sync(wg);
}

// ------------------------------------------------------- shape, mosaic --

template <int BM, int NP>
__device__ __forceinline__ void shape_pass(const WSmem& sm, int nstage,
                                           int reps, int k, int n, int c0,
                                           int wg, Ring& r,
                                           float* __restrict__ out,
                                           long long row0) {
  float acc[NP / 2];
#pragma unroll
  for (int j = 0; j < NP / 2; ++j) acc[j] = 0.f;
  mainloop<BM, NP>(acc, sm.tile, sm, nstage, reps, k, wg, r);
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
  stage_x<BM>(sm.gtile, x, k, row0, wg);
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
  stage_x<BM>(sm.gtile, x, W, row0, wg);
  const float start = relu ? 0.01f : 0.f;  // mlp: the +0.01 as the start
#pragma unroll 1
  for (int i = 0; i < MAX_W; ++i) {
    float acc[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) acc[j] = start;
    mainloop<BM, W>(acc, sm.tile, sm, nstage, 1, W, wg, r);
    if (i + 1 == MAX_W) {
      store_out<W>(acc, out, W, row0, 0, wg, relu);
      return;
    }
    store_tile<BM, W>(acc, sm.tile, wg, relu);
  }
}

// ------------------------------------------------------ mixed, merged --

enum Src { SRC_X = 0, SRC_H = 1, SRC_CAT = 2 };

// One column pass of a walk: its A operand (the tile `src`, `chunks` of 32
// columns from column 0), its width, and where it goes: the out column of
// its first value, or -1 for a pass kept in h (bf16, columns 0 .. np).
struct Pass {
  int src, chunks, np, out_col;
};

constexpr int NPASS = 12;
struct Walk {
  Pass p[NPASS];
};

// The passes of both walks, in order; the weight stream holds, pass by
// pass, the images of the pass's weight slabs (dot_probe.WALKS).
constexpr Walk WALK = {{
    {SRC_X, 4, 256, -1},     // L0
    {SRC_H, 8, 256, -1},     // L1
    {SRC_H, 8, 256, -1},     // L2
    {SRC_H, 8, 256, -1},     // L3
    {SRC_H, 8, 256, -1},     // L4
    {SRC_CAT, 12, 256, -1},  // skip: [h | x] @ W
    {SRC_H, 8, 256, -1},     // L6
    {SRC_H, 8, 256, -1},     // L7
    {SRC_H, 8, 128, 128},    // head: the alpha block to out[:, 128:]
    {SRC_H, 8, 256, -1},     // head: the feature
    {SRC_CAT, 12, 128, -1},  // views: [feature | x] @ W
    {SRC_H, 4, 128, 0},      // rgb to out[:, :128]
}};

constexpr long long walk_bytes() {
  long long b = 0;
  for (int i = 0; i < NPASS; ++i)
    b += (long long)WALK.p[i].chunks * WALK.p[i].np * SLAB_K * 2;
  return b;
}

// shared memory of the tiles: one [BM, 384] tile, or (concat) cat
// [BM, 384], h [BM, 256] and x [BM, 128], in that order
__host__ __device__ constexpr long long walk_tile_bytes(int bm,
                                                       bool concat) {
  return (long long)bm * (concat ? CAT + W + XK : CAT) * 2;
}

// cat's rows of warpgroup wg = [h | x], afresh: chunk c of cat is chunk
// 12 + c of the tiles (h, then x, follow cat), copied as 64-byte rows (the
// swizzle depends on the row alone); visible to wgmma after.
template <int BM>
__device__ __forceinline__ void concat(unsigned char* tiles, int wg) {
  constexpr int C = Geo<BM>::CHUNK;
  constexpr int ROW16 = 64 * 64 / 16;  // 16-byte words of a chunk's 64 rows
  const int base = wg * 64 * 64;
  for (int e = threadIdx.x & 127; e < (CAT / 32) * ROW16; e += 128) {
    const int b = (e / ROW16) * C + base + (e % ROW16) * 16;
    *reinterpret_cast<uint4*>(tiles + b) =
        *reinterpret_cast<const uint4*>(tiles + b + (CAT / 32) * C);
  }
  fence_proxy_async();
  wg_sync(wg);
}

template <int BM, int NP>
__device__ __forceinline__ void walk_pass(const Pass& p, uint32_t a,
                                          uint32_t h, const WSmem& sm,
                                          int nstage, int wg, Ring& r,
                                          float* __restrict__ out,
                                          long long row0) {
  float acc[NP / 2];
#pragma unroll
  for (int j = 0; j < NP / 2; ++j) acc[j] = 0.f;
  mainloop<BM, NP>(acc, a, sm, nstage, 1, p.chunks * SLAB_K, wg, r);
  if (p.out_col < 0) store_tile<BM, NP>(acc, h, wg, false);
  else store_out<NP>(acc, out, W, row0, p.out_col, wg, false);
}

// tools/dot_decompose.py `make_mixed_kernel` and `make_merged_kernel`:
// the passes of `walk` over one row tile; the weight stream is
// dot_probe.walk_stream of the walk's weights.
template <int BM, bool CONCAT>
__global__ void __launch_bounds__(Geo<BM>::THREADS, 1)
walk_kernel(int nstage, const __grid_constant__ Walk walk,
            const bf16* __restrict__ x,
            const unsigned char* __restrict__ wstream,
            float* __restrict__ out) {
  using G = Geo<BM>;
  static_assert(G::NPMAX == W, "a kept pass holds the full width");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WSmem sm =
      wg_smem<BM>(smem_raw, (int)walk_tile_bytes(BM, CONCAT), nstage);
  const long long row0 = (long long)blockIdx.x * BM;
  const int wg = threadIdx.x >> 7;
  Ring r;

  if (wg == G::NWG) {  // producer warp
    if ((threadIdx.x & 31) != 0) return;
    long long off = 0;
    for (int i = 0; i < NPASS; ++i)
      produce(sm, nstage, G::STAGE, wstream, walk.p[i].chunks,
              (uint32_t)walk.p[i].np * SLAB_K * 2, r, off);
    drain(sm, nstage, r);
    return;
  }
  // scratch: h in chunks 0-7 of the one tile, x in 8-11, the tile is cat
  const uint32_t cat = sm.tile;
  const uint32_t h = CONCAT ? cat + (CAT / 32) * G::CHUNK : cat;
  const uint32_t xt = h + (W / 32) * G::CHUNK;
  stage_x<BM>(sm.gtile + (xt - sm.tile), x, XK, row0, wg);
#pragma unroll 1
  for (int i = 0; i < NPASS; ++i) {
    const Pass& p = walk.p[i];
    if (CONCAT && p.src == SRC_CAT) concat<BM>(sm.gtile, wg);
    const uint32_t a = p.src == SRC_X ? xt : p.src == SRC_H ? h : cat;
    if (p.np == 256)
      walk_pass<BM, 256>(p, a, h, sm, nstage, wg, r, out, row0);
    else
      walk_pass<BM, 128>(p, a, h, sm, nstage, wg, r, out, row0);
  }
}

// ---------------------------------------------------------------- host --

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

// Ring depth of a wgmma kernel: as many stages as fit beside tiles of
// tile_bytes, at most MAX_STAGES; 0 if fewer than 4 fit.
template <int BM>
int ring_stages(long long tile_bytes) {
  const long long left = SMEM_LIMIT - SMEM_ALIGN - tile_bytes;
  const long long n = left / (Geo<BM>::STAGE + 16);
  return n < 4 ? 0 : (int)(n < MAX_STAGES ? n : MAX_STAGES);
}

// Launches a wgmma kernel of row tile BM: (nstage, args...) with a ring
// of as many stages as fit beside its tiles of tile_bytes.
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

int run_walk(const void* x, const void* w, long long w_bytes, bool concat,
             void* out, long long rows, int tile, void* stream) {
  if (!rows_ok(rows, tile) || (concat && tile != 64) ||
      w_bytes != walk_bytes())
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const unsigned char* wp = static_cast<const unsigned char*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (concat)
    return launch_wg<64>(walk_kernel<64, true>, walk_tile_bytes(64, true),
                         rows, s, WALK, xp, wp, o);
  if (tile == 64)
    return launch_wg<64>(walk_kernel<64, false>, walk_tile_bytes(64, false),
                         rows, s, WALK, xp, wp, o);
  return launch_wg<128>(walk_kernel<128, false>, walk_tile_bytes(128, false),
                        rows, s, WALK, xp, wp, o);
}

}  // namespace

extern "C" {

// Each launcher takes device pointers, launches on `stream` and returns
// cudaGetLastError() (0 on success).  w: the weights packed as one stream
// of slab images, 16-byte aligned (dot_probe.probe_stream for shape and
// mosaic, dot_probe.walk_stream for mixed and merged, whose launchers
// refuse a stream of other than w_bytes = the walk's bytes).

int plnerf_probe_shape(const void* x, const void* w, int reps, int k, int n,
                       void* out, long long rows, int tile, void* stream) {
  return shape(x, w, reps, k, n, out, rows, tile, stream);
}

int plnerf_probe_mixed(const void* x, const void* w, long long w_bytes,
                       void* out, long long rows, int tile, void* stream) {
  return run_walk(x, w, w_bytes, false, out, rows, tile, stream);
}

int plnerf_probe_merged(const void* x, const void* w, long long w_bytes,
                        int use_concat, void* out, long long rows, int tile,
                        void* stream) {
  return run_walk(x, w, w_bytes, use_concat != 0, out, rows, tile, stream);
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
