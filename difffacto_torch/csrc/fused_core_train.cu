// The trainable denoiser trunk: a forward and a backward kernel for sm_90a.
//
// Replaces the TPU pair difffacto_tpu/ops/fused_core_train.py:
// _trunk_train_fwd_kernel and _trunk_train_bwd_kernel (the custom VJP
// fused_trunk_train_call). The trunk is the one of csrc/fused_core.cu without
// proj_in: pre-LN -> depth x [LN -> q -> attention to the 4 part tokens ->
// out-proj -> dropout -> residual -> LN -> GEGLU FF with dropout on the
// activations -> residual] -> post-LN, bf16 operands, f32 accumulation and
// f32 LayerNorm statistics, rounded to bf16 where the Pallas kernels round.
//
// Dropout masks are never stored. Both kernels regenerate them from a 32-bit
// integer hash of (seed, batch row, global token, block, site, column): a
// murmur3 finalizer chained over the fields, kept when the hash is below
// round((1 - p) 2^32) and scaled by 1 / (1 - p). The mask depends on the
// global token index, not on the tile, and ops/fused_core_train.py computes
// the same bits in plain PyTorch.
//
// Forward: one thread block of 8 warps per (batch row, 64-token tile), the
// design of csrc/fused_core.cu; it saves nothing.
//
// Backward: recomputes the tile's forward, walks the blocks in reverse and
// returns dx (bf16), dK and dV ((depth, B, 4, 128), f32) and the 15 parameter
// gradients (f32). Matrix-product inputs of the backward are rounded to bf16
// first, as the Pallas kernel does.
//  * Recompute: the walk needs each block's input u and post-attention hidden
//    up, 2 x depth tiles of 64 x 128 bf16 (160 KB at depth 5), which do not
//    fit beside the weight staging in 227 KB. The grid is persistent (one
//    block per SM, each walking many tiles) and every block owns one such
//    scratch in global memory, 21.6 MB for 132 blocks, which stays in L2. A
//    32-token tile would have halved the reuse of every staged weight.
//  * The FF backward runs in eight 64-wide chunks of the 512 inner units so
//    that a, g, d_act (f32), the three weight chunks and the bf16 operands of
//    one chunk fit; the 64 x 1024 intermediate never exists whole.
//  * Weight gradients: a CUDA grid is concurrent, so a tile's contribution
//    (a product contracted over its 64 tokens) goes through shared memory
//    into zeroed f32 buffers with atomicAdd; 1.15 M adds per tile at depth 5
//    into 4.6 MB that stays in L2. dK, dV and the vector gradients go the
//    same way. The order of the sums changes from run to run, so gradients
//    repeat only to f32 rounding.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 230,400 MACs per token and
// block forward; given only its inputs the backward needs that once more and
// two products per matrix product, 691,200 MACs, 3 forwards. At B=128, N=2048,
// depth 5: 0.60 TFLOP forward (0.61 ms), 1.81 TFLOP backward (1.83 ms), against
// 0.14 GB of traffic: both are compute-bound. This kernel does more than the
// bound counts: keeping only u and up in the scratch, it repeats the Wq and W1
// products in the reverse walk (another 147,456 MACs, 0.6 forwards).
//
// First things a later change should fix: the weight re-reads from L2 per
// tile (as in fused_core.cu), scalar atomics (sm_90 has a 4-wide f32 red),
// synchronous staging, WMMA instead of wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;        // model width
constexpr int DH = 16;        // head width (8 heads)
constexpr int HEADS = 8;
constexpr int CTX = 4;        // context (part) tokens
constexpr int FF = 512;       // GEGLU inner width
constexpr int TILE = 64;      // tokens per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int FC = 64;        // inner units per chunk of the FF backward
constexpr int LDB = D + 8;    // bf16 row stride of a 128-wide tile
constexpr int LDF = D + 4;    // f32 row stride of a 128-wide tile
constexpr int LDC = FC + 8;   // bf16 row stride of a 64-wide tile
constexpr int LDCF = FC + 4;  // f32 row stride of a 64-wide tile

constexpr int SZ_BT = TILE * LDB * 2;   // 64 x 128 bf16
constexpr int SZ_FT = TILE * LDF * 4;   // 64 x 128 f32
constexpr int SZ_W = D * LDB * 2;       // 128 x 128 bf16
constexpr int SZ_BC = TILE * LDC * 2;   // 64 x 64 bf16
constexpr int SZ_FC = TILE * LDCF * 4;  // 64 x 64 f32
constexpr int SZ_W1C = D * LDC * 2;     // 128 x 64 bf16
constexpr int SZ_DW = D * LDCF * 4;     // 128 x 64 f32

// Common to every phase.
constexpr int OFF_X = 0;                             // residual stream / u / up, bf16
constexpr int OFF_KV = OFF_X + SZ_BT;                // K then V of this row and block, f32
constexpr int OFF_MASK = OFF_KV + 2 * CTX * D * 4;   // 4 floats
constexpr int OFF_KEYS = OFF_MASK + 32;              // 2 x 64 row keys of the dropout hash
constexpr int OFF_COLS = OFF_KEYS + 2 * TILE * 4;    // 4 x 128 column sums
constexpr int OFF_POOL = OFF_COLS + 4 * D * 4 + 96;  // 24192
// Forward (and the recompute of the backward).
constexpr int P_H = OFF_POOL;
constexpr int P_ACT = P_H + SZ_BT;
constexpr int P_F0 = P_ACT + SZ_BT;
constexpr int P_F1 = P_F0 + SZ_FT;
constexpr int P_W0 = P_F1 + SZ_FT;
constexpr int P_W1 = P_W0 + SZ_W;
constexpr int FWD_SMEM = P_W1 + SZ_W;
// Backward, FF half of a block.
constexpr int B_D = OFF_POOL;            // the gradient of the residual stream, f32
constexpr int B_FA = B_D + SZ_FT;        // a chunk, f32; FA and FG together also hold a
constexpr int B_FG = B_FA + SZ_FC;       // weight-gradient tile or a 64 x 128 f32 tile
constexpr int B_F2 = B_FG + SZ_FC;       // d_act chunk, f32
constexpr int B_WA1 = B_F2 + SZ_FC;      // W1[:, a chunk]
constexpr int B_WG1 = B_WA1 + SZ_W1C;    // W1[:, g chunk]
constexpr int B_W2C = B_WG1 + SZ_W1C;    // W2[chunk rows, :]
constexpr int B_DC = B_W2C + SZ_BT;      // bf16(d)
constexpr int B_H2 = B_DC + SZ_BT;       // LN(up)
constexpr int B_ACT = B_H2 + SZ_BT;      // activation chunk
constexpr int B_DA = B_ACT + SZ_BC;
constexpr int B_DG = B_DA + SZ_BC;
constexpr int BFF_SMEM = B_DG + SZ_BC;
// Backward, attention half of a block.
constexpr int A_FT = B_D + SZ_FT;        // f32 tile or a weight-gradient half
constexpr int A_H = A_FT + SZ_DW;
constexpr int A_Q = A_H + SZ_BT;
constexpr int A_ATT = A_Q + SZ_BT;
constexpr int A_DOC = A_ATT + SZ_BT;     // bf16(d_o), then bf16(dq)
constexpr int A_DATT = A_DOC + SZ_BT;
constexpr int A_WA = A_DATT + SZ_BT;
constexpr int A_WS = A_WA + SZ_W;        // softmax weights, 64 x 32 f32
constexpr int A_DSS = A_WS + TILE * HEADS * CTX * 4;
constexpr int BATT_SMEM = A_DSS + TILE * HEADS * CTX * 4;
constexpr int BWD_SMEM =
    BATT_SMEM > BFF_SMEM ? (BATT_SMEM > FWD_SMEM ? BATT_SMEM : FWD_SMEM)
                         : (BFF_SMEM > FWD_SMEM ? BFF_SMEM : FWD_SMEM);
static_assert(OFF_POOL % 128 == 0, "pool must stay aligned for WMMA");
static_assert(BWD_SMEM <= 232448 && FWD_SMEM <= 232448, "over the 227 KB a block may use");
static_assert(SZ_FT <= 2 * SZ_FC && SZ_DW <= 2 * SZ_FC, "FA and FG must hold a gradient tile");

struct Args {
  const bf16* x; const bf16* dy; const bf16* k; const bf16* v; const float* mask;
  const bf16* pre_scale; const bf16* pre_bias; const bf16* post_scale; const bf16* post_bias;
  const bf16* n2_scale; const bf16* n2_bias; const bf16* wq; const bf16* wout; const float* bout;
  const bf16* ff_scale; const bf16* ff_bias; const bf16* w1; const float* b1;
  const bf16* w2; const float* b2;
  const int* seed;
  bf16* out;      // forward: y; backward: dx
  bf16* scratch;  // backward: per thread block, 2 x depth tiles of 64 x 128
  float* dk; float* dv; float* dpre_s; float* dpre_b; float* dpost_s; float* dpost_b;
  float* dn2s; float* dn2b; float* dwq; float* dwout; float* dbout; float* dffs; float* dffb;
  float* dw1; float* db1; float* dw2; float* db2;
  int B, N, depth, drop;
  float scale, keep_scale;
  unsigned int thresh;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr float GELU_K0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_K1 = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.0f + tanhf(GELU_K0 * (v + GELU_K1 * v * v * v)));
}

__device__ __forceinline__ float gelu_tanh_prime(float g) {
  const float t = tanhf(GELU_K0 * (g + GELU_K1 * g * g * g));
  const float du = GELU_K0 * (1.0f + 3.0f * GELU_K1 * g * g);
  return 0.5f * (1.0f + t) + 0.5f * g * (1.0f - t * t) * du;
}

// ---- the dropout hash (ops/fused_core_train.py:dropout_bits computes the same)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13; h *= 0xC2B2AE35u; h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, int b, int n, int block, int site) {
  const uint32_t h = fmix32(seed + 0x9E3779B9u * (uint32_t)(b + 1));
  return fmix32(h ^ ((uint32_t)n * 0x85EBCA77u + (uint32_t)(block * 2 + site)));
}

__device__ __forceinline__ float drop_mult(const Args& a, uint32_t key, int col) {
  return fmix32(key + (uint32_t)col * 0x9E3779B9u) < a.thresh ? a.keep_scale : 0.0f;
}

__device__ __forceinline__ void make_keys(const Args& a, uint32_t* keys, int b, int n0, int block) {
  if (a.drop && threadIdx.x < 2 * TILE) {
    const int site = threadIdx.x >> 6, t = threadIdx.x & (TILE - 1);
    keys[site * TILE + t] = row_key((uint32_t)a.seed[0], b, n0 + t, block, site);
  }
}

// ---- copies
// rows x 128 bf16 from global (row stride src_ld) into shared memory (stride LDB).
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int src_ld, int rows) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += THREADS) {
    const int r = i >> 4, c = i & 15;
    reinterpret_cast<uint4*>(dst + r * LDB)[c] =
        reinterpret_cast<const uint4*>(src + (size_t)r * src_ld)[c];
  }
}

// 128 x 64 bf16 from global (row stride src_ld) into shared memory (stride LDC).
__device__ __forceinline__ void stage_cols64(bf16* dst, const bf16* src, int src_ld) {
  for (int i = threadIdx.x; i < D * (FC / 8); i += THREADS) {
    const int r = i >> 3, c = i & 7;
    reinterpret_cast<uint4*>(dst + r * LDC)[c] =
        reinterpret_cast<const uint4*>(src + (size_t)r * src_ld)[c];
  }
}

// A tile of the (B, N, 128) bf16 array src into shared memory; rows past N are 0.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b, int n0, int N) {
  for (int i = threadIdx.x; i < TILE * (D / 8); i += THREADS) {
    const int t = i >> 4, c = i & 15, n = n0 + t;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) v = reinterpret_cast<const uint4*>(src + ((size_t)b * N + n) * D)[c];
    reinterpret_cast<uint4*>(dst + t * LDB)[c] = v;
  }
}

__device__ __forceinline__ void store_tile(bf16* dst, const bf16* src, int b, int n0, int N) {
  for (int i = threadIdx.x; i < TILE * (D / 8); i += THREADS) {
    const int t = i >> 4, c = i & 15, n = n0 + t;
    if (n < N)
      reinterpret_cast<uint4*>(dst + ((size_t)b * N + n) * D)[c] =
          reinterpret_cast<const uint4*>(src + t * LDB)[c];
  }
}

// The tile to and from this block's dense 64 x 128 scratch slot.
__device__ __forceinline__ void save_scratch(bf16* slot, const bf16* src) {
  for (int i = threadIdx.x; i < TILE * (D / 8); i += THREADS)
    reinterpret_cast<uint4*>(slot)[i] = reinterpret_cast<const uint4*>(src + (i >> 4) * LDB)[i & 15];
}

__device__ __forceinline__ void load_scratch(bf16* dst, const bf16* slot) {
  for (int i = threadIdx.x; i < TILE * (D / 8); i += THREADS)
    reinterpret_cast<uint4*>(dst + (i >> 4) * LDB)[i & 15] = reinterpret_cast<const uint4*>(slot)[i];
}

// ---- matrix products
// acc[j] += A (16 rows from A, depth K) x B (K x 16 columns at 16 j). A points
// at its first row (row-major) or first column (ACOL: element (m, k) at
// A[k * lda + m]); B at its first column (row-major) or, BCOL, element (k, n)
// at B[n * ldb + k].
template <bool ACOL, bool BCOL, int NT>
__device__ __forceinline__ void mm(const bf16* A, int lda, const bf16* B, int ldb, int K,
                                   Acc (&acc)[NT]) {
  for (int kk = 0; kk < K; kk += 16) {
    FragA a;
    FragAT at;
    if (ACOL) wmma::load_matrix_sync(at, A + kk * lda, lda);
    else wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (BCOL) {
        FragBT bt;
        wmma::load_matrix_sync(bt, B + (j * 16) * ldb + kk, ldb);
        if (ACOL) wmma::mma_sync(acc[j], at, bt, acc[j]);
        else wmma::mma_sync(acc[j], a, bt, acc[j]);
      } else {
        FragB bb;
        wmma::load_matrix_sync(bb, B + kk * ldb + j * 16, ldb);
        if (ACOL) wmma::mma_sync(acc[j], at, bb, acc[j]);
        else wmma::mma_sync(acc[j], a, bb, acc[j]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(Acc (&acc)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.0f);
}

template <int NT>
__device__ __forceinline__ void store_acc(float* C, int ldc, Acc (&acc)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wmma::store_matrix_sync(C + j * 16, acc[j], ldc, wmma::mem_row_major);
}

// Warp tilings of an output: 64 x 128 (16 x 64 a warp), 64 x 64 (16 x 32), 128 x 64 (16 x 64).
__device__ __forceinline__ int row64() { return ((threadIdx.x >> 5) >> 1) * 16; }
__device__ __forceinline__ int col128() { return ((threadIdx.x >> 5) & 1) * 64; }
__device__ __forceinline__ int col64() { return ((threadIdx.x >> 5) & 1) * 32; }
__device__ __forceinline__ int row128() { return (threadIdx.x >> 5) * 16; }

// C (64 x 128 f32, stride LDF) = A (64 x 128 bf16, stride LDB) x W (128 x 128, stride LDB),
// or x W^T with WT.
template <bool WT>
__device__ __forceinline__ void gemm_tile(const bf16* A, const bf16* W, float* C) {
  Acc acc[4];
  zero_acc(acc);
  const int r0 = row64(), c0 = col128();
  if (WT) mm<false, true, 4>(A + r0 * LDB, LDB, W + c0 * LDB, LDB, D, acc);
  else mm<false, false, 4>(A + r0 * LDB, LDB, W + c0, LDB, D, acc);
  store_acc(C + r0 * LDF + c0, LDF, acc);
}

// One 128 x 64 half of a weight gradient: C (stride LDCF) = A^T x B[:, 64 half ...], both
// 64-token tiles; A has 128 columns (stride LDB), B points at its first column (stride ldb).
__device__ __forceinline__ void grad_128x64(const bf16* A, const bf16* B, int ldb, float* C) {
  Acc acc[4];
  zero_acc(acc);
  const int r0 = row128();
  mm<true, false, 4>(A + r0, LDB, B, ldb, TILE, acc);
  store_acc(C + r0 * LDCF, LDCF, acc);
}

// dst[r * ldd + c] += src[r * lds + c] over rows x COLS, with atomics.
template <int COLS>
__device__ __forceinline__ void flush_add(float* dst, int ldd, const float* src, int lds, int rows) {
  for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    atomicAdd(dst + (size_t)r * ldd + c, src[r * lds + c]);
  }
}

// The two column-sum vectors of a LayerNorm backward into global memory; zeroes them.
__device__ __forceinline__ void flush_cols(float* gs, float* gb, float* cs, float* cb) {
  if (threadIdx.x < D) {
    atomicAdd(gs + threadIdx.x, cs[threadIdx.x]);
    atomicAdd(gb + threadIdx.x, cb[threadIdx.x]);
    cs[threadIdx.x] = 0.0f;
    cb[threadIdx.x] = 0.0f;
  }
}

// ---- LayerNorm
// Each row of src into dst (both bf16, stride LDB): one warp per row, four
// columns per lane, two-pass f32 statistics. In place is safe.
__device__ __forceinline__ void layer_norm(const bf16* src, bf16* dst, const bf16* scale,
                                           const bf16* bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = __bfloat162float(scale[lane * 4 + j]);
    b[j] = __bfloat162float(bias[lane * 4 + j]);
  }
  for (int r = warp; r < TILE; r += THREADS / 32) {
    float v[4], sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __bfloat162float(src[r * LDB + lane * 4 + j]);
      sum += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum * (1.0f / D);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sq += (v[j] - mu) * (v[j] - mu);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = rsqrtf(sq * (1.0f / D) + 1e-5f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[r * LDB + lane * 4 + j] = __float2bfloat16((v[j] - mu) * inv * s[j] + b[j]);
  }
}

// Backward of y = LN(x) * scale + bias, row by row: with dxh = dy * scale,
// out = add + inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)). dy, out and
// add are f32 tiles of stride LDF (out may be dy or add). The column sums of
// dy * xhat and of dy are added to cs and cb in shared memory.
__device__ __forceinline__ void layer_norm_bwd(const bf16* x, const bf16* scale, const float* dy,
                                               float* out, const float* add, float* cs,
                                               float* cb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[4], ps[4], pb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = __bfloat162float(scale[lane * 4 + j]);
    ps[j] = 0.0f;
    pb[j] = 0.0f;
  }
  for (int r = warp; r < TILE; r += THREADS / 32) {
    float v[4], sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __bfloat162float(x[r * LDB + lane * 4 + j]);
      sum += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum * (1.0f / D);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sq += (v[j] - mu) * (v[j] - mu);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = rsqrtf(sq * (1.0f / D) + 1e-5f);
    float xh[4], dxh[4], m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = dy[r * LDF + lane * 4 + j];
      xh[j] = (v[j] - mu) * inv;
      ps[j] += g * xh[j];
      pb[j] += g;
      dxh[j] = g * s[j];
      m1 += dxh[j];
      m2 += dxh[j] * xh[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 *= (1.0f / D);
    m2 *= (1.0f / D);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = r * LDF + lane * 4 + j;
      const float res = inv * (dxh[j] - m1 - xh[j] * m2);
      out[idx] = add ? add[idx] + res : res;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    atomicAdd(cs + lane * 4 + j, ps[j]);
    atomicAdd(cb + lane * 4 + j, pb[j]);
  }
}

// ---- attention to the 4 context tokens
// Four consecutive lanes serve one token, two heads each. Reads q, writes the
// weighted sum of V to out (may be q); wsave, if given, gets the unrounded
// softmax weights as (token, head, context token).
__device__ __forceinline__ void attention(const bf16* q, bf16* out, float* wsave, const float* kv,
                                          const float* mask, float scale) {
  const int tok = threadIdx.x >> 2, h0 = (threadIdx.x & 3) * 2;
  const float* K = kv;
  const float* V = kv + CTX * D;
  const bf16* qrow = q + tok * LDB + h0 * DH;
  bf16* orow = out + tok * LDB + h0 * DH;
  float qv[2 * DH];
#pragma unroll
  for (int i = 0; i < 2 * DH; ++i) qv[i] = __bfloat162float(qrow[i]);
  float s[2][CTX];
  float c = -3.0e38f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      const float* kr = K + m * D + (h0 + hh) * DH;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc += qv[hh * DH + d] * kr[d];
      s[hh][m] = acc * scale + (mask[m] - 1.0f) * 1e30f;
      c = fmaxf(c, s[hh][m]);
    }
  }
  c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 1));
  c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 2));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float e[CTX], den = 0.0f;
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      e[m] = expf(s[hh][m] - c) * mask[m];
      den += e[m];
    }
    den = fmaxf(den, 1e-30f);
    float w[CTX];
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      const float wf = e[m] / den;
      if (wsave) wsave[tok * (HEADS * CTX) + (h0 + hh) * CTX + m] = wf;
      w[m] = round_bf16(wf);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < CTX; ++m) acc += w[m] * V[m * D + (h0 + hh) * DH + d];
      orow[hh * DH + d] = __float2bfloat16(acc);
    }
  }
}

// x = bf16(x + bf16((C + bias) * dropout)) over the whole tile; keys holds the
// rows' hash keys of this site, or is null where there is no dropout site.
__device__ __forceinline__ void residual_add(const Args& a, bf16* x, const float* C,
                                             const float* bias, const uint32_t* keys) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i >> 7, c = i & (D - 1);
    float o = C[r * LDF + c] + bias[c];
    if (keys && a.drop) o *= drop_mult(a, keys[r], c);
    x[r * LDB + c] = __float2bfloat16(__bfloat162float(x[r * LDB + c]) + round_bf16(o));
  }
}

__device__ __forceinline__ void load_kv(const Args& a, float* kv, int b, int block) {
  const size_t off = ((size_t)block * a.B + b) * CTX * D;
  for (int j = threadIdx.x; j < CTX * D; j += THREADS) {
    kv[j] = __bfloat162float(a.k[off + j]);
    kv[CTX * D + j] = __bfloat162float(a.v[off + j]);
  }
}

// The forward of one tile up to (not including) the post-LN; the residual
// stream ends in shared memory at OFF_X. With SAVE, each block's input and
// post-attention hidden go to this thread block's scratch.
template <bool SAVE>
__device__ __forceinline__ void forward_tile(const Args& a, unsigned char* smem, int b, int n0,
                                             bf16* scratch) {
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* hs = reinterpret_cast<bf16*>(smem + P_H);
  bf16* act = reinterpret_cast<bf16*>(smem + P_ACT);
  float* f0 = reinterpret_cast<float*>(smem + P_F0);
  float* f1 = reinterpret_cast<float*>(smem + P_F1);
  bf16* w0 = reinterpret_cast<bf16*>(smem + P_W0);
  bf16* w1s = reinterpret_cast<bf16*>(smem + P_W1);
  float* kv = reinterpret_cast<float*>(smem + OFF_KV);
  float* mask = reinterpret_cast<float*>(smem + OFF_MASK);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + OFF_KEYS);
  const int tid = threadIdx.x;

  load_tile(xs, a.x, b, n0, a.N);
  if (tid < CTX) mask[tid] = a.mask[b * CTX + tid];
  __syncthreads();
  layer_norm(xs, xs, a.pre_scale, a.pre_bias);
  __syncthreads();

  for (int i = 0; i < a.depth; ++i) {
    // ---- attention half
    if (SAVE) save_scratch(scratch + (size_t)(2 * i) * TILE * D, xs);
    make_keys(a, keys, b, n0, i);
    layer_norm(xs, hs, a.n2_scale + i * D, a.n2_bias + i * D);
    stage_rows(w0, a.wq + (size_t)i * D * D, D, D);
    load_kv(a, kv, b, i);
    __syncthreads();
    gemm_tile<false>(hs, w0, f0);
    __syncthreads();
    for (int j = tid; j < TILE * D; j += THREADS)
      hs[(j >> 7) * LDB + (j & (D - 1))] = __float2bfloat16(f0[(j >> 7) * LDF + (j & (D - 1))]);
    stage_rows(w0, a.wout + (size_t)i * D * D, D, D);
    __syncthreads();
    attention(hs, hs, nullptr, kv, mask, a.scale);
    __syncthreads();
    gemm_tile<false>(hs, w0, f0);
    __syncthreads();
    residual_add(a, xs, f0, a.bout + i * D, keys);
    __syncthreads();
    if (SAVE) save_scratch(scratch + (size_t)(2 * i + 1) * TILE * D, xs);

    // ---- GEGLU feed-forward half, four 128-wide chunks of the 512 inner units
    layer_norm(xs, hs, a.ff_scale + i * D, a.ff_bias + i * D);
    Acc ff[4];
    zero_acc(ff);
    const bf16* w1i = a.w1 + (size_t)i * D * 2 * FF;
    const float* b1i = a.b1 + i * 2 * FF;
    const int r0 = row64(), c0 = col128();
    for (int ch = 0; ch < FF / D; ++ch) {
      stage_rows(w0, w1i + ch * D, 2 * FF, D);
      stage_rows(w1s, w1i + FF + ch * D, 2 * FF, D);
      __syncthreads();
      gemm_tile<false>(hs, w0, f0);
      gemm_tile<false>(hs, w1s, f1);
      __syncthreads();
      for (int j = tid; j < TILE * D; j += THREADS) {
        const int r = j >> 7, c = j & (D - 1);
        const float u = f0[r * LDF + c] + b1i[ch * D + c];
        const float g = f1[r * LDF + c] + b1i[FF + ch * D + c];
        float av = u * gelu_tanh(g);
        if (a.drop) av *= drop_mult(a, keys[TILE + r], ch * D + c);
        act[r * LDB + c] = __float2bfloat16(av);
      }
      stage_rows(w0, a.w2 + ((size_t)i * FF + ch * D) * D, D, D);
      __syncthreads();
      mm<false, false, 4>(act + r0 * LDB, LDB, w0 + c0, LDB, D, ff);
      __syncthreads();
    }
    store_acc(f0 + r0 * LDF + c0, LDF, ff);
    __syncthreads();
    residual_add(a, xs, f0, a.b2 + i * D, nullptr);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 1) trunk_train_fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y, n0 = blockIdx.x * TILE;
  forward_tile<false>(a, smem, b, n0, nullptr);
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* hs = reinterpret_cast<bf16*>(smem + P_H);
  layer_norm(xs, hs, a.post_scale, a.post_bias);
  __syncthreads();
  store_tile(a.out, hs, b, n0, a.N);
}

__global__ void __launch_bounds__(THREADS, 1) trunk_train_bwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_X);
  float* kv = reinterpret_cast<float*>(smem + OFF_KV);
  float* mask = reinterpret_cast<float*>(smem + OFF_MASK);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + OFF_KEYS);
  float* cs = reinterpret_cast<float*>(smem + OFF_COLS);
  float* cb = cs + D;
  float* dd = reinterpret_cast<float*>(smem + B_D);
  // FF half
  float* fa = reinterpret_cast<float*>(smem + B_FA);
  float* fg = reinterpret_cast<float*>(smem + B_FG);
  float* f2 = reinterpret_cast<float*>(smem + B_F2);
  float* tmpf = fa;  // FA and FG together: a 64 x 128 f32 tile or a gradient tile
  bf16* wa1 = reinterpret_cast<bf16*>(smem + B_WA1);
  bf16* wg1 = reinterpret_cast<bf16*>(smem + B_WG1);
  bf16* w2c = reinterpret_cast<bf16*>(smem + B_W2C);
  bf16* dc = reinterpret_cast<bf16*>(smem + B_DC);
  bf16* h2 = reinterpret_cast<bf16*>(smem + B_H2);
  bf16* actc = reinterpret_cast<bf16*>(smem + B_ACT);
  bf16* dac = reinterpret_cast<bf16*>(smem + B_DA);
  bf16* dgc = reinterpret_cast<bf16*>(smem + B_DG);
  // attention half
  float* ft = reinterpret_cast<float*>(smem + A_FT);
  bf16* hh = reinterpret_cast<bf16*>(smem + A_H);
  bf16* qq = reinterpret_cast<bf16*>(smem + A_Q);
  bf16* att = reinterpret_cast<bf16*>(smem + A_ATT);
  bf16* doc = reinterpret_cast<bf16*>(smem + A_DOC);
  bf16* datt = reinterpret_cast<bf16*>(smem + A_DATT);
  bf16* wa = reinterpret_cast<bf16*>(smem + A_WA);
  float* ws = reinterpret_cast<float*>(smem + A_WS);
  float* dss = reinterpret_cast<float*>(smem + A_DSS);

  const int tid = threadIdx.x;
  const int tiles_per_row = (a.N + TILE - 1) / TILE;
  const int total = a.B * tiles_per_row;
  bf16* scratch = a.scratch + (size_t)blockIdx.x * 2 * a.depth * TILE * D;

  if (tid < D) {
    cs[tid] = 0.0f;
    cb[tid] = 0.0f;
  }

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int b = tile / tiles_per_row, n0 = (tile % tiles_per_row) * TILE;
    __syncthreads();
    forward_tile<true>(a, smem, b, n0, scratch);

    // ---- post-LN backward: d = dLN(x_final), from dy
    for (int i = tid; i < TILE * D; i += THREADS) {
      const int r = i >> 7, c = i & (D - 1), n = n0 + r;
      tmpf[r * LDF + c] = n < a.N ? __bfloat162float(a.dy[((size_t)b * a.N + n) * D + c]) : 0.0f;
    }
    __syncthreads();
    layer_norm_bwd(xs, a.post_scale, tmpf, dd, nullptr, cs, cb);
    __syncthreads();
    flush_cols(a.dpost_s, a.dpost_b, cs, cb);
    __syncthreads();

    for (int i = a.depth - 1; i >= 0; --i) {
      make_keys(a, keys, b, n0, i);
      // ================= feed-forward half: v = up + FF(LN(up))
      load_scratch(xs, scratch + (size_t)(2 * i + 1) * TILE * D);
      __syncthreads();
      layer_norm(xs, h2, a.ff_scale + i * D, a.ff_bias + i * D);
      {
        // bf16(d) and db2, a fixed column per thread
        const int c = tid & (D - 1);
        float sum = 0.0f;
        for (int r = tid >> 7; r < TILE; r += THREADS / D) {
          const float v = dd[r * LDF + c];
          dc[r * LDB + c] = __float2bfloat16(v);
          sum += v;
        }
        atomicAdd(a.db2 + i * D + c, sum);
      }
      Acc dh2[4];
      zero_acc(dh2);
      const bf16* w1i = a.w1 + (size_t)i * D * 2 * FF;
      const float* b1i = a.b1 + i * 2 * FF;
      for (int ch = 0; ch < FF / FC; ++ch) {
        stage_cols64(wa1, w1i + ch * FC, 2 * FF);
        stage_cols64(wg1, w1i + FF + ch * FC, 2 * FF);
        stage_rows(w2c, a.w2 + ((size_t)i * FF + ch * FC) * D, D, FC);
        __syncthreads();
        {
          // a and g chunks and d_act = bf16(d) W2[chunk]^T, each 64 x 64
          const int r0 = row64(), c0 = col64();
          Acc acc[2];
          zero_acc(acc);
          mm<false, false, 2>(h2 + r0 * LDB, LDB, wa1 + c0, LDC, D, acc);
          store_acc(fa + r0 * LDCF + c0, LDCF, acc);
          zero_acc(acc);
          mm<false, false, 2>(h2 + r0 * LDB, LDB, wg1 + c0, LDC, D, acc);
          store_acc(fg + r0 * LDCF + c0, LDCF, acc);
          zero_acc(acc);
          mm<false, true, 2>(dc + r0 * LDB, LDB, w2c + c0 * LDB, LDB, D, acc);
          store_acc(f2 + r0 * LDCF + c0, LDCF, acc);
        }
        __syncthreads();
        {
          const int c = tid & (FC - 1), col = ch * FC + c;
          const float ba = b1i[col], bg = b1i[FF + col];
          float suma = 0.0f, sumg = 0.0f;
          for (int r = tid >> 6; r < TILE; r += THREADS / FC) {
            const float av = fa[r * LDCF + c] + ba;
            const float gv = fg[r * LDCF + c] + bg;
            const float gl = gelu_tanh(gv);
            const float m2 = a.drop ? drop_mult(a, keys[TILE + r], col) : 1.0f;
            actc[r * LDC + c] = __float2bfloat16(av * gl * m2);
            const float dact = f2[r * LDCF + c] * m2;
            const float da = dact * gl;
            const float dg = dact * av * gelu_tanh_prime(gv);
            dac[r * LDC + c] = __float2bfloat16(da);
            dgc[r * LDC + c] = __float2bfloat16(dg);
            suma += da;
            sumg += dg;
          }
          atomicAdd(a.db1 + i * 2 * FF + col, suma);
          atomicAdd(a.db1 + i * 2 * FF + FF + col, sumg);
        }
        __syncthreads();
        {
          // dW2[chunk rows] = act^T bf16(d): 64 x 128
          const int r0 = row64(), c0 = col128();
          Acc acc[4];
          zero_acc(acc);
          mm<true, false, 4>(actc + r0, LDC, dc + c0, LDB, TILE, acc);
          store_acc(tmpf + r0 * LDF + c0, LDF, acc);
          // d(LN(up)) += da W1a[chunk]^T + dg W1g[chunk]^T
          mm<false, true, 4>(dac + r0 * LDC, LDC, wa1 + c0 * LDC, LDC, FC, dh2);
          mm<false, true, 4>(dgc + r0 * LDC, LDC, wg1 + c0 * LDC, LDC, FC, dh2);
        }
        __syncthreads();
        flush_add<D>(a.dw2 + ((size_t)i * FF + ch * FC) * D, D, tmpf, LDF, FC);
        __syncthreads();
        grad_128x64(h2, dac, LDC, tmpf);
        __syncthreads();
        flush_add<FC>(a.dw1 + (size_t)i * D * 2 * FF + ch * FC, 2 * FF, tmpf, LDCF, D);
        __syncthreads();
        grad_128x64(h2, dgc, LDC, tmpf);
        __syncthreads();
        flush_add<FC>(a.dw1 + (size_t)i * D * 2 * FF + FF + ch * FC, 2 * FF, tmpf, LDCF, D);
        __syncthreads();
      }
      store_acc(tmpf + row64() * LDF + col128(), LDF, dh2);
      __syncthreads();
      layer_norm_bwd(xs, a.ff_scale + i * D, tmpf, dd, dd, cs, cb);  // d = dup
      __syncthreads();
      flush_cols(a.dffs + i * D, a.dffb + i * D, cs, cb);

      // ================= attention half: up = u + drop(attn(LN(u)) Wout + bout)
      load_scratch(xs, scratch + (size_t)(2 * i) * TILE * D);
      load_kv(a, kv, b, i);
      stage_rows(wa, a.wq + (size_t)i * D * D, D, D);
      __syncthreads();
      layer_norm(xs, hh, a.n2_scale + i * D, a.n2_bias + i * D);
      __syncthreads();
      gemm_tile<false>(hh, wa, ft);
      __syncthreads();
      for (int j = tid; j < TILE * D; j += THREADS)
        qq[(j >> 7) * LDB + (j & (D - 1))] = __float2bfloat16(ft[(j >> 7) * LDF + (j & (D - 1))]);
      stage_rows(wa, a.wout + (size_t)i * D * D, D, D);
      {
        // bf16(d_o), d_o = dup * dropout, and dbout
        const int c = tid & (D - 1);
        float sum = 0.0f;
        for (int r = tid >> 7; r < TILE; r += THREADS / D) {
          float v = dd[r * LDF + c];
          if (a.drop) v *= drop_mult(a, keys[r], c);
          doc[r * LDB + c] = __float2bfloat16(v);
          sum += v;
        }
        atomicAdd(a.dbout + i * D + c, sum);
      }
      __syncthreads();
      attention(qq, att, ws, kv, mask, a.scale);
      __syncthreads();
      for (int half = 0; half < 2; ++half) {  // dWout = attn^T bf16(d_o)
        grad_128x64(att, doc + half * FC, LDB, ft);
        __syncthreads();
        flush_add<FC>(a.dwout + (size_t)i * D * D + half * FC, D, ft, LDCF, D);
        __syncthreads();
      }
      gemm_tile<true>(doc, wa, ft);  // d_attn = bf16(d_o) Wout^T
      __syncthreads();
      {
        // softmax and score backward per (token, head)
        const int tok = tid >> 2, h0 = (tid & 3) * 2;
        const float* K = kv;
        const float* V = kv + CTX * D;
        for (int hx = 0; hx < 2; ++hx) {
          const int h = h0 + hx;
          float da[DH];
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            da[d] = round_bf16(ft[tok * LDF + h * DH + d]);
            datt[tok * LDB + h * DH + d] = __float2bfloat16(da[d]);
          }
          float dws[CTX], w[CTX], t = 0.0f;
#pragma unroll
          for (int m = 0; m < CTX; ++m) {
            float acc = 0.0f;
#pragma unroll
            for (int d = 0; d < DH; ++d) acc += da[d] * V[m * D + h * DH + d];
            dws[m] = acc;
            w[m] = ws[tok * (HEADS * CTX) + h * CTX + m];
            t += acc * w[m];
          }
          float ds[CTX];
#pragma unroll
          for (int m = 0; m < CTX; ++m) {
            ds[m] = round_bf16(w[m] * (dws[m] - t));
            dss[tok * (HEADS * CTX) + h * CTX + m] = ds[m];
          }
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            float acc = 0.0f;
#pragma unroll
            for (int m = 0; m < CTX; ++m) acc += ds[m] * K[m * D + h * DH + d];
            doc[tok * LDB + h * DH + d] = __float2bfloat16(acc * a.scale);  // bf16(dq)
          }
        }
      }
      stage_rows(wa, a.wq + (size_t)i * D * D, D, D);
      __syncthreads();
      {
        // dV = bf16(w)^T bf16(d_attn), dK = scale q^T bf16(ds): (4, 128) each
        const int c = tid & (D - 1), h = c >> 4, m0 = (tid >> 7) * 2;
        float v0 = 0.0f, v1 = 0.0f, k0 = 0.0f, k1 = 0.0f;
        for (int t = 0; t < TILE; ++t) {
          const float dav = __bfloat162float(datt[t * LDB + c]);
          const float qv = __bfloat162float(qq[t * LDB + c]);
          const int o = t * (HEADS * CTX) + h * CTX + m0;
          v0 += round_bf16(ws[o]) * dav;
          v1 += round_bf16(ws[o + 1]) * dav;
          k0 += qv * dss[o];
          k1 += qv * dss[o + 1];
        }
        const size_t off = (((size_t)i * a.B + b) * CTX + m0) * D + c;
        atomicAdd(a.dv + off, v0);
        atomicAdd(a.dv + off + D, v1);
        atomicAdd(a.dk + off, k0 * a.scale);
        atomicAdd(a.dk + off + D, k1 * a.scale);
      }
      for (int half = 0; half < 2; ++half) {  // dWq = LN(u)^T bf16(dq)
        grad_128x64(hh, doc + half * FC, LDB, ft);
        __syncthreads();
        flush_add<FC>(a.dwq + (size_t)i * D * D + half * FC, D, ft, LDCF, D);
        __syncthreads();
      }
      gemm_tile<true>(doc, wa, ft);  // d(LN(u)) = bf16(dq) Wq^T
      __syncthreads();
      layer_norm_bwd(xs, a.n2_scale + i * D, ft, dd, dd, cs, cb);  // d = dup + dLN
      __syncthreads();
      flush_cols(a.dn2s + i * D, a.dn2b + i * D, cs, cb);
      __syncthreads();
    }

    // ---- pre-LN backward and dx
    load_tile(xs, a.x, b, n0, a.N);
    __syncthreads();
    layer_norm_bwd(xs, a.pre_scale, dd, dd, nullptr, cs, cb);
    __syncthreads();
    flush_cols(a.dpre_s, a.dpre_b, cs, cb);
    for (int i = tid; i < TILE * D; i += THREADS) {
      const int r = i >> 7, c = i & (D - 1), n = n0 + r;
      if (n < a.N) a.out[((size_t)b * a.N + n) * D + c] = __float2bfloat16(dd[r * LDF + c]);
    }
  }
}

void fill_args(Args& a, const void* const* p, const void* seed, int B, int N, int depth,
               float scale, float keep_scale, unsigned int thresh, int drop) {
  a.x = (const bf16*)p[0]; a.k = (const bf16*)p[1]; a.v = (const bf16*)p[2];
  a.mask = (const float*)p[3];
  a.pre_scale = (const bf16*)p[4]; a.pre_bias = (const bf16*)p[5];
  a.post_scale = (const bf16*)p[6]; a.post_bias = (const bf16*)p[7];
  a.n2_scale = (const bf16*)p[8]; a.n2_bias = (const bf16*)p[9];
  a.wq = (const bf16*)p[10]; a.wout = (const bf16*)p[11]; a.bout = (const float*)p[12];
  a.ff_scale = (const bf16*)p[13]; a.ff_bias = (const bf16*)p[14];
  a.w1 = (const bf16*)p[15]; a.b1 = (const float*)p[16];
  a.w2 = (const bf16*)p[17]; a.b2 = (const float*)p[18];
  a.seed = (const int*)seed;
  a.B = B; a.N = N; a.depth = depth; a.drop = drop;
  a.scale = scale; a.keep_scale = keep_scale; a.thresh = thresh;
}

bool bad_shape(int B, int N, int depth) { return B < 1 || B > 65535 || N < 1 || depth < 1; }

}  // namespace

// ops: the 19 operand pointers in the order x, k, v, mask, pre_scale, pre_bias,
// post_scale, post_bias, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias,
// w1, b1, w2, b2. seed: one int32 on the device.
extern "C" int difffacto_trunk_train_fwd(const void* const* ops, const void* seed, void* out,
                                         int B, int N, int depth, float scale, float keep_scale,
                                         unsigned int thresh, int drop, void* stream) {
  if (bad_shape(B, N, depth)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  fill_args(a, ops, seed, B, N, depth, scale, keep_scale, thresh, drop);
  a.out = (bf16*)out;
  dim3 grid((N + TILE - 1) / TILE, B);
  trunk_train_fwd_kernel<<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// grads: one zeroed f32 buffer holding, in this order, dk and dv (depth, B, 4,
// 128), dpre_s, dpre_b, dpost_s, dpost_b (128), dn2s, dn2b (depth, 128), dwq,
// dwout (depth, 128, 128), dbout, dffs, dffb (depth, 128), dw1 (depth, 128,
// 1024), db1 (depth, 1024), dw2 (depth, 512, 128), db2 (depth, 128). scratch:
// blocks x 2 depth x 64 x 128 bf16.
extern "C" int difffacto_trunk_train_bwd(const void* const* ops, const void* dy, const void* seed,
                                         void* dx, void* scratch, void* grads, int blocks, int B,
                                         int N, int depth, float scale, float keep_scale,
                                         unsigned int thresh, int drop, void* stream) {
  if (bad_shape(B, N, depth) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  fill_args(a, ops, seed, B, N, depth, scale, keep_scale, thresh, drop);
  a.dy = (const bf16*)dy;
  a.out = (bf16*)dx;
  a.scratch = (bf16*)scratch;
  float* g = (float*)grads;
  const size_t kv = (size_t)depth * B * CTX * D, vec = (size_t)depth * D;
  a.dk = g; g += kv;
  a.dv = g; g += kv;
  a.dpre_s = g; g += D;
  a.dpre_b = g; g += D;
  a.dpost_s = g; g += D;
  a.dpost_b = g; g += D;
  a.dn2s = g; g += vec;
  a.dn2b = g; g += vec;
  a.dwq = g; g += vec * D;
  a.dwout = g; g += vec * D;
  a.dbout = g; g += vec;
  a.dffs = g; g += vec;
  a.dffb = g; g += vec;
  a.dw1 = g; g += vec * 2 * FF;
  a.db1 = g; g += (size_t)depth * 2 * FF;
  a.dw2 = g; g += (size_t)depth * FF * D;
  a.db2 = g;
  trunk_train_bwd_kernel<<<blocks, THREADS, BWD_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one thread block of the forward and of the backward.
extern "C" int difffacto_trunk_train_fwd_smem_bytes() { return FWD_SMEM; }
extern "C" int difffacto_trunk_train_bwd_smem_bytes() { return BWD_SMEM; }
