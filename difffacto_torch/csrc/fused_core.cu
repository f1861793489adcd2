// The whole denoiser trunk of one diffusion step, as one kernel for sm_90a.
//
// Replaces the TPU kernel difffacto_tpu/ops/fused_core.py:_core_kernel (the
// Pallas program launched at difffacto_tpu/models/denoiser.py:270) with the
// head fused and the tail not, as the JAX default runs it. For every token:
//
//   h = proj_in(x)                      13 -> 128, f32 accumulate, round bf16
//   h = LN(h)                           pre-LN
//   5 x [ a = LN(h); q = a Wq                                   (round bf16)
//         attention to the 4 part tokens, 8 heads of 16, scale 0.25: scores
//         f32; masked tokens sunk by -1e30 before one max-shift per token;
//         weights zeroed by the mask, divided by the per-head sum (clamped at
//         1e-30), rounded to bf16; weighted sum of V rounded to bf16
//         h = h + bf16(attn Wout + bout)
//         a = LN(h); [u | g] = a W1 + b1     (128 -> 2 x 512, f32)
//         h = h + bf16(bf16(u * gelu_tanh(g)) W2 + b2) ]
//   out = LN(h)                         post-LN, (B, N, 128) bf16
//
// Operands are bf16; LayerNorm statistics (eps 1e-5, biased variance) and all
// accumulation are f32. The bf16 rounding points are the Pallas kernel's.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 1,153,664 MACs per token, so
// 1.21e12 FLOP per launch at B=256, N=2048 (1.22 ms), against ~153 MB of
// traffic (0.046 ms): the kernel is compute-bound.
//
// Design (simple first): one thread block of 8 warps per (batch row, 64-token
// tile); a tile never crosses a batch row and the ragged edge is masked. The
// tile's residual stream stays in shared memory (bf16) for all five blocks.
// Matrix products use WMMA bf16 16x16x16 fragments with f32 accumulators: a
// warp owns a 16 x 64 slab of the 64 x 128 output. Each block's Wq, Wout, then
// W1 and W2 stream through shared memory in 128-column chunks, and the FF
// output accumulates over the four chunks in registers, so the 64 x 1024
// GEGLU intermediate never exists whole. K and V of the 4 context tokens
// ((depth, B, 4, 128), computed outside) are staged per block. Shared memory
// is ~189 KB, so one block runs per SM.
//
// A second entry point, difffacto_fused_block, runs one block alone from the
// same code with proj_in and the pre- and post-LN compiled out: x (B, N, 128)
// bf16 in, the block's residual stream out. It replaces the TPU kernel
// difffacto_tpu/ops/fused_block.py:_block_kernel (the flat single-attention
// block with a context, difffacto_tpu/nn/attention.py:271), whose arithmetic
// is this kernel's per-block body. Its bound: 14 D^2 + 1024 MACs per token,
// 2.41e11 FLOP at B=256, N=2048 (0.24 ms), against 0.46 MB of weights and 4
// bytes a token and channel of x in and out (0.08 ms): compute-bound.
//
// First thing a later change should fix: one block's weights are 0.46 MB
// (2.29 MB for five), so they cannot stay resident as they do in the TPU's
// VMEM, and every thread block re-reads all 2.29 MB from L2 -- at B=256,
// 8,192 blocks x 2.29 MB ~ 19 GB of L2 traffic per launch, more than the
// tensor-core time. Larger token tiles, a cluster sharing weight chunks
// through TMA multicast, or a persistent block that keeps a weight slice and
// walks many tiles all cut it. The loads are synchronous (no cp.async/TMA
// pipeline) and WMMA is not wgmma; both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;        // model width
constexpr int DH = 16;        // head width (8 heads)
constexpr int CTX = 4;        // context (part) tokens
constexpr int FF = 512;       // GEGLU inner width
constexpr int MAX_IN = 16;    // widest raw input
constexpr int TILE = 64;      // tokens per thread block
constexpr int THREADS = 256;  // 8 warps
constexpr int LDB = D + 8;    // bf16 row stride in shared memory (staggers banks)
constexpr int LDF = D + 4;    // f32 row stride in shared memory

constexpr int SZ_TILE_BF = TILE * LDB * 2;
constexpr int SZ_TILE_F = TILE * LDF * 4;
constexpr int SZ_W = D * LDB * 2;
constexpr int OFF_X = 0;                        // residual stream, bf16
constexpr int OFF_H = OFF_X + SZ_TILE_BF;       // LN output, then q, then attention output
constexpr int OFF_ACT = OFF_H + SZ_TILE_BF;     // GEGLU activation chunk, bf16
constexpr int OFF_F0 = OFF_ACT + SZ_TILE_BF;    // f32 scratch (also the staged input)
constexpr int OFF_F1 = OFF_F0 + SZ_TILE_F;      // f32 scratch
constexpr int OFF_W0 = OFF_F1 + SZ_TILE_F;      // weight chunk, 128 x 128 bf16
constexpr int OFF_W1 = OFF_W0 + SZ_W;           // weight chunk
constexpr int OFF_KV = OFF_W1 + SZ_W;           // K then V of this row and block, f32
constexpr int OFF_MASK = OFF_KV + 2 * CTX * D * 4;
constexpr int SMEM_BYTES = OFF_MASK + CTX * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
static_assert(TILE * MAX_IN * 4 + MAX_IN * D * 4 <= SZ_TILE_F, "staged input must fit in F0");

struct Args {
  const bf16* x; const bf16* pin_w; const float* pin_b;
  const bf16* k; const bf16* v; const float* mask;
  const bf16* pre_scale; const bf16* pre_bias; const bf16* post_scale; const bf16* post_bias;
  const bf16* n2_scale; const bf16* n2_bias; const bf16* wq; const bf16* wout; const float* bout;
  const bf16* ff_scale; const bf16* ff_bias; const bf16* w1; const float* b1;
  const bf16* w2; const float* b2;
  bf16* out;
  int B, N, in_ch, depth;
  float scale;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

// Copy a 128 x 128 bf16 block (row stride src_ld elements) into shared memory.
__device__ __forceinline__ void stage_weight(bf16* dst, const bf16* src, int src_ld) {
  for (int i = threadIdx.x; i < D * (D / 8); i += THREADS) {
    const int r = i >> 4, c = i & 15;
    reinterpret_cast<uint4*>(dst + r * LDB)[c] =
        reinterpret_cast<const uint4*>(src + (size_t)r * src_ld)[c];
  }
}

// acc[j] += A (64 x 128, this warp's 16 rows) x W (128 x 128, this warp's 64 columns).
__device__ __forceinline__ void warp_gemm(const bf16* A, const bf16* W, Acc (&acc)[4]) {
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp >> 1) * 16, col0 = (warp & 1) * 64;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + row0 * LDB + kk, LDB);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, W + kk * LDB + col0 + j * 16, LDB);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(Acc (&acc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
}

__device__ __forceinline__ void store_acc(float* C, Acc (&acc)[4]) {
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp >> 1) * 16, col0 = (warp & 1) * 64;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(C + row0 * LDF + col0 + j * 16, acc[j], LDF, wmma::mem_row_major);
}

// C = A x W, written to f32 shared memory.
__device__ __forceinline__ void gemm_to(const bf16* A, const bf16* W, float* C) {
  Acc acc[4];
  zero_acc(acc);
  warp_gemm(A, W, acc);
  store_acc(C, acc);
}

// LayerNorm of each row of src into dst (both bf16, stride LDB): one warp per
// row, four columns per lane, two-pass f32 statistics.
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

// Attention of every token to the 4 context tokens, in place on q: four
// consecutive lanes serve one token, two heads each.
__device__ __forceinline__ void attention(bf16* q, const float* kv, const float* mask,
                                          float scale) {
  const int tok = threadIdx.x >> 2, h0 = (threadIdx.x & 3) * 2;
  const float* K = kv;
  const float* V = kv + CTX * D;
  bf16* row = q + tok * LDB + h0 * DH;
  float qv[2 * DH];
#pragma unroll
  for (int i = 0; i < 2 * DH; ++i) qv[i] = __bfloat162float(row[i]);
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
    for (int m = 0; m < CTX; ++m) w[m] = round_bf16(e[m] / den);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < CTX; ++m) acc += w[m] * V[m * D + (h0 + hh) * DH + d];
      row[hh * DH + d] = __float2bfloat16(acc);
    }
  }
}

// x = bf16(x + bf16(C + bias)) over the whole tile.
__device__ __forceinline__ void residual_add(bf16* x, const float* C, const float* bias) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i >> 7, c = i & (D - 1);
    const float o = round_bf16(C[r * LDF + c] + bias[c]);
    x[r * LDB + c] = __float2bfloat16(__bfloat162float(x[r * LDB + c]) + o);
  }
}

// TRUNK: the whole trunk (proj_in, pre-LN, depth blocks, post-LN). Otherwise
// one block on x (B, N, D) as it is, its residual stream stored.
template <bool TRUNK>
__global__ void __launch_bounds__(THREADS, 1) fused_core_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* hs = reinterpret_cast<bf16*>(smem + OFF_H);
  bf16* act = reinterpret_cast<bf16*>(smem + OFF_ACT);
  float* f0 = reinterpret_cast<float*>(smem + OFF_F0);
  float* f1 = reinterpret_cast<float*>(smem + OFF_F1);
  bf16* w0 = reinterpret_cast<bf16*>(smem + OFF_W0);
  bf16* w1s = reinterpret_cast<bf16*>(smem + OFF_W1);
  float* kv = reinterpret_cast<float*>(smem + OFF_KV);
  float* mask = reinterpret_cast<float*>(smem + OFF_MASK);

  const int b = blockIdx.y, n0 = blockIdx.x * TILE, tid = threadIdx.x;
  if (tid < CTX) mask[tid] = a.mask[b * CTX + tid];

  if constexpr (TRUNK) {
    // ---- proj_in: stage the raw input tile and the 13 x 128 kernel in f32
    const int in_ch = a.in_ch;
    float* xin = f0;                  // (TILE, MAX_IN)
    float* pw = f0 + TILE * MAX_IN;   // (MAX_IN, D)
    for (int i = tid; i < TILE * in_ch; i += THREADS) {
      const int t = i / in_ch, c = i - t * in_ch, n = n0 + t;
      xin[t * MAX_IN + c] =
          n < a.N ? __bfloat162float(a.x[((size_t)b * a.N + n) * in_ch + c]) : 0.0f;
    }
    for (int i = tid; i < in_ch * D; i += THREADS) pw[i] = __bfloat162float(a.pin_w[i]);
    __syncthreads();
    for (int i = tid; i < TILE * D; i += THREADS) {
      const int t = i >> 7, c = i & (D - 1);
      float acc = 0.0f;
      for (int j = 0; j < in_ch; ++j) acc += xin[t * MAX_IN + j] * pw[j * D + c];
      xs[t * LDB + c] = __float2bfloat16(acc + a.pin_b[c]);
    }
    __syncthreads();
    layer_norm(xs, xs, a.pre_scale, a.pre_bias);
  } else {
    // ---- the block's input tile as it is, zero past the last token
    for (int i = tid; i < TILE * (D / 8); i += THREADS) {
      const int t = i >> 4, c = i & 15, n = n0 + t;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < a.N) val = reinterpret_cast<const uint4*>(a.x + ((size_t)b * a.N + n) * D)[c];
      reinterpret_cast<uint4*>(xs + t * LDB)[c] = val;
    }
  }
  __syncthreads();

  for (int i = 0; i < a.depth; ++i) {
    // ---- attention half
    layer_norm(xs, hs, a.n2_scale + i * D, a.n2_bias + i * D);
    stage_weight(w0, a.wq + (size_t)i * D * D, D);
    const size_t kv_off = ((size_t)i * a.B + b) * CTX * D;
    for (int j = tid; j < CTX * D; j += THREADS) {
      kv[j] = __bfloat162float(a.k[kv_off + j]);
      kv[CTX * D + j] = __bfloat162float(a.v[kv_off + j]);
    }
    __syncthreads();
    gemm_to(hs, w0, f0);
    __syncthreads();
    for (int j = tid; j < TILE * D; j += THREADS)
      hs[(j >> 7) * LDB + (j & (D - 1))] = __float2bfloat16(f0[(j >> 7) * LDF + (j & (D - 1))]);
    stage_weight(w0, a.wout + (size_t)i * D * D, D);
    __syncthreads();
    attention(hs, kv, mask, a.scale);
    __syncthreads();
    gemm_to(hs, w0, f0);
    __syncthreads();
    residual_add(xs, f0, a.bout + i * D);
    __syncthreads();

    // ---- GEGLU feed-forward half, four 128-wide chunks of the 512 inner units
    layer_norm(xs, hs, a.ff_scale + i * D, a.ff_bias + i * D);
    Acc ff[4];
    zero_acc(ff);
    const bf16* w1i = a.w1 + (size_t)i * D * 2 * FF;
    const float* b1i = a.b1 + i * 2 * FF;
    for (int ch = 0; ch < FF / D; ++ch) {
      stage_weight(w0, w1i + ch * D, 2 * FF);
      stage_weight(w1s, w1i + FF + ch * D, 2 * FF);
      __syncthreads();
      gemm_to(hs, w0, f0);
      gemm_to(hs, w1s, f1);
      __syncthreads();
      for (int j = tid; j < TILE * D; j += THREADS) {
        const int r = j >> 7, c = j & (D - 1);
        const float u = f0[r * LDF + c] + b1i[ch * D + c];
        const float g = f1[r * LDF + c] + b1i[FF + ch * D + c];
        act[r * LDB + c] = __float2bfloat16(u * gelu_tanh(g));
      }
      stage_weight(w0, a.w2 + ((size_t)i * FF + ch * D) * D, D);
      __syncthreads();
      warp_gemm(act, w0, ff);
      __syncthreads();
    }
    store_acc(f0, ff);
    __syncthreads();
    residual_add(xs, f0, a.b2 + i * D);
    __syncthreads();
  }

  // ---- post-LN (the trunk only) and the store of the valid rows
  if constexpr (TRUNK) {
    layer_norm(xs, hs, a.post_scale, a.post_bias);
    __syncthreads();
  }
  const bf16* res = TRUNK ? hs : xs;
  for (int i = tid; i < TILE * (D / 8); i += THREADS) {
    const int t = i >> 4, c = i & 15, n = n0 + t;
    if (n < a.N)
      reinterpret_cast<uint4*>(a.out + ((size_t)b * a.N + n) * D)[c] =
          reinterpret_cast<const uint4*>(res + t * LDB)[c];
  }
}

}  // namespace

extern "C" int difffacto_fused_core(
    const void* x, const void* pin_w, const void* pin_b, const void* k, const void* v,
    const void* mask, const void* pre_scale, const void* pre_bias, const void* post_scale,
    const void* post_bias, const void* n2_scale, const void* n2_bias, const void* wq,
    const void* wout, const void* bout, const void* ff_scale, const void* ff_bias,
    const void* w1, const void* b1, const void* w2, const void* b2, void* out, int B, int N,
    int in_ch, int depth, float scale, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || in_ch < 1 || in_ch > MAX_IN || depth < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_core_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.x = (const bf16*)x; a.pin_w = (const bf16*)pin_w; a.pin_b = (const float*)pin_b;
  a.k = (const bf16*)k; a.v = (const bf16*)v; a.mask = (const float*)mask;
  a.pre_scale = (const bf16*)pre_scale; a.pre_bias = (const bf16*)pre_bias;
  a.post_scale = (const bf16*)post_scale; a.post_bias = (const bf16*)post_bias;
  a.n2_scale = (const bf16*)n2_scale; a.n2_bias = (const bf16*)n2_bias;
  a.wq = (const bf16*)wq; a.wout = (const bf16*)wout; a.bout = (const float*)bout;
  a.ff_scale = (const bf16*)ff_scale; a.ff_bias = (const bf16*)ff_bias;
  a.w1 = (const bf16*)w1; a.b1 = (const float*)b1; a.w2 = (const bf16*)w2;
  a.b2 = (const float*)b2; a.out = (bf16*)out;
  a.B = B; a.N = N; a.in_ch = in_ch; a.depth = depth; a.scale = scale;
  dim3 grid((N + TILE - 1) / TILE, B);
  fused_core_kernel<true><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// One block: x, out (B, N, 128) bf16; k, v (B, 4, 128) bf16; mask (B, 4) f32.
extern "C" int difffacto_fused_block(
    const void* x, const void* k, const void* v, const void* mask, const void* n2_scale,
    const void* n2_bias, const void* wq, const void* wout, const void* bout,
    const void* ff_scale, const void* ff_bias, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, int B, int N, float scale, void* stream) {
  if (B < 1 || B > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_core_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  a.x = (const bf16*)x; a.k = (const bf16*)k; a.v = (const bf16*)v;
  a.mask = (const float*)mask;
  a.n2_scale = (const bf16*)n2_scale; a.n2_bias = (const bf16*)n2_bias;
  a.wq = (const bf16*)wq; a.wout = (const bf16*)wout; a.bout = (const float*)bout;
  a.ff_scale = (const bf16*)ff_scale; a.ff_bias = (const bf16*)ff_bias;
  a.w1 = (const bf16*)w1; a.b1 = (const float*)b1; a.w2 = (const bf16*)w2;
  a.b2 = (const float*)b2; a.out = (bf16*)out;
  a.B = B; a.N = N; a.depth = 1; a.scale = scale;
  dim3 grid((N + TILE - 1) / TILE, B);
  fused_core_kernel<false><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one thread block, for reports.
extern "C" int difffacto_fused_core_smem_bytes() { return SMEM_BYTES; }
