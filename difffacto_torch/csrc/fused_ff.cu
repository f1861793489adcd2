// Fused LayerNorm -> GEGLU feed-forward -> residual, for sm_90a.
//
// Replaces the TPU kernel difffacto_tpu/ops/fused_ff.py:_kernel (the Pallas
// program that FusedLNFF launches, difffacto_tpu/nn/layers.py:146). For every
// token x of width D (128 in the denoiser, 256 in the aligner), FF = 4 D:
//
//   h = bf16(LN(x))                     f32 statistics, eps 1e-5, biased variance
//   [u | g] = h W1 + b1                 D -> 2 x FF, f32 accumulate, f32 bias
//   act = bf16(u * gelu_tanh(g))
//   out = bf16(x + bf16(act W2 + b2))   f32 accumulate, f32 bias
//
// Operands are bf16 (the LayerNorm's scale and bias too), the biases b1 and b2
// f32. The bf16 rounding points are the Pallas kernel's.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 3 D FF = 12 D^2 MACs per
// token, so 24 D^2 FLOP: 2.06e11 at T = 524,288 and D = 128 (0.21 ms), against
// 4 T D bytes of activations plus 24 D^2 bytes of weights (0.08 ms): the
// kernel is compute-bound, so it has to run on the tensor cores' full rate
// (wgmma) with the weights streamed behind the products.
//
// D = 128 (the two-attention denoiser, 500 launches a generation): the trunk
// template of csrc/trunk.cuh in Mode::FF, the FF half of csrc/fused_core.cu's
// blocks on its own. A persistent grid of one thread block per SM walks
// 128-token tiles (ops/fused_core.py:schedule(1, T, sms), passed in by the
// wrapper); the ragged tail is zero-filled and not stored. A producer thread
// streams W1's u|g columns and W2's rows in 8 chunks of 64 inner units
// through a 4-stage TMA ring that never drains between tiles; two consumer
// warpgroups of 64 tokens each keep x, LN(x), the GEGLU activations and the
// W2 accumulator in registers (wgmma with A from registers, B from the ring)
// and apply the LayerNorm, GEGLU and residual epilogues on the fragments.
// Each chunk fetched from L2 serves 128 tokens. The chunk loop stays unrolled
// by 2 (the ptxas hazard noted in trunk.cuh).
//
// D = 256 (the aligner, T = 4 B, 5 launches a generation): the first design,
// in namespace `wide` below, WMMA over 64-token tiles with synchronous weight
// staging. The trunk template is fixed at D = 128: at 256 its f32 output
// accumulator (128 registers a thread) beside the packed x and LN(x) would not
// fit in the consumers' 232 registers unless LN(x) were parked in shared
// memory, which the ring leaves no room for. The aligner's launches take
// about 0.8 ms a generation, so the wide instantiation is left for later.

#include "trunk.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {
namespace wide {

constexpr int TILE = 64;      // tokens per thread block
constexpr int THREADS = 256;  // 8 warps
constexpr int CW = 64;        // inner units per chunk
constexpr int LDC = CW + 8;   // bf16 row stride of a chunk (act, W1's columns)
constexpr int LDU = CW + 4;   // f32 row stride of u and g

constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int D = 256;        // the aligner's width (128 runs the trunk template)

struct Smem {
  static constexpr int FF = 4 * D;
  static constexpr int LDX = D + 8;  // bf16 row stride of x, h and a chunk of W2
  static constexpr int LDO = D + 4;  // f32 row stride of the output
  static constexpr int SZ_X = TILE * LDX * 2;
  static constexpr int SZ_ACT = TILE * LDC * 2;
  static constexpr int SZ_U = TILE * LDU * 4;
  // One region holds the chunk's W1 columns (u and g), then its W2 rows, and
  // at the end the f32 output.
  static constexpr int SZ_W = cmax(cmax(2 * D * LDC * 2, CW * LDX * 2), TILE * LDO * 4);
  static constexpr int OFF_X = 0;
  static constexpr int OFF_H = OFF_X + SZ_X;
  static constexpr int OFF_ACT = OFF_H + SZ_X;
  static constexpr int OFF_U = OFF_ACT + SZ_ACT;
  static constexpr int OFF_G = OFF_U + SZ_U;
  static constexpr int OFF_W = OFF_G + SZ_U;
  static constexpr int BYTES = OFF_W + SZ_W;
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

struct Args {
  const bf16* x; const bf16* ln_scale; const bf16* ln_bias;
  const bf16* w1; const float* b1; const bf16* w2; const float* b2;
  bf16* out;
  long long T;
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

__global__ void __launch_bounds__(THREADS, 1) fused_ff_kernel(const Args a) {
  using S = Smem;
  constexpr int FF = S::FF, LDX = S::LDX, LDO = S::LDO;
  constexpr int VEC = D / 8;    // 16-byte vectors in a row of x
  constexpr int PER = D / 32;   // LayerNorm columns per lane
  constexpr int NO = D / 32;    // output fragments per warp (16 x D/2)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::OFF_X);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::OFF_H);
  bf16* act = reinterpret_cast<bf16*>(smem + S::OFF_ACT);
  float* us = reinterpret_cast<float*>(smem + S::OFF_U);
  float* gs = reinterpret_cast<float*>(smem + S::OFF_G);
  bf16* w1u = reinterpret_cast<bf16*>(smem + S::OFF_W);
  bf16* w1g = w1u + D * LDC;
  bf16* w2s = reinterpret_cast<bf16*>(smem + S::OFF_W);
  float* outs = reinterpret_cast<float*>(smem + S::OFF_W);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t0 = (long long)blockIdx.x * TILE;

  // ---- the x tile, zero past the last token
  for (int i = tid; i < TILE * VEC; i += THREADS) {
    const int r = i / VEC, c = i % VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < a.T) val = reinterpret_cast<const uint4*>(a.x + (t0 + r) * D)[c];
    reinterpret_cast<uint4*>(xs + r * LDX)[c] = val;
  }
  __syncthreads();

  // ---- LayerNorm: one warp per row, two-pass f32 statistics
  {
    float s[PER], b[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      s[j] = __bfloat162float(a.ln_scale[lane * PER + j]);
      b[j] = __bfloat162float(a.ln_bias[lane * PER + j]);
    }
    for (int r = warp; r < TILE; r += THREADS / 32) {
      float v[PER], sum = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        v[j] = __bfloat162float(xs[r * LDX + lane * PER + j]);
        sum += v[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum * (1.0f / D);
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) sq += (v[j] - mu) * (v[j] - mu);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float inv = rsqrtf(sq * (1.0f / D) + 1e-5f);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        hs[r * LDX + lane * PER + j] = __float2bfloat16((v[j] - mu) * inv * s[j] + b[j]);
    }
  }
  __syncthreads();

  // A warp owns 16 rows: 32 of a chunk's 64 columns, and D/2 output columns.
  const int row0 = (warp >> 1) * 16;
  const int ucol0 = (warp & 1) * 32;
  const int ocol0 = (warp & 1) * (D / 2);
  Acc out[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) wmma::fill_fragment(out[j], 0.0f);

  for (int ch = 0; ch < FF / CW; ++ch) {
    // ---- the chunk's u and g columns of W1 (row stride 2 FF)
    const bf16* w1 = a.w1 + ch * CW;
    for (int i = tid; i < D * (CW / 8); i += THREADS) {
      const int r = i / (CW / 8), c = i % (CW / 8);
      reinterpret_cast<uint4*>(w1u + r * LDC)[c] =
          reinterpret_cast<const uint4*>(w1 + (size_t)r * 2 * FF)[c];
      reinterpret_cast<uint4*>(w1g + r * LDC)[c] =
          reinterpret_cast<const uint4*>(w1 + FF + (size_t)r * 2 * FF)[c];
    }
    __syncthreads();
    {
      Acc u[2], g[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(u[j], 0.0f);
        wmma::fill_fragment(g[j], 0.0f);
      }
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, hs + row0 * LDX + kk, LDX);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, w1u + kk * LDC + ucol0 + j * 16, LDC);
          wmma::mma_sync(u[j], fa, fb, u[j]);
          wmma::load_matrix_sync(fb, w1g + kk * LDC + ucol0 + j * 16, LDC);
          wmma::mma_sync(g[j], fa, fb, g[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(us + row0 * LDU + ucol0 + j * 16, u[j], LDU, wmma::mem_row_major);
        wmma::store_matrix_sync(gs + row0 * LDU + ucol0 + j * 16, g[j], LDU, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // ---- GEGLU into act; the chunk's rows of W2 where W1's columns were
    const float* b1 = a.b1 + ch * CW;
    for (int i = tid; i < TILE * CW; i += THREADS) {
      const int r = i / CW, c = i % CW;
      const float uu = us[r * LDU + c] + b1[c];
      const float gg = gs[r * LDU + c] + b1[FF + c];
      act[r * LDC + c] = __float2bfloat16(uu * gelu_tanh(gg));
    }
    const bf16* w2 = a.w2 + (size_t)ch * CW * D;
    for (int i = tid; i < CW * VEC; i += THREADS) {
      const int r = i / VEC, c = i % VEC;
      reinterpret_cast<uint4*>(w2s + r * LDX)[c] =
          reinterpret_cast<const uint4*>(w2 + (size_t)r * D)[c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CW; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, act + row0 * LDC + kk, LDC);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, w2s + kk * LDX + ocol0 + j * 16, LDX);
        wmma::mma_sync(out[j], fa, fb, out[j]);
      }
    }
    __syncthreads();
  }

  // ---- x + bf16(out + b2), the valid rows only
#pragma unroll
  for (int j = 0; j < NO; ++j)
    wmma::store_matrix_sync(outs + row0 * LDO + ocol0 + j * 16, out[j], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TILE * D; i += THREADS) {
    const int r = i / D, c = i % D;
    if (t0 + r < a.T) {
      const float o = round_bf16(outs[r * LDO + c] + a.b2[c]);
      a.out[(t0 + r) * D + c] = __float2bfloat16(__bfloat162float(xs[r * LDX + c]) + o);
    }
  }
}

int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.T + TILE - 1) / TILE;
  fused_ff_kernel<<<(unsigned)blocks, THREADS, Smem::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace

// x, out (T, D) bf16; ln_scale, ln_bias (D,) bf16; w1 (D, 8 D), w2 (4 D, D)
// bf16; b1 (8 D,), b2 (D,) f32. D = 128 walks `grid` blocks over
// `tiles_per_row` tiles of 128 tokens (the wrapper's schedule); D = 256 takes
// neither. Returns a cudaError_t.
extern "C" int difffacto_fused_ff(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* out, long long T, int D, int grid, int tiles_per_row,
                                  void* stream) {
  if (T < 1 || T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128) {
    Params p = {};
    p.x = (const bf16*)x;
    p.ff_scale = (const bf16*)ln_scale; p.ff_bias = (const bf16*)ln_bias;
    p.b1 = (const float*)b1; p.b2 = (const float*)b2;
    p.out = (bf16*)out;
    p.B = 1; p.N = (int)T; p.depth = 1;
    return (int)launch<Mode::FF>(p, grid, tiles_per_row, nullptr, nullptr, w1, w2, s);
  }
  if (D != 256) return (int)cudaErrorInvalidValue;
  wide::Args a;
  a.x = (const bf16*)x; a.ln_scale = (const bf16*)ln_scale; a.ln_bias = (const bf16*)ln_bias;
  a.w1 = (const bf16*)w1; a.b1 = (const float*)b1; a.w2 = (const bf16*)w2;
  a.b2 = (const float*)b2; a.out = (bf16*)out; a.T = T;
  return wide::launch(a, s);
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one thread block at width D, for reports.
extern "C" int difffacto_fused_ff_smem_bytes(int D) {
  return D == 128 ? SMEM_BYTES : D == 256 ? wide::Smem::BYTES : 0;
}
