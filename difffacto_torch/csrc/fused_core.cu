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
// gelu_tanh(g) is computed as g / (1 + exp(-2 z)), z = sqrt(2/pi)(g + 0.044715
// g^3), which equals 0.5 g (1 + tanh z); the exponentials use the fast
// hardware path (ex2.approx), a relative error near 1e-6, far below bf16's.
// The attention weights multiply by the reciprocal of the per-head sum, one
// division a head (at most an f32 ulp from dividing, before the bf16 round).
// tanh.approx.f32 was tried for the GELU and left out: it raised the trunk's
// mean difference from its plain version past the 1e-3 the checks allow.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 1,153,664 MACs per token, so
// 1.21e12 FLOP per launch at B=256, N=2048 (1.22 ms), against ~153 MB of
// traffic (0.046 ms): the kernel is compute-bound.
//
// Design. A persistent grid, one thread block per SM, walks work items of
// (batch row, 128-token tile) in the order tile = blockIdx.x, blockIdx.x +
// gridDim.x, ...; a tile never crosses a batch row (K, V and the mask are per
// row) and the ragged tail is zero-filled and not stored. The grid and the
// tiles per row are the wrapper's (ops/fused_core.py:schedule); the kernel
// walks what it is given. K and V of the row come into shared memory 8
// blocks at a time, so any depth runs. A block has three warpgroups:
//
// - warpgroup 2, the producer: one thread streams every weight chunk through
//   a ring of STAGES shared-memory stages with TMA (128-byte swizzle, boxes of
//   64 columns read from the stacked (depth, in, out) bf16 weights), in the
//   order the math consumes them: Wq, Wout, then W1's u|g columns and W2's rows
//   for each of 8 chunks of 64 inner units, for every block of every tile. The
//   ring never drains at a block or tile boundary. Full and empty mbarriers
//   order it; the producer keeps 40 registers (setmaxnreg).
// - warpgroups 0 and 1, the consumers: 64 tokens each, 232 registers each. All
//   activations live in registers, in the f32 accumulator layout of wgmma
//   m64n128k16 and packed as bf16 pairs in the A-operand layout (csrc/
//   hopper.cuh): LayerNorm, the attention to the 4 part tokens (quad shuffles),
//   the bias, residual and GEGLU epilogues all work on those fragments, and
//   every product takes its A from registers and its B from the ring. The
//   residual stream stays on chip for all the blocks (in registers, parked in
//   shared memory during the FF chunks); the W2 accumulator stays in registers
//   over the 8 chunks.
//
// Each weight chunk fetched from L2 serves 128 tokens (64 before), and a
// block walks about 31 tiles at B=256, N=2048. Every tile streams all 2.29 MB
// of the weights, so by that count ~9.4 GB come from L2 per launch against
// ~19 GB before (a model of the traffic, not a measurement).
//
// A second entry point, difffacto_fused_block, runs one block alone from the
// same template with proj_in and the pre- and post-LN compiled out: x (B, N,
// 128) bf16 in, the block's residual stream out. It replaces the TPU kernel
// difffacto_tpu/ops/fused_block.py:_block_kernel (the flat single-attention
// block with a context, difffacto_tpu/nn/attention.py:271), whose arithmetic
// is this kernel's per-block body. Its bound: 14 D^2 + 1024 MACs per token,
// 2.41e11 FLOP at B=256, N=2048 (0.24 ms), against 0.46 MB of weights and 4
// bytes a token and channel of x in and out (0.08 ms): compute-bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int D = 128;          // model width
constexpr int CTX = 4;          // context (part) tokens
constexpr int FF = 512;         // GEGLU inner width
constexpr int MAX_IN = 16;      // widest raw input
constexpr int KV_GROUP = 8;     // blocks whose K and V are in shared memory at once
constexpr int TILE = 128;       // tokens per work item
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 tokens each
constexpr int CT = 128 * CONSUMERS;       // consumer threads
constexpr int THREADS = CT + 128;
constexpr int STAGES = 4;       // weight ring depth
constexpr int FC = 64;          // FF inner units per chunk
constexpr int NCH = FF / FC;    // FF chunks per block
constexpr int CHUNKS = 2 + 2 * NCH;       // weight chunks per block: Wq, Wout, (W1, W2) x 8
constexpr int BOX_K128 = 128 * 128;       // bytes of a 128-row x 64-column box
constexpr int BOX_K64 = 64 * 128;         // bytes of a 64-row x 64-column box
constexpr int STAGE_BYTES = 2 * BOX_K128;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

constexpr int OFF_RING = 0;
constexpr int OFF_STASH = OFF_RING + STAGES * STAGE_BYTES;         // residual, 32 words a thread
constexpr int OFF_KV = OFF_STASH + CONSUMERS * 128 * 32 * 4;       // K, V of the row, bf16
constexpr int OFF_PIN = OFF_KV + KV_GROUP * 2 * CTX * D * 2;       // proj_in kernel, f32
constexpr int OFF_MASK = OFF_PIN + MAX_IN * D * 4;
constexpr int OFF_BAR = OFF_MASK + 64;
constexpr int SMEM_USED = OFF_BAR + 2 * STAGES * 8;
constexpr int SMEM_BYTES = SMEM_USED + 1024;                       // room to align to 1024
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
static_assert(CONSUMER_REGS * 128 * CONSUMERS + PRODUCER_REGS * 128 <= 65536, "register file");

struct Params {
  CUtensorMap wq, wout, w1, w2;  // TMA maps of the stacked weights (see weight_map)
  const bf16* x; const bf16* pin_w; const float* pin_b;
  const bf16* k; const bf16* v; const float* mask;
  const bf16* pre_scale; const bf16* pre_bias; const bf16* post_scale; const bf16* post_bias;
  const bf16* n2_scale; const bf16* n2_bias; const float* bout;
  const bf16* ff_scale; const bf16* ff_bias; const float* b1; const float* b2;
  bf16* out;
  int B, N, in_ch, depth, tiles_per_row, total_tiles;  // the last two from the wrapper's schedule
  float scale;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 0.5 g (1 + tanh z) as g / (1 + exp(-2 z)).
__device__ __forceinline__ float gelu_tanh(float g) {
  const float z = g * (0.7978845608028654f + 0.0356774081363001f * g * g);
  return __fdividef(g, 1.0f + __expf(-2.0f * z));
}

__device__ __forceinline__ float2 ldg_bf16x2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// LayerNorm of the thread's two rows of x (packed, see hopper.cuh) into y;
// the four threads of a quad hold one row's 128 columns.
__device__ __forceinline__ void layer_norm(const uint32_t (&x)[32], uint32_t (&y)[32],
                                           const bf16* scale, const bf16* bias, int t) {
  float mu[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 v = unpack_bf16(x[2 * j + r]);
      s += v.x + v.y;
    }
    mu[r] = quad_sum(s) * (1.0f / D);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 v = unpack_bf16(x[2 * j + r]);
      q += (v.x - mu[r]) * (v.x - mu[r]) + (v.y - mu[r]) * (v.y - mu[r]);
    }
    inv[r] = rsqrtf(quad_sum(q) * (1.0f / D) + 1e-5f);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 s = ldg_bf16x2(scale + 8 * j + 2 * t), b = ldg_bf16x2(bias + 8 * j + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = unpack_bf16(x[2 * j + r]);
      y[2 * j + r] = pack_bf16((v.x - mu[r]) * inv[r] * s.x + b.x,
                               (v.y - mu[r]) * inv[r] * s.y + b.y);
    }
  }
}

// Attention of the thread's two tokens to the 4 context tokens: q is the f32
// accumulator of a Wq (columns 16 h .. 16 h + 15 are head h), K and V (4 x 128
// bf16 each) lie in shared memory; the rounded output is packed into o.
__device__ __forceinline__ void attention(const float (&q)[64], const bf16* K, const bf16* V,
                                          const float* mask, float scale, int t,
                                          uint32_t (&o)[32]) {
  float mk[CTX];
#pragma unroll
  for (int m = 0; m < CTX; ++m) mk[m] = mask[m];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s[8][CTX];
#pragma unroll
    for (int h = 0; h < 8; ++h)
#pragma unroll
      for (int m = 0; m < CTX; ++m) s[h][m] = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float q0 = round_bf16(q[4 * j + 2 * r]), q1 = round_bf16(q[4 * j + 2 * r + 1]);
#pragma unroll
      for (int m = 0; m < CTX; ++m) {
        const float2 k = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(K + m * D + 8 * j + 2 * t));
        s[j >> 1][m] += q0 * k.x + q1 * k.y;
      }
    }
    float c = -3.0e38f;
#pragma unroll
    for (int h = 0; h < 8; ++h)
#pragma unroll
      for (int m = 0; m < CTX; ++m) {
        s[h][m] = quad_sum(s[h][m]) * scale + (mk[m] - 1.0f) * 1e30f;
        c = fmaxf(c, s[h][m]);
      }
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      float den = 0.0f;
#pragma unroll
      for (int m = 0; m < CTX; ++m) {
        s[h][m] = __expf(s[h][m] - c) * mk[m];
        den += s[h][m];
      }
      const float inv = 1.0f / fmaxf(den, 1e-30f);  // one division a head
#pragma unroll
      for (int m = 0; m < CTX; ++m) s[h][m] = round_bf16(s[h][m] * inv);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float o0 = 0.0f, o1 = 0.0f;
#pragma unroll
      for (int m = 0; m < CTX; ++m) {
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(V + m * D + 8 * j + 2 * t));
        o0 += s[j >> 1][m] * vv.x;
        o1 += s[j >> 1][m] * vv.y;
      }
      o[2 * j + r] = pack_bf16(o0, o1);
    }
  }
}

// h = bf16(h + bf16(acc + bias)) on the thread's fragment.
__device__ __forceinline__ void residual_add(uint32_t (&h)[32], const float (&acc)[64],
                                             const float* bias, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = unpack_bf16(h[2 * j + r]);
      h[2 * j + r] = pack_bf16(v.x + round_bf16(acc[4 * j + 2 * r] + b.x),
                               v.y + round_bf16(acc[4 * j + 2 * r + 1] + b.y));
    }
  }
}

// The GEGLU activation of one chunk: acc holds u (columns 0..63) and g
// (64..127) of 64 inner units starting at unit c0; act = bf16(u * gelu(g)).
__device__ __forceinline__ void geglu(const float (&acc)[64], const float* b1, int c0, int t,
                                      uint32_t (&act)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bu = __ldg(reinterpret_cast<const float2*>(b1 + c0 + 8 * j + 2 * t));
    const float2 bg = __ldg(reinterpret_cast<const float2*>(b1 + FF + c0 + 8 * j + 2 * t));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float u0 = acc[4 * j + 2 * r] + bu.x, u1 = acc[4 * j + 2 * r + 1] + bu.y;
      const float g0 = acc[4 * (j + 8) + 2 * r] + bg.x, g1 = acc[4 * (j + 8) + 2 * r + 1] + bg.y;
      act[2 * j + r] = pack_bf16(u0 * gelu_tanh(g0), u1 * gelu_tanh(g1));
    }
  }
}

// The consumers' side of the ring: wait for chunk `it`, run its products,
// release the stage (one arrival per consumer warp).
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int it;

  template <int KSTEPS>
  __device__ __forceinline__ void product(float (&d)[64], uint32_t (&a)[4 * KSTEPS],
                                          bool accumulate) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    chunk_product<KSTEPS>(d, a, smem_addr(base + s * STAGE_BYTES),
                          KSTEPS == 8 ? BOX_K128 : BOX_K64, accumulate);
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
    ++it;
  }
};

// The producer: every chunk of `passes` block passes, in the consumers' order.
__device__ __forceinline__ void produce(const Params& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int passes) {
  int it = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int i = pass % p.depth;
    for (int c = 0; c < CHUNKS; ++c, ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      unsigned char* dst = ring + s * STAGE_BYTES;
      if (c < 2) {
        const CUtensorMap* m = c == 0 ? &p.wq : &p.wout;
        mbar_expect_tx(&full[s], 2 * BOX_K128);
        tma_load_3d(dst, m, &full[s], 0, 0, i);
        tma_load_3d(dst + BOX_K128, m, &full[s], 64, 0, i);
      } else if ((c & 1) == 0) {  // W1: the u and the g columns of chunk ch
        const int ch = (c - 2) >> 1;
        mbar_expect_tx(&full[s], 2 * BOX_K128);
        tma_load_3d(dst, &p.w1, &full[s], ch * FC, 0, i);
        tma_load_3d(dst + BOX_K128, &p.w1, &full[s], FF + ch * FC, 0, i);
      } else {  // W2: rows of chunk ch, both column halves
        const int ch = (c - 3) >> 1;
        mbar_expect_tx(&full[s], 2 * BOX_K64);
        tma_load_3d(dst, &p.w2, &full[s], 0, ch * FC, i);
        tma_load_3d(dst + BOX_K64, &p.w2, &full[s], 64, ch * FC, i);
      }
    }
  }
}

// K and V of blocks i0 .. i0 + KV_GROUP - 1 of batch row b into shared memory,
// and at i0 = 0 the row's mask. The barrier before keeps the previous group
// until both warpgroups are done with it.
__device__ __forceinline__ void stage_kv(const Params& p, bf16* kv, float* mask, int b, int i0,
                                         int tid) {
  named_sync(1, CT);
  const int blocks = min(KV_GROUP, p.depth - i0);
  for (int w = tid; w < blocks * CTX * D / 2; w += CT) {
    const int j = w / (CTX * D / 2), e = w - j * (CTX * D / 2);
    const size_t src = ((size_t)(i0 + j) * p.B + b) * (CTX * D / 2) + e;
    uint32_t* dst = reinterpret_cast<uint32_t*>(kv + j * 2 * CTX * D);
    dst[e] = reinterpret_cast<const uint32_t*>(p.k)[src];
    dst[CTX * D / 2 + e] = reinterpret_cast<const uint32_t*>(p.v)[src];
  }
  if (i0 == 0 && tid < CTX) mask[tid] = p.mask[b * CTX + tid];
  named_sync(1, CT);
}

// TRUNK: the whole trunk (proj_in, pre-LN, depth blocks, post-LN). Otherwise
// one block on x (B, N, D) as it is, its residual stream stored.
template <bool TRUNK>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, Ring ring) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;  // rows row0, row0 + 8
  bf16* kv = reinterpret_cast<bf16*>(smem + OFF_KV);
  float* pin = reinterpret_cast<float*>(smem + OFF_PIN);
  float* mask = reinterpret_cast<float*>(smem + OFF_MASK);
  uint32_t* stash = reinterpret_cast<uint32_t*>(smem + OFF_STASH) + tid;

  if constexpr (TRUNK) {
    for (int i = tid; i < MAX_IN * D; i += CT) {
      const int c = i / D;
      pin[i] = c < p.in_ch ? __bfloat162float(p.pin_w[i]) : 0.0f;
    }
  }

  for (int tile = blockIdx.x; tile < p.total_tiles; tile += gridDim.x) {
    const int b = tile / p.tiles_per_row;
    const int n0 = (tile - b * p.tiles_per_row) * TILE;
    // K and V of the row's first blocks, and its mask (the first barrier also
    // publishes the proj_in kernel).
    stage_kv(p, kv, mask, b, 0, tid);

    // ---- the tile's rows in, zero past the last token
    uint32_t h[32];
    if constexpr (TRUNK) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + row0 + 8 * r;
        float xin[MAX_IN];
#pragma unroll
        for (int c = 0; c < MAX_IN; ++c)
          xin[c] = (n < p.N && c < p.in_ch)
                       ? __bfloat162float(p.x[((size_t)b * p.N + n) * p.in_ch + c])
                       : 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * t;
          float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
          for (int c = 0; c < MAX_IN; ++c) {
            const float2 w = *reinterpret_cast<const float2*>(pin + c * D + col);
            a0 += xin[c] * w.x;
            a1 += xin[c] * w.y;
          }
          const float2 pb = __ldg(reinterpret_cast<const float2*>(p.pin_b + col));
          h[2 * j + r] = pack_bf16(a0 + pb.x, a1 + pb.y);
        }
      }
      uint32_t pre[32];
      layer_norm(h, pre, p.pre_scale, p.pre_bias, t);
#pragma unroll
      for (int w = 0; w < 32; ++w) h[w] = pre[w];
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + row0 + 8 * r;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(p.x + ((size_t)b * p.N + n) * D);
#pragma unroll
        for (int j = 0; j < 16; ++j) h[2 * j + r] = n < p.N ? __ldg(src + 4 * j + t) : 0u;
      }
    }

    for (int i = 0; i < p.depth; ++i) {
      if (i > 0 && i % KV_GROUP == 0) stage_kv(p, kv, mask, b, i, tid);
      const bf16* K = kv + (i % KV_GROUP) * 2 * CTX * D;
      // ---- attention half
      uint32_t a[32];
      float acc[64];
      layer_norm(h, a, p.n2_scale + i * D, p.n2_bias + i * D, t);
      ring.product<8>(acc, a, false);                       // q = a Wq
      attention(acc, K, K + CTX * D, mask, p.scale, t, a);  // a = attn
      ring.product<8>(acc, a, false);                       // attn Wout
      residual_add(h, acc, p.bout + i * D, t);

      // ---- GEGLU feed-forward half, 8 chunks of 64 inner units
      layer_norm(h, a, p.ff_scale + i * D, p.ff_bias + i * D, t);
#pragma unroll
      for (int w = 0; w < 32; ++w) stash[w * CT] = h[w];
      float ff[64];
#pragma unroll
      for (int w = 0; w < 64; ++w) ff[w] = 0.0f;
      const float* b1 = p.b1 + i * 2 * FF;
      // Unrolled by 2: with this loop rolled, ptxas (CUDA 12.9) gave the GEGLU
      // activations of one chunk the registers of a's upper half, which the
      // next chunk's W1 product reads as its A operand (seen in the SASS: only
      // chunk 0 was right; see chunk_product in hopper.cuh). Unrolled by 8 it
      // is right too, but slower (code size).
#pragma unroll 2
      for (int ch = 0; ch < NCH; ++ch) {
        ring.product<8>(acc, a, false);  // [u | g] of the chunk
        uint32_t act[16];
        geglu(acc, b1, ch * FC, t, act);
        ring.product<4>(ff, act, true);  // ff += act W2 rows of the chunk
      }
#pragma unroll
      for (int w = 0; w < 32; ++w) h[w] = stash[w * CT];
      residual_add(h, ff, p.b2 + i * D, t);
    }

    // ---- post-LN (the trunk only) and the store of the valid rows
    uint32_t y[32];
    if constexpr (TRUNK) {
      layer_norm(h, y, p.post_scale, p.post_bias, t);
    } else {
#pragma unroll
      for (int w = 0; w < 32; ++w) y[w] = h[w];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + row0 + 8 * r;
      if (n < p.N) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(p.out + ((size_t)b * p.N + n) * D);
#pragma unroll
        for (int j = 0; j < 16; ++j) dst[4 * j + t] = y[2 * j + r];
      }
    }
  }
}

template <bool TRUNK>
__global__ void __launch_bounds__(THREADS, 1) fused_core_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CT) {
      prefetch_tensormap(&p.wq);
      prefetch_tensormap(&p.wout);
      prefetch_tensormap(&p.w1);
      prefetch_tensormap(&p.w2);
      const int tiles = (p.total_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
      produce(p, smem + OFF_RING, full, empty, tiles * p.depth);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<TRUNK>(p, smem, Ring{smem + OFF_RING, full, empty, 0});
  }
}

// ---- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The TMA map of a stacked weight (depth, rows, cols) bf16: dimensions
// innermost first (cols, rows, depth), byte strides of rows and blocks, boxes
// of 64 columns x box_rows rows x 1 block with the 128-byte swizzle.
cudaError_t weight_map(CUtensorMap* map, const void* w, int depth, int rows, int cols,
                       int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wrapper's schedule: `grid` blocks walk B x tiles_per_row tiles. Refused
// unless the tiles cover every token and every block has one.
template <bool TRUNK>
cudaError_t launch(Params& p, int grid, int tiles_per_row, const void* wq, const void* wout,
                   const void* w1, const void* w2, cudaStream_t stream) {
  const long long total = (long long)p.B * tiles_per_row;
  if (tiles_per_row < 1 || (long long)tiles_per_row * TILE < p.N || total > 0x7fffffff ||
      grid < 1 || grid > total)
    return cudaErrorInvalidValue;
  p.tiles_per_row = tiles_per_row;
  p.total_tiles = (int)total;
  cudaError_t err = weight_map(&p.wq, wq, p.depth, D, D, D);
  if (err == cudaSuccess) err = weight_map(&p.wout, wout, p.depth, D, D, D);
  if (err == cudaSuccess) err = weight_map(&p.w1, w1, p.depth, D, 2 * FF, D);
  if (err == cudaSuccess) err = weight_map(&p.w2, w2, p.depth, FF, D, FC);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_core_kernel<TRUNK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  fused_core_kernel<TRUNK><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int difffacto_fused_core(
    const void* x, const void* pin_w, const void* pin_b, const void* k, const void* v,
    const void* mask, const void* pre_scale, const void* pre_bias, const void* post_scale,
    const void* post_bias, const void* n2_scale, const void* n2_bias, const void* wq,
    const void* wout, const void* bout, const void* ff_scale, const void* ff_bias,
    const void* w1, const void* b1, const void* w2, const void* b2, void* out, int B, int N,
    int in_ch, int depth, float scale, int grid, int tiles_per_row, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || in_ch < 1 || in_ch > MAX_IN || depth < 1)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = (const bf16*)x; p.pin_w = (const bf16*)pin_w; p.pin_b = (const float*)pin_b;
  p.k = (const bf16*)k; p.v = (const bf16*)v; p.mask = (const float*)mask;
  p.pre_scale = (const bf16*)pre_scale; p.pre_bias = (const bf16*)pre_bias;
  p.post_scale = (const bf16*)post_scale; p.post_bias = (const bf16*)post_bias;
  p.n2_scale = (const bf16*)n2_scale; p.n2_bias = (const bf16*)n2_bias;
  p.bout = (const float*)bout; p.ff_scale = (const bf16*)ff_scale;
  p.ff_bias = (const bf16*)ff_bias; p.b1 = (const float*)b1; p.b2 = (const float*)b2;
  p.out = (bf16*)out;
  p.B = B; p.N = N; p.in_ch = in_ch; p.depth = depth; p.scale = scale;
  return (int)launch<true>(p, grid, tiles_per_row, wq, wout, w1, w2, (cudaStream_t)stream);
}

// One block: x, out (B, N, 128) bf16; k, v (B, 4, 128) bf16; mask (B, 4) f32.
extern "C" int difffacto_fused_block(
    const void* x, const void* k, const void* v, const void* mask, const void* n2_scale,
    const void* n2_bias, const void* wq, const void* wout, const void* bout,
    const void* ff_scale, const void* ff_bias, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, int B, int N, float scale, int grid, int tiles_per_row,
    void* stream) {
  if (B < 1 || B > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = (const bf16*)x; p.k = (const bf16*)k; p.v = (const bf16*)v;
  p.mask = (const float*)mask;
  p.n2_scale = (const bf16*)n2_scale; p.n2_bias = (const bf16*)n2_bias;
  p.bout = (const float*)bout; p.ff_scale = (const bf16*)ff_scale;
  p.ff_bias = (const bf16*)ff_bias; p.b1 = (const float*)b1; p.b2 = (const float*)b2;
  p.out = (bf16*)out;
  p.B = B; p.N = N; p.in_ch = 0; p.depth = 1; p.scale = scale;
  return (int)launch<false>(p, grid, tiles_per_row, wq, wout, w1, w2, (cudaStream_t)stream);
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one thread block, for reports.
extern "C" int difffacto_fused_core_smem_bytes() { return SMEM_BYTES; }
