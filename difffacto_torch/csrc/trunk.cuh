// The denoiser trunk's block math for sm_90a as one template, shared by the
// generation trunk and the one-block entry (csrc/fused_core.cu), the training
// trunk's forward (csrc/fused_core_train.cu) and the fused LN-GEGLU FF at
// D = 128 (csrc/fused_ff.cu); the design is described at the top of
// csrc/fused_core.cu.
//
// Mode::TRUNK: proj_in, pre-LN, depth blocks, post-LN.
// Mode::BLOCK: one block on x (B, N, 128) as it is, its residual stream out.
// Mode::TRAIN: pre-LN, depth blocks with dropout after the out-projection
//   (site 0) and on the GEGLU activations (site 1), post-LN; with p.acts set
//   it also stores each block's input u and post-attention hidden up, and the
//   hidden before the post-LN, for the backward kernel.
// Mode::FF: the GEGLU feed-forward half alone on x (T, 128) as it is (B = 1,
//   N = T): x + FF(LN(x)) with FF's LayerNorm and biases, no attention, no K
//   or V, 16 weight chunks a tile (csrc/fused_ff.cu, the two-attention
//   block's FusedLNFF).
//
// Dropout masks come from a 32-bit integer hash of (seed, batch row, global
// token, block, site, column): a murmur3 finalizer chained over the fields,
// kept when the hash is below round((1 - p) 2^32) and scaled by 1 / (1 - p).
// ops/fused_core_train.py:dropout_bits computes the same bits. A thread knows
// the rows and columns of its accumulator fragment, so the multiplier is
// applied there.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

enum class Mode { TRUNK, BLOCK, TRAIN, FF };

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
  bf16* acts;        // TRAIN: (2 depth + 1, B, N, 128) saved activations, or null
  const int* seed;   // TRAIN: the dropout seed, one int on the device
  int B, N, in_ch, depth, tiles_per_row, total_tiles;  // the last two from the wrapper's schedule
  float scale, keep_scale;  // TRAIN: keep_scale = 1 / (1 - p)
  unsigned int thresh;      // TRAIN: kept where the hash is below this
  int drop;                 // TRAIN: dropout on (p > 0)
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

// ---- the dropout hash (ops/fused_core_train.py:dropout_bits computes the same)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13; h *= 0xC2B2AE35u; h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, int b, int n, int block, int site) {
  const uint32_t h = fmix32(seed + 0x9E3779B9u * (uint32_t)(b + 1));
  return fmix32(h ^ ((uint32_t)n * 0x85EBCA77u + (uint32_t)(block * 2 + site)));
}

// The multiplier of no dropout site.
struct NoDropout {
  __device__ __forceinline__ float operator()(int, int) const { return 1.0f; }
};

// The dropout multiplier of one site at (row r of the thread's two, column).
struct Dropout {
  uint32_t key[2];
  uint32_t thresh;
  float keep;
  bool on;
  template <class P>  // the forward's or the backward's parameters
  __device__ __forceinline__ Dropout(const P& p, int b, int n, int block, int site)
      : thresh(p.thresh), keep(p.keep_scale), on(p.drop != 0) {
    const uint32_t seed = on ? (uint32_t)__ldg(p.seed) : 0u;
    key[0] = row_key(seed, b, n, block, site);
    key[1] = row_key(seed, b, n + 8, block, site);
  }
  __device__ __forceinline__ float operator()(int r, int col) const {
    if (!on) return 1.0f;
    return fmix32(key[r] + (uint32_t)col * 0x9E3779B9u) < thresh ? keep : 0.0f;
  }
};

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

// h = bf16(h + bf16((acc + bias) * drop)) on the thread's fragment.
template <class Drop = NoDropout>
__device__ __forceinline__ void residual_add(uint32_t (&h)[32], const float (&acc)[64],
                                             const float* bias, int t, const Drop& drop = Drop()) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = unpack_bf16(h[2 * j + r]);
      h[2 * j + r] = pack_bf16(v.x + round_bf16((acc[4 * j + 2 * r] + b.x) * drop(r, col)),
                               v.y + round_bf16((acc[4 * j + 2 * r + 1] + b.y) * drop(r, col + 1)));
    }
  }
}

// The GEGLU activation of one chunk: acc holds u (columns 0..63) and g
// (64..127) of 64 inner units starting at unit c0; act = bf16(u * gelu(g) * drop).
template <class Drop = NoDropout>
__device__ __forceinline__ void geglu(const float (&acc)[64], const float* b1, int c0, int t,
                                      uint32_t (&act)[16], const Drop& drop = Drop()) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bu = __ldg(reinterpret_cast<const float2*>(b1 + c0 + 8 * j + 2 * t));
    const float2 bg = __ldg(reinterpret_cast<const float2*>(b1 + FF + c0 + 8 * j + 2 * t));
    const int col = c0 + 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float u0 = acc[4 * j + 2 * r] + bu.x, u1 = acc[4 * j + 2 * r + 1] + bu.y;
      const float g0 = acc[4 * (j + 8) + 2 * r] + bg.x, g1 = acc[4 * (j + 8) + 2 * r + 1] + bg.y;
      act[2 * j + r] = pack_bf16(u0 * gelu_tanh(g0) * drop(r, col),
                                 u1 * gelu_tanh(g1) * drop(r, col + 1));
    }
  }
}

// The thread's two rows (tokens n0 + row0, n0 + row0 + 8) of a fragment into
// row b of a (B, N, 128) bf16 array; rows past N are not stored.
__device__ __forceinline__ void store_rows(bf16* dst, const uint32_t (&y)[32], const Params& p,
                                           int b, int n0, int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + row0 + 8 * r;
    if (n < p.N) {
      uint32_t* d = reinterpret_cast<uint32_t*>(dst + ((size_t)b * p.N + n) * D);
#pragma unroll
      for (int j = 0; j < 16; ++j) d[4 * j + t] = y[2 * j + r];
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

// The producer: the chunks from `first` on (2 skips Wq and Wout) of `passes`
// block passes, in the consumers' order.
__device__ __forceinline__ void produce(const Params& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int passes, int first) {
  int it = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int i = pass % p.depth;
    for (int c = first; c < CHUNKS; ++c, ++it) {
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

// One of the four modes (see the note at the top).
template <Mode MODE>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, Ring ring) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;  // rows row0, row0 + 8
  bf16* kv = reinterpret_cast<bf16*>(smem + OFF_KV);
  float* pin = reinterpret_cast<float*>(smem + OFF_PIN);
  float* mask = reinterpret_cast<float*>(smem + OFF_MASK);
  uint32_t* stash = reinterpret_cast<uint32_t*>(smem + OFF_STASH) + tid;

  constexpr bool TRUNK = MODE == Mode::TRUNK, TRAIN = MODE == Mode::TRAIN, FFONLY = MODE == Mode::FF;
  const size_t slot = (size_t)p.B * p.N * D;  // elements of one saved-activation slot
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
    if constexpr (!FFONLY) stage_kv(p, kv, mask, b, 0, tid);

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
      if constexpr (TRAIN) {
        uint32_t pre[32];
        layer_norm(h, pre, p.pre_scale, p.pre_bias, t);
#pragma unroll
        for (int w = 0; w < 32; ++w) h[w] = pre[w];
      }
    }

    for (int i = 0; i < p.depth; ++i) {
      uint32_t a[32];
      float acc[64];
      if constexpr (!FFONLY) {
        if (i > 0 && i % KV_GROUP == 0) stage_kv(p, kv, mask, b, i, tid);
        const bf16* K = kv + (i % KV_GROUP) * 2 * CTX * D;
        // ---- attention half
        layer_norm(h, a, p.n2_scale + i * D, p.n2_bias + i * D, t);
        ring.product<8>(acc, a, false);                       // q = a Wq
        attention(acc, K, K + CTX * D, mask, p.scale, t, a);  // a = attn
        ring.product<8>(acc, a, false);                       // attn Wout
        if constexpr (TRAIN) {
          if (p.acts) store_rows(p.acts + 2 * i * slot, h, p, b, n0, row0, t);  // u
          residual_add(h, acc, p.bout + i * D, t, Dropout(p, b, n0 + row0, i, 0));
          if (p.acts) store_rows(p.acts + (2 * i + 1) * slot, h, p, b, n0, row0, t);  // up
        } else {
          residual_add(h, acc, p.bout + i * D, t);
        }
      }

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
        if constexpr (TRAIN) geglu(acc, b1, ch * FC, t, act, Dropout(p, b, n0 + row0, i, 1));
        else geglu(acc, b1, ch * FC, t, act);
        ring.product<4>(ff, act, true);  // ff += act W2 rows of the chunk
      }
#pragma unroll
      for (int w = 0; w < 32; ++w) h[w] = stash[w * CT];
      residual_add(h, ff, p.b2 + i * D, t);
    }

    // ---- post-LN (not for one block or the FF alone) and the store of the valid rows
    uint32_t y[32];
    if constexpr (MODE == Mode::BLOCK || FFONLY) {
#pragma unroll
      for (int w = 0; w < 32; ++w) y[w] = h[w];
    } else {
      if constexpr (TRAIN) {
        if (p.acts) store_rows(p.acts + 2 * p.depth * slot, h, p, b, n0, row0, t);
      }
      layer_norm(h, y, p.post_scale, p.post_bias, t);
    }
    store_rows(p.out, y, p, b, n0, row0, t);
  }
}

template <Mode MODE>
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
      constexpr bool FFONLY = MODE == Mode::FF;  // no Wq, Wout maps
      if (!FFONLY) {
        prefetch_tensormap(&p.wq);
        prefetch_tensormap(&p.wout);
      }
      prefetch_tensormap(&p.w1);
      prefetch_tensormap(&p.w2);
      const int tiles = (p.total_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
      produce(p, smem + OFF_RING, full, empty, tiles * p.depth, FFONLY ? 2 : 0);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<MODE>(p, smem, Ring{smem + OFF_RING, full, empty, 0});
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
// unless the tiles cover every token and every block has one. Mode::FF takes
// no Wq or Wout (null).
template <Mode MODE>
cudaError_t launch(Params& p, int grid, int tiles_per_row, const void* wq, const void* wout,
                   const void* w1, const void* w2, cudaStream_t stream) {
  const long long total = (long long)p.B * tiles_per_row;
  if (tiles_per_row < 1 || (long long)tiles_per_row * TILE < p.N || total > 0x7fffffff ||
      grid < 1 || grid > total)
    return cudaErrorInvalidValue;
  p.tiles_per_row = tiles_per_row;
  p.total_tiles = (int)total;
  cudaError_t err = cudaSuccess;
  if (MODE != Mode::FF) {
    err = weight_map(&p.wq, wq, p.depth, D, D, D);
    if (err == cudaSuccess) err = weight_map(&p.wout, wout, p.depth, D, D, D);
  }
  if (err == cudaSuccess) err = weight_map(&p.w1, w1, p.depth, D, 2 * FF, D);
  if (err == cudaSuccess) err = weight_map(&p.w2, w2, p.depth, FF, D, FC);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_core_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  fused_core_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
