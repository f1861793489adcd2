// The trainable denoiser trunk: a forward and a backward kernel for sm_90a.
//
// Replaces the TPU pair difffacto_tpu/ops/fused_core_train.py:
// _trunk_train_fwd_kernel and _trunk_train_bwd_kernel (the custom VJP
// fused_trunk_train_call). The trunk is the one of csrc/fused_core.cu without
// proj_in: pre-LN -> depth x [LN -> q -> attention to the 4 part tokens ->
// out-proj -> dropout -> residual -> LN -> GEGLU FF with dropout on the
// activations -> residual] -> post-LN, bf16 operands, f32 accumulation and
// f32 LayerNorm statistics, rounded to bf16 where the Pallas kernels round.
// Dropout masks are never stored: both kernels regenerate them from the hash
// of csrc/trunk.cuh (seed, batch row, global token, block, site, column).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 230,400 MACs per token and
// block forward. The backward is given the forward's saved u, up and final
// hidden, so it redoes only the Wq and W1 products and the attention
// (148,480 MACs) before two products per matrix product and the attention's
// backward (460,800): 609,280 MACs. At B=128, N=2048, depth 5: 0.60 TFLOP
// forward (0.61 ms), 1.60 TFLOP backward (1.61 ms), against 0.14 GB of
// operands and 0.74 GB of saved activations: both are compute-bound. Given
// only the Pallas pair's inputs the backward would redo the whole forward
// (691,200 MACs, 1.83 ms): the bound earlier measurements were held to.
//
// Forward (trunk_train_fwd): csrc/trunk.cuh's persistent kernel in
// Mode::TRAIN: one thread block per SM walks (batch row, 128-token tile) work
// items, a producer warp streams the stacked weights through a 4-stage TMA
// ring, two consumer warpgroups run wgmma with A in registers; dropout is
// applied in the accumulator fragments. Under autograd it also stores each
// block's input u and post-attention hidden up and the hidden before the
// post-LN: 2 depth + 1 bf16 slots of (B, N, 128), 738 MB at B=128, N=2048,
// depth 5, which the backward reads instead of recomputing the forward.
//
// Backward (trunk_train_bwd_kernel): the same persistent walk, a 3-stage TMA
// ring of the same weight boxes in the order the reverse walk needs them
// (per block: W1 and W2 of 8 chunks of 64 inner units, then Wout and Wq), and
// two consumer warpgroups of 64 tokens each. For every block, in reverse:
//  * FF half: h2 = LN(up) and bf16(d) go to shared memory (128-byte swizzle);
//    per chunk [u | g] = h2 W1 and d_act = bf16(d) W2^T (wgmma, A and B from
//    shared memory, B K-major where the product takes a weight transposed),
//    the GEGLU backward in the fragments, d(h2) += da W1u^T + dg W1g^T (A in
//    registers), and the chunk's weight gradients dW2 = act^T bf16(d),
//    dW1 = h2^T [da | dg], contracted over the 128 tokens of the tile with
//    both operands in shared memory (A MN-major: the transposed products).
//  * attention half: q = LN(u) Wq, d_attn = bf16(d_o) Wout^T, the softmax and
//    score backward per token in the fragments (quad shuffles), dWout =
//    attn^T bf16(d_o), dq Wq^T, dWq = LN(u)^T bf16(dq); dK and dV are summed
//    over the warp's tokens with shuffles.
//  * LayerNorm backwards in the fragments; their column sums and the bias
//    gradients are summed over a warp's rows with shuffles.
// The gradient d of the residual stream is parked in a per-block global
// scratch (64 KB, L2-resident) while the FF chunks and the attention run:
// with it in registers the consumers would need more than 232.
//
// Measured (tools/train_bwd_probe_torch.py, which builds this file with
// -DPROBE_NO_FLUSH, -DPROBE_NO_COLUMN_SUMS or -DPROBE_NO_COLUMN_REDUCTIONS:
// measurement builds with wrong gradients; H100 80GB HBM3 at 700 W, B=128,
// N=2048): of ~21.8 ms, the weight-gradient flush takes ~20% and the column
// sums (vector gradients, dK, dV: sums, shuffles, reductions) ~28%, most of it
// in the sums and shuffles and the registers they hold; their global
// reductions alone ~5%. Saving the activations costs the forward ~0.7 ms;
// recomputing them would cost the backward a whole forward (~3.8 ms).
//
// Weight gradients: each tile's contribution, contracted over its 128 tokens,
// goes into the zeroed f32 buffers with 4-wide f32 reductions (red.v4, one per
// thread and 4 entries); at depth 5 that is 1.15 M f32 a tile, 9.4 GB of
// reduction traffic into L2 at B=128, N=2048. The order of the sums changes
// from run to run, so the gradients repeat only to f32 rounding.

#include "trunk.cuh"

namespace {

// ---- the backward kernel's shapes and shared memory
constexpr int BW_STAGES = 3;                    // weight ring depth (32 KB a stage)
constexpr int BW_CHUNKS = 2 * NCH + 2;           // per block: (W1, W2) x 8, Wout, Wq
constexpr int BW_RING = 0;
constexpr int BW_POOL = BW_RING + BW_STAGES * STAGE_BYTES;
// FF half
constexpr int BW_H2 = BW_POOL;                  // LN(up), 2 boxes of 128 tokens x 64
constexpr int BW_DC = BW_H2 + 2 * BOX_K128;     // bf16(d), 2 boxes
constexpr int BW_ACT = BW_DC + 2 * BOX_K128;    // act of the chunk, 1 box
constexpr int BW_DA = BW_ACT + BOX_K128;        // da of the chunk
constexpr int BW_DG = BW_DA + BOX_K128;         // dg of the chunk
// attention half, over the same pool
constexpr int BW_A = BW_H2;                     // LN(u)
constexpr int BW_DO = BW_DC;                    // bf16(d_o)
constexpr int BW_ATT = BW_ACT;                  // attn, then bf16(dq): 2 boxes
constexpr int BW_WDS = BW_DG;                   // bf16 softmax weights and ds, (token, m, head)
constexpr int BW_KV = BW_DG + BOX_K128;         // K, V of the block and row, bf16
constexpr int BW_MASK = BW_KV + 2 * CTX * D * 2;
constexpr int BW_BAR = BW_MASK + 64;
constexpr int BW_SMEM = BW_BAR + 2 * BW_STAGES * 8 + 1024;
static_assert(BW_SMEM <= 232448, "over the 227 KB a block may use");
static_assert(BW_POOL % 1024 == 0 && BW_ACT % 1024 == 0, "swizzled boxes need 1024-byte alignment");
constexpr int PARK_FLOATS = CT * 64;            // the parked gradient of one thread block
constexpr int BW_CONSUMER_REGS = CONSUMER_REGS, BW_PRODUCER_REGS = PRODUCER_REGS;

struct BwdParams {
  CUtensorMap wq, wout, w1, w2;
  const bf16* x; const bf16* dy; const bf16* acts; const bf16* k; const bf16* v;
  const float* mask; const int* seed;
  const bf16* pre_scale; const bf16* post_scale; const bf16* n2_scale; const bf16* n2_bias;
  const bf16* ff_scale; const bf16* ff_bias; const float* b1;
  bf16* dx; float* park;
  float* dk; float* dv; float* dpre_s; float* dpre_b; float* dpost_s; float* dpost_b;
  float* dn2s; float* dn2b; float* dwq; float* dwout; float* dbout; float* dffs; float* dffb;
  float* dw1; float* db1; float* dw2; float* db2;
  int B, N, depth, tiles_per_row, total_tiles, drop;
  float scale, keep_scale;
  unsigned int thresh;
};

// gelu_tanh(g) = g s, s = sigmoid(2 z), z = sqrt(2/pi)(g + 0.044715 g^3), and
// its derivative s + 2 g s (1 - s) z'.
__device__ __forceinline__ void gelu_and_prime(float g, float& gl, float& gp) {
  const float z = g * (0.7978845608028654f + 0.0356774081363001f * g * g);
  const float dz = 0.7978845608028654f + 0.1070322243089003f * g * g;
  const float s = __fdividef(1.0f, 1.0f + __expf(-2.0f * z));
  gl = g * s;
  gp = s + 2.0f * g * s * (1.0f - s) * dz;
}

// ---- fragments in and out (layout of csrc/hopper.cuh; rows row0, row0 + 8)

// The thread's two rows of row b of a (B, N, 128) bf16 array; 0 past N.
__device__ __forceinline__ void load_rows(const bf16* src, uint32_t (&h)[32], int N, int b,
                                          int n0, int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + row0 + 8 * r;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src + ((size_t)b * N + n) * D);
#pragma unroll
    for (int j = 0; j < 16; ++j) h[2 * j + r] = n < N ? __ldg(s + 4 * j + t) : 0u;
  }
}

// A packed fragment (rows row0, row0 + 8, 128 columns) into shared memory as
// two boxes of 128 rows x 64 columns with the 128-byte swizzle (the layout TMA
// writes).
__device__ __forceinline__ void store_swizzled(unsigned char* tile, const uint32_t (&y)[32],
                                               int row0, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      *reinterpret_cast<uint32_t*>(tile + (j >> 3) * BOX_K128 + row * 128 +
                                   (((j & 7) ^ (row & 7)) << 4) + 4 * t) = y[2 * j + r];
    }
}

__device__ __forceinline__ void pack_fragment(const float (&d)[64], uint32_t (&y)[32]) {
#pragma unroll
  for (int w = 0; w < 32; ++w) y[w] = pack_bf16(d[2 * w], d[2 * w + 1]);
}

// The parked gradient (64 f32 a thread) to and from the block's global scratch.
__device__ __forceinline__ void park(float* slot, const float (&d)[64]) {
  float4* s = reinterpret_cast<float4*>(slot) + threadIdx.x;
#pragma unroll
  for (int w = 0; w < 16; ++w) s[w * CT] = make_float4(d[4 * w], d[4 * w + 1], d[4 * w + 2], d[4 * w + 3]);
}

__device__ __forceinline__ void unpark(const float* slot, float (&d)[64]) {
  const float4* s = reinterpret_cast<const float4*>(slot) + threadIdx.x;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const float4 v = s[w * CT];
    d[4 * w] = v.x; d[4 * w + 1] = v.y; d[4 * w + 2] = v.z; d[4 * w + 3] = v.w;
  }
}

// Column sums over the warp's 16 rows: a and b are the thread's sums of
// columns 2 t and 2 t + 1 of an 8-column block over its two rows; the lanes
// of quad 0 add the warp's sums into dst[2 t], dst[2 t + 1].
__device__ __forceinline__ void red_column_pair(float* dst, float a, float b, int lane) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
#if defined(PROBE_NO_COLUMN_SUMS)
  if (lane < 0) red_add_v2(dst + 2 * lane, a, b);  // never: the sums become dead code
#elif defined(PROBE_NO_COLUMN_REDUCTIONS)
  if (lane < 4 && a == 12345.0f) red_add_v2(dst + 2 * lane, a, b);  // the sums stay live
#else
  if (lane < 4) red_add_v2(dst + 2 * lane, a, b);
#endif
}

// The same over 16 blocks: v[2 j + e] is the sum of column 8 j + 2 t + e.
__device__ __forceinline__ void red_columns(const float (&v)[32], float* dst, int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) red_column_pair(dst + 8 * j, v[2 * j], v[2 * j + 1], lane);
}

// An accumulator (64 rows x 8 J columns) of a weight gradient into the f32
// buffer dst (row stride ld), row m of the warpgroup's product at dst + m ld:
// neighbouring threads swap halves so that each adds 4 consecutive columns.
template <int J>
__device__ __forceinline__ void red_tile(const float (&d)[4 * J], float* dst, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3, odd = t & 1;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + g + 8 * odd;
  float* base = dst + (size_t)row * ld + 2 * (t - odd);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float s0 = odd ? d[4 * j] : d[4 * j + 2], s1 = odd ? d[4 * j + 1] : d[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
#if defined(PROBE_NO_FLUSH)
    (void)r0; (void)r1; (void)base;
#else
    if (odd) red_add_v4(base + 8 * j, r0, r1, d[4 * j + 2], d[4 * j + 3]);
    else red_add_v4(base + 8 * j, d[4 * j], d[4 * j + 1], r0, r1);
#endif
  }
}

// The backward of y = LN(x) * scale + bias on the thread's two rows: with
// g = dy * scale, out += inv (g - mean(g) - xhat mean(g xhat)); the column
// sums of dy xhat and dy go to gs and gb (over the warp, then reductions).
__device__ __forceinline__ void layer_norm_bwd(const uint32_t (&x)[32], const bf16* scale,
                                               const float (&dy)[64], float (&out)[64],
                                               float* gs, float* gb, int t, int lane) {
  float mu[2], inv[2], m1[2], m2[2];
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
    float a = 0.0f, c = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 v = unpack_bf16(x[2 * j + r]);
      const float2 sc = ldg_bf16x2(scale + 8 * j + 2 * t);
      const float g0 = dy[4 * j + 2 * r] * sc.x, g1 = dy[4 * j + 2 * r + 1] * sc.y;
      a += g0 + g1;
      c += g0 * (v.x - mu[r]) * inv[r] + g1 * (v.y - mu[r]) * inv[r];
    }
    m1[r] = quad_sum(a) * (1.0f / D);
    m2[r] = quad_sum(c) * (1.0f / D);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 sc = ldg_bf16x2(scale + 8 * j + 2 * t);
    float cs0 = 0.0f, cs1 = 0.0f, cb0 = 0.0f, cb1 = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = unpack_bf16(x[2 * j + r]);
      const float xh0 = (v.x - mu[r]) * inv[r], xh1 = (v.y - mu[r]) * inv[r];
      const float g0 = dy[4 * j + 2 * r], g1 = dy[4 * j + 2 * r + 1];
      out[4 * j + 2 * r] += inv[r] * (g0 * sc.x - m1[r] - xh0 * m2[r]);
      out[4 * j + 2 * r + 1] += inv[r] * (g1 * sc.y - m1[r] - xh1 * m2[r]);
      cs0 += g0 * xh0;
      cs1 += g1 * xh1;
      cb0 += g0;
      cb1 += g1;
    }
    red_column_pair(gs + 8 * j, cs0, cs1, lane);
    red_column_pair(gb + 8 * j, cb0, cb1, lane);
  }
}

// ---- products. K-major operands: a k-step of 16 advances 32 bytes inside a
// 64-column box, and every 4 k-steps moves to the next box (box_bytes on).
// MN-major operands (the 128-token contractions): a k-step is 16 rows, 2048
// bytes, of every box.

// d (64 x 128) = A (64 rows of a K-major tile in shared memory, 128 deep) x
// B (a weight stage: MN-major boxes of 128 rows, as the forward reads them).
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint32_t a, uint32_t b) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n128k16_ss<0, 1>(d, desc_k_sw128(a + (kk >> 2) * BOX_K128 + 32 * (kk & 3)),
                              desc_mn_sw128(b + 2048u * kk, BOX_K128, 1024u), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// d (64 x 64) = A (64 rows of a K-major tile, 128 deep) x B (W2's two K-major
// boxes of 64 rows: d_act = bf16(d) W2_chunk^T).
__device__ __forceinline__ void mma_ss_w2t(float (&d)[32], uint32_t a, uint32_t b) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss<0, 0>(d, desc_k_sw128(a + (kk >> 2) * BOX_K128 + 32 * (kk & 3)),
                             desc_k_sw128(b + (kk >> 2) * BOX_K64 + 32 * (kk & 3)), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// d (64 x 8 J) = A^T B over the 128 tokens of the tile: A one MN-major box
// (tokens x 64), B J / 8 MN-major boxes (tokens x 64 each, BOX_K128 apart).
template <int J>
__device__ __forceinline__ void mma_tokens(float (&d)[4 * J], uint32_t a, uint32_t b) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t da = desc_mn_sw128(a + 2048u * kk, BOX_K128, 1024u);
    const uint64_t db = desc_mn_sw128(b + 2048u * kk, BOX_K128, 1024u);
    if constexpr (J == 16) wgmma_m64n128k16_ss<1, 1>(d, da, db, kk > 0);
    else wgmma_m64n64k16_ss<1, 1>(d, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// d (+)= A (registers, KSTEPS k-steps) x B, B K-major boxes of 128 rows: the
// products with a weight transposed (d_attn, d LN(u), d h2).
template <int KSTEPS>
__device__ __forceinline__ void mma_rs_kmajor(float (&d)[64], uint32_t (&a)[4 * KSTEPS],
                                              uint32_t b, bool accumulate) {
  fence_regs(d);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    wgmma_m64n128k16_rs<0>(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                           desc_k_sw128(b + (kk >> 2) * BOX_K128 + 32 * (kk & 3)),
                           (accumulate || kk > 0) ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(a);
}

// ---- the weight ring, in the reverse walk's order
struct BwdRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int it;

  // Wait for the next stage; returns its index.
  __device__ __forceinline__ int acquire() {
    const int s = it % BW_STAGES;
    mbar_wait(&full[s], (it / BW_STAGES) & 1);
    ++it;
    return s;
  }
  __device__ __forceinline__ uint32_t addr(int s) const {
    return smem_addr(base + s * STAGE_BYTES);
  }
  __device__ __forceinline__ void release(int s) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
};

__device__ __forceinline__ void produce_bwd(const BwdParams& p, unsigned char* ring,
                                            uint64_t* full, uint64_t* empty, int tiles) {
  int it = 0;
  for (int tile = 0; tile < tiles; ++tile)
    for (int i = p.depth - 1; i >= 0; --i)
      for (int c = 0; c < BW_CHUNKS; ++c, ++it) {
        const int s = it % BW_STAGES;
        mbar_wait(&empty[s], ((it / BW_STAGES) & 1) ^ 1);
        unsigned char* dst = ring + s * STAGE_BYTES;
        if (c < 2 * NCH && (c & 1) == 0) {  // W1: the u and the g columns of chunk c / 2
          const int ch = c >> 1;
          mbar_expect_tx(&full[s], 2 * BOX_K128);
          tma_load_3d(dst, &p.w1, &full[s], ch * FC, 0, i);
          tma_load_3d(dst + BOX_K128, &p.w1, &full[s], FF + ch * FC, 0, i);
        } else if (c < 2 * NCH) {  // W2: the chunk's rows, both column halves
          const int ch = c >> 1;
          mbar_expect_tx(&full[s], 2 * BOX_K64);
          tma_load_3d(dst, &p.w2, &full[s], 0, ch * FC, i);
          tma_load_3d(dst + BOX_K64, &p.w2, &full[s], 64, ch * FC, i);
        } else {  // Wout, then Wq
          const CUtensorMap* m = c == 2 * NCH ? &p.wout : &p.wq;
          mbar_expect_tx(&full[s], 2 * BOX_K128);
          tma_load_3d(dst, m, &full[s], 0, 0, i);
          tma_load_3d(dst + BOX_K128, m, &full[s], 64, 0, i);
        }
      }
}

// The attention of row r (of the thread's two tokens) recomputed and
// differentiated, from q and d_attn (bf16, packed): the rounded output goes
// into the swizzled tile att, the rounded dq into dq, and the rounded softmax
// weights and ds of the thread's heads 2 t, 2 t + 1 into wds ((token, m, head)
// bf16, two arrays).
__device__ __forceinline__ void attention_bwd(const uint32_t (&q)[32], const uint32_t (&da)[32],
                                              const bf16* K, const bf16* V, const float* mask,
                                              float scale, int t, int r, int row,
                                              unsigned char* att, uint32_t (&dq)[32], bf16* wds) {
  float w[8][CTX];
#pragma unroll
  for (int h = 0; h < 8; ++h)
#pragma unroll
    for (int m = 0; m < CTX; ++m) w[h][m] = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 qq = unpack_bf16(q[2 * j + r]);
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      const float2 k = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(K + m * D + 8 * j + 2 * t));
      w[j >> 1][m] += qq.x * k.x + qq.y * k.y;
    }
  }
  float c = -3.0e38f;
#pragma unroll
  for (int h = 0; h < 8; ++h)
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      w[h][m] = quad_sum(w[h][m]) * scale + (mask[m] - 1.0f) * 1e30f;
      c = fmaxf(c, w[h][m]);
    }
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float den = 0.0f;
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      w[h][m] = __expf(w[h][m] - c) * mask[m];
      den += w[h][m];
    }
    const float inv = 1.0f / fmaxf(den, 1e-30f);
#pragma unroll
    for (int m = 0; m < CTX; ++m) w[h][m] *= inv;
  }
  // attn, and ds[h][m] first holding the sum over the head's columns of
  // bf16(d_attn) V[m]
  float ds[8][CTX];
#pragma unroll
  for (int h = 0; h < 8; ++h)
#pragma unroll
    for (int m = 0; m < CTX; ++m) ds[h][m] = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int h = j >> 1;
    const float2 dd = unpack_bf16(da[2 * j + r]);
    float o0 = 0.0f, o1 = 0.0f;
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(V + m * D + 8 * j + 2 * t));
      const float wr = round_bf16(w[h][m]);
      o0 += wr * vv.x;
      o1 += wr * vv.y;
      ds[h][m] += dd.x * vv.x + dd.y * vv.y;
    }
    *reinterpret_cast<uint32_t*>(att + (j >> 3) * BOX_K128 + row * 128 +
                                 (((j & 7) ^ (row & 7)) << 4) + 4 * t) = pack_bf16(o0, o1);
  }
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float tt = 0.0f;
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      ds[h][m] = quad_sum(ds[h][m]);
      tt += w[h][m] * ds[h][m];
    }
#pragma unroll
    for (int m = 0; m < CTX; ++m) ds[h][m] = round_bf16(w[h][m] * (ds[h][m] - tt));
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int m = 0; m < CTX; ++m) {
      const float2 k = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(K + m * D + 8 * j + 2 * t));
      a0 += ds[j >> 1][m] * k.x;
      a1 += ds[j >> 1][m] * k.y;
    }
    dq[2 * j + r] = pack_bf16(a0 * scale, a1 * scale);
  }
  // this thread's heads 2 t and 2 t + 1: weights then ds, (token, m, head)
#pragma unroll
  for (int m = 0; m < CTX; ++m) {
    __nv_bfloat162* wp = reinterpret_cast<__nv_bfloat162*>(wds + (row * CTX + m) * 8 + 2 * t);
    wp[0] = __floats2bfloat162_rn(w[2 * t][m], w[2 * t + 1][m]);
    wp[TILE * CTX * 4] = __floats2bfloat162_rn(ds[2 * t][m], ds[2 * t + 1][m]);
  }
}

// dV[m] += sum over tokens bf16(w) bf16(d_attn), dK[m] += scale sum q ds for
// the warp's 16 tokens: per context token, the thread's columns summed over its
// two rows, then over the warp.
__device__ __forceinline__ void dkv_partial(const uint32_t (&q)[32], const uint32_t (&da)[32],
                                            const bf16* wds, int row0, float* dk, float* dv,
                                            float scale, int lane) {
#pragma unroll 1
  for (int m = 0; m < CTX; ++m) {
    float pv[32], pk[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pv[i] = pk[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bf16* wrow = wds + ((row0 + 8 * r) * CTX + m) * 8;
      const uint4 wv = *reinterpret_cast<const uint4*>(wrow);
      const uint4 sv = *reinterpret_cast<const uint4*>(wrow + TILE * CTX * 8);
      const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w}, ss[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 wh = unpack_bf16(ww[j >> 2]), sh = unpack_bf16(ss[j >> 2]);
        const float wj = (j >> 1) & 1 ? wh.y : wh.x, sj = (j >> 1) & 1 ? sh.y : sh.x;
        const float2 a = unpack_bf16(da[2 * j + r]), qq = unpack_bf16(q[2 * j + r]);
        pv[2 * j] += wj * a.x;
        pv[2 * j + 1] += wj * a.y;
        pk[2 * j] += sj * qq.x;
        pk[2 * j + 1] += sj * qq.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) pk[i] *= scale;
    red_columns(pv, dv + m * D, lane);
    red_columns(pk, dk + m * D, lane);
  }
}

__device__ __forceinline__ void consume_bwd(const BwdParams& p, unsigned char* smem,
                                            BwdRing ring) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wg = tid >> 7;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // rows row0, row0 + 8 of the tile
  const uint32_t s_h2 = smem_addr(smem + BW_H2), s_dc = smem_addr(smem + BW_DC);
  const uint32_t s_act = smem_addr(smem + BW_ACT), s_da = smem_addr(smem + BW_DA);
  const uint32_t s_dg = smem_addr(smem + BW_DG);
  const uint32_t s_wg_rows = wg * 64 * 128;  // this warpgroup's rows in a K-major box
  bf16* K = reinterpret_cast<bf16*>(smem + BW_KV);
  bf16* V = K + CTX * D;
  float* mask = reinterpret_cast<float*>(smem + BW_MASK);
  bf16* wds = reinterpret_cast<bf16*>(smem + BW_WDS);
  float* parked = p.park + (size_t)blockIdx.x * PARK_FLOATS;
  const size_t slot = (size_t)p.B * p.N * D;

  for (int tile = blockIdx.x; tile < p.total_tiles; tile += gridDim.x) {
    const int b = tile / p.tiles_per_row;
    const int n0 = (tile - b * p.tiles_per_row) * TILE;
    if (tid < CTX) mask[tid] = p.mask[b * CTX + tid];

    // ---- post-LN backward: d = dLN(h_final) from dy
    float d[64];
    {
      uint32_t hf[32], dyp[32];
      float dy[64];
      load_rows(p.acts + 2 * p.depth * slot, hf, p.N, b, n0, row0, t);
      load_rows(p.dy, dyp, p.N, b, n0, row0, t);
#pragma unroll
      for (int w = 0; w < 32; ++w) {
        const float2 v = unpack_bf16(dyp[w]);
        dy[2 * w] = v.x;
        dy[2 * w + 1] = v.y;
      }
#pragma unroll
      for (int w = 0; w < 64; ++w) d[w] = 0.0f;
      layer_norm_bwd(hf, p.post_scale, dy, d, p.dpost_s, p.dpost_b, t, lane);
    }

    for (int i = p.depth - 1; i >= 0; --i) {
      const float* b1 = p.b1 + i * 2 * FF;
      // K and V of block i and row b (the barriers of the FF chunks publish them;
      // the previous block's were last read before its dWq barrier)
      for (int w = tid; w < CTX * D / 2; w += CT) {
        const size_t src = ((size_t)i * p.B + b) * (CTX * D / 2) + w;
        reinterpret_cast<uint32_t*>(K)[w] = reinterpret_cast<const uint32_t*>(p.k)[src];
        reinterpret_cast<uint32_t*>(V)[w] = reinterpret_cast<const uint32_t*>(p.v)[src];
      }

      // ================= feed-forward half: v = up + FF(LN(up))
      {
        uint32_t y[32];
        load_rows(p.acts + (2 * i + 1) * slot, y, p.N, b, n0, row0, t);
        uint32_t h2[32];
        layer_norm(y, h2, p.ff_scale + i * D, p.ff_bias + i * D, t);
        store_swizzled(smem + BW_H2, h2, row0, t);
        pack_fragment(d, y);  // bf16(d)
        store_swizzled(smem + BW_DC, y, row0, t);
        float cs[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          cs[2 * j] = d[4 * j] + d[4 * j + 2];
          cs[2 * j + 1] = d[4 * j + 1] + d[4 * j + 3];
        }
        red_columns(cs, p.db2 + i * D, lane);
      }
      park(parked, d);
      fence_proxy_async();
      named_sync(1, CT);

      float dh2[64];
#pragma unroll
      for (int w = 0; w < 64; ++w) dh2[w] = 0.0f;
      const Dropout drop1(p, b, n0 + row0, i, 1);
#pragma unroll 1
      for (int ch = 0; ch < NCH; ++ch) {
        const int s1 = ring.acquire(), s2 = ring.acquire();
        uint32_t pda[16], pdg[16];
        {
          float ug[64], dact[32];
          mma_ss_n128(ug, s_h2 + s_wg_rows, ring.addr(s1));  // [u | g] = h2 W1
          mma_ss_w2t(dact, s_dc + s_wg_rows, ring.addr(s2));       // bf16(d) W2^T
          ring.release(s2);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = ch * FC + 8 * j + 2 * t;
            const float2 bu = __ldg(reinterpret_cast<const float2*>(b1 + col));
            const float2 bg = __ldg(reinterpret_cast<const float2*>(b1 + FF + col));
            float sa[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = row0 + 8 * r;
              float act[2], dav[2], dgv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float u = ug[4 * j + 2 * r + e] + (e ? bu.y : bu.x);
                const float gg = ug[4 * (j + 8) + 2 * r + e] + (e ? bg.y : bg.x);
                const float m = drop1(r, col + e);
                float gl, gp;
                gelu_and_prime(gg, gl, gp);
                const float dm = dact[4 * j + 2 * r + e] * m;
                act[e] = u * gl * m;
                dav[e] = dm * gl;
                dgv[e] = dm * u * gp;
                sa[e] += dav[e];
                sg[e] += dgv[e];
              }
              pda[2 * j + r] = pack_bf16(dav[0], dav[1]);
              pdg[2 * j + r] = pack_bf16(dgv[0], dgv[1]);
              const int off = row * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
              *reinterpret_cast<uint32_t*>(smem + BW_ACT + off) = pack_bf16(act[0], act[1]);
              *reinterpret_cast<uint32_t*>(smem + BW_DA + off) = pda[2 * j + r];
              *reinterpret_cast<uint32_t*>(smem + BW_DG + off) = pdg[2 * j + r];
            }
            red_column_pair(p.db1 + i * 2 * FF + col - 2 * t, sa[0], sa[1], lane);
            red_column_pair(p.db1 + i * 2 * FF + FF + col - 2 * t, sg[0], sg[1], lane);
          }
        }
        // d h2 += da W1u^T + dg W1g^T
        mma_rs_kmajor<4>(dh2, pda, ring.addr(s1), true);
        mma_rs_kmajor<4>(dh2, pdg, ring.addr(s1) + BOX_K128, true);
        ring.release(s1);
        fence_proxy_async();
        named_sync(1, CT);
        {
          float acc[32];
          // dW2[chunk rows, this warpgroup's 64 columns] = act^T bf16(d)
          mma_tokens<8>(acc, s_act, s_dc + wg * BOX_K128);
          red_tile<8>(acc, p.dw2 + ((size_t)i * FF + ch * FC) * D + wg * 64, D, lane);
          // dW1[this warpgroup's 64 rows, u and g columns of the chunk] = h2^T [da | dg]
          float* w1rows = p.dw1 + ((size_t)i * D + wg * 64) * 2 * FF + ch * FC;
          mma_tokens<8>(acc, s_h2 + wg * BOX_K128, s_da);
          red_tile<8>(acc, w1rows, 2 * FF, lane);
          mma_tokens<8>(acc, s_h2 + wg * BOX_K128, s_dg);
          red_tile<8>(acc, w1rows + FF, 2 * FF, lane);
        }
        named_sync(1, CT);  // both warpgroups are done with act, da, dg
      }
      // d_up = d + dLN(up)
      {
        uint32_t y[32];
        load_rows(p.acts + (2 * i + 1) * slot, y, p.N, b, n0, row0, t);
        unpark(parked, d);
        layer_norm_bwd(y, p.ff_scale + i * D, dh2, d, p.dffs + i * D, p.dffb + i * D, t, lane);
      }

      // ================= attention half: up = u + drop(attn(LN(u)) Wout + bout)
      uint32_t pdo[32];
      {
        const Dropout drop0(p, b, n0 + row0, i, 0);
        float cs[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          cs[2 * j] = cs[2 * j + 1] = 0.0f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float o0 = d[4 * j + 2 * r] * drop0(r, 8 * j + 2 * t);
            const float o1 = d[4 * j + 2 * r + 1] * drop0(r, 8 * j + 2 * t + 1);
            cs[2 * j] += o0;
            cs[2 * j + 1] += o1;
            pdo[2 * j + r] = pack_bf16(o0, o1);
          }
        }
        red_columns(cs, p.dbout + i * D, lane);
      }
      park(parked, d);
      store_swizzled(smem + BW_DO, pdo, row0, t);
      uint32_t pdq[32];
      int sq;  // the ring stage of Wq, kept for d LN(u)
      {
        uint32_t pq[32], pdat[32];
        {
          uint32_t u[32], a[32];
          load_rows(p.acts + 2 * i * slot, u, p.N, b, n0, row0, t);
          layer_norm(u, a, p.n2_scale + i * D, p.n2_bias + i * D, t);
          store_swizzled(smem + BW_A, a, row0, t);
          float q[64];
          const int so = ring.acquire();
          sq = ring.acquire();
          chunk_product<8>(q, a, ring.addr(sq), BOX_K128, false);  // q = LN(u) Wq
          pack_fragment(q, pq);
          float dat[64];
          mma_rs_kmajor<8>(dat, pdo, ring.addr(so), false);  // d_attn = bf16(d_o) Wout^T
          ring.release(so);
          pack_fragment(dat, pdat);
          attention_bwd(pq, pdat, K, V, mask, p.scale, t, 0, row0, smem + BW_ATT, pdq, wds);
          attention_bwd(pq, pdat, K, V, mask, p.scale, t, 1, row0 + 8, smem + BW_ATT, pdq, wds);
          __syncwarp();
          const size_t kv = (((size_t)i * p.B + b) * CTX) * D;
          dkv_partial(pq, pdat, wds, row0, p.dk + kv, p.dv + kv, p.scale, lane);
        }
      }
      fence_proxy_async();
      named_sync(1, CT);
      {
        // dWout[this warpgroup's 64 rows, :] = attn^T bf16(d_o)
        float acc[64];
        mma_tokens<16>(acc, smem_addr(smem + BW_ATT) + wg * BOX_K128, smem_addr(smem + BW_DO));
        red_tile<16>(acc, p.dwout + ((size_t)i * D + wg * 64) * D, D, lane);
      }
      named_sync(1, CT);  // attn is read: bf16(dq) takes its place
      store_swizzled(smem + BW_ATT, pdq, row0, t);
      {
        // d LN(u) = bf16(dq) Wq^T, then d = d_up + dLN(u)
        float dln[64];
        mma_rs_kmajor<8>(dln, pdq, ring.addr(sq), false);
        ring.release(sq);
        uint32_t u[32];
        load_rows(p.acts + 2 * i * slot, u, p.N, b, n0, row0, t);
        unpark(parked, d);
        layer_norm_bwd(u, p.n2_scale + i * D, dln, d, p.dn2s + i * D, p.dn2b + i * D, t, lane);
      }
      fence_proxy_async();
      named_sync(1, CT);
      {
        // dWq[this warpgroup's 64 rows, :] = LN(u)^T bf16(dq)
        float acc[64];
        mma_tokens<16>(acc, smem_addr(smem + BW_A) + wg * BOX_K128, smem_addr(smem + BW_ATT));
        red_tile<16>(acc, p.dwq + ((size_t)i * D + wg * 64) * D, D, lane);
      }
      named_sync(1, CT);  // the pool and K, V are free for the next block
    }

    // ---- pre-LN backward and dx
    {
      uint32_t x[32], y[32];
      load_rows(p.x, x, p.N, b, n0, row0, t);
      float dx[64];
#pragma unroll
      for (int w = 0; w < 64; ++w) dx[w] = 0.0f;
      layer_norm_bwd(x, p.pre_scale, d, dx, p.dpre_s, p.dpre_b, t, lane);
      pack_fragment(dx, y);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + row0 + 8 * r;
        if (n < p.N) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(p.dx + ((size_t)b * p.N + n) * D);
#pragma unroll
          for (int j = 0; j < 16; ++j) dst[4 * j + t] = y[2 * j + r];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    trunk_train_bwd_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BW_BAR);
  uint64_t* empty = full + BW_STAGES;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    setmaxnreg_dec<BW_PRODUCER_REGS>();
    if (threadIdx.x == CT) {
      prefetch_tensormap(&p.wq);
      prefetch_tensormap(&p.wout);
      prefetch_tensormap(&p.w1);
      prefetch_tensormap(&p.w2);
      const int tiles = (p.total_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
      produce_bwd(p, smem + BW_RING, full, empty, tiles);
    }
  } else {
    setmaxnreg_inc<BW_CONSUMER_REGS>();
    consume_bwd(p, smem, BwdRing{smem + BW_RING, full, empty, 0});
  }
}

bool bad_walk(int B, int N, int depth, int grid, int tiles_per_row) {
  const long long total = (long long)B * tiles_per_row;
  return B < 1 || B > 65535 || N < 1 || depth < 1 || tiles_per_row < 1 ||
         (long long)tiles_per_row * TILE < N || total > 0x7fffffff || grid < 1 || grid > total;
}

}  // namespace

// ops: the 19 operand pointers in the order x, k, v, mask, pre_scale, pre_bias,
// post_scale, post_bias, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias,
// w1, b1, w2, b2. seed: one int32 on the device. acts: the (2 depth + 1, B, N,
// 128) bf16 buffer of saved activations, or null (nothing saved).
extern "C" int difffacto_trunk_train_fwd(const void* const* ops, const void* seed, void* out,
                                         void* acts, int B, int N, int depth, float scale,
                                         float keep_scale, unsigned int thresh, int drop,
                                         int grid, int tiles_per_row, void* stream) {
  if (bad_walk(B, N, depth, grid, tiles_per_row)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = (const bf16*)ops[0]; p.k = (const bf16*)ops[1]; p.v = (const bf16*)ops[2];
  p.mask = (const float*)ops[3];
  p.pre_scale = (const bf16*)ops[4]; p.pre_bias = (const bf16*)ops[5];
  p.post_scale = (const bf16*)ops[6]; p.post_bias = (const bf16*)ops[7];
  p.n2_scale = (const bf16*)ops[8]; p.n2_bias = (const bf16*)ops[9];
  p.bout = (const float*)ops[12]; p.ff_scale = (const bf16*)ops[13];
  p.ff_bias = (const bf16*)ops[14]; p.b1 = (const float*)ops[16]; p.b2 = (const float*)ops[18];
  p.out = (bf16*)out; p.acts = (bf16*)acts; p.seed = (const int*)seed;
  p.B = B; p.N = N; p.in_ch = 0; p.depth = depth; p.scale = scale;
  p.keep_scale = keep_scale; p.thresh = thresh; p.drop = drop;
  return (int)launch<Mode::TRAIN>(p, grid, tiles_per_row, ops[10], ops[11], ops[15], ops[17],
                                  (cudaStream_t)stream);
}

// grads: one zeroed f32 buffer holding, in this order, dk and dv (depth, B, 4,
// 128), dpre_s, dpre_b, dpost_s, dpost_b (128), dn2s, dn2b (depth, 128), dwq,
// dwout (depth, 128, 128), dbout, dffs, dffb (depth, 128), dw1 (depth, 128,
// 1024), db1 (depth, 1024), dw2 (depth, 512, 128), db2 (depth, 128). acts: the
// forward's saved activations. park: grid x difffacto_trunk_train_park_floats()
// f32 of scratch.
extern "C" int difffacto_trunk_train_bwd(const void* const* ops, const void* dy, const void* seed,
                                         const void* acts, void* dx, void* park, void* grads,
                                         int B, int N, int depth, float scale, float keep_scale,
                                         unsigned int thresh, int drop, int grid,
                                         int tiles_per_row, void* stream) {
  if (bad_walk(B, N, depth, grid, tiles_per_row)) return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  p.x = (const bf16*)ops[0]; p.k = (const bf16*)ops[1]; p.v = (const bf16*)ops[2];
  p.mask = (const float*)ops[3];
  p.pre_scale = (const bf16*)ops[4]; p.post_scale = (const bf16*)ops[6];
  p.n2_scale = (const bf16*)ops[8]; p.n2_bias = (const bf16*)ops[9];
  p.ff_scale = (const bf16*)ops[13]; p.ff_bias = (const bf16*)ops[14];
  p.b1 = (const float*)ops[16];
  p.dy = (const bf16*)dy; p.seed = (const int*)seed; p.acts = (const bf16*)acts;
  p.dx = (bf16*)dx; p.park = (float*)park;
  p.B = B; p.N = N; p.depth = depth; p.drop = drop;
  p.scale = scale; p.keep_scale = keep_scale; p.thresh = thresh;
  p.tiles_per_row = tiles_per_row;
  p.total_tiles = B * tiles_per_row;
  float* g = (float*)grads;
  const size_t kv = (size_t)depth * B * CTX * D, vec = (size_t)depth * D;
  p.dk = g; g += kv;
  p.dv = g; g += kv;
  p.dpre_s = g; g += D;
  p.dpre_b = g; g += D;
  p.dpost_s = g; g += D;
  p.dpost_b = g; g += D;
  p.dn2s = g; g += vec;
  p.dn2b = g; g += vec;
  p.dwq = g; g += vec * D;
  p.dwout = g; g += vec * D;
  p.dbout = g; g += vec;
  p.dffs = g; g += vec;
  p.dffb = g; g += vec;
  p.dw1 = g; g += vec * 2 * FF;
  p.db1 = g; g += (size_t)depth * 2 * FF;
  p.dw2 = g; g += (size_t)depth * FF * D;
  p.db2 = g;
  cudaError_t err = weight_map(&p.wq, ops[10], depth, D, D, D);
  if (err == cudaSuccess) err = weight_map(&p.wout, ops[11], depth, D, D, D);
  if (err == cudaSuccess) err = weight_map(&p.w1, ops[15], depth, D, 2 * FF, D);
  if (err == cudaSuccess) err = weight_map(&p.w2, ops[17], depth, FF, D, FC);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(trunk_train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BW_SMEM);
  if (err != cudaSuccess) return (int)err;
  trunk_train_bwd_kernel<<<grid, THREADS, BW_SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one thread block of the forward and of the backward.
extern "C" int difffacto_trunk_train_fwd_smem_bytes() { return SMEM_BYTES; }
extern "C" int difffacto_trunk_train_bwd_smem_bytes() { return BW_SMEM; }

// f32 entries of the backward's parked gradient, per thread block.
extern "C" int difffacto_trunk_train_park_floats() { return PARK_FLOATS; }
