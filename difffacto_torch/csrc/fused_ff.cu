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
// D = 256 (the aligner, T = 4 B, 5 launches a generation at batch 256, T =
// 1024), namespace `wide` below. The trunk template does not hold D = 256 in
// its registers, and at T = 1024 a persistent grid of 128-token tiles would
// use 8 of the 132 SMs, so the FF's hidden width is split across a thread
// block cluster instead (ops/fused_ff.py:wide_plan states the plan):
// - a cluster of 8 blocks takes 64 tokens, block r the GEGLU units
//   [128 r, 128 r + 128) (u and g), so T = 1024 is 16 clusters: 128 blocks;
// - every block loads its slice of W1 (256 x 256, 128 KB) and W2 (128 x 256,
//   64 KB) with TMA at its start, each part on its own mbarrier, and meanwhile
//   computes LN(x) of the tile (redundantly in each block, f32 statistics)
//   into shared memory as a K-major, 128-byte-swizzled wgmma operand;
// - two warpgroups each take 64 of the slice's units: [u | g] = LN(x) W1 with
//   wgmma (both operands from shared memory, 16 k-steps over the two halves
//   of K as they arrive), then bf16(u gelu_tanh(g)) in registers into shared
//   memory (over LN(x), which both are done with), then the block's f32
//   partial of the output, 128 columns a warpgroup, against its W2 rows;
// - the block's f32 partial (64 x 256) goes to shared memory band by band,
//   where its W1 slice was; block q owns the output band [32 q, 32 q + 32),
//   and one bulk copy (cp.async.bulk shared::cta -> shared::cluster) sends
//   each band to its owner, counted on the owner's mbarrier. A split cluster
//   barrier, arrived at after the W1 product and waited on after the W2
//   product, keeps the copies behind every block's last read of W1. Block q
//   sums the 8 partials of its band in rank order and writes
//   x + bf16(sum + b2).
// Shared memory: 32 KB (LN(x), then the activations) + 128 KB (W1's slice,
// then the partial and the bands received) + 64 KB (W2's slice).
// The bound at T = 1024 is 1.63 us of tensor-core operations; the kernel
// takes far longer, bound by latency and by the exchange of the partials
// (56 KB leave each block), not by its products. tools/fps_ff_ab_torch.py
// --probe times copies of this kernel cut after the weights and LN(x),
// after the products, or after the exchange.

#include "trunk.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wide {

constexpr int D = 256;               // the aligner's width (128 runs the trunk template)
constexpr int FF = 4 * D;            // GEGLU units
constexpr int TILE = 64;             // tokens a cluster
constexpr int CLUSTER = 8;           // blocks a tile
constexpr int SLICE = FF / CLUSTER;  // GEGLU units a block
constexpr int BAND = D / CLUSTER;    // output columns a block sums over the cluster
constexpr int THREADS = 256;         // two warpgroups, 64 of the slice's units each
constexpr int BOX = 128 * 128;       // bytes of a weight box: 128 rows x 64 columns
constexpr int A_BOX = TILE * 128;    // bytes of an operand box: 64 rows x 64 columns
constexpr int BAND_BYTES = TILE * BAND * 4;  // one band of a partial, f32

constexpr int OFF_A = 0;                   // LN(x), 4 boxes; then the activations, 2
constexpr int OFF_W1 = OFF_A + 4 * A_BOX;  // [K half][warpgroup][u | g]; then the partials
constexpr int OFF_W2 = OFF_W1 + 8 * BOX;   // [warpgroup][64-column box]
constexpr int OFF_BAR = OFF_W2 + 4 * BOX;  // W1's halves, W2, the partials received
constexpr int BYTES = OFF_BAR + 4 * 8 + 1024;  // room to align to 1024
static_assert(BYTES <= 232448, "over the 227 KB a block may use");
static_assert(2 * CLUSTER * BAND_BYTES <= 8 * BOX, "the partials fit where W1's slice was");

// Float pair p (of 16) of a band's row `row`, XOR-swizzled so that a warp's
// pair stores spread over the banks; pairs 2k and 2k + 1 stay side by side.
__device__ __forceinline__ int band_pair(int row, int p) { return p ^ ((row & 7) << 1); }
static_assert(SLICE == 2 * 64 && BAND * CLUSTER == D, "two warpgroups of 64 units");

struct Args {
  CUtensorMap w1, w2;  // (256, 2048) and (1024, 256), boxes of 128 rows x 64 columns
  const bf16* x; const bf16* ln_scale; const bf16* ln_bias;
  const float* b1; const float* b2;
  bf16* out;
  long long T;
};

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
ff_wide_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp & 3) * 16 + g;  // the thread's fragment rows: row0, row0 + 8
  const int rank = (int)cluster_rank();
  const long long t0 = (long long)(blockIdx.x / CLUSTER) * TILE;

  // ---- the slice's weights, by TMA, behind the LayerNorm
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bar[3], (CLUSTER - 1) * BAND_BYTES);
    prefetch_tensormap(&a.w1);
    prefetch_tensormap(&a.w2);
    for (int h = 0; h < 2; ++h) {
      mbar_expect_tx(&bar[h], 4 * BOX);
      for (int w = 0; w < 2; ++w) {
        unsigned char* dst = smem + OFF_W1 + (2 * h + w) * 2 * BOX;
        const int u0 = rank * SLICE + 64 * w;
        tma_load_3d(dst, &a.w1, &bar[h], u0, 128 * h, 0);            // u columns
        tma_load_3d(dst + BOX, &a.w1, &bar[h], FF + u0, 128 * h, 0);  // g columns
      }
    }
    mbar_expect_tx(&bar[2], 4 * BOX);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < 2; ++c)
        tma_load_3d(smem + OFF_W2 + (2 * w + c) * BOX, &a.w2, &bar[2], 128 * w + 64 * c,
                    rank * SLICE, 0);
  }

  // ---- LN(x): a warp a row, a lane 8 columns (one 16-byte swizzle chunk); 0 past T
  {
    float sc[8], bi[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 s2 = ldg_bf16x2(a.ln_scale + 8 * lane + 2 * k);
      const float2 b2 = ldg_bf16x2(a.ln_bias + 8 * lane + 2 * k);
      sc[2 * k] = s2.x; sc[2 * k + 1] = s2.y;
      bi[2 * k] = b2.x; bi[2 * k + 1] = b2.y;
    }
    constexpr int ROWS = TILE / (THREADS / 32);  // rows a warp
    uint4 raw[ROWS];  // all of the warp's rows in flight at once
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = warp + k * (THREADS / 32);
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < a.T) raw[k] = __ldg(reinterpret_cast<const uint4*>(a.x + (t0 + r) * D) + lane);
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = warp + k * (THREADS / 32);
      const uint32_t w4[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
      float v[8], sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16(w4[i]);
        v[2 * i] = f.x; v[2 * i + 1] = f.y;
        sum += f.x + f.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum * (1.0f / D);
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sq += (v[i] - mu) * (v[i] - mu);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float inv = rsqrtf(sq * (1.0f / D) + 1e-5f);
      uint4 y;
      y.x = pack_bf16((v[0] - mu) * inv * sc[0] + bi[0], (v[1] - mu) * inv * sc[1] + bi[1]);
      y.y = pack_bf16((v[2] - mu) * inv * sc[2] + bi[2], (v[3] - mu) * inv * sc[3] + bi[3]);
      y.z = pack_bf16((v[4] - mu) * inv * sc[4] + bi[4], (v[5] - mu) * inv * sc[5] + bi[5]);
      y.w = pack_bf16((v[6] - mu) * inv * sc[6] + bi[6], (v[7] - mu) * inv * sc[7] + bi[7]);
      *reinterpret_cast<uint4*>(smem + OFF_A + (lane >> 3) * A_BOX + r * 128 +
                                (((lane & 7) ^ (r & 7)) << 4)) = y;
    }
  }
  fence_proxy_async();
  __syncthreads();  // also publishes the initialised mbarriers

  // The residual and b2 of the thread's 8 output columns of its band, for the end.
  const int out_row = tid >> 2, out_col = rank * BAND + (tid & 3) * 8;
  uint4 x_res = make_uint4(0u, 0u, 0u, 0u);
  if (t0 + out_row < a.T) x_res = __ldg(reinterpret_cast<const uint4*>(a.x + (t0 + out_row) * D + out_col));
  const float4 b2_lo = __ldg(reinterpret_cast<const float4*>(a.b2 + out_col));
  const float4 b2_hi = __ldg(reinterpret_cast<const float4*>(a.b2 + out_col + 4));

  // ---- [u | g] of the warpgroup's 64 units: 16 k-steps, each K half as it lands
  const uint32_t a_base = smem_addr(smem + OFF_A);
  float acc[64];
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mbar_wait(&bar[h], 0);
    const uint32_t b = smem_addr(smem + OFF_W1 + (2 * h + wg) * 2 * BOX);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int k = 8 * h + kk;
      wgmma_m64n128k16_ss<0, 1>(acc, desc_k_sw128(a_base + (k >> 2) * A_BOX + 32 * (k & 3)),
                                desc_mn_sw128(b + 2048u * kk, BOX, 1024u), k > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();  // both warpgroups are done with LN(x)
  cluster_arrive();  // ... and with W1's slice, where the cluster's partials will land

  // ---- act = bf16(u gelu_tanh(g)) over LN(x): the warpgroup's units are box wg
  {
    const float* b1 = a.b1 + rank * SLICE + 64 * wg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bu = __ldg(reinterpret_cast<const float2*>(b1 + 8 * j + 2 * t));
      const float2 bg = __ldg(reinterpret_cast<const float2*>(b1 + FF + 8 * j + 2 * t));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float u0 = acc[4 * j + 2 * r] + bu.x, u1 = acc[4 * j + 2 * r + 1] + bu.y;
        const float g0 = acc[4 * (j + 8) + 2 * r] + bg.x, g1 = acc[4 * (j + 8) + 2 * r + 1] + bg.y;
        *reinterpret_cast<uint32_t*>(smem + OFF_A + wg * A_BOX + row * 128 +
                                     ((j ^ (row & 7)) << 4) + 4 * t) =
            pack_bf16(u0 * gelu_tanh(g0), u1 * gelu_tanh(g1));
      }
    }
  }
  fence_proxy_async();
  __syncthreads();

  // ---- the block's partial: act (64 x 128) x W2's slice rows, 128 columns a warpgroup
  mbar_wait(&bar[2], 0);
  {
    const uint32_t b = smem_addr(smem + OFF_W2 + wg * 2 * BOX);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n128k16_ss<0, 1>(acc, desc_k_sw128(a_base + (kk >> 2) * A_BOX + 32 * (kk & 3)),
                                desc_mn_sw128(b + 2048u * kk, BOX, 1024u), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  // The partial, band by band ([band][row][32 f32], pairs swizzled), where
  // W1's slice was; band q goes to block q's slot `rank` behind it.
  float* part = reinterpret_cast<float*>(smem + OFF_W1);
  float* recv = part + CLUSTER * TILE * BAND;  // [sender][row][32]
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, band = 4 * wg + (j >> 2);
      *reinterpret_cast<float2*>(part + (band * TILE + row) * BAND +
                                 2 * band_pair(row, 4 * (j & 3) + t)) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  fence_proxy_async();
  __syncthreads();
  cluster_wait();  // every block of the cluster is done with its W1 slice
  if (tid < CLUSTER && tid != rank)
    bulk_copy_to_cluster(cluster_map(recv + rank * TILE * BAND, tid), part + tid * TILE * BAND,
                         BAND_BYTES, cluster_map(&bar[3], tid));

  // ---- block r: x + bf16(sum of the 8 partials + b2) on columns [32 r, 32 r + 32)
  mbar_wait_cluster(&bar[3], 0);
  cluster_arrive();  // every band this block is owed has landed
  {
    const int c = (tid & 3) * 8;
    float sum[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sum[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {  // in rank order
      const float* src = (q == rank ? part + rank * TILE * BAND : recv + q * TILE * BAND) +
                         out_row * BAND;
      const float4 v0 = *reinterpret_cast<const float4*>(src + 2 * band_pair(out_row, c / 2));
      const float4 v1 = *reinterpret_cast<const float4*>(src + 2 * band_pair(out_row, c / 2 + 2));
      sum[0] += v0.x; sum[1] += v0.y; sum[2] += v0.z; sum[3] += v0.w;
      sum[4] += v1.x; sum[5] += v1.y; sum[6] += v1.z; sum[7] += v1.w;
    }
    const float b[8] = {b2_lo.x, b2_lo.y, b2_lo.z, b2_lo.w, b2_hi.x, b2_hi.y, b2_hi.z, b2_hi.w};
    const uint32_t w4[4] = {x_res.x, x_res.y, x_res.z, x_res.w};
    uint32_t y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 xv = unpack_bf16(w4[k]);
      y[k] = pack_bf16(xv.x + round_bf16(sum[2 * k] + b[2 * k]),
                       xv.y + round_bf16(sum[2 * k + 1] + b[2 * k + 1]));
    }
    if (t0 + out_row < a.T)
      *reinterpret_cast<uint4*>(a.out + (t0 + out_row) * D + out_col) =
          make_uint4(y[0], y[1], y[2], y[3]);
  }
  cluster_wait();  // no block leaves while its bands may still be read from it
}

// The plan of ops/fused_ff.py:wide_plan: `tiles` clusters of CLUSTER blocks.
int launch(Args& a, const void* w1, const void* w2, int grid, int tiles, cudaStream_t stream) {
  if (tiles < 1 || (long long)tiles * TILE < a.T || (long long)(tiles - 1) * TILE >= a.T ||
      (long long)grid != (long long)tiles * CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = weight_map(&a.w1, w1, 1, D, 2 * FF, 128);
  if (err == cudaSuccess) err = weight_map(&a.w2, w2, 1, FF, D, 128);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ff_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  ff_wide_kernel<<<grid, THREADS, BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace

// x, out (T, D) bf16; ln_scale, ln_bias (D,) bf16; w1 (D, 8 D), w2 (4 D, D)
// bf16; b1 (8 D,), b2 (D,) f32. D = 128 walks `grid` blocks over
// `tiles_per_row` tiles of 128 tokens (the wrapper's schedule); D = 256 runs
// `tiles_per_row` clusters of 64 tokens, `grid` = 8 tiles_per_row blocks
// (ops/fused_ff.py:wide_plan). Returns a cudaError_t.
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
  wide::Args a = {};
  a.x = (const bf16*)x; a.ln_scale = (const bf16*)ln_scale; a.ln_bias = (const bf16*)ln_bias;
  a.b1 = (const float*)b1; a.b2 = (const float*)b2; a.out = (bf16*)out; a.T = T;
  return wide::launch(a, w1, w2, grid, tiles_per_row, s);
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one thread block at width D, for reports.
extern "C" int difffacto_fused_ff_smem_bytes(int D) {
  return D == 128 ? SMEM_BYTES : D == 256 ? wide::BYTES : 0;
}
