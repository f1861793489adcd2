// The whole denoiser trunk of one diffusion step, as one kernel for sm_90a.
//
// Replaces the TPU kernel difffacto_tpu/ops/fused_core.py:_core_kernel (the
// Pallas program launched at difffacto_tpu/models/denoiser.py:270) in all
// four of its forms: the head fused and the tail not, as the JAX default runs
// it (difffacto_fused_core), the head-less trunk, and each of those with
// proj_out fused (the *_tail entries below). One more entry, which no
// TPU kernel has, runs the two-attention trunk (difffacto_fused_core_two_attn,
// below). For every token:
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

#include "trunk.cuh"

// The operands every trunk entry shares (all but x, proj_in and proj_out).
static Params trunk_params(const void* k, const void* v, const void* mask, const void* pre_scale,
                           const void* pre_bias, const void* post_scale, const void* post_bias,
                           const void* n2_scale, const void* n2_bias, const void* bout,
                           const void* ff_scale, const void* ff_bias, const void* b1,
                           const void* b2, void* out, int B, int N, int depth, float scale) {
  Params p = {};
  p.k = (const bf16*)k; p.v = (const bf16*)v; p.mask = (const float*)mask;
  p.pre_scale = (const bf16*)pre_scale; p.pre_bias = (const bf16*)pre_bias;
  p.post_scale = (const bf16*)post_scale; p.post_bias = (const bf16*)post_bias;
  p.n2_scale = (const bf16*)n2_scale; p.n2_bias = (const bf16*)n2_bias;
  p.bout = (const float*)bout; p.ff_scale = (const bf16*)ff_scale;
  p.ff_bias = (const bf16*)ff_bias; p.b1 = (const float*)b1; p.b2 = (const float*)b2;
  p.out = (bf16*)out;
  p.B = B; p.N = N; p.depth = depth; p.scale = scale;
  return p;
}

extern "C" int difffacto_fused_core(
    const void* x, const void* pin_w, const void* pin_b, const void* k, const void* v,
    const void* mask, const void* pre_scale, const void* pre_bias, const void* post_scale,
    const void* post_bias, const void* n2_scale, const void* n2_bias, const void* wq,
    const void* wout, const void* bout, const void* ff_scale, const void* ff_bias,
    const void* w1, const void* b1, const void* w2, const void* b2, void* out, int B, int N,
    int in_ch, int depth, float scale, int grid, int tiles_per_row, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || in_ch < 1 || in_ch > MAX_IN || depth < 1)
    return (int)cudaErrorInvalidValue;
  Params p = trunk_params(k, v, mask, pre_scale, pre_bias, post_scale, post_bias, n2_scale,
                          n2_bias, bout, ff_scale, ff_bias, b1, b2, out, B, N, depth, scale);
  p.x = (const bf16*)x; p.pin_w = (const bf16*)pin_w; p.pin_b = (const float*)pin_b;
  p.in_ch = in_ch;
  return (int)launch<Mode::TRUNK>(p, grid, tiles_per_row, wq, wout, w1, w2, (cudaStream_t)stream);
}

// The trunk with proj_out fused (the TPU kernel's has_tail=True form, which
// the JAX denoiser takes under DIFFFACTO_FUSE_TAIL=1, difffacto_tpu/models/
// denoiser.py:244-281): the operands of difffacto_fused_core, then pout_w
// (128, out_ch) bf16 and pout_b (out_ch,) f32; out (B, N, out_ch) bf16,
// out_ch 1 .. 8. After the post-LN each token's row goes through
// bf16(LN(h) W_out + b_out) with f32 sums; the tile's rows are gathered in
// shared memory and stored as one contiguous run. Its bound is the trunk's
// plus 128 out_ch MACs a token, with out_ch * 2 bytes a token out.
extern "C" int difffacto_fused_core_tail(
    const void* x, const void* pin_w, const void* pin_b, const void* k, const void* v,
    const void* mask, const void* pre_scale, const void* pre_bias, const void* post_scale,
    const void* post_bias, const void* n2_scale, const void* n2_bias, const void* wq,
    const void* wout, const void* bout, const void* ff_scale, const void* ff_bias,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* pout_w,
    const void* pout_b, void* out, int B, int N, int in_ch, int depth, int out_ch,
    float scale, int grid, int tiles_per_row, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || in_ch < 1 || in_ch > MAX_IN || depth < 1 || out_ch < 1 ||
      out_ch > MAX_OUT)
    return (int)cudaErrorInvalidValue;
  Params p = trunk_params(k, v, mask, pre_scale, pre_bias, post_scale, post_bias, n2_scale,
                          n2_bias, bout, ff_scale, ff_bias, b1, b2, out, B, N, depth, scale);
  p.x = (const bf16*)x; p.pin_w = (const bf16*)pin_w; p.pin_b = (const float*)pin_b;
  p.in_ch = in_ch;
  p.pout_w = (const bf16*)pout_w; p.pout_b = (const float*)pout_b; p.out_ch = out_ch;
  return (int)launch<Mode::TRUNK, true>(p, grid, tiles_per_row, wq, wout, w1, w2,
                                        (cudaStream_t)stream);
}

// The trunk without proj_in (Mode::HEADLESS): x, out (B, N, 128) bf16, x
// the hidden state h0 that the caller projected (and, with add_t_to_x,
// biased by the time embedding); the rest as difffacto_fused_core. It is the
// same TPU kernel's has_head=False form (difffacto_tpu/ops/fused_core.py:
// 118-160), which the JAX denoiser takes when it adds t to x
// (difffacto_tpu/models/denoiser.py:244-258). Its bound is the trunk's less
// proj_in's operations, with 256 bytes a token of x in.
extern "C" int difffacto_fused_core_headless(
    const void* x, const void* k, const void* v, const void* mask, const void* pre_scale,
    const void* pre_bias, const void* post_scale, const void* post_bias, const void* n2_scale,
    const void* n2_bias, const void* wq, const void* wout, const void* bout,
    const void* ff_scale, const void* ff_bias, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, int B, int N, int depth, float scale, int grid,
    int tiles_per_row, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || depth < 1) return (int)cudaErrorInvalidValue;
  Params p = trunk_params(k, v, mask, pre_scale, pre_bias, post_scale, post_bias, n2_scale,
                          n2_bias, bout, ff_scale, ff_bias, b1, b2, out, B, N, depth, scale);
  p.x = (const bf16*)x;
  return (int)launch<Mode::HEADLESS>(p, grid, tiles_per_row, wq, wout, w1, w2,
                                     (cudaStream_t)stream);
}

// The head-less trunk with proj_out fused (has_head=False, has_tail=True):
// the operands of difffacto_fused_core_headless, then pout_w and pout_b as
// difffacto_fused_core_tail takes them; out (B, N, out_ch) bf16. The JAX
// denoiser takes it under DIFFFACTO_FUSE_TAIL=1 with add_t_to_x or with
// DIFFFACTO_FUSE_HEAD=0.
extern "C" int difffacto_fused_core_headless_tail(
    const void* x, const void* k, const void* v, const void* mask, const void* pre_scale,
    const void* pre_bias, const void* post_scale, const void* post_bias, const void* n2_scale,
    const void* n2_bias, const void* wq, const void* wout, const void* bout,
    const void* ff_scale, const void* ff_bias, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* pout_w, const void* pout_b, void* out, int B, int N, int depth,
    int out_ch, float scale, int grid, int tiles_per_row, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || depth < 1 || out_ch < 1 || out_ch > MAX_OUT)
    return (int)cudaErrorInvalidValue;
  Params p = trunk_params(k, v, mask, pre_scale, pre_bias, post_scale, post_bias, n2_scale,
                          n2_bias, bout, ff_scale, ff_bias, b1, b2, out, B, N, depth, scale);
  p.x = (const bf16*)x;
  p.pout_w = (const bf16*)pout_w; p.pout_b = (const float*)pout_b; p.out_ch = out_ch;
  return (int)launch<Mode::HEADLESS, true>(p, grid, tiles_per_row, wq, wout, w1, w2,
                                           (cudaStream_t)stream);
}

// The two-attention trunk (single_attn=False, as DiffFacto's
// BasicTransformerBlock runs by default, nets/attention.py:152-195): the
// operands of difffacto_fused_core, then the first attention's k1, v1
// (depth, B, 4, 128) bf16, norm1's n1_scale, n1_bias (depth, 128) bf16, wq1,
// wout1 (depth, 128, 128) bf16 and bout1 (depth, 128) f32. Each block runs
//   a = LN1(h); h = h + bf16(attn(a Wq1; K1, V1) Wout1 + bout1)
// with attn1's arithmetic that of attn2 (above), before attn2 and the GEGLU;
// both attentions cross-attend to the 4 part tokens under the same mask.
// Bound: the trunk's plus 2 D^2 + 2 K D = 33,792 MACs a token a block
// (1,322,624 a token at depth 5: 0.70 ms at B=128, N=2048), with Wq1, Wout1,
// K1 and V1 read once: compute-bound. Its kernel is fused_core_two_attn_kernel.
extern "C" int difffacto_fused_core_two_attn(
    const void* x, const void* pin_w, const void* pin_b, const void* k, const void* v,
    const void* mask, const void* pre_scale, const void* pre_bias, const void* post_scale,
    const void* post_bias, const void* n2_scale, const void* n2_bias, const void* wq,
    const void* wout, const void* bout, const void* ff_scale, const void* ff_bias,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* k1,
    const void* v1, const void* n1_scale, const void* n1_bias, const void* wq1,
    const void* wout1, const void* bout1, void* out, int B, int N, int in_ch, int depth,
    float scale, int grid, int tiles_per_row, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || in_ch < 1 || in_ch > MAX_IN || depth < 1)
    return (int)cudaErrorInvalidValue;
  Params p = trunk_params(k, v, mask, pre_scale, pre_bias, post_scale, post_bias, n2_scale,
                          n2_bias, bout, ff_scale, ff_bias, b1, b2, out, B, N, depth, scale);
  p.x = (const bf16*)x; p.pin_w = (const bf16*)pin_w; p.pin_b = (const float*)pin_b;
  p.in_ch = in_ch;
  p.k1 = (const bf16*)k1; p.v1 = (const bf16*)v1;
  p.n1_scale = (const bf16*)n1_scale; p.n1_bias = (const bf16*)n1_bias;
  p.bout1 = (const float*)bout1;
  return (int)launch<Mode::TRUNK, false, true>(p, grid, tiles_per_row, wq, wout, w1, w2,
                                               (cudaStream_t)stream, wq1, wout1);
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
  return (int)launch<Mode::BLOCK>(p, grid, tiles_per_row, wq, wout, w1, w2, (cudaStream_t)stream);
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one thread block (of a tail entry with tail != 0), for reports.
extern "C" int difffacto_fused_core_smem_bytes(int tail) {
  return tail ? SMEM_BYTES_TAIL : SMEM_BYTES;
}
