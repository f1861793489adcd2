// Eval-grade EMD assignment for Hopper (sm_90a): Sinkhorn warm start, then a
// dense auction, one persistent thread block per pair of clouds.
//
// Replaces the TPU kernel difffacto_tpu/ops/emd_pallas.py:_emd_hybrid_kernel
// and computes what it computes:
//   1. annealed log-domain Sinkhorn over the (m, n) L2 distance matrix (m = n
//      unless the caller subsamples rows): per iteration f_i = -eps *
//      logsumexp_j((g_j - d_ij) / eps), then g_j likewise over the rows; the
//      caller passes eps for each iteration;
//   2. an auction from price = -g: every unassigned row bids best - better +
//      eps on its best object (value -d - price, the lowest index among equal
//      values), each object takes the largest bid (the lowest row among equal
//      bids), evicts its owner and raises its price; it stops when no row is
//      unassigned or after auction_iters rounds;
//   3. rows still unassigned take their best object at the final prices.
// Only the assignment comes out (and, for the bound, the rounds run, the bids
// computed and the Sinkhorn's clock cycles); matched distances are computed
// outside in f32 (ops/emd.py).
//
// What is not carried over from the TPU: its 8 MB bf16 distance cache (an SM
// has 227 KB), its 128-lane tiles and per-tile fori_loops, the padded K = 8
// matrix product and the tile-skip counters. Distances are recomputed in f32
// from coordinates held on chip, as in the TPU kernel's own cache_dist=False
// branch, and rows that are assigned simply do not bid.
//
// What bounds it on an H100: the Sinkhorn's 2 * iterations * m * n elements a
// pair (1.26e9 at n = 2048); the bids add n elements each (one square root);
// the bytes (24 n read, 4 n written) are negligible. With both its exp2 and its
// square root on the special-function units (MUFU: 16 lanes an SM against
// 128 FMA lanes, so a warp's MUFU instruction holds its sub-partition's unit 8
// clocks, where the dispatch takes one instruction a clock), an element costs
// 16 MUFU clocks a warp against 11.6 dispatch slots (185 instructions for 16
// elements in the SASS of the inner loop): the MUFU sets the pace and the FMA
// pipes idle. So a fixed share of the exp2s runs on the FMA pipes instead:
//
// - Base-2 log domain. The potentials are held scaled by c = log2(e) / eps in
//   the .w of each point's float4 (rescaled when eps steps), so an element is
//   z = fma(-c, d, w_other) + w_self and the term 2^z is one ex2.approx.
// - The soft exp2 (exp2_soft): 2^z at least as accurately as ex2.approx in
//   12 FMA-pipe instructions, 11 dispatch slots more than ex2.approx. A sweep
//   step takes ROWS x KSTEP = 16 terms; SOFT_TERMS of them go to
//   exp2_soft. With s the soft share, 16 - 8 s MUFU clocks against
//   11.6 + 11 s dispatch slots a warp-element: they meet near s = 1/4, but one
//   row slot in four (s = 1/4) ran at 80% of that bound with both pipes full;
//   s = 3/16 keeps the MUFU the bound (14.5 clocks against 13.6 slots) with
//   a slot to spare and ran faster, in both instantiations (PERF.md §6 row 5).
// - d = sqrt.approx(dx^2 + dy^2 + dz^2): one MUFU for every element. A square
//   root in software to 2^-22 costs about 15 instructions.
// - No running max. A point's sum is shifted by its own potential from the
//   previous sweep (w_self above): with f_i + g_j - d_ij <= about 0 at every
//   sweep of the annealed Sinkhorn the terms stay near 1 or below. A sum
//   outside [2^-64, 2^64], or not finite, puts the point on a list that the
//   warps then redo with the exact max (two passes, lanes over the other
//   axis, shuffle reductions); new w = w_self - log2(sum), with the accurate
//   log2f (once a point a sweep).
// - Each thread sweeps four points against every point of the other axis: one
//   shared-memory broadcast (16 bytes) feeds four independent accumulators
//   (n / 4 threads up to 1024, so 512 at n = 2048). Two points a thread, or
//   eight with 128 registers, ran slower.
//
// What the approximations cost: sqrt.approx and ex2.approx (flush-to-zero)
// are within about 2 ulp of the exact results (PTX ISA: relative error 2^-22
// and 2^-22.5 for ex2 of an argument in range), exp2_soft within 2^-23.6; a
// term below 2^-126 flushes to 0, in both exp2s, which inside the band is
// below 2^-51 of the sum. In the potentials that
// is a few f32 ulp a sweep, far below eps; the plain version
// (ops/emd_hybrid.py) computes exact square roots and exps with a max shift,
// so near-ties may go to other objects: the matched costs agree within 0.5 %.
// ops/emd_hybrid.py:sinkhorn_log2_reference models this sweep (shift, band,
// redo, the soft terms) on the CPU, and exp2_soft_reference the soft exp2.
//
// The auction's bids are a warp's job each: the unassigned rows of each
// 32-row chunk (a ballot over the assignment), chunks striped over the
// warps; lanes scan objects lane, lane + 32, ... and a shuffle reduction of
// (best, second, lowest index) gives the serial scan's result exactly
// (ops/emd_hybrid.py:best_two_strided models it). The per-object winner is one
// 64-bit atomicMax on (bits of the bid, ~row): bids are positive, so their
// bits order as unsigned integers, and ~row makes the lowest row win a tie;
// the result does not depend on the order of the atomics. The
// force-assignment sweep runs the same routine.
//
// Layout: per pair, p1[i] = (x1_i, w_i) and p2[j] = (x2_j, w_j or price_j) as
// float4; then the 64-bit per-object winner key, the assignment (the redo
// list during the Sinkhorn) and the owner: 48 bytes a point. Up to n = 4736
// this is dynamic shared memory; beyond (n = 8192) the same state lies in a
// global-memory workspace that the wrapper passes, and L1/L2 serve the sweeps.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int SMEM_LIMIT = 232448;   // what one Hopper thread block may use
constexpr int STATE_BYTES = 48;      // per point: 2 float4, u64, 2 int
constexpr int ROWS = 4;              // points a thread sweeps at once
constexpr int KSTEP = 4;             // points of the other axis a step of the sweep takes
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SUM_LO = 0x1p-64f, SUM_HI = 0x1p64f;  // the shifted sum's band
constexpr unsigned FULL = 0xffffffffu;

// Terms of each ROWS x KSTEP block of a sweep step on the soft exp2, in both
// instantiations: the global-workspace one (n > 4736), whose sweeps L1 and L2
// serve, gained from it too.
constexpr int SOFT_TERMS = 3;

// 2^f = 1 + f (C1 + f (C2 + ... + f C6)) on [-1/2, 1/2]: minimax for the
// relative error with the constant term 1, the coefficients rounded to f32;
// 2^-28.9 exact, 2^-23.6 with the f32 roundings. Degree 5 (2^-22.58) keeps
// ex2.approx's 2^-22 too; the sixth FFMA leaves the sums nearer the exact
// ones the plain version takes (PERF.md §6 row 5).
constexpr float EXP2_C1 = 0x1.62e430p-1f, EXP2_C2 = 0x1.ebfbdcp-3f, EXP2_C3 = 0x1.c6aee8p-5f,
                EXP2_C4 = 0x1.3b2d4cp-7f, EXP2_C5 = 0x1.5f3e52p-10f, EXP2_C6 = 0x1.41fbbcp-13f;
constexpr float EXP2_SHIFT = 0x1.8p23f + 127.0f;  // t = z + this holds rint(z) + 127 in its low bits

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^z on the FMA pipes, as ex2.approx.ftz gives it: relative error under
// 2^-23.5, and 0 where the result is below 2^-126. z = j + f with j = rint(z)
// from the magic-number add and f in [-1/2, 1/2] exact; 2^j is built in the
// exponent field from t's low bits (0 at j = -127, where z is clamped) and the
// product flushes a subnormal to 0. Valid for z < 128.5; the sweep's z stay
// below about 0 (sweep_shifted).
__device__ __forceinline__ float exp2_soft(float z) {
  z = fmaxf(z, -127.0f);
  const float t = __fadd_rn(z, EXP2_SHIFT);
  const float f = __fsub_rn(z, __fsub_rn(t, EXP2_SHIFT));
  float p = fmaf(EXP2_C6, f, EXP2_C5);
  p = fmaf(p, f, EXP2_C4);
  p = fmaf(p, f, EXP2_C3);
  p = fmaf(p, f, EXP2_C2);
  p = fmaf(p, f, EXP2_C1);
  p = fmaf(p, f, 1.0f);
  const float scale = __uint_as_float(__float_as_uint(t) << 23);
  float y;
  asm("mul.ftz.f32 %0, %1, %2;" : "=f"(y) : "f"(p), "f"(scale));
  return y;
}

__device__ __forceinline__ float dist(const float4& a, const float4& b) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  return sqrt_approx(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
}

// One half of a Sinkhorn iteration: every point of `self` (count of them)
// against every point of `other`. With w the scaled potentials,
// S = sum_k 2^(fma(-c, d, other[k].w) + self.w) and self.w -= log2(S); a sum
// outside the band goes on the redo list instead. Each exponent is at most
// about 0: self.w and other[k].w were each set by a log-sum-exp that holds
// the other's term, and a rescale multiplies both by the same ratio. A step
// takes KSTEP other points (others % KSTEP == 0); of its ROWS x KSTEP terms,
// term (r, u) takes exp2_soft where (ROWS - 1 - r) KSTEP + u < SOFT_TERMS.
__device__ __forceinline__ void sweep_shifted(float4* self, int count, const float4* other,
                                              int others, float c, int* redo, int* redo_count) {
  const int tid = threadIdx.x, T = blockDim.x;
  for (int base = 0; base < count; base += ROWS * T) {
    float4 p[ROWS];
    float S[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      p[r] = self[min(base + r * T + tid, count - 1)];
      S[r] = 0.0f;
    }
    for (int k = 0; k < others; k += KSTEP) {
#pragma unroll
      for (int u = 0; u < KSTEP; ++u) {
        const float4 q = other[k + u];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float z = fmaf(-c, dist(p[r], q), q.w) + p[r].w;
          S[r] += (ROWS - 1 - r) * KSTEP + u < SOFT_TERMS ? exp2_soft(z) : exp2_approx(z);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = base + r * T + tid;
      if (i >= count) continue;
      if (S[r] >= SUM_LO && S[r] <= SUM_HI) self[i].w = p[r].w - log2f(S[r]);
      else redo[atomicAdd(redo_count, 1)] = i;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The points on the redo list, a warp each, with the exact max:
// M = max_k z_k, S = sum_k 2^(z_k - M) >= 1, self.w = -(M + log2(S)).
__device__ __forceinline__ void sweep_redo(float4* self, const float4* other, int others, float c,
                                           const int* redo, int n_redo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  for (int e = warp; e < n_redo; e += W) {
    const int i = redo[e];
    const float4 p = self[i];
    float M = NEG;
    for (int k = lane; k < others; k += 32) {
      const float4 q = other[k];
      M = fmaxf(M, fmaf(-c, dist(p, q), q.w));
    }
    M = warp_max(M);
    float S = 0.0f;
    for (int k = lane; k < others; k += 32) {
      const float4 q = other[k];
      S += exp2_approx(fmaf(-c, dist(p, q), q.w) - M);
    }
    S = warp_sum(S);
    if (lane == 0) self[i].w = -(M + log2f(S));
  }
}

// A whole half-iteration: the shifted sweep, then the redo list. `count` is
// this half's list counter, `other_count` the other half's, which no thread
// reads again before the next half (two barriers on).
__device__ __forceinline__ void sinkhorn_half(float4* self, int count, const float4* other,
                                              int others, float c, int* redo, int* redo_count,
                                              int* other_count) {
  if (threadIdx.x == 0) *other_count = 0;
  sweep_shifted(self, count, other, others, c, redo, redo_count);
  __syncthreads();
  const int n_redo = *redo_count;
  if (n_redo > 0) sweep_redo(self, other, others, c, redo, n_redo);
  __syncthreads();
}

// A row's best object at the current prices, a warp's job: the largest
// -d - price (lowest index among equals) and the largest value among the
// other objects. Lanes scan objects lane, lane + 32, ... as the serial scan
// does, then a butterfly merges (best, second, index); every lane ends with
// the result, which equals the serial scan's over all n objects.
__device__ __forceinline__ void best_two(const float4 self, const float4* p2, int n,
                                         float& best, float& second, int& bj) {
  const int lane = threadIdx.x & 31;
  best = NEG; second = NEG; bj = INT_MAX;
  for (int j = lane; j < n; j += 32) {
    const float4 q = p2[j];
    const float v = -dist(self, q) - q.w;
    if (v > best) { second = best; best = v; bj = j; }
    else if (v > second) { second = v; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o), os = __shfl_xor_sync(FULL, second, o);
    const int oj = __shfl_xor_sync(FULL, bj, o);
    if (ob > best || (ob == best && oj < bj)) {
      second = fmaxf(os, best);
      best = ob;
      bj = oj;
    } else {
      second = fmaxf(second, ob);
    }
  }
  if (bj == INT_MAX) bj = 0;  // no value above NEG: the serial scan keeps 0
}

template <bool SMEM>
__global__ void __launch_bounds__(1024, 1)
emd_hybrid_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  const float* __restrict__ eps_table, int* __restrict__ out,
                  int* __restrict__ rounds_out, int* __restrict__ bids_out,
                  long long* __restrict__ cycles_out, unsigned char* workspace,
                  int n, int m, int sinkhorn_iters, int auction_iters, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int unassigned;
  __shared__ int redo_count[2];

  unsigned char* base = SMEM ? smem_raw
                             : workspace + (size_t)blockIdx.x * n * STATE_BYTES;
  float4* p1 = reinterpret_cast<float4*>(base);
  float4* p2 = p1 + n;
  unsigned long long* win = reinterpret_cast<unsigned long long*>(p2 + n);
  int* assign = reinterpret_cast<int*>(win + n);
  int* owner = assign + n;

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const float* a = x1 + (size_t)blockIdx.x * n * 3;
  const float* b = x2 + (size_t)blockIdx.x * n * 3;
  for (int i = tid; i < n; i += T) {
    p1[i] = make_float4(a[3 * i], a[3 * i + 1], a[3 * i + 2], 0.0f);  // f = 0
    p2[i] = make_float4(b[3 * i], b[3 * i + 1], b[3 * i + 2], 0.0f);  // g = 0
    win[i] = 0ull;
  }
  if (tid == 0) {
    unassigned = n;
    redo_count[0] = redo_count[1] = 0;
  }
  __syncthreads();

  // ---- phase 1: Sinkhorn. Rows 0..m-1 carry c f, every column c g; the
  // redo list lies in `assign` until the auction.
  const long long start = clock64();
  float c = sinkhorn_iters > 0 ? LOG2E / eps_table[0] : 1.0f;
  for (int k = 0; k < sinkhorn_iters; ++k) {
    const float ck = LOG2E / eps_table[k];
    if (ck != c) {  // eps stepped: both potentials to the new scale
      const float ratio = ck / c;
      for (int i = tid; i < m; i += T) p1[i].w *= ratio;
      for (int j = tid; j < n; j += T) p2[j].w *= ratio;
      c = ck;
      __syncthreads();
    }
    sinkhorn_half(p1, m, p2, n, c, assign, &redo_count[0], &redo_count[1]);
    sinkhorn_half(p2, n, p1, m, c, assign, &redo_count[1], &redo_count[0]);
  }
  if (tid == 0 && cycles_out != nullptr) cycles_out[blockIdx.x] = clock64() - start;

  // ---- phase 2: auction from price = -g = -w / c.
  for (int j = tid; j < n; j += T) {
    p2[j].w = -p2[j].w / c;
    assign[j] = -1;
    owner[j] = -1;
  }
  __syncthreads();

  int rounds = 0, bids = 0;  // the same in every thread
  while (rounds < auction_iters) {
    bids += unassigned;  // written next after the barrier below
    for (int r0 = warp * 32; r0 < n; r0 += W * 32) {
      unsigned todo = __ballot_sync(FULL, assign[r0 + lane] < 0);
      while (todo) {
        const int i = r0 + __ffs(todo) - 1;
        todo &= todo - 1;
        float best, second;
        int bj;
        best_two(p1[i], p2, n, best, second, bj);
        if (lane == 0) {
          const float inc = best - second + eps;  // > 0
          atomicMax(&win[bj], ((unsigned long long)__float_as_uint(inc) << 32) |
                                  (unsigned)(~(unsigned)i));
        }
      }
    }
    __syncthreads();
    // Each taken object: raise the price, evict the owner, seat the winner.
    // An evicted row did not bid and a winner wins one object, so the writes
    // to assign never meet.
    for (int j = tid; j < n; j += T) {
      const unsigned long long key = win[j];
      if (key == 0ull) continue;
      win[j] = 0ull;
      const int row = (int)(~(unsigned)(key & 0xffffffffull));
      p2[j].w += __uint_as_float((unsigned)(key >> 32));
      const int prev = owner[j];
      if (prev >= 0) assign[prev] = -1;
      else atomicSub(&unassigned, 1);
      assign[row] = j;
      owner[j] = row;
    }
    ++rounds;
    __syncthreads();
    if (unassigned == 0) break;
  }

  // ---- phase 3: stragglers take their best object at the final prices.
  bids += unassigned;
  int* o = out + (size_t)blockIdx.x * n;
  for (int r0 = warp * 32; r0 < n; r0 += W * 32) {
    const int j = assign[r0 + lane];
    if (j >= 0) o[r0 + lane] = j;
    unsigned todo = __ballot_sync(FULL, j < 0);
    while (todo) {
      const int i = r0 + __ffs(todo) - 1;
      todo &= todo - 1;
      float best, second;
      int bj;
      best_two(p1[i], p2, n, best, second, bj);
      if (lane == 0) o[i] = bj;
    }
  }
  if (tid == 0 && rounds_out != nullptr) rounds_out[blockIdx.x] = rounds;
  if (tid == 0 && bids_out != nullptr) bids_out[blockIdx.x] = bids;
}

// The sweep's two exp2s over count values of z, for the tests: exp2_soft
// where soft, else ex2.approx.ftz.
__global__ void exp2_probe_kernel(const float* __restrict__ z, float* __restrict__ out, int count,
                                  bool soft) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = soft ? exp2_soft(z[i]) : exp2_approx(z[i]);
}

}  // namespace

// Bytes of global workspace one pair needs, 0 where the state fits in shared memory.
extern "C" long long difffacto_emd_hybrid_workspace_bytes(int n) {
  const long long bytes = (long long)n * STATE_BYTES;
  return bytes <= SMEM_LIMIT ? 0 : bytes;
}

// The terms of each ROWS x KSTEP block of a sweep step that take the soft exp2.
extern "C" int difffacto_emd_hybrid_soft_terms() { return SOFT_TERMS; }

// z, out (count,) f32 on the card. Returns a cudaError_t.
extern "C" int difffacto_emd_exp2_probe(const void* z, void* out, int count, int soft,
                                        void* stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  exp2_probe_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)z, (float*)out, count, soft != 0);
  return (int)cudaGetLastError();
}

// x1, x2 (B, n, 3) f32 contiguous; eps_table (sinkhorn_iters,) f32; out (B, n)
// int32; rounds, bids (B,) int32 or null; cycles (B,) int64 or null, the clock
// cycles of each pair's Sinkhorn; workspace B * workspace_bytes(n) bytes,
// 16-byte aligned, or null where that is 0. n % 128 == 0 and 0 < m <= n.
// Returns a cudaError_t.
extern "C" int difffacto_emd_hybrid(const void* x1, const void* x2, const void* eps_table,
                                    void* out, void* rounds, void* bids, void* cycles,
                                    void* workspace, int B, int n, int m, int sinkhorn_iters,
                                    int auction_iters, float eps, void* stream) {
  if (B <= 0 || n <= 0 || n % (32 * ROWS) || m <= 0 || m > n) return (int)cudaErrorInvalidValue;
  // ROWS points a thread, whole warps: n / ROWS threads up to 1024.
  const int threads = n / ROWS >= 1024 ? 1024 : n / ROWS;
  const size_t bytes = (size_t)n * STATE_BYTES;
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes <= (size_t)SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(
        emd_hybrid_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    emd_hybrid_kernel<true><<<B, threads, bytes, s>>>(
        (const float*)x1, (const float*)x2, (const float*)eps_table, (int*)out, (int*)rounds,
        (int*)bids, (long long*)cycles, nullptr, n, m, sinkhorn_iters, auction_iters, eps);
  } else {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    emd_hybrid_kernel<false><<<B, threads, 0, s>>>(
        (const float*)x1, (const float*)x2, (const float*)eps_table, (int*)out, (int*)rounds,
        (int*)bids, (long long*)cycles, (unsigned char*)workspace, n, m, sinkhorn_iters,
        auction_iters, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
