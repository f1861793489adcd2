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
// Only the assignment comes out (and, for the bound, the rounds run and the
// bids computed); matched distances are computed outside in f32 (ops/emd.py).
//
// What is not carried over from the TPU: its 8 MB bf16 distance cache, its
// 128-lane tiles and per-tile fori_loops, the padded K = 8 matrix product and
// the tile-skip counters. Distances are recomputed in f32 from coordinates
// held on chip, as in the TPU kernel's own cache_dist=False branch, and rows
// that are assigned simply do not bid.
//
// Layout: per pair, p1[i] = (x1_i, f_i) and p2[j] = (x2_j, g_j or price_j) as
// float4, so a sweep reads one 16-byte broadcast word per element; then the
// 64-bit per-object winner key, the assignment and the owner: 48 bytes a
// point. Up to n = 4736 this is dynamic shared memory; beyond (n = 8192) the
// same state lies in a global-memory workspace that the wrapper passes, and
// L1/L2 serve the sweeps.
//
// A sweep gives each thread a row (or a column) and an online log-sum-exp
// over the other axis in chunks of four. The per-object winner is one 64-bit
// atomicMax on (bits of the bid, ~row): bids are positive, so their bits
// order as unsigned integers, and ~row makes the lowest row win a tie; the
// result does not depend on the order of the atomics.
//
// Bound: 2 * sinkhorn_iters * m * n Sinkhorn elements a pair and n elements
// for every bid (only unassigned rows bid, so the kernel counts them: the
// unassigned rows of each round plus the rows force-assigned at the end), each
// element about 10 f32 operations and a square root, and in the Sinkhorn
// sweeps one exp; the bytes (24 n read, 4 n written) are negligible. expf and
// logf are the accurate ones, not the fast intrinsics.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int SMEM_LIMIT = 232448;   // what one Hopper thread block may use
constexpr int STATE_BYTES = 48;      // per point: 2 float4, u64, 2 int
constexpr float NEG = -1e30f;

__device__ __forceinline__ float dist(const float4& a, const float4& b) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  return sqrtf(dx * dx + dy * dy + dz * dz);
}

// -eps * log(sum_k exp((other[k].w - d(self, other[k])) / eps)); count % 4 == 0.
__device__ __forceinline__ float soft_min(const float4 self, const float4* other, int count,
                                          float eps, float inv_eps) {
  float M = NEG, S = 0.0f;
  for (int k = 0; k < count; k += 4) {
    float z[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 q = other[k + u];
      z[u] = (q.w - dist(self, q)) * inv_eps;
    }
    const float cm = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
    if (cm > M) { S *= expf(M - cm); M = cm; }
    S += (expf(z[0] - M) + expf(z[1] - M)) + (expf(z[2] - M) + expf(z[3] - M));
  }
  return -eps * (logf(fmaxf(S, 1e-30f)) + M);
}

// A row's best object at the current prices: the largest -d - price (lowest
// index among equals) and the largest value among the other objects.
__device__ __forceinline__ void best_two(const float4 self, const float4* p2, int n,
                                         float& best, float& second, int& bj) {
  best = NEG; second = NEG; bj = 0;
  for (int j = 0; j < n; ++j) {
    const float4 q = p2[j];
    const float v = -dist(self, q) - q.w;
    if (v > best) { second = best; best = v; bj = j; }
    else if (v > second) { second = v; }
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(1024, 1)
emd_hybrid_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  const float* __restrict__ eps_table, int* __restrict__ out,
                  int* __restrict__ rounds_out, int* __restrict__ bids_out,
                  unsigned char* workspace,
                  int n, int m, int sinkhorn_iters, int auction_iters, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int unassigned;

  unsigned char* base = SMEM ? smem_raw
                             : workspace + (size_t)blockIdx.x * n * STATE_BYTES;
  float4* p1 = reinterpret_cast<float4*>(base);
  float4* p2 = p1 + n;
  unsigned long long* win = reinterpret_cast<unsigned long long*>(p2 + n);
  int* assign = reinterpret_cast<int*>(win + n);
  int* owner = assign + n;

  const int tid = threadIdx.x, T = blockDim.x;
  const float* a = x1 + (size_t)blockIdx.x * n * 3;
  const float* b = x2 + (size_t)blockIdx.x * n * 3;
  for (int i = tid; i < n; i += T) {
    p1[i] = make_float4(a[3 * i], a[3 * i + 1], a[3 * i + 2], 0.0f);
    p2[i] = make_float4(b[3 * i], b[3 * i + 1], b[3 * i + 2], 0.0f);  // g = 0
    win[i] = 0ull;
    assign[i] = -1;
    owner[i] = -1;
  }
  if (tid == 0) unassigned = n;
  __syncthreads();

  // ---- phase 1: Sinkhorn. Rows 0..m-1 carry f, every column carries g.
  for (int k = 0; k < sinkhorn_iters; ++k) {
    const float e = eps_table[k];
    const float inv = 1.0f / e;
    for (int i = tid; i < m; i += T) p1[i].w = soft_min(p1[i], p2, n, e, inv);
    __syncthreads();
    for (int j = tid; j < n; j += T) p2[j].w = soft_min(p2[j], p1, m, e, inv);
    __syncthreads();
  }

  // ---- phase 2: auction from price = -g.
  for (int j = tid; j < n; j += T) p2[j].w = -p2[j].w;
  __syncthreads();

  int rounds = 0, bids = 0;  // the same in every thread
  while (rounds < auction_iters) {
    bids += unassigned;  // written next after the barrier below
    for (int i = tid; i < n; i += T) {
      if (assign[i] >= 0) continue;
      float best, second;
      int bj;
      best_two(p1[i], p2, n, best, second, bj);
      const float inc = best - second + eps;  // > 0
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(inc) << 32) | (unsigned)(~(unsigned)i);
      atomicMax(&win[bj], key);
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
  for (int i = tid; i < n; i += T) {
    int j = assign[i];
    if (j < 0) {
      float best, second;
      best_two(p1[i], p2, n, best, second, j);
    }
    o[i] = j;
  }
  if (tid == 0 && rounds_out != nullptr) rounds_out[blockIdx.x] = rounds;
  if (tid == 0 && bids_out != nullptr) bids_out[blockIdx.x] = bids;
}

}  // namespace

// Bytes of global workspace one pair needs, 0 where the state fits in shared memory.
extern "C" long long difffacto_emd_hybrid_workspace_bytes(int n) {
  const long long bytes = (long long)n * STATE_BYTES;
  return bytes <= SMEM_LIMIT ? 0 : bytes;
}

// x1, x2 (B, n, 3) f32 contiguous; eps_table (sinkhorn_iters,) f32; out (B, n)
// int32; rounds, bids (B,) int32 or null; workspace B * workspace_bytes(n) bytes,
// 16-byte aligned, or null where that is 0. n % 4 == 0 and m % 4 == 0, 0 < m <= n.
// Returns a cudaError_t.
extern "C" int difffacto_emd_hybrid(const void* x1, const void* x2, const void* eps_table,
                                    void* out, void* rounds, void* bids, void* workspace,
                                    int B, int n, int m, int sinkhorn_iters,
                                    int auction_iters, float eps, void* stream) {
  if (B <= 0 || n <= 0 || n % 4 || m <= 0 || m > n || m % 4) return (int)cudaErrorInvalidValue;
  const int threads = n >= 1024 ? 1024 : (n + 31) / 32 * 32;
  const size_t bytes = (size_t)n * STATE_BYTES;
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes <= (size_t)SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(
        emd_hybrid_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    emd_hybrid_kernel<true><<<B, threads, bytes, s>>>(
        (const float*)x1, (const float*)x2, (const float*)eps_table, (int*)out, (int*)rounds,
        (int*)bids, nullptr, n, m, sinkhorn_iters, auction_iters, eps);
  } else {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    emd_hybrid_kernel<false><<<B, threads, 0, s>>>(
        (const float*)x1, (const float*)x2, (const float*)eps_table, (int*)out, (int*)rounds,
        (int*)bids, (unsigned char*)workspace, n, m, sinkhorn_iters, auction_iters, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
