// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel difffacto_tpu/ops/fps_pallas.py:_fps_kernel. It
// computes what that kernel computes: start at index 0, keep the running
// minimum squared distance of every point to the chosen set on chip, and at
// each of the m - 1 steps take the point with the largest minimum, ties to the
// lowest index, with no near-origin skip. Arithmetic is fixed so that the
// plain PyTorch version (ops/fps.py:furthest_point_sample_reference) gives the
// same indices: f32, d = (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics, so nvcc cannot contract a product and a sum into an FMA.
//
// Bound: B * (m - 1) * N distance updates of 8 f32 operations over the f32
// peak; the bytes (B * N * 12 read once) are far less. Under both lies a
// latency floor: the m - 1 steps depend on each other, so each step's
// reduction and barrier are paid 2047 times at the protocol's m = 2048.
//
// The kernel (fps_reg_kernel), launched by the plan of ops/fps.py:plan:
// - A cluster of C thread blocks takes one cloud (C = 1, 2, 4 or 8). Block r
//   owns points [r npc, (r + 1) npc), and its thread t the contiguous run
//   [t P, (t + 1) P) of them (P = 16 or 32), kept in registers with
//   their running minimum: a step's sweep reads and writes no shared memory.
//   Each block keeps a read-only copy of the whole cloud's coordinates in
//   shared memory, from which every thread reads the chosen point.
// - Distances are >= 0, so their f32 bits order as unsigned integers. A
//   thread keeps its first largest (its lowest index); a warp takes
//   __reduce_max_sync of the bits, then __reduce_min_sync of the indices that
//   hold it, and publishes that (bits, index) pair into a double-buffered
//   slot: with C = 1 a shared-memory store and the block's barrier; with
//   C > 1 lane r sends it to block r by st.async, which counts its bytes on
//   that block's mbarrier (a phase completes when all C x warps pairs of the
//   step have landed), so no cluster-wide barrier is taken a step.
// - Every warp then reduces the pairs the same way (largest bits, lowest
//   index): one pair of reductions a level, no shuffle of indices.
// A block holds at most 8192 points in its registers, so the plan takes a
// cluster of at least ceil(N / 8192) blocks a cloud; the shared copy of the
// cloud bounds N at (232448 - 2064) / 12 = 19,198 points.
// fps_reg_kernel<P, false> is a probe of the latency floor: the same steps
// with no distance sweep (each thread's candidate is a hash of the previous
// step's point), so its time is the reduction, exchange, barrier and index
// store alone.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;  // what one Hopper thread block may use
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CLUSTER = 8;
constexpr int BLOCK_POINTS = 8192;
constexpr int MAX_CANDS = MAX_CLUSTER * (BLOCK_POINTS / 16 / 32);
// The kernel's static shared memory: the candidate slots and barriers.
constexpr int REG_STATIC_BYTES = 2 * MAX_CANDS * 8 + 16;

__device__ __forceinline__ float sqdist(float x, float y, float z, float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A block holds at most BLOCK_POINTS points in registers: 512 threads of 16
// or 256 of 32, each with up to 128 or 255 registers.
template <int P>
constexpr int reg_threads() { return BLOCK_POINTS / P; }

template <int P, bool SWEEP>
__global__ void __launch_bounds__(reg_threads<P>(), 1)
fps_reg_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N, int m, int C,
               int npc) {
  extern __shared__ float cloud_xyz[];  // the whole cloud: x, y and z arrays of N
  float* xs = cloud_xyz;
  float* ys = xs + N;
  float* zs = ys + N;
  __shared__ uint2 key[2][MAX_CANDS];  // (bits, index) of each warp's winner
  __shared__ uint64_t landed[2];       // C > 1: a step's candidates have all arrived

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int rank = C > 1 ? (int)cluster_rank() : 0;
  const int base = rank * npc + tid * P;  // the thread's first point
  const float* p = xyz + (size_t)(blockIdx.x / C) * N * 3;
  int* o = out + (size_t)(blockIdx.x / C) * m;
  const int ncand = C * nwarps, per = (ncand + 31) >> 5;
  const uint32_t step_bytes = (uint32_t)ncand * sizeof(uint2);

  for (int i = tid; i < N; i += blockDim.x) {
    xs[i] = p[3 * i];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
  }
  // Padding (past the block's points or past N) keeps a minimum of 0: it
  // never beats a point, and where every minimum is 0 the lowest index (a
  // real point) wins.
  float px[P], py[P], pz[P], dist[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = base + j;
    const bool ok = tid * P + j < npc && i < N;
    px[j] = ok ? p[3 * i] : 0.0f;
    py[j] = ok ? p[3 * i + 1] : 0.0f;
    pz[j] = ok ? p[3 * i + 2] : 0.0f;
    dist[j] = ok ? CUDART_INF_F : 0.0f;
  }
  float cx = p[0], cy = p[1], cz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  if (C > 1) {
    // Step s's candidates land on landed[s & 1]: one arrival (this block's
    // expect_tx) and step_bytes from the cluster's warps a phase.
    if (tid == 0) {
      mbar_init(&landed[0], 1);
      mbar_init(&landed[1], 1);
      mbar_init_fence();
      if (m > 1) mbar_expect_tx(&landed[1], step_bytes);
      if (m > 2) mbar_expect_tx(&landed[0], step_bytes);
    }
    cluster_sync();  // every block's barriers exist before any candidate is sent
  } else {
    __syncthreads();
  }

  for (int s = 1; s < m; ++s) {
    const int buf = s & 1;
    unsigned bb = 0u;
    int bj = 0;
    if constexpr (SWEEP) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        dist[j] = fminf(dist[j], sqdist(px[j], py[j], pz[j], cx, cy, cz));
        const unsigned bits = __float_as_uint(dist[j]);
        if (bits > bb) { bb = bits; bj = j; }  // ties keep the lower j
      }
    } else {
      bb = (__float_as_uint(cx) ^ ((unsigned)tid * 0x9E3779B9u)) >> 9;
    }
    // The warp's largest bits, then the lowest index holding them.
    const unsigned wmax = __reduce_max_sync(FULL, bb);
    const unsigned widx = __reduce_min_sync(FULL, bb == wmax ? (unsigned)(base + bj) : ~0u);
    const int slot = rank * nwarps + warp;
    if (C == 1) {
      if (lane == 0) key[buf][slot] = make_uint2(wmax, widx);
      __syncthreads();
    } else {
      if (lane < C)
        st_async_u32x2(cluster_map(&key[buf][slot], lane), wmax, widx,
                       cluster_map(&landed[buf], lane));
      mbar_wait_cluster(&landed[buf], ((s - 1) >> 1) & 1);
      // Re-arm for step s + 2: its candidates need this block's of step s + 1,
      // which its warps send only after reading these.
      if (tid == 0 && s + 2 < m) mbar_expect_tx(&landed[buf], step_bytes);
    }
    // Every warp: the largest candidate bits, then the lowest index holding them.
    unsigned cb = 0u, ci = ~0u;
    for (int k = 0; k < per; ++k) {
      const int c = lane * per + k;
      if (c < ncand) {
        const uint2 v = key[buf][c];
        if (v.x > cb || (v.x == cb && v.y < ci)) { cb = v.x; ci = v.y; }
      }
    }
    const unsigned cmax = __reduce_max_sync(FULL, cb);
    int cur = (int)__reduce_min_sync(FULL, cb == cmax ? ci : ~0u);
    if constexpr (!SWEEP) cur = min(cur, N - 1);  // the probe's candidates may be padding
    cx = xs[cur];
    cy = ys[cur];
    cz = zs[cur];
    if (rank == 0 && tid == 0) o[s] = cur;
  }
  if (C > 1) cluster_sync();  // no block leaves while another may still send to it
}

template <int P, bool SWEEP>
int launch_reg(const float* xyz, int* out, int B, int N, int m, int C, int threads,
               cudaStream_t stream) {
  const int npc = (N + C - 1) / C;
  const size_t bytes = (size_t)N * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_reg_kernel<P, SWEEP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_reg_kernel<P, SWEEP>, xyz, out, N, m, C, npc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) f32 contiguous -> out (B, m) int32, by the plan of
// ops/fps.py:plan: `points` = P (16 or 32) points a thread, `threads` a
// block, `cluster` = C blocks a cloud. `probe` = 1 runs the latency-floor
// probe instead (its indices are not FPS). Returns a cudaError_t.
extern "C" int difffacto_fps(const void* xyz, void* out, int B, int N, int m, int cluster,
                             int threads, int points, int probe, void* stream) {
  if (B <= 0 || N <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if ((points != 16 && points != 32) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != MAX_CLUSTER) ||
      threads < 32 || threads > BLOCK_POINTS / points || threads % 32 ||
      (long long)threads * points < (N + cluster - 1) / cluster ||
      (size_t)N * 3 * sizeof(float) + REG_STATIC_BYTES > (size_t)SMEM_LIMIT ||
      (long long)B * cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (points == 16)
    return probe ? launch_reg<16, false>(x, o, B, N, m, cluster, threads, s)
                 : launch_reg<16, true>(x, o, B, N, m, cluster, threads, s);
  return probe ? launch_reg<32, false>(x, o, B, N, m, cluster, threads, s)
               : launch_reg<32, true>(x, o, B, N, m, cluster, threads, s);
}

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
