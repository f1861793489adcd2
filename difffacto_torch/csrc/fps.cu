// Furthest point sampling for Hopper (sm_90a): one thread block per cloud.
//
// Replaces the TPU kernel difffacto_tpu/ops/fps_pallas.py:_fps_kernel. It
// computes what that kernel computes: start at index 0, keep the running
// minimum squared distance of every point to the chosen set on chip, and at
// each of the m - 1 steps take the point with the largest minimum, ties to the
// lowest index, with no near-origin skip. The TPU's channel-first layout, its
// one-hot lane gather and its masked full-vector stores are not carried over:
// the coordinates are read once from (B, N, 3) into shared memory as three
// arrays, the chosen point's coordinates are a broadcast shared-memory read,
// and thread 0 stores each index.
//
// Arithmetic is fixed so that the plain PyTorch version
// (ops/fps.py:furthest_point_sample_reference) gives the same indices: f32,
// d = (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics, so nvcc
// cannot contract a product and a sum into an FMA.
//
// One step is a strided sweep (each thread owns N / blockDim points), a warp
// shuffle argmax on (value, index), one __syncthreads, and a second shuffle
// argmax over the warps' results that every warp repeats for itself; the
// warps' results are double-buffered so one barrier a step is enough.
//
// Bound: B * (m - 1) * N distance updates of 8 f32 operations over the f32
// peak; the bytes (B * N * 12 read once) are far less. Under both lies a
// latency floor: the m - 1 steps depend on each other and one cloud cannot
// use more than one SM here, so B clouds keep B of the 132 SMs busy.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int SMEM_LIMIT = 232448;  // what one Hopper thread block may use
constexpr unsigned FULL = 0xffffffffu;

// (v, i) beats (bv, bi): larger value, then lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL, bv, o);
    int oi = __shfl_xor_sync(FULL, bi, o);
    if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N, int m) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + N;
  float* zs = ys + N;
  float* dist = zs + N;
  __shared__ float warp_v[2][32];
  __shared__ int warp_i[2][32];

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  int* o = out + (size_t)blockIdx.x * m;

  for (int i = tid; i < N; i += T) {
    xs[i] = p[3 * i];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
    dist[i] = CUDART_INF_F;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int cur = 0;
  for (int s = 1; s < m; ++s) {
    const float cx = xs[cur], cy = ys[cur], cz = zs[cur];
    float bv = -1.0f;  // every distance is >= 0
    int bi = 0x7fffffff;
    for (int i = tid; i < N; i += T) {  // indices rise, so > keeps the lowest
      const float dx = __fsub_rn(xs[i], cx);
      const float dy = __fsub_rn(ys[i], cy);
      const float dz = __fsub_rn(zs[i], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float dm = fminf(dist[i], d);
      dist[i] = dm;
      if (dm > bv) { bv = dm; bi = i; }
    }
    warp_argmax(bv, bi);
    const int buf = s & 1;
    if (lane == 0) { warp_v[buf][warp] = bv; warp_i[buf][warp] = bi; }
    __syncthreads();
    bv = lane < nwarps ? warp_v[buf][lane] : -1.0f;
    bi = lane < nwarps ? warp_i[buf][lane] : 0x7fffffff;
    warp_argmax(bv, bi);
    cur = bi;
    if (tid == 0) o[s] = cur;
  }
}

}  // namespace

// xyz (B, N, 3) f32 contiguous -> out (B, m) int32. Returns a cudaError_t.
extern "C" int difffacto_fps(const void* xyz, void* out, int B, int N, int m, void* stream) {
  if (B <= 0 || N <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)N * 4 * sizeof(float);
  if (bytes > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int threads = ((N + 7) / 8 + 31) / 32 * 32;  // about 8 points a thread
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  fps_kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
      (const float*)xyz, (int*)out, N, m);
  return (int)cudaGetLastError();
}

// The most points a cloud may have: four f32 arrays of N in shared memory.
extern "C" int difffacto_fps_max_points() { return SMEM_LIMIT / (4 * (int)sizeof(float)); }

extern "C" const char* difffacto_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
