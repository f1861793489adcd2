// Hopper building blocks shared by the port's kernels (sm_90a only):
// mbarriers, TMA tensor loads, warpgroup matrix multiply (wgmma) with A in
// registers or in shared memory and B in shared memory, vector reductions into
// global memory, register rebalancing, and thread block clusters (rank,
// distributed shared memory, the cluster barrier).
//
// Conventions. A bf16 weight W (K, N) with N contiguous is fetched by TMA in
// boxes of K' rows x 64 columns (128 bytes a row) with the 128-byte swizzle;
// wgmma reads such boxes as an MN-major ("transposed") B operand whose 64-
// column blocks lie box_bytes apart (the descriptor's leading byte offset)
// and whose 8-row groups lie 1024 bytes apart (its stride byte offset).
//
// A (64 x 16 per k-step) lives in registers, four 32-bit words of two bf16
// each, in the layout of the f32 accumulator the previous product left: a
// thread (warp w of its warpgroup, lane = 4 g + t) holds rows 16 w + g and
// 16 w + g + 8, columns 8 j + 2 t and 8 j + 2 t + 1 of each 8-column block j.
// So the accumulator d[4 j + 2 r + e] (r: row g or g + 8, e: column) packs
// into p[2 j + r], and p[4 kk .. 4 kk + 3] is A of k-step kk.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// A wait on an mbarrier that lasts longer than this is a fault, not a
// pipeline stall: the kernel traps and the launch reports an error.
constexpr unsigned long long kWaitLimitNs = 4000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and announce the bytes the TMA loads of this phase will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// A named barrier over the first `threads` threads of the block (id >= 1).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One TMA load of a 3-D box (c0 innermost) into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// Shared-memory descriptor of an MN-major B operand with the 128-byte swizzle
// (see the note at the top); `saddr` must keep the 1024-byte alignment of the
// swizzle pattern, which a k-step's advance of 16 rows (2048 bytes) does.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across the
// asynchronous product: every register it reads or writes is "touched" here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 128 f32) = A (64 x 16 bf16, registers) x B (16 x 128 bf16 in shared
// memory, MN-major for TB = 1, K-major for TB = 0) + (accumulate ? d : 0).
template <int TB = 1>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %68, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, %70;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(accumulate), "l"(desc_b), "n"(TB));
}

// d += A (64 x 16 k-steps) x B over the k-steps of one weight chunk in a ring
// stage at shared address `b_base`: k-step kk reads 16 rows from
// b_base + 2048 kk, with the two 64-column halves `box_bytes` apart. Waits for
// the products to finish before it returns.
//
// A hazard seen with nvcc and ptxas of CUDA 12.9 (build 36037853): in a rolled
// loop that calls this twice per iteration with one A array kept over the
// loop and a second one written between the calls (fused_core.cu's FF chunk
// loop), ptxas gave the written array the registers of the kept one's upper
// half. The output was wrong with no error; the cause is not known. Nothing at
// build time detects it: a loop of this shape must be held against its plain
// version on the card (fused_core.cu unrolls that loop by 2, which avoids it).
template <int KSTEPS>
__device__ __forceinline__ void chunk_product(float (&d)[64], uint32_t (&a)[4 * KSTEPS],
                                              uint32_t b_base, uint32_t box_bytes,
                                              bool accumulate) {
  fence_regs(d);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    wgmma_m64n128k16_rs(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                        desc_mn_sw128(b_base + 2048u * kk, box_bytes, 1024u),
                        (accumulate || kk > 0) ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(a);
}

// Make this thread's ordinary shared-memory stores visible to the
// asynchronous proxy (wgmma operand reads) before a barrier hands them over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d (64 x 128 f32) = A (64 x 16 bf16) x B (16 x 128 bf16) + (accumulate ? d : 0),
// both operands in shared memory by descriptor; TA, TB: 1 for MN-major
// ("transposed"), 0 for K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64 f32) = A (64 x 16 bf16) x B (16 x 64 bf16) + (accumulate ? d : 0),
// both operands in shared memory by descriptor; TA, TB: 1 for MN-major
// ("transposed"), 0 for K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// A K-major operand with the 128-byte swizzle: rows of 64 bf16 (128 bytes),
// 8-row groups 1024 bytes apart; a k-step of 16 advances the start by 32
// bytes inside the swizzle atom (the leading byte offset is not used).
__device__ __forceinline__ uint64_t desc_k_sw128(uint32_t saddr) {
  return desc_mn_sw128(saddr, 16u, 1024u);
}

// One 4-wide f32 reduction into global memory (sm_90: a single red.v4).
__device__ __forceinline__ void red_add_v4(float* dst, float a, float b, float c, float e) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(a, b, c, e));
}

__device__ __forceinline__ void red_add_v2(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

// ---- thread block clusters: rank, distributed shared memory, the split barrier

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of `p` (this block's shared memory) in the
// shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// Asynchronous stores into the shared memory of a block of the cluster that
// count their bytes on that block's mbarrier (both addresses from
// cluster_map); its threads see the data once they see the phase complete
// (mbar_wait_cluster).
__device__ __forceinline__ void st_async_u32x2(uint32_t addr, uint32_t a, uint32_t b,
                                               uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];" ::"r"(
          addr),
      "r"(a), "r"(b), "r"(bar)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16) from this block's shared memory
// to the shared memory of a block of the cluster, counted on that block's
// mbarrier (dst and bar from cluster_map). The source must stay until the
// receiver has seen the phase complete.
__device__ __forceinline__ void bulk_copy_to_cluster(uint32_t dst, const void* src,
                                                     uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: for phases that other blocks of
// the cluster complete.
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait_cluster(addr, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait_cluster(addr, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// Every thread of every block of the cluster arrives (releasing its earlier
// shared-memory writes) and then waits for all of them (acquiring theirs).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

}  // namespace hopper
