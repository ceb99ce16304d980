// Shared helpers of the port's Hopper kernels.  Every entry point has a
// plain C signature (bound from Python with ctypes), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError()
// so the caller sees a refused launch at once.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CS_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float cs_to_float(float x) { return x; }
__device__ __forceinline__ float cs_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float cs_to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T cs_from_float(float x);
template <> __device__ __forceinline__ float cs_from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cs_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half cs_from_float<__half>(float x) {
  return __float2half_rn(x);
}

// ---- asynchronous copies and tensor-core products (attention.cu, ssd_scan.cu):
// 16-byte cp.async into shared memory, ldmatrix, mma.sync m16n8k16 bf16 (or
// f16) -> f32
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// the same, reading src_bytes (0 or 16) of src and zero-filling the rest
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
// an 8-byte copy (int8 rows of 24 bytes: D 24)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// a BYTES (4 or 8) copy reading src_bytes (0 or BYTES) of src and
// zero-filling the rest (rows that are only 8- or 4-byte aligned)
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src, int src_bytes = BYTES) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col); F16: f16
// operands (the attention kernels' OPS_F16 builds)
template <bool F16 = false>
__device__ __forceinline__ void mma16816(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two f32 values rounded to a pair of E (bf16 or f16), lo in the low half
template <class E> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// a pair of non-negative E (probabilities) widened to f32 by integer ops:
// a bf16 by a 16-bit shift; an f16's exponent and mantissa bits moved 13
// up into an f32 are its value times 2^-112 (f16 subnormals land on f32
// denormals, exact too: no flush to zero in these builds), so one multiply
// by 2^112 restores it
template <class E> __device__ __forceinline__ float2 unpack_p2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack_p2<__nv_bfloat16>(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
template <> __device__ __forceinline__ float2 unpack_p2<__half>(uint32_t v) {
  return make_float2(__uint_as_float((v & 0xffffu) << 13) * 0x1p112f,
                     __uint_as_float((v >> 16) << 13) * 0x1p112f);
}
