// Pieces shared by the tensor-core IVF scans (ivf_probe_scan.cu, B2, and
// ivf_chunked_scan.cu, B3): cp.async copies, the m16n8k16 bf16 -> f32
// product, the exact int8 / bf16 -> bf16x2 fragment loads and the bf16
// query scratch.  Each including source is compiled on its own, so
// everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Bits;  // the element's bit pattern, for copies
template <> struct Bits<int8_t> { using type = uint8_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a * b for one m16n8k16 tile, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive stored elements (the lower one in the low half) as a
// bf16x2 register.  An int8 v becomes the float 2^23 + (v + 128) by
// placing the byte under the exponent of 2^23, minus 2^23 + 128: exactly
// v, whose bf16 is its upper half (v has at most 8 significant bits).
// Integer and add units only, no conversion instructions.
__device__ __forceinline__ uint32_t bf16x2_of(const int8_t* p) {
  const uint32_t raw = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
  const float lo =
      __uint_as_float(__byte_perm(raw, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float hi =
      __uint_as_float(__byte_perm(raw, 0x4B000000u, 0x7651)) - 8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint32_t bf16x2_of(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q_bf16[b, d] = bf16_rn(queries[b, d]) for d < dim, 0 up to dim_pad.
__global__ void prep_queries_kernel(const float* __restrict__ queries,
                                    __nv_bfloat16* __restrict__ q_bf16,
                                    int batch, int dim, int dim_pad) {
  const size_t n = (size_t)batch * dim_pad;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / dim_pad;
    const int d = (int)(i - b * dim_pad);
    q_bf16[i] = __float2bfloat16_rn(d < dim ? queries[b * dim + d] : 0.0f);
  }
}

}  // namespace
