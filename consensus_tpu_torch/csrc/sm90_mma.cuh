// Tensor-core and asynchronous-copy helpers shared by the attention kernels
// (flash_attention.cu, decode_attention.cu), as inline PTX for sm_90a.
//
// * mma.sync.aligned.m16n8k16 bf16 x bf16 -> fp32.  Fragment layouts, with
//   g = lane / 4 and t = lane % 4:
//     A (16x16, row-major), 4 regs of 2 bf16: a0 (row g, cols 2t, 2t+1),
//       a1 (row g+8, cols 2t..), a2 (row g, cols 2t+8..), a3 (row g+8,
//       cols 2t+8..);
//     B (16x8, k x n), 2 regs: b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9;
//       col g);
//     C (16x8 fp32), 4 regs: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//       g+8, cols 2t, 2t+1).
//   So the C fragments of two neighbouring 8-column tiles, rounded to bf16
//   pairs, are exactly the A fragment of one 16-deep step: the attention
//   kernels turn P into the A operand of P.V without leaving registers.
// * ldmatrix.x4 (and .trans) loads four 8x8 bf16 matrices from shared
//   memory; lanes 8i..8i+7 give the row addresses of matrix i.
// * cp.async.cg 16-byte copies global -> shared with zero fill, and their
//   commit / wait groups.
//
// Shared-memory tiles are row-major with HD + 8 bf16 per row: the 16-byte
// pad puts the 8 rows an ldmatrix reads at one column on 8 different bank
// groups.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global `src` to shared `dst`; when `pred` is false the
// source is not read and `dst` is filled with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Copy rows [row0, row0 + ROWS) of a row-major bf16 array (`stride`
// elements between rows, HD wide) into a shared tile of HD + 8 per row with
// cp.async, THREADS threads taking 16 bytes each per step.  Rows at or past
// `limit` are zero-filled and not read.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ base,
                                          size_t stride, int row0, int limit) {
  constexpr int CHUNKS = HD / 8;
  constexpr int LD = HD + 8;
  static_assert(ROWS * CHUNKS % THREADS == 0, "tile does not split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    const bool ok = row < limit;
    cp_async_16(dst + r * LD + c, base + (size_t)(ok ? row : 0) * stride + c, ok);
  }
}

// c += a * b on the tensor cores (16x16 bf16 by 16x8 bf16, fp32 sums).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of bf16: `lo` in the low half (the lower
// column of an A fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (ex2.approx with flush to zero), about
// 5% faster in the attention loops than exp2f; 2^-inf is 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the four lanes (t = 0..3) that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ldmatrix.x4 row address inside a 16 x 16 block of a row-major tile with
// leading dimension LD, as the A operand (Q or P rows x depth): matrices
// (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15),
// (rows 8-15, cols 8-15).
template <int LD>
__device__ __forceinline__ int a_offset(int lane) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}

// ldmatrix.x4 row address for the B operand of S = Q K^T from a row-major
// K tile (keys x depth): two 8-key column tiles, each 16 deep.  Registers
// {0, 1} are the B fragment of keys 0-7, {2, 3} of keys 8-15.
template <int LD>
__device__ __forceinline__ int kt_offset(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}

// ldmatrix.x4.trans row address for the B operand of O = P V from a
// row-major V tile (keys x depth): 16 keys deep, two 8-column tiles.
// Registers {0, 1} are the B fragment of columns 0-7, {2, 3} of 8-15.
template <int LD>
__device__ __forceinline__ int v_offset(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
}

}  // namespace sm90
