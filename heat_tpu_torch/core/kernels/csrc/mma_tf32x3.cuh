// fp32-accurate matrix products on Hopper's tensor cores: 3xTF32 with mma.sync.
//
// An f32 value x splits into a TF32 "big" part, x rounded to TF32 (10 explicit mantissa
// bits) to nearest with ties away from zero (cvt.rna), and a TF32 "small" part, the
// residual x − big rounded the same way. big carries x's top 11 significant bits and
// small the next 11, so big + small is x to within about 2⁻²² of |x|. A product a·b is
// then
//   a_small·b_big + a_big·b_small + a_big·b_big
// on the tensor cores with f32 accumulation, in that order (CUTLASS's
// OpMultiplyAddFastF32). The dropped a_small·b_small term is below 2⁻²² of |a·b|, so a dot
// product keeps fp32's level of accuracy at up to a third of the TF32 rate (495/3 = 165
// TFLOP/s dense on an H100 SXM, against 67 TFLOP/s for fp32 FMAs). Values of bf16 or f16
// are exact in TF32 (8 and 10 explicit mantissa bits): their small part is 0 and the
// products with it are skipped (the kExact flags below).
//
// The m16n8k8 fragments (PTX ISA, mma.m16n8k8 with .tf32), for lane = 4·g + t:
//   A (16 × 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 × 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 × 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An 8 × 4 block of f32 values is an 8 × 8 block of b16 values, so ldmatrix (x4) reads a
// whole A fragment, or the B fragments of two n-tiles, from a row-major f32 tile whose
// rows are 16-byte aligned: lane 4g + t receives the word (row g, column t) of each block.
// A C fragment serves as the A operand of a next product over its 8 columns when that
// product's k index is permuted within the chunk (k t ↔ column 2t, k t + 4 ↔ column
// 2t + 1): a = {c0, c2, c1, c3}, and the B operand is read with the same permutation.
// The sum over k is the same sum in another order, and no shuffle or shared-memory trip
// is needed (`from_acc`).

#pragma once

#include <cstdint>

namespace tf32x3 {

// x rounded to TF32, to nearest with ties away from zero, as an f32 bit pattern (the low
// 13 bits cleared)
__device__ __forceinline__ uint32_t round_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r & 0xffffe000u;
}

// the big and small TF32 parts of x; with kExact (x is a bf16 or f16 value) small is 0
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    if constexpr (kExact) {
        big = __float_as_uint(x);
        small = 0u;
    } else {
        big = round_tf32(x);
        small = round_tf32(x - __uint_as_float(big));
    }
}

// c += a·b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in 3xTF32 from the operands' parts: small·big, big·small, big·big; a product
// with an exact (zero) small part is skipped
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2], const uint32_t (&b_small)[2]) {
    if constexpr (!kExactA) mma(c, a_small, b_big);
    if constexpr (!kExactB) mma(c, a_big, b_small);
    mma(c, a_big, b_big);
}

// the A operand over a C fragment's 8 columns, k permuted as in the note above
__device__ __forceinline__ void from_acc(const float (&c)[4], float (&a)[4]) {
    a[0] = c[0];
    a[1] = c[2];
    a[2] = c[1];
    a[3] = c[3];
}

// four 8 × 4 blocks of 32-bit words from shared memory: lanes 8j .. 8j+7 give the
// addresses of block j's rows (16-byte aligned), and r[j] is word (g, t) of block j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

}  // namespace tf32x3
