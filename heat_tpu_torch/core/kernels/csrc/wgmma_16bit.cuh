// The 16-bit tensor-core machinery of the attention kernels' bf16 and f16 instances (K2 and K3
// in flash_attention_fwd.cu and flash_attention_fwd_pipelined.cu through flash_fwd_16bit.cuh,
// K4 and K5 in flash_attention_bwd.cu): wgmma m64nNk16 with f32 accumulation, its shared-memory
// descriptors for operands stored K-major and MN-major in the 128-byte swizzle, the products
// of a warpgroup's own rows by a ring tile and of a register tile by a ring tile, the 3-D TMA
// load that fills them, and the host's tensor maps of (batch·head, rows, head dim) tensors.
//
// A tile in shared memory is what TMA writes for a box of 64 columns (128 bytes) by R rows,
// 128-byte swizzled: row r at byte 128·r, its 16-byte chunk c at chunk c ^ (r % 8), the tile
// on a 1024-byte boundary. A head dim of 128 is two such tiles, R·128 bytes apart. One tile
// serves two products: read K-major (rows are M or N, the head dim is K: q·kᵀ) and MN-major
// (rows are K, the head dim is N: dS·k), as wgmma takes a transposed B of 16-bit types.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "tma_ring.cuh"

namespace wg16 {

// a (64 columns x `box` rows) box at (column x, row y, batch·head z) of a 3-D map into shared
// memory, its bytes counted on `bar`; rows and columns past the tensor's ends arrive as zeros
__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map, uint32_t dst, uint32_t bar, int x, int y, int z) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
        "[%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
        : "memory");
}

// wgmma's descriptor of an operand in the 128-byte swizzle (layout type 1, bits 62-63): its
// address, the leading byte offset LBO and the stride byte offset SBO, both in 16-byte units.
//   K-major (rows are M or N, 128 bytes of K each): 8-row groups 1024 bytes apart (SBO), LBO
//     unused; a step of 16 values along K adds 32 bytes to the address.
//   MN-major (rows are K, 64 values of M or N each): 8-row groups of K 1024 bytes apart (SBO),
//     successive 64-column blocks of N `lbo` bytes apart (LBO); a step of 16 rows of K adds
//     2048 bytes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// two f32 values rounded to nearest even into T and packed as one register, `lo` in the low
// half: the A operand's layout of a pair of neighbouring K values
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

#define WG16_SS_M64N64K16(TYPE)                                                                   \
    asm volatile(                                                                                 \
        "{\n"                                                                                     \
        ".reg .pred p;\n"                                                                          \
        "setp.ne.b32 p, %34, 0;\n"                                                               \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                           \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
        "%32, %33, p, 1, 1, 0, 0;\n"                                                             \
        "}\n"                                                                                     \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
        : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define WG16_RS_M64N64K16_TB(TYPE)                                                                \
    asm volatile(                                                                                 \
        "{\n"                                                                                     \
        ".reg .pred p;\n"                                                                          \
        "setp.ne.b32 p, %37, 0;\n"                                                               \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                          \
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                                             \
        "}\n"                                                                                     \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define WG16_RS_M64N128K16_TB(TYPE)                                                                \
    asm volatile(                                                                                 \
        "{\n"                                                                                     \
        ".reg .pred p;\n"                                                                          \
        "setp.ne.b32 p, %69, 0;\n"                                                               \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "                          \
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                                             \
        "}\n"                                                                                     \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d (64 x 64, f32) (+)= A (64 x 16) · B (64 x 16)ᵀ, both K-major in shared memory; d is
// overwritten where scale_d is 0
template <typename T>
__device__ __forceinline__ void ss_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        WG16_SS_M64N64K16("bf16");
    } else {
        WG16_SS_M64N64K16("f16");
    }
}

// d (64 x N, f32) += A (64 x 16, from registers in the accumulator's row layout) · B (16 x N),
// B MN-major in shared memory; N = 64 or 128
template <typename T, int N>
__device__ __forceinline__ void rs_m64k16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
    static_assert(N == 64 || N == 128, "rs_m64k16 takes N = 64 or 128");
    if constexpr (N == 64) {
        if constexpr (std::is_same_v<T, __nv_bfloat16>) {
            WG16_RS_M64N64K16_TB("bf16");
        } else {
            WG16_RS_M64N64K16_TB("f16");
        }
    } else {
        if constexpr (std::is_same_v<T, __nv_bfloat16>) {
            WG16_RS_M64N128K16_TB("bf16");
        } else {
            WG16_RS_M64N128K16_TB("f16");
        }
    }
}

// ------------------------------------------------- the attention kernels' tiles (K2, K3, K4, K5)
//
// A box is 64 columns by 64 rows of 2-byte values. A block's own rows (those of its two
// consumer warpgroups, kOwnRows) lie as DP / 64 column blocks of kOwnRows / 64 boxes each,
// kOwnBlock bytes apart; a ring tile of 64 rows as DP / 64 boxes, kBox bytes apart.
constexpr int kBox = 64 * 64 * 2;
constexpr int kOwnRows = 128;
constexpr int kOwnBlock = (kOwnRows / 64) * kBox;

// W (a warpgroup's 64 x 64 accumulator, f32) as the A operand of a product over its 64
// columns: for each k16 step kk, the accumulator's fragment of columns 16·kk .. packed in pairs
// into T, then fenced, so that every register is written before wgmma.fence
template <typename T>
__device__ __forceinline__ void a_frags(uint32_t (&a)[4][4], const float (&w)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            a[kk][i] = pack2<T>(w[8 * kk + 2 * i], w[8 * kk + 2 * i + 1]);
            asm volatile("" : "+r"(a[kk][i])::"memory");
        }
    }
}

// X (64 x 64) = A·Bᵀ over the padded head dim for A a warpgroup's 64 own rows (at `a`, a
// column block every kOwnBlock bytes) and B a ring tile (at `b`, a box every kBox bytes), both
// K-major
template <typename T, int DP>
__device__ __forceinline__ void own_by_tile(float (&x)[32], uint32_t a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t at = (kk / 4) * kOwnBlock + (kk % 4) * 32;
        const uint32_t bt = (kk / 4) * kBox + (kk % 4) * 32;
        ss_m64n64k16<T>(x, desc_k_major(a + at), desc_k_major(b + bt), kk > 0);
    }
}

// acc (64 x DP) += W·B for W (64 x 64) in a_frags' registers and B a ring tile (64 rows of the
// padded head dim, at `b`), MN-major
template <typename T, int DP>
__device__ __forceinline__ void acc_by_tile(float (&acc)[DP / 2], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rs_m64k16<T, DP>(acc, a[kk], desc_mn_major(b + kk * 16 * 128, kBox));
}

// two neighbouring values of an output row, in T or in f32
template <typename T>
__device__ __forceinline__ void store_pair(void* out, long long off, float x, float y, int out_f32) {
    if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(x, y);
    } else {
        *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + off) = pack2<T>(x, y);
    }
}

// what TMA takes: a head dim of 8·n values (16-byte row strides) and 16-byte aligned tensors;
// the wrappers pad any other head dim and copy a tensor that is not aligned
template <typename... Ptr>
bool tma_ready(int d, Ptr... tensors) {
    const uintptr_t bits = (reinterpret_cast<uintptr_t>(tensors) | ...);
    return d % 8 == 0 && bits % 16 == 0;
}

template <typename T> constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
template <> constexpr CUtensorMapDataType kMapType<__half> = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;

// a 3-D map of a contiguous (bh, rows, d) tensor of T, boxes of 64 columns x `box_rows` rows of
// one batch·head, 128-byte swizzle, zeros out of bounds. TMA wants 16-byte row strides and a
// 16-byte aligned base: d a multiple of 8 (the caller pads others).
template <typename T>
int make_map_3d(CUtensorMap* map, const void* ptr, long long bh, long long rows, int d, int box_rows) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return kErrNoEncode;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(bh)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(T), static_cast<cuuint64_t>(rows * d) * sizeof(T)};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = fn(map, kMapType<T>, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
        last_encode_result = r;
        return kErrEncode;
    }
    return 0;
}

}  // namespace wg16
