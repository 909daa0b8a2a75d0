// The int8 tensor-core machinery that the integer products share (int_gemm_tc.cu for the 8-bit
// types, int_gemm_planes.cu for the byte planes of int16, int32 and int64): the tile shape, the
// TMA load and wgmma descriptor of its tiles, the 128-register wgmma m64n256k32 of 8-bit
// operands, and the host's tensor maps; the ring's mbarriers and cuTensorMapEncodeTiled come
// from tma_ring.cuh.
//
// A block computes a 128 x 256 tile of C: a producer warpgroup, of which one thread keeps a ring
// of kStages stages full by TMA (a 128 x 128-byte tile of A and a 256 x 128-byte tile of B^T a
// stage, 128-byte swizzled as wgmma reads them, with a full and an empty mbarrier a stage), and
// two consumer warpgroups of 64 rows, each holding its 64 x 256 int32 accumulators in registers
// (kAcc a thread). setmaxnreg hands the producer's registers to the consumers.

#pragma once

#include "tma_ring.cuh"

namespace {

constexpr int kBM = 128;                 // rows of C a block: two consumer warpgroups of 64
constexpr int kBN = 256;                 // columns of C a block: one wgmma m64n256k32 a k step
constexpr int kBK = 128;                 // bytes of k a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;            // the producer warpgroup, then two consumers
constexpr int kGroupM = 16;              // tile-rows of C taken together (L2 reuse)
constexpr int kATile = kBM * kBK;        // 16 KB
constexpr int kBTile = kBN * kBK;        // 32 KB
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
constexpr int kAcc = kBN / 2;            // int32 accumulators a thread: 64 x 256 over 128 threads

// a (box rows x 128 bytes) tile at (k byte x, row y) of the map into shared memory, its bytes
// counted on `bar`
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar, int x, int y) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
            "r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
        : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle, rows of 128 bytes:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused by this layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_operand(int32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define INT_WGMMA_M64N256K32(TYPE)                                                                              \
    asm volatile(                                                                                               \
        "{\n"                                                                                                   \
        ".reg .pred p;\n"                                                                                       \
        "setp.ne.b32 p, %130, 0;\n"                                                                             \
        "wgmma.mma_async.sync.aligned.m64n256k32.s32." TYPE "." TYPE " "                                        \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                               \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                      \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                      \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                      \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                      \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                      \
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "          \
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "     \
        "%128, %129, p;\n"                                                                                      \
        "}\n"                                                                                                   \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),       \
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]),            \
          "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),            \
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),            \
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),            \
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),            \
          "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),            \
          "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),            \
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),            \
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),            \
          "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),            \
          "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]),            \
          "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),            \
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]),     \
          "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),     \
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),     \
          "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])      \
        : "l"(desc_a), "l"(desc_b), "r"(1))

// d (64 x 256, int32) += A (64 x 32 bytes) · B^T (256 x 32 bytes)^T, both from shared memory
template <bool kSigned>
__device__ __forceinline__ void wgmma_m64n256k32(int32_t (&d)[kAcc], uint64_t desc_a, uint64_t desc_b) {
    if constexpr (kSigned) {
        INT_WGMMA_M64N256K32("s8");
    } else {
        INT_WGMMA_M64N256K32("u8");
    }
}

// a 2-D map of `rows` rows of `k_pad` bytes, boxes of `box_rows` x 128 bytes, 128-byte swizzle,
// zeros out of bounds
int make_map(CUtensorMap* map, const void* ptr, long long rows, long long k_pad, int box_rows) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return kErrNoEncode;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
        last_encode_result = r;
        return kErrEncode;
    }
    return 0;
}

}  // namespace
