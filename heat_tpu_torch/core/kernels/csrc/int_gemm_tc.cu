// The 8-bit integer and bool matrix product on Hopper's int8 tensor cores: C = A·B for int8,
// uint8 and bool.
//
// Replaces no Pallas kernel. heat_tpu leaves an integer or bool product to XLA's dot_general
// (jnp.matmul, jnp.dot, jnp.vdot), which gives the product modulo 2^8 for int8 and uint8 and,
// for bool, the OR of ANDs; int_gemm.cu says so for every integer type. This source takes the
// three types of one byte, which have exactly one int8 tensor-core product each:
//
//   int8  : wgmma s8 x s8 -> s32, the int32 sum cut to its low 8 bits
//   uint8 : wgmma u8 x u8 -> s32, the same cut
//   bool  : torch.bool is one byte, 0 or 1, so the same u8 product; the sum compared with 0
//
// No .satfinite: the int32 sums wrap modulo 2^32, which keeps the low 8 bits that XLA's
// wrapping int8 sums give, and a sum of 0/1 products is 0 only where every AND is 0 (k < 2^31).
//
// What bounds it on an H100: operations on the int8 tensor cores. At 8192^3 the product is
// 1.1e12 operations, 0.556 ms at the published 1,979 TOP/s, against 0.060 ms for its bytes.
// The design feeds those cores as Hopper's GEMMs do:
//   * a block computes a 128 x 256 tile of C: two consumer warpgroups of 64 rows, each with its
//     64 x 256 int32 accumulators in registers (128 a thread) through wgmma m64n256k32, whose
//     operands are read from shared memory by descriptor;
//   * one producer thread keeps a ring of 4 stages full by TMA: a 128 x 128-byte tile of A and a
//     256 x 128-byte tile of B^T a stage (48 KB), 128-byte swizzled as wgmma reads them, with a
//     full and an empty mbarrier a stage; setmaxnreg hands the producer's registers to the
//     consumers;
//   * each consumer keeps one group of wgmma in flight while it waits for the next stage, and
//     frees a stage when the group that read it has ended;
//   * wgmma takes no MN-major operand of 8 bits, so both operands are K-major in shared memory:
//     A (m, k) row-major already is, and B comes as B^T (n, k), written by int_transpose_pad
//     below (0.04 ms of bytes at 8192^2) unless n is 1, where B already is B^T;
//   * TMA's global strides are multiples of 16 bytes, so k is padded with zeros to 16 (zeros add
//     nothing to a sum); the m, n and k edges of a tile are filled with zeros by TMA's
//     out-of-bounds rule and the epilogue masks its stores;
//   * batches: the operands are 2-D maps of (batch rows, k), a batch's tile at row
//     batch·m (A) or batch·n (B^T), or at row 0 where one matrix serves every batch; a tile's
//     rows past m (n) may read the next batch's rows, which reach only outputs that are masked;
//   * tiles are taken 16 tile-rows at a time along n, so that the tiles that run together share
//     their A and B^T tiles in L2.
// The tensor maps are built on the host for each call through cuTensorMapEncodeTiled, taken from
// libcuda.so.1 by dlsym, and passed as __grid_constant__ parameters. The tile shape, the ring's
// helpers, the wgmma and the maps live in wgmma_int8.cuh, which int_gemm_planes.cu shares.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with ctypes
// by heat_tpu_torch/core/kernels/int_matmul.py). Every entry point returns a cudaError_t, or one
// of this source's codes (int_gemm_tc_error_string names them).

#include "wgmma_int8.cuh"

namespace {

// the epilogue: the int32 sum cut to int8, to uint8, or compared with 0 (bool)
enum Out { kOutInt8 = 0, kOutUInt8 = 1, kOutBool = 2 };

struct Shape {
    int m, n;
    int k_tiles;          // k (padded to 16) in tiles of kBK bytes
    int tiles_m, tiles_n;
    int a_rows_batch;     // rows of A's map between batches: m, or 0 where A is shared
    int b_rows_batch;     // rows of B^T's map between batches: n, or 0
};

template <bool kSigned, int kOut>
__global__ void __launch_bounds__(kThreads, 1)
    int_gemm_tc_kernel(__grid_constant__ const CUtensorMap map_a, __grid_constant__ const CUtensorMap map_b,
                       uint8_t* __restrict__ c, const Shape s) {
    extern __shared__ uint8_t smem_raw[];
    // the 128-byte swizzle wants its tiles on 1024-byte boundaries
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t a_smem = base;                            // kStages A tiles
    const uint32_t b_smem = base + kStages * kATile;         // kStages B^T tiles
    const uint32_t bars = base + kStages * kStageBytes;      // full[kStages], then empty[kStages]
    auto full = [&](int st) { return bars + 8u * st; };
    auto empty = [&](int st) { return bars + 8u * (kStages + st); };

    // the tile of C: kGroupM tile-rows at a time, along n within the group
    const int pid = blockIdx.x;
    const int in_group = kGroupM * s.tiles_n;
    const int first_m = (pid / in_group) * kGroupM;
    const int group_m = min(s.tiles_m - first_m, kGroupM);
    const int tile_m = first_m + (pid % in_group) % group_m;
    const int tile_n = (pid % in_group) / group_m;
    const int batch = blockIdx.z;

    if (threadIdx.x == 0) {
        for (int st = 0; st < kStages; ++st) {
            mbar_init(full(st), 1);   // the producer's arrival, with the stage's bytes
            mbar_init(empty(st), 2);  // one arrival a consumer warpgroup
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int warpgroup = threadIdx.x / 128;
    if (warpgroup == 0) {
        // the producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            const int a_row = batch * s.a_rows_batch + tile_m * kBM;
            const int b_row = batch * s.b_rows_batch + tile_n * kBN;
            int st = 0;
            uint32_t phase = 0;
            for (int kt = 0; kt < s.k_tiles; ++kt) {
                mbar_wait(empty(st), phase ^ 1u);
                mbar_expect_tx(full(st), kStageBytes);
                tma_load(&map_a, a_smem + st * kATile, full(st), kt * kBK, a_row);
                tma_load(&map_b, b_smem + st * kBTile, full(st), kt * kBK, b_row);
                if (++st == kStages) {
                    st = 0;
                    phase ^= 1u;
                }
            }
        }
    } else {
        // a consumer: 64 rows of the tile, all 256 columns
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = warpgroup - 1;
        int32_t d[kAcc];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) d[i] = 0;

        int st = 0, prev = 0;
        uint32_t phase = 0;
        for (int kt = 0; kt < s.k_tiles; ++kt) {
            mbar_wait(full(st), phase);
#pragma unroll
            for (int i = 0; i < kAcc; ++i) fence_operand(d[i]);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            const uint64_t da = smem_desc(a_smem + st * kATile + wg * (64 * kBK));
            const uint64_t db = smem_desc(b_smem + st * kBTile);
#pragma unroll
            for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes a wgmma: 2 in the descriptor's 16-byte units
                wgmma_m64n256k32<kSigned>(d, da + 2 * kk, db + 2 * kk);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int i = 0; i < kAcc; ++i) fence_operand(d[i]);
            // the group before this one has ended: free the stage it read
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
            if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
            prev = st;
            if (++st == kStages) {
                st = 0;
                phase ^= 1u;
            }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < kAcc; ++i) fence_operand(d[i]);

        // the epilogue: thread t of the warpgroup holds, for each 8 columns j, rows
        // 16·(t/32) + (t%32)/4 and 8 below, columns 8j + 2·(t%4) and the next
        const int t = threadIdx.x % 128;
        const long long row0 = (long long)tile_m * kBM + wg * 64 + 16 * (t / 32) + (t % 32) / 4;
        const long long col0 = (long long)tile_n * kBN + 2 * (t % 4);
        uint8_t* cb = c + (long long)batch * s.m * s.n;
        const bool pairs = (s.n % 2) == 0;  // two neighbouring bytes of a row as one 16-bit store
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long row = row0 + 8 * h;
            if (row >= s.m) continue;
            uint8_t* crow = cb + row * s.n;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j) {
                const long long col = col0 + 8 * j;
                uint8_t v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int32_t x = d[4 * j + 2 * h + e];
                    v[e] = kOut == kOutBool ? static_cast<uint8_t>(x != 0) : static_cast<uint8_t>(x);
                }
                if (pairs && col + 1 < s.n) {
                    *reinterpret_cast<uint16_t*>(crow + col) = static_cast<uint16_t>(v[0] | (v[1] << 8));
                } else {
                    if (col < s.n) crow[col] = v[0];
                    if (col + 1 < s.n) crow[col + 1] = v[1];
                }
            }
        }
    }
}

// bt (batch, n, k_pad) = b (batch, k, n)^T, zeros in columns k .. k_pad: 64 x 64-byte tiles
// through shared memory, rows of 68 bytes so that the transposed reads spread over the banks.
// A tile inside b whose rows start on 16-byte boundaries moves 16 bytes a thread each way;
// an edge tile, or any tile where n % 16 != 0, moves bytes.
constexpr int kTT = 64;
constexpr int kTThreads = 256;
constexpr int kTPitch = kTT + 4;

__global__ void __launch_bounds__(kTThreads)
    int_transpose_pad_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ bt, long long k, long long n,
                             long long k_pad) {
    __shared__ __align__(16) uint8_t tile[kTT * kTPitch];
    const uint8_t* src = b + (long long)blockIdx.z * k * n;
    uint8_t* dst = bt + (long long)blockIdx.z * n * k_pad;
    const long long tiles_n = (n + kTT - 1) / kTT;
    const long long n0 = (blockIdx.x % tiles_n) * kTT, k0 = (blockIdx.x / tiles_n) * kTT;
    const bool wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 && n0 + kTT <= n && k0 + kTT <= k;
    if (wide) {
        // thread t: 16 bytes of row t/4 of b (a k), at column 16·(t%4) of the tile
        const int r = threadIdx.x / 4, c = 16 * (threadIdx.x % 4);
        const uint4 v = *reinterpret_cast<const uint4*>(src + (k0 + r) * n + n0 + c);
        uint32_t* row = reinterpret_cast<uint32_t*>(tile + r * kTPitch + c);
        row[0] = v.x;
        row[1] = v.y;
        row[2] = v.z;
        row[3] = v.w;
        __syncthreads();
        // thread t: 16 bytes of row t/4 of bt (an n), at column 16·(t%4) of the tile
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            uint32_t x = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) x |= static_cast<uint32_t>(tile[(c + 4 * q + e) * kTPitch + r]) << (8 * e);
            w[q] = x;
        }
        *reinterpret_cast<uint4*>(dst + (n0 + r) * k_pad + k0 + c) = make_uint4(w[0], w[1], w[2], w[3]);
        return;
    }
    for (int i = threadIdx.x; i < kTT * kTT; i += kTThreads) {
        const int r = i / kTT, cc = i % kTT;  // neighbouring threads on neighbouring columns of b
        const long long gk = k0 + r, gn = n0 + cc;
        tile[r * kTPitch + cc] = (gk < k && gn < n) ? src[gk * n + gn] : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTT * kTT; i += kTThreads) {
        const int r = i / kTT, cc = i % kTT;  // neighbouring threads on neighbouring columns of bt
        const long long gn = n0 + r, gk = k0 + cc;
        if (gn < n && gk < k_pad) dst[gn * k_pad + gk] = tile[cc * kTPitch + r];
    }
}

template <bool kSigned, int kOut>
int gemm(const CUtensorMap& ma, const CUtensorMap& mb, void* c, const Shape& s, int batch, cudaStream_t stream) {
    auto kernel = int_gemm_tc_kernel<kSigned, kOut>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    const long long tiles = (long long)s.tiles_m * s.tiles_n;
    kernel<<<dim3((unsigned)tiles, 1, (unsigned)batch), kThreads, kSmemBytes, stream>>>(ma, mb,
                                                                                      static_cast<uint8_t*>(c), s);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// c (batch, m, n) = a · bt^T for 8-bit operands: a holds (rows, k_pad) bytes, the m rows of
// batch z from row z·a_rows_batch (0: one matrix for every batch), bt (rows, k_pad) bytes, the
// n rows of batch z from row z·b_rows_batch; k_pad a multiple of 16 with zeros past k; both
// 16-byte aligned. `dtype` is int_matmul.py's code: 0 bool, 1 uint8, 2 int8. One launch on
// `stream`; nothing is synchronised.
int int_gemm_tc_launch(int device, int dtype, const void* a, const void* bt, void* c, long long batch, long long m,
                       long long n, long long k_pad, long long a_rows, long long b_rows, long long a_rows_batch,
                       long long b_rows_batch, void* stream) {
    if (batch < 1 || m < 1 || n < 1 || k_pad < 16 || k_pad % 16 != 0) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(bt) % 16 != 0)
        return cudaErrorMisalignedAddress;
    const long long tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
    if (batch > 65535 || tiles_m * tiles_n > 0x7fffffffLL || a_rows + kBM > 0x7fffffffLL ||
        b_rows + kBN > 0x7fffffffLL || k_pad > 0x7fffffffLL - kBK)
        return kErrShape;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    CUtensorMap ma, mb;
    int rc = make_map(&ma, a, a_rows, k_pad, kBM);
    if (rc != 0) return rc;
    rc = make_map(&mb, bt, b_rows, k_pad, kBN);
    if (rc != 0) return rc;
    const Shape s{(int)m, (int)n, (int)((k_pad + kBK - 1) / kBK), (int)tiles_m, (int)tiles_n, (int)a_rows_batch,
                  (int)b_rows_batch};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return gemm<false, kOutBool>(ma, mb, c, s, (int)batch, st);
        case 1: return gemm<false, kOutUInt8>(ma, mb, c, s, (int)batch, st);
        case 2: return gemm<true, kOutInt8>(ma, mb, c, s, (int)batch, st);
        default: return cudaErrorInvalidValue;
    }
}

// bt (batch, n, k_pad) = b (batch, k, n)^T of bytes, each contiguous, zeros in columns k .. k_pad.
// One launch on `stream`.
int int_transpose_pad_launch(int device, const void* b, void* bt, long long batch, long long k, long long n,
                             long long k_pad, void* stream) {
    if (batch < 1 || batch > 65535 || k < 1 || n < 1 || k_pad < k) return cudaErrorInvalidValue;
    const long long tiles = ((n + kTT - 1) / kTT) * ((k_pad + kTT - 1) / kTT);
    if (tiles > 0x7fffffffLL) return kErrShape;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)tiles, 1, (unsigned)batch);
    int_transpose_pad_kernel<<<grid, kTThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), k, n, k_pad);
    return cudaGetLastError();
}

const char* int_gemm_tc_error_string(int code) { return tc_error_string(code); }

}  // extern "C"
