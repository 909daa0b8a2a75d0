// The int16, int32 and int64 matrix products on Hopper's int8 tensor cores, as products of the
// operands' byte planes: C = A·B modulo 2^bits.
//
// Replaces no Pallas kernel. heat_tpu leaves an integer product to XLA's dot_general (jnp.matmul,
// jnp.dot, jnp.vdot), which gives it modulo 2^bits of the type; int_gemm.cu says so for every
// integer type. This source takes the matrices of the three wider types (the 1-D dot stays on
// int_gemm.cu's dot kernel, the 8-bit types on int_gemm_tc.cu).
//
// The arithmetic (held on the CPU by int_matmul.plane_reference and the tests of
// tests/test_torch_int_matmul.py):
//   * each operand is cut into its S bytes, two's complement read as unsigned: S = 2 for int16,
//     4 for int32, 8 for int64. Then A ≡ Σᵢ aᵢ·2^(8i) modulo 2^bits with every plane aᵢ u8, so
//     every product is wgmma .s32.u8.u8 and no plane needs a sign;
//   * the plane pairs of equal weight s = i + j < S are summed into one int32 accumulator Pₛ
//     (pairs of weight S or more vanish modulo 2^bits): C = Σₛ Pₛ·2^(8s) modulo 2^bits;
//   * int16 and int32: every Pₛ may wrap modulo 2^32, since the result keeps no bit above 2^32,
//     so one accumulator serves every class, by Horner's rule: P_{S-1}, shifted left 8 and
//     added to by P_{S-2}, and so on down to P₀; then cut to the type. No limit on k;
//   * int64: Pₛ is needed modulo 2^(64-8s). For s ≥ 4 a wrap modulo 2^32 is enough, so classes
//     7 to 4 run as above into H, which adds H·2^32 to C. For s ≤ 3 the sum must be whole, below
//     2^32 read as uint32; the worst class is 3: 4 pairs of 255·255 a step of k, which holds
//     for at most 16,512 steps. So k runs in chunks of kChunkK = 16,384 for those classes, and
//     at each class's end in each chunk its accumulator, read as uint32, is added shifted by 8s
//     into C (uint64 sums modulo 2^64) and restarted: 1 + 4·chunks passes of a block over its
//     tile of C (256 KB, which stays in L2 while the block runs);
//   * no .satfinite: the sums wrap.
// Every order of these sums gives the same bits, so the result is exact and equal to XLA's.
//
// What bounds it on an H100: operations on the int8 tensor cores. A product of m·n·k takes 3
// (int16), 10 (int32) or 36 (int64) int8 products of that size: at 8192^3 int32 that is 1.1e13
// operations, 5.556 ms at the published 1,979 TOP/s, against 0.8 ms for its bytes. The design
// is int_gemm_tc.cu's (wgmma_int8.cuh: a 128 x 256 tile of C a block, two consumer warpgroups
// with 64 x 256 int32 accumulators in registers, one producer thread with a 4-stage TMA ring,
// setmaxnreg), walking a longer k: every plane pair of a class over the whole k (or a chunk),
// class after class. One accumulator a thread, so the tile stays 128 x 256, where wgmma reads
// operands from shared memory at well under its bandwidth. At a class's end a consumer waits
// for its wgmma to end and shifts, stores or folds its accumulators while the producer keeps
// loading the next class's tiles.
//   * The planes: wgmma takes 8-bit operands K-major from shared memory, as TMA tiles of one
//     plane. int_planes writes A's planes, (S, rows, k_pad) bytes, and int_planes_t B's as
//     planes of B^T, (S, batch·n, k_pad), through a 64 x 64 tile in shared memory (where n is
//     1, B already is B^T and int_planes splits it). k is padded with zeros to 16 (TMA's
//     stride rule). At 8192^2 int32 each pass moves 0.5 GB, 0.16 ms of bytes; counted in the
//     product's time.
//   * The ragged m, n and k edges of a tile get zeros by TMA's out-of-bounds rule and the
//     epilogue masks its stores. A tile's rows past m (n) may read the next batch's or plane's
//     rows, which reach only outputs that are masked.
//   * Batches: a plane's rows are (batch rows, k_pad) as in int_gemm_tc.cu, a batch's tile at
//     row batch·m (A) or batch·n (B^T), or at row 0 where one matrix serves every batch; plane
//     i's rows follow plane i − 1's.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with ctypes
// by heat_tpu_torch/core/kernels/int_matmul.py). Every entry point returns a cudaError_t, or one
// of wgmma_int8.cuh's codes (int_gemm_planes_error_string names them).

#include <type_traits>

#include "wgmma_int8.cuh"

namespace {

constexpr int kChunkK = 16384;             // int64: k steps a chunk of classes 0 to 3 (≤ 16,512)
constexpr int kChunkTiles = kChunkK / kBK;

// what a consumer does at the end of a class: shift its accumulators left 8 (Horner's rule),
// store them cut to int16 or int32, or add them into int64 C shifted by 32 (the first write of
// C) or by 8·class
enum Action { kShift = 0, kStore = 1, kFoldHigh = 2, kFold = 3 };

struct PlaneShape {
    int m, n;
    int k_tiles;          // k (padded to 16) in tiles of kBK bytes
    int tiles_m, tiles_n;
    int a_rows_batch;     // rows of a plane of A between batches: m, or 0 where A is shared
    int b_rows_batch;     // rows of a plane of B^T between batches: n, or 0
    int a_plane_rows;     // rows of A's map between planes
    int b_plane_rows;     // rows of B^T's map between planes
};

// The products in their order, as segments: a class over the whole k (int16, int32, and int64's
// classes 7 to 4), or one of int64's classes 3 to 0 over a chunk of k. Segment g's class, k
// tiles [k0, k1) and the action at its end.
template <int kPlanes>
__device__ __forceinline__ int segments(const PlaneShape& s) {
    return kPlanes < 8 ? kPlanes : 4 + 4 * ((s.k_tiles + kChunkTiles - 1) / kChunkTiles);
}

template <int kPlanes>
__device__ __forceinline__ void segment(const PlaneShape& s, int g, int& c, int& k0, int& k1, int& action) {
    if (kPlanes < 8 || g < 4) {
        c = (kPlanes < 8 ? kPlanes - 1 : 7) - g;
        k0 = 0;
        k1 = s.k_tiles;
        action = kPlanes < 8 ? (c == 0 ? kStore : kShift) : (c == 4 ? kFoldHigh : kShift);
        return;
    }
    c = 3 - (g - 4) % 4;
    k0 = (g - 4) / 4 * kChunkTiles;
    k1 = min(k0 + kChunkTiles, s.k_tiles);
    action = kFold;
}

// step(i, j, kt) for each k tile of each plane pair (aᵢ, bⱼ) of each segment, and end(action,
// class) after each segment. The producer and the consumers walk the same order.
template <int kPlanes, class Step, class End>
__device__ __forceinline__ void for_each_step(const PlaneShape& s, Step&& step, End&& end) {
    const int n_segments = segments<kPlanes>(s);
    for (int g = 0; g < n_segments; ++g) {
        int c, k0, k1, action;
        segment<kPlanes>(s, g, c, k0, k1, action);
        for (int i = 0; i <= c; ++i)
            for (int kt = k0; kt < k1; ++kt) step(i, c - i, kt);
        end(action, c);
    }
}

// the block's tile of C: kGroupM tile-rows at a time, along n within the group
__device__ __forceinline__ void tile_of(const PlaneShape& s, int& tile_m, int& tile_n) {
    const int pid = blockIdx.x;
    const int in_group = kGroupM * s.tiles_n;
    const int first_m = (pid / in_group) * kGroupM;
    const int group_m = min(s.tiles_m - first_m, kGroupM);
    tile_m = first_m + (pid % in_group) % group_m;
    tile_n = (pid % in_group) / group_m;
}

// two neighbouring outputs of a row, (x0, x1) at columns col and col + 1: int16 and int32 cut to
// the type and stored; int64 read as uint32, shifted left by `shift`, and written (first) or
// added. One store of both where n is even.
template <typename T>
__device__ __forceinline__ void put_pair(T* crow, int col, int n, bool pairs, int32_t x0, int32_t x1, int shift,
                                         bool first) {
    if constexpr (sizeof(T) == 8) {
        const T v0 = static_cast<T>(static_cast<uint32_t>(x0)) << shift;
        const T v1 = static_cast<T>(static_cast<uint32_t>(x1)) << shift;
        if (pairs && col + 1 < n) {
            ulonglong2* p = reinterpret_cast<ulonglong2*>(crow + col);
            if (first) {
                *p = make_ulonglong2(v0, v1);
            } else {
                const ulonglong2 old = *p;
                *p = make_ulonglong2(old.x + v0, old.y + v1);
            }
        } else {
            if (col < n) crow[col] = first ? v0 : crow[col] + v0;
            if (col + 1 < n) crow[col + 1] = first ? v1 : crow[col + 1] + v1;
        }
    } else {
        const T v0 = static_cast<T>(x0), v1 = static_cast<T>(x1);
        if (pairs && col + 1 < n) {
            if constexpr (sizeof(T) == 2) {
                *reinterpret_cast<uint32_t*>(crow + col) = static_cast<uint32_t>(static_cast<uint16_t>(v0)) |
                                                           (static_cast<uint32_t>(static_cast<uint16_t>(v1)) << 16);
            } else {
                *reinterpret_cast<int2*>(crow + col) = make_int2(v0, v1);
            }
        } else {
            if (col < n) crow[col] = v0;
            if (col + 1 < n) crow[col + 1] = v1;
        }
    }
}

// one instance a type: kPlanes 2 (int16), 4 (int32) or 8 (int64)
template <int kPlanes>
__global__ void __launch_bounds__(kThreads, 1)
    int_gemm_planes_kernel(__grid_constant__ const CUtensorMap map_a, __grid_constant__ const CUtensorMap map_b,
                           void* __restrict__ c, __grid_constant__ const PlaneShape s) {
    using Out = std::conditional_t<kPlanes == 2, int16_t, std::conditional_t<kPlanes == 4, int32_t, unsigned long long>>;
    extern __shared__ uint8_t smem_raw[];
    // the 128-byte swizzle wants its tiles on 1024-byte boundaries
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t a_smem = base;                            // kStages A tiles
    const uint32_t b_smem = base + kStages * kATile;         // kStages B^T tiles
    const uint32_t bars = base + kStages * kStageBytes;      // full[kStages], then empty[kStages]
    auto full = [&](int st) { return bars + 8u * st; };
    auto empty = [&](int st) { return bars + 8u * (kStages + st); };

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
        // the producer: one thread keeps the ring full, plane pair after plane pair
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            int tile_m, tile_n;
            tile_of(s, tile_m, tile_n);
            const int a_row = blockIdx.z * s.a_rows_batch + tile_m * kBM;
            const int b_row = blockIdx.z * s.b_rows_batch + tile_n * kBN;
            int st = 0;
            uint32_t phase = 0;
            for_each_step<kPlanes>(
                s,
                [&](int i, int j, int kt) {
                    mbar_wait(empty(st), phase ^ 1u);
                    mbar_expect_tx(full(st), kStageBytes);
                    tma_load(&map_a, a_smem + st * kATile, full(st), kt * kBK, i * s.a_plane_rows + a_row);
                    tma_load(&map_b, b_smem + st * kBTile, full(st), kt * kBK, j * s.b_plane_rows + b_row);
                    if (++st == kStages) {
                        st = 0;
                        phase ^= 1u;
                    }
                },
                [](int, int) {});
        }
    } else {
        // a consumer: 64 rows of the tile, all 256 columns
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const uint32_t a_wg = a_smem + (warpgroup - 1) * (64 * kBK);
        int32_t d[kAcc];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) d[i] = 0;

        int st = 0, prev = 0;
        uint32_t phase = 0;
        bool held = false;  // a stage read by a group that may still run
        for_each_step<kPlanes>(
            s,
            [&](int, int, int) {
                mbar_wait(full(st), phase);
#pragma unroll
                for (int i = 0; i < kAcc; ++i) fence_operand(d[i]);
                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                const uint64_t da = smem_desc(a_wg + st * kATile);
                const uint64_t db = smem_desc(b_smem + st * kBTile);
#pragma unroll
                for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes a wgmma: 2 in the descriptor's 16-byte units
                    wgmma_m64n256k32<false>(d, da + 2 * kk, db + 2 * kk);
                asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
                for (int i = 0; i < kAcc; ++i) fence_operand(d[i]);
                // the group before this one has ended: free the stage it read
                asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
                if (held && threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
                held = true;
                prev = st;
                if (++st == kStages) {
                    st = 0;
                    phase ^= 1u;
                }
            },
            [&](int action, int cls) {
                // the segment's last group ends, and its stage is freed, before the accumulators move
                asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
                for (int i = 0; i < kAcc; ++i) fence_operand(d[i]);
                if (threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
                held = false;
                if (action == kShift) {
#pragma unroll
                    for (int i = 0; i < kAcc; ++i) d[i] = static_cast<int32_t>(static_cast<uint32_t>(d[i]) << 8);
                    return;
                }
                // thread t of the warpgroup holds, for each 8 columns j, rows 16·(t/32) + (t%32)/4
                // and 8 below, columns 8j + 2·(t%4) and the next
                int tile_m, tile_n;
                tile_of(s, tile_m, tile_n);
                const int t = threadIdx.x % 128;
                const int row0 = tile_m * kBM + (warpgroup - 1) * 64 + 16 * (t / 32) + (t % 32) / 4;
                const int col0 = tile_n * kBN + 2 * (t % 4);
                const bool pairs = (s.n % 2) == 0;
                const int shift = action == kFoldHigh ? 32 : 8 * cls;
                const bool first = action != kFold;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + 8 * h;
                    if (row >= s.m) continue;
                    Out* crow = static_cast<Out*>(c) + ((long long)blockIdx.z * s.m + row) * s.n;
#pragma unroll
                    for (int j = 0; j < kBN / 8; ++j)
                        put_pair(crow, col0 + 8 * j, s.n, pairs, d[4 * j + 2 * h], d[4 * j + 2 * h + 1], shift, first);
                }
#pragma unroll
                for (int i = 0; i < kAcc; ++i) d[i] = 0;
            });
    }
}

// planes (S, rows, k_pad) of x (rows, k) of T: plane p holds byte p of each entry (two's
// complement read as unsigned), zeros in columns k .. k_pad. A warp a row, a lane 4 entries of
// it at a time, written as one 32-bit word a plane.
constexpr int kPlaneThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kPlaneThreads)
    int_planes_kernel(const T* __restrict__ x, uint8_t* __restrict__ out, long long rows, long long k, long long k_pad) {
    using U = std::make_unsigned_t<T>;
    constexpr int S = sizeof(T);
    const long long r = (long long)blockIdx.x * (kPlaneThreads / 32) + threadIdx.x / 32;
    if (r >= rows) return;
    const long long plane = rows * k_pad;
    const T* src = x + r * k;
    uint8_t* dst = out + r * k_pad;
    for (long long q = 4 * (threadIdx.x % 32); q < k_pad; q += 4 * 32) {
        U v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = q + e < k ? static_cast<U>(src[q + e]) : U(0);
#pragma unroll
        for (int p = 0; p < S; ++p) {
            uint32_t word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) word |= static_cast<uint32_t>((v[e] >> (8 * p)) & 0xFF) << (8 * e);
            *reinterpret_cast<uint32_t*>(dst + p * plane + q) = word;
        }
    }
}

// planes (S, batch·n, k_pad) of B^T from b (batch, k, n) of T: plane p, row z·n + j, column i
// holds byte p of b[z, i, j], zeros in columns k .. k_pad. 64 x 64 tiles through shared memory
// (rows of 65 entries, so that the transposed reads spread over the banks); neighbouring
// threads read neighbouring columns of b and write neighbouring words of a plane's row.
constexpr int kPT = 64;

template <typename T>
__global__ void __launch_bounds__(kPlaneThreads)
    int_planes_t_kernel(const T* __restrict__ b, uint8_t* __restrict__ out, long long k, long long n, long long k_pad,
                        long long plane) {
    using U = std::make_unsigned_t<T>;
    constexpr int S = sizeof(T);
    __shared__ T tile[kPT][kPT + 1];
    const T* src = b + (long long)blockIdx.z * k * n;
    uint8_t* dst = out + (long long)blockIdx.z * n * k_pad;
    const long long tiles_n = (n + kPT - 1) / kPT;
    const long long n0 = (blockIdx.x % tiles_n) * kPT, k0 = (blockIdx.x / tiles_n) * kPT;
    for (int i = threadIdx.x; i < kPT * kPT; i += kPlaneThreads) {
        const int r = i / kPT, cc = i % kPT;
        const long long gk = k0 + r, gn = n0 + cc;
        tile[r][cc] = (gk < k && gn < n) ? src[gk * n + gn] : T(0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kPT * (kPT / 4); i += kPlaneThreads) {
        const int w = i % (kPT / 4), j = i / (kPT / 4);  // the word w (k0 + 4w ..) of row n0 + j
        const long long gn = n0 + j, gk = k0 + 4 * w;
        if (gn >= n || gk >= k_pad) continue;
        U v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = static_cast<U>(tile[4 * w + e][j]);
#pragma unroll
        for (int p = 0; p < S; ++p) {
            uint32_t word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) word |= static_cast<uint32_t>((v[e] >> (8 * p)) & 0xFF) << (8 * e);
            *reinterpret_cast<uint32_t*>(dst + p * plane + gn * k_pad + gk) = word;
        }
    }
}

template <int kPlanes>
int gemm(const CUtensorMap& ma, const CUtensorMap& mb, void* c, const PlaneShape& s, dim3 grid, cudaStream_t stream) {
    auto kernel = int_gemm_planes_kernel<kPlanes>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmemBytes, stream>>>(ma, mb, c, s);
    return cudaGetLastError();
}

template <typename T>
int split_rows(const void* x, void* out, long long rows, long long k, long long k_pad, cudaStream_t stream) {
    const long long blocks = (rows + kPlaneThreads / 32 - 1) / (kPlaneThreads / 32);
    if (blocks > 0x7fffffffLL) return kErrShape;
    int_planes_kernel<T><<<(unsigned)blocks, kPlaneThreads, 0, stream>>>(static_cast<const T*>(x),
                                                                        static_cast<uint8_t*>(out), rows, k, k_pad);
    return cudaGetLastError();
}

template <typename T>
int split_cols(const void* b, void* out, long long batch, long long k, long long n, long long k_pad, cudaStream_t stream) {
    const long long tiles = ((n + kPT - 1) / kPT) * ((k_pad + kPT - 1) / kPT);
    if (tiles > 0x7fffffffLL) return kErrShape;
    int_planes_t_kernel<T><<<dim3((unsigned)tiles, 1, (unsigned)batch), kPlaneThreads, 0, stream>>>(
        static_cast<const T*>(b), static_cast<uint8_t*>(out), k, n, k_pad, batch * n * k_pad);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// c (batch, m, n) of int16, int32 or int64 (planes 2, 4 or 8) from the byte planes of its
// operands: a holds `planes` planes of a_plane_rows rows of k_pad bytes, batch z's m rows of
// each from row z·a_rows_batch (0: one matrix for every batch); bt the same of B^T, n rows a
// batch; k_pad a multiple of 16 with zeros past k; both 16-byte aligned. One launch on `stream`;
// nothing is synchronised.
int int_gemm_planes_launch(int device, int planes, const void* a, const void* bt, void* c, long long batch, long long m,
                           long long n, long long k_pad, long long a_plane_rows, long long b_plane_rows,
                           long long a_rows_batch, long long b_rows_batch, void* stream) {
    if (planes != 2 && planes != 4 && planes != 8) return cudaErrorInvalidValue;
    if (batch < 1 || m < 1 || n < 1 || k_pad < 16 || k_pad % 16 != 0 || a_plane_rows < 1 || b_plane_rows < 1)
        return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(bt) % 16 != 0)
        return cudaErrorMisalignedAddress;
    const long long tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
    const long long a_rows = planes * a_plane_rows, b_rows = planes * b_plane_rows;
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
    const PlaneShape s{(int)m, (int)n, (int)((k_pad + kBK - 1) / kBK), (int)tiles_m, (int)tiles_n, (int)a_rows_batch,
                       (int)b_rows_batch, (int)a_plane_rows, (int)b_plane_rows};
    const dim3 grid((unsigned)(tiles_m * tiles_n), 1, (unsigned)batch);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (planes) {
        case 2: return gemm<2>(ma, mb, c, s, grid, st);
        case 4: return gemm<4>(ma, mb, c, s, grid, st);
        default: return gemm<8>(ma, mb, c, s, grid, st);
    }
}

// out (S, rows, k_pad) = the S byte planes of x (rows, k), contiguous entries of `elem_bytes`
// bytes (S = elem_bytes: 2, 4 or 8), zeros past k. One launch on `stream`.
int int_planes_launch(int device, int elem_bytes, const void* x, void* out, long long rows, long long k,
                      long long k_pad, void* stream) {
    if (rows < 1 || k < 1 || k_pad < k || k_pad % 16 != 0) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (elem_bytes) {
        case 2: return split_rows<int16_t>(x, out, rows, k, k_pad, st);
        case 4: return split_rows<int32_t>(x, out, rows, k, k_pad, st);
        case 8: return split_rows<int64_t>(x, out, rows, k, k_pad, st);
        default: return cudaErrorInvalidValue;
    }
}

// out (S, batch·n, k_pad) = the S byte planes of b (batch, k, n)^T, contiguous entries of
// `elem_bytes` bytes, zeros past k. One launch on `stream`.
int int_planes_t_launch(int device, int elem_bytes, const void* b, void* out, long long batch, long long k, long long n,
                        long long k_pad, void* stream) {
    if (batch < 1 || batch > 65535 || k < 1 || n < 1 || k_pad < k || k_pad % 16 != 0) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (elem_bytes) {
        case 2: return split_cols<int16_t>(b, out, batch, k, n, k_pad, st);
        case 4: return split_cols<int32_t>(b, out, batch, k, n, k_pad, st);
        case 8: return split_cols<int64_t>(b, out, batch, k, n, k_pad, st);
        default: return cudaErrorInvalidValue;
    }
}

const char* int_gemm_planes_error_string(int code) { return tc_error_string(code); }

}  // extern "C"
