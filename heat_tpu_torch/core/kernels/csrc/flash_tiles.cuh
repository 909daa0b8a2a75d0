// Tiles, fragments and products shared by the flash-attention kernels for Hopper: the
// forwards K2 (flash_attention_fwd.cu) and K3 (flash_attention_fwd_pipelined.cu) and the
// backward's K4 and K5 (flash_attention_bwd.cu). Every product is an m16n8k8 TF32 mma.sync
// in 3xTF32 (mma_tf32x3.cuh), whose fragment layouts this file follows.
//
// Tiles live in shared memory as rows of the padded head dim DP (64 or 128), their 16-byte
// chunks XOR-swizzled by row % 8 (`swz`), so that ldmatrix reads an A fragment, or the B
// fragments of two n-tiles, in one instruction without bank conflicts. They arrive through
// cp.async rings in the input type (16, 8 or 4 bytes a copy as the addresses and the row
// width allow; rows past the end zero-filled through src-size; 2-byte rows of odd d, which
// are not 4-byte aligned, copied with plain loads into the same ring), and are split once
// per block into TF32 parts as they land (`split_tile`). The head dim's padding is zeroed
// once and never copied over. A row block's own rows (q and dO in K4, k and v in K5) are
// kept as f32 (`load_own`) and split as each warp reads them; the forwards' q is split
// once in place (`load_q`).
//
// The helpers that copy or split a whole tile take its rows (ROWS) and the block's threads
// (THREADS) as template parameters: every thread of the block calls them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "mma_tf32x3.cuh"

namespace flash {

constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, heat_tpu's _NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// element (r, c) of a (rows, DP) tile of T: the 16-byte chunks of row r XOR-swizzled by r % 8
template <typename T, int DP>
__device__ __forceinline__ int swz(int r, int c) {
    constexpr int E = 16 / sizeof(T);
    static_assert(DP / E >= 8, "the swizzle needs 8 chunks a row");
    return r * DP + (((c / E) ^ (r & 7)) * E) + (c % E);
}
template <int DP>
__device__ __forceinline__ int swz4(int r, int c) {
    return swz<float, DP>(r, c);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// W bytes from global to shared memory, asynchronously; with valid false nothing is read
// and the W bytes are zero-filled (src-size 0)
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    const int n = valid ? W : 0;
    if constexpr (W == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n)
                     : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(W),
                     "r"(n)
                     : "memory");
    }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows r0 .. r0+ROWS-1 of a (n, d) matrix into a swizzled (ROWS, DP) tile, W bytes a copy
// (W divides d·sizeof(T) and the source's alignment); rows past n are zero-filled. Columns
// d .. DP-1 are never written here (zeroed once).
template <typename T, int DP, int W, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int r0, int n, int d) {
    constexpr int E = W / sizeof(T);
    const int per_row = d / E;
    for (int idx = threadIdx.x; idx < ROWS * per_row; idx += THREADS) {
        const int j = idx / per_row;
        const int c = (idx - j * per_row) * E;
        const bool in = r0 + j < n;
        cp_async<W>(dst + swz<T, DP>(j, c), in ? src + (long long)(r0 + j) * d + c : src, in);
    }
}

// the same with plain loads, for rows that are not 4-byte aligned (2-byte types, odd d)
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile_sync(T* dst, const T* src, int r0, int n, int d) {
    for (int idx = threadIdx.x; idx < ROWS * d; idx += THREADS) {
        const int j = idx / d;
        const int c = idx - j * d;
        dst[swz<T, DP>(j, c)] = (r0 + j < n) ? src[(long long)(r0 + j) * d + c] : from_f32<T>(0.f);
    }
}

// the same for rows of exactly DP values in 16-byte copies: each thread's copies known at
// compile time, with no division by a row width that is not
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile_full(T* dst, const T* src, int r0, int n) {
    constexpr int E = 16 / sizeof(T);
    constexpr int PER_ROW = DP / E;
    constexpr int N = ROWS * PER_ROW;  // copies
#pragma unroll
    for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
        const int idx = threadIdx.x + it * THREADS;
        if (N % THREADS != 0 && idx >= N) break;
        const int j = idx / PER_ROW;
        const int c = (idx % PER_ROW) * E;
        const bool in = r0 + j < n;
        cp_async<16>(dst + swz<T, DP>(j, c), in ? src + (long long)(r0 + j) * DP + c : src, in);
    }
}

// a tile by the copy width `w` the launcher chose (copy_width); rows of exactly DP values
// in 16-byte copies take copy_tile_full
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int r0, int n, int d, int w) {
    if (w == 16 && d == DP) {
        copy_tile_full<T, DP, ROWS, THREADS>(dst, src, r0, n);
    } else if (w == 16) {
        copy_tile<T, DP, 16, ROWS, THREADS>(dst, src, r0, n, d);
    } else if (w == 8) {
        copy_tile<T, DP, 8, ROWS, THREADS>(dst, src, r0, n, d);
    } else if (w == 4) {
        copy_tile<T, DP, 4, ROWS, THREADS>(dst, src, r0, n, d);
    } else {
        copy_tile_sync<T, DP, ROWS, THREADS>(dst, src, r0, n, d);
    }
}

// columns d .. DP-1 of `rows` consecutive swizzled rows of T set to zero
template <typename T, int DP, int THREADS>
__device__ __forceinline__ void zero_pad(T* dst, int rows, int d) {
    const int pad = DP - d;
    for (int idx = threadIdx.x; idx < rows * pad; idx += THREADS) {
        const int r = idx / pad;
        dst[swz<T, DP>(r, d + idx - r * pad)] = from_f32<T>(0.f);
    }
}

// The TF32 parts of a tile in shared memory: (rows, DP) words each, swizzled as f32
struct Parts {
    const uint32_t* big;
    const uint32_t* small;  // unused for 2-byte types
};

// rows r0 .. r0+ROWS-1 of a (n, d) matrix as f32 (zero past n and d), swizzled: a block's
// own rows, loaded once and split as their fragments are read
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_own(uint32_t* dst, const T* src, int r0, int n, int d) {
    for (int idx = threadIdx.x; idx < ROWS * DP / 4; idx += THREADS) {
        const int r = idx / (DP / 4);
        const int c = (idx - r * (DP / 4)) * 4;
        uint4 b;
        uint32_t* bp = &b.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x = (r0 + r < n && c + e < d) ? to_f32(src[(long long)(r0 + r) * d + c + e]) : 0.f;
            bp[e] = __float_as_uint(x);
        }
        *reinterpret_cast<uint4*>(dst + swz4<DP>(r, c)) = b;
    }
}

// a (ROWS, DP) ring tile split into TF32 parts: f32 in place (big parts over the values,
// small parts into `work`), 2-byte values widened into `work`. Returns where its parts lie.
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ Parts split_tile(T* tile, uint32_t* work) {
    for (int idx = threadIdx.x; idx < ROWS * DP / 4; idx += THREADS) {
        const int r = idx / (DP / 4);
        const int c = (idx - r * (DP / 4)) * 4;
        const int at = swz4<DP>(r, c);
        if constexpr (sizeof(T) == 4) {
            float4* p = reinterpret_cast<float4*>(tile + at);
            const float4 x = *p;
            uint4 b, s;
            tf32x3::split<false>(x.x, b.x, s.x);
            tf32x3::split<false>(x.y, b.y, s.y);
            tf32x3::split<false>(x.z, b.z, s.z);
            tf32x3::split<false>(x.w, b.w, s.w);
            *reinterpret_cast<uint4*>(p) = b;
            *reinterpret_cast<uint4*>(work + at) = s;
        } else {
            const T* h = tile + swz<T, DP>(r, c);  // 4 values within one 16-byte chunk
            *reinterpret_cast<uint4*>(work + at) = make_uint4(__float_as_uint(to_f32(h[0])), __float_as_uint(to_f32(h[1])),
                                                              __float_as_uint(to_f32(h[2])), __float_as_uint(to_f32(h[3])));
        }
    }
    if constexpr (sizeof(T) == 4) return {reinterpret_cast<const uint32_t*>(tile), work};
    else return {work, work};
}

// Fragments from swizzled f32 tiles, lane = 4·g + t (mma_tf32x3.cuh):
// the A operand over rows m0 .. m0+15 and columns k0 .. k0+7
template <int DP>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint32_t* s, int m0, int k0, int lane) {
    const int i = lane & 7;
    const int j = lane >> 3;
    tf32x3::ldmatrix_x4(a, s + swz4<DP>(m0 + i + 8 * (j & 1), k0 + 4 * (j >> 1)));
}
// the B operands of two n-tiles of a tile stored (n, k): rows n0 .. n0+7 and n0+8 .. n0+15
// are their columns, columns k0 .. k0+7 their k; b = {b0, b1} of the first, then the second
template <int DP>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const uint32_t* s, int n0, int k0, int lane) {
    const int i = lane & 7;
    const int j = lane >> 3;
    tf32x3::ldmatrix_x4(b, s + swz4<DP>(n0 + i + 8 * (j >> 1), k0 + 4 * (j & 1)));
}
// the B operands of n-tiles 2p and 2p+1 of a tile stored (k, n), k permuted as
// tf32x3::from_acc's A (rows k0 + 2t and k0 + 2t + 1 are its k t and t + 4) and the two
// n-tiles interleaved (column n of n-tile 2p + h is column 16p + 2n + h), so that each
// lane reads two adjacent words a row
template <int DP>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const uint32_t* s, int k0, int p, int g, int t) {
    const uint2 lo = *reinterpret_cast<const uint2*>(s + swz4<DP>(k0 + 2 * t, 16 * p + 2 * g));
    const uint2 hi = *reinterpret_cast<const uint2*>(s + swz4<DP>(k0 + 2 * t + 1, 16 * p + 2 * g));
    b[0] = lo.x;
    b[1] = hi.x;
    b[2] = lo.y;
    b[3] = hi.y;
}

// acc (16 × DP, columns interleaved as frag_b_kn's) += W·B for W (16 × 8·NT) in
// accumulator fragments (f32: P, or dS) and B an (8·NT, DP) tile: P·V in the forwards,
// dS·K in K4, Pᵀ·dO and dSᵀ·Q in K5
template <bool kExact, int DP, int NT>
__device__ __forceinline__ void accumulate(const float (&w)[NT][4], Parts b, int g, int t, float (&acc)[DP / 8][4]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        float f[4];
        tf32x3::from_acc(w[n], f);
        uint32_t wb[4], ws[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) tf32x3::split<false>(f[i], wb[i], ws[i]);
#pragma unroll
        for (int p = 0; p < DP / 16; ++p) {
            uint32_t bb[4], bs[4] = {};
            frag_b_kn<DP>(bb, b.big, 8 * n, p, g, t);
            if constexpr (!kExact) frag_b_kn<DP>(bs, b.small, 8 * n, p, g, t);
            tf32x3::mma3<false, kExact>(acc[2 * p], wb, ws, {bb[0], bb[1]}, {bs[0], bs[1]});
            tf32x3::mma3<false, kExact>(acc[2 * p + 1], wb, ws, {bb[2], bb[3]}, {bs[2], bs[3]});
        }
    }
}

// the column of element i of accumulator n-tile c (frag_b_kn's interleaving)
__device__ __forceinline__ int acc_col(int c, int i, int t) { return 16 * (c / 2) + 4 * t + 2 * (i & 1) + (c & 1); }

// ---------------------------------------------------------------- the forwards (K2, K3)

namespace fwd {

// The block of K2 and K3: eight warps of 16 query rows (the m16 of m16n8k8). For the head
// dim padded to DP: keys per tile, and the blocks that share an SM in registers and shared
// memory (two at d <= 64, at 128 registers a thread). Trials on the card chose this shape
// over blocks of four or six warps, tiles of 64 keys and q in registers (PERF.md).
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;
constexpr int kStages = 2;  // stages of the k and v rings

template <int DP> struct Shape;
template <> struct Shape<64> {
    static constexpr int kTile = 32;
    static constexpr int kBlocks = 2;
};
template <> struct Shape<128> {
    static constexpr int kTile = 16;
    static constexpr int kBlocks = 1;
};

// Shared memory, for the head dim padded to DP:
//   q     : the block's kRows rows as f32, split in place (big parts over the values, small
//           parts in (kRows, DP) words beside; 2-byte values are exact and only widened)
//   rings : kStages stages each of the k and the v tile as copied, in the input type,
//           (kTile, DP) each; for f32 a tile's big parts replace it in place
//   work  : (kTile, DP) words each for the k and the v tile a step reads: their small parts
//           (f32) or their values widened to f32 (2-byte types)
template <typename T, int DP>
__host__ __device__ constexpr int q_words() {
    return (sizeof(T) == 4 ? 2 : 1) * kRows * DP;
}
template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
    return 4 * q_words<T, DP>() + sizeof(T) * 2 * kStages * Shape<DP>::kTile * DP + 4 * 2 * Shape<DP>::kTile * DP;
}
static_assert(Shape<64>::kBlocks * (smem_bytes<float, 64>() + 1024) <= 233472 &&
                  Shape<128>::kBlocks * (smem_bytes<float, 128>() + 1024) <= 233472,
              "the forwards' blocks must fit an SM's shared memory");

}  // namespace fwd

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x, the MUFU.EX2 approximation (relative error about 2⁻²²; results below 2⁻¹²⁶ flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// rows r0 .. r0+kRows-1 of a (n, d) q as f32, split once in place into TF32 parts (2-byte
// values only widened): every thread of the block calls it, and the parts are in place
// when it returns
template <typename T, int DP>
__device__ __forceinline__ void load_q(uint32_t* qs, const T* src, int r0, int n, int d) {
    load_own<T, DP, fwd::kRows, fwd::kThreads>(qs, src, r0, n, d);
    __syncthreads();
    if constexpr (sizeof(T) == 4) {
        split_tile<float, DP, fwd::kRows, fwd::kThreads>(reinterpret_cast<float*>(qs), qs + fwd::kRows * DP);
        __syncthreads();
    }
}

// A warp's 16 query rows m0 .. of load_q's parts as the A operand of S = q·kᵀ, k chunk by
// k chunk: two ldmatrix a chunk (one for 2-byte q, whose small parts are 0)
template <bool kExact, int DP>
struct QRows {
    const uint32_t* qs;
    int m0, lane;
    __device__ __forceinline__ void get(int kk, uint32_t (&b)[4], uint32_t (&s)[4]) const {
        frag_a<DP>(b, qs, m0, 8 * kk, lane);
        if constexpr (kExact) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i] = 0u;
        } else {
            frag_a<DP>(s, qs + fwd::kRows * DP, m0, 8 * kk, lane);
        }
    }
};

// s (16 × 8·NT) = q·kᵀ over the padded head dim for a (8·NT, DP) k tile in parts
template <bool kExact, int DP, int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const QRows<kExact, DP>& q, Parts k, int lane) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
        uint32_t ab[4], as[4];
        q.get(kk, ab, as);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
            uint32_t bb[4], bs[4] = {};
            frag_b_nk<DP>(bb, k.big, 16 * np, 8 * kk, lane);
            if constexpr (!kExact) frag_b_nk<DP>(bs, k.small, 16 * np, 8 * kk, lane);
            tf32x3::mma3<kExact, kExact>(s[2 * np], ab, as, {bb[0], bb[1]}, {bs[0], bs[1]});
            tf32x3::mma3<kExact, kExact>(s[2 * np + 1], ab, as, {bb[2], bb[3]}, {bs[2], bs[3]});
        }
    }
}

// The online-softmax state of a thread's two rows (r_lo and r_lo + 8 of the accumulator
// layout): the output accumulator, the row maximum m (in log2 units, the whole row's) and
// this thread's part of the row sum l (its quad's four parts are added at the end)
template <int DP>
struct Rows {
    float acc[DP / 8][4];
    float m[2], l[2];
    __device__ __forceinline__ Rows() {
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
        }
        m[0] = m[1] = kNegInf;
        l[0] = l[1] = 0.f;
    }
};

// Where a key tile lies and what masks it: keys j0 .. of the block's rows row0 .. (this
// thread's r_lo, r_lo + 8)
struct TileAt {
    const float* bias;  // (tq, tk) f32 or null
    int j0, row0, r_lo, tq, tk, g, t;
    float c2;           // scale·log2(e): scores in log2 units
    bool causal;
};

// One tile of the online-softmax recurrence (heat_tpu's `_online_softmax_update`,
// flash_attention.py:135-153) on the raw products s = q·kᵀ of keys at.j0 .., then
// acc += P·V for the (8·NT, DP) v tile in parts. Scores are taken in log2 units,
// x = s·scale·log2(e) + bias·log2(e), so that P = 2^(x − m) is one MUFU.EX2. Masked scores
// get the finite NEG_INF (the causal mask, only in tiles that straddle the block's
// diagonal), keys past tk −inf (weight exactly 0); the maximum is clamped at NEG_INF/2
// (heat_tpu's m_safe), so a row masked so far keeps l = 0 and O = 0.
template <bool kExact, int DP, int NT>
__device__ __forceinline__ void softmax_pv(float (&s)[NT][4], Parts v, Rows<DP>& st, const TileAt& at) {
    const bool straddles = at.causal && at.j0 + 8 * NT - 1 > at.row0;  // flag bit 4 of _pair_schedule
    const bool ragged = at.j0 + 8 * NT > at.tk;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] *= at.c2;
    }
    if (at.bias != nullptr) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = at.r_lo + 8 * (i / 2);
                const int key = at.j0 + 8 * n + 2 * at.t + (i & 1);
                if (row < at.tq && key < at.tk) s[n][i] = fmaf(at.bias[(long long)row * at.tk + key], kLog2e, s[n][i]);
            }
        }
    }
    if (straddles || ragged) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = at.r_lo + 8 * (i / 2);
                const int key = at.j0 + 8 * n + 2 * at.t + (i & 1);
                if (straddles && key > row) s[n][i] = kNegInf;
                if (key >= at.tk) s[n][i] = -INFINITY;  // no such key
            }
        }
    }
    float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
    }
    float ms[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row's maximum over its quad, lanes 4g .. 4g+3
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        ms[h] = fmaxf(mx[h], kNegInf / 2);
        corr[h] = exp2_approx(st.m[h] - ms[h]);
        st.m[h] = mx[h];
        st.l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            s[n][i] = exp2_approx(s[n][i] - ms[i / 2]);
            st.l[i / 2] += s[n][i];
        }
    }
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st.acc[c][i] *= corr[i / 2];
    }
    accumulate<kExact, DP>(s, v, at.g, at.t, st.acc);
}

// O = acc / max(l, 1e-30) in T and LSE = max(m, NEG_INF/2) + log(max(l, 1e-30)) (natural
// units) for the thread's rows that exist, the quad's parts of l added first
template <typename T, int DP>
__device__ __forceinline__ void finalize(Rows<DP>& st, T* o, float* lse, long long bh, int r_lo, int tq, int d,
                                         int t) {
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float l = st.l[h];
        l += __shfl_xor_sync(kFull, l, 1);
        l += __shfl_xor_sync(kFull, l, 2);
        lc[h] = fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = r_lo + 8 * (i / 2);
            const int col = acc_col(c, i, t);
            if (row < tq && col < d) o[(bh * tq + row) * d + col] = from_f32<T>(st.acc[c][i] / lc[i / 2]);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = r_lo + 8 * h;
        if (t == 0 && row < tq) lse[bh * tq + row] = fmaxf(st.m[h] * kLn2, kNegInf / 2) + logf(lc[h]);
    }
}

// ---------------------------------------------------------------- host side

// the dynamic shared memory above 48 KB that `kernel` needs, opted into once per device
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, int device, std::atomic<unsigned long long>& done) {
    const unsigned long long bit = 1ull << (device & 63);
    if (bytes <= 48 * 1024 || (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
    return err;
}

// the widest copy (16, 8 or 4 bytes; 2 for plain loads) that every tensor's address and
// the row width allow
template <typename T, typename... Ptr>
int copy_width(int d, Ptr... tensors) {
    const uintptr_t bits = (reinterpret_cast<uintptr_t>(tensors) | ... | static_cast<uintptr_t>(d * sizeof(T)));
    int w = 16;
    while (w > 2 && bits % w != 0) w /= 2;
    return w;
}

}  // namespace flash
