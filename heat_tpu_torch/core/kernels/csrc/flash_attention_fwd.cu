// K2 for Hopper: the flash-attention forward.
//
// Replaces the Pallas TPU kernel heat_tpu/core/kernels/flash_attention.py:156 (`_kernel`,
// launched by `_flash_pallas`). For q (bh, tq, d) and k, v (bh, tk, d) in f32, bf16 or f16,
// and an optional additive bias (tq, tk) f32 shared by every batch·head, it writes
//   o   (bh, tq, d) in q's type : softmax(scale·q·kᵀ + bias) v, rows fully masked give 0
//   lse (bh, tq)    f32         : max(m, NEG_INF/2) + log(max(l, 1e-30)), m the row maximum
// by the online-softmax recurrence of `_online_softmax_update` (flash_attention.py:135).
// Causal attention is top-left aligned: row i attends columns j <= i, for any tq, tk.
//
// What bounds it on an H100: an attention of bh·tq·tk·d reads q, k, v and writes o once
// (a few hundred MB at the shapes of the Transformer-base forward) against 4·bh·tq·tk·d
// operations, some 1e3 operations per byte: it is bound by arithmetic. This port computes
// in full fp32 (plain FMAs, no tensor cores), so 67 TFLOP/s is its roof; bf16 and f16 inputs
// are read as such and converted to f32. The design keeps the (tq, tk) scores out of
// device memory, as the TPU kernel does, and keeps the FMA pipes fed:
//   * One block owns ROWS query rows of one batch·head and loops over tiles of BK keys;
//     each tile of k and v is staged once in shared memory (as f32) and read by every row
//     of the block. m, l and the output accumulator live in f32 registers; o and lse are
//     written once. A row is owned by TPR neighbouring threads (1 for d <= 64, 2 for
//     d <= 128), each holding 64 columns of q and of the accumulator in registers (the
//     head dim padded with zeros to DP = 64 or 128): six instances, 3 types x 2 widths.
//   * The scores of one tile are BK independent dot products per thread and the update
//     of the accumulator DP/TPR independent FMAs per key, so each thread has enough
//     independent work to hide the FMA latency at the low occupancy its registers allow.
//     All threads of a warp read the same key row of shared memory at once (a broadcast).
//   * Causal tiles wholly above the diagonal are skipped by the loop bound, not masked;
//     only the tiles that straddle the block's diagonal pay the mask (`_pair_schedule`'s
//     flag bit 4). The ragged edges of tq and tk are masked here, so any length runs.
//   * Deterministic: no reduction crosses blocks, and each row sums its keys in a fixed
//     order. Two runs give identical bits.
// Probabilities stay in f32 for p·v (the TPU kernel rounds them to v's type first), and
// exp is the accurate expf, not __expf.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with
// ctypes by heat_tpu_torch/core/kernels/flash_attention.py). Entry points return a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kThreads = 128;                    // threads per block
constexpr int kBK = 32;                          // keys per tile
constexpr float kNegInf = -FLT_MAX;              // finfo(float32).min, heat_tpu's _NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// DP: head dim padded to 64 or 128; TPR: threads per query row
__host__ __device__ constexpr int rows_per_block(int tpr) { return kThreads / tpr; }

__host__ __device__ constexpr size_t smem_bytes(int dp, int tpr, bool has_bias) {
    return sizeof(float) * (2 * kBK * dp                                        // k and v tiles
                            + (has_bias ? rows_per_block(tpr) * (kBK + 1) : 0));  // bias tile
}
// 41,216 bytes at most (d <= 128 with a bias): within the 48 KB a launch gets without
// opting in to more, so there is no cudaFuncSetAttribute call
static_assert(smem_bytes(64, 1, true) <= 48 * 1024 && smem_bytes(128, 2, true) <= 48 * 1024,
              "K2's shared memory needs cudaFuncSetAttribute");

}  // namespace

template <typename T, int DP, int TPR>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
    int tq, int tk, int d, float scale, int causal, int q_tiles) {
    constexpr int ROWS = rows_per_block(TPR);
    constexpr int DPT = DP / TPR;   // columns of one thread
    constexpr int C4 = DPT / 4;     // its float4 chunks: chunk i holds columns 4*(sub + TPR*i) ..+3
    constexpr int BS = kBK + 1;     // bias tile row stride (no bank conflicts)
    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);  // (kBK, DP)
    float* vs = ks + kBK * DP;                   // (kBK, DP)
    float* bs = vs + kBK * DP;                   // (ROWS, BS) when bias

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int sub = tid % TPR;
    const long long bh = blockIdx.x / q_tiles;
    const int row0 = (blockIdx.x % q_tiles) * ROWS;
    const int row = row0 + r;
    const bool live = row < tq;
    const T* kb = k + bh * tk * d;
    const T* vb = v + bh * tk * d;

    float qr[DPT];
    float acc[DPT];
    {
        const T* qrow = q + (bh * tq + (live ? row : 0)) * d;
#pragma unroll
        for (int i = 0; i < C4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * (sub + TPR * i) + e;
                qr[4 * i + e] = (live && c < d) ? to_f32(qrow[c]) : 0.f;
                acc[4 * i + e] = 0.f;
            }
        }
    }
    float m = kNegInf;
    float l = 0.f;

    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + kBK - 1) / kBK;
    if (causal) {
        const int last_row = min(row0 + ROWS, tq) - 1;
        tiles = min(tiles, last_row / kBK + 1);
    }

    for (int t = 0; t < tiles; ++t) {
        const int j0 = t * kBK;
        __syncthreads();  // every thread is done with the previous tile
        for (int idx = tid; idx < kBK * DP; idx += kThreads) {
            const int j = idx / DP;
            const int c = idx % DP;
            const bool in = j0 + j < tk && c < d;
            const long long off = (long long)(j0 + j) * d + c;
            ks[idx] = in ? to_f32(kb[off]) : 0.f;
            vs[idx] = in ? to_f32(vb[off]) : 0.f;
        }
        if (bias != nullptr) {
            for (int idx = tid; idx < ROWS * kBK; idx += kThreads) {
                const int rr = idx / kBK;
                const int j = idx % kBK;
                const bool in = row0 + rr < tq && j0 + j < tk;
                bs[rr * BS + j] = in ? bias[(long long)(row0 + rr) * tk + j0 + j] : 0.f;
            }
        }
        __syncthreads();

        // scores of this tile: BK independent dot products over this thread's columns
        float s[kBK];
#pragma unroll
        for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
        for (int i = 0; i < C4; ++i) {
            const int c = 4 * (sub + TPR * i);
#pragma unroll
            for (int j = 0; j < kBK; ++j) {
                const float4 kv = *reinterpret_cast<const float4*>(ks + j * DP + c);
                s[j] = fmaf(qr[4 * i + 0], kv.x, s[j]);
                s[j] = fmaf(qr[4 * i + 1], kv.y, s[j]);
                s[j] = fmaf(qr[4 * i + 2], kv.z, s[j]);
                s[j] = fmaf(qr[4 * i + 3], kv.w, s[j]);
            }
        }
        if (TPR > 1) {
#pragma unroll
            for (int j = 0; j < kBK; ++j) {
#pragma unroll
                for (int off = 1; off < TPR; off <<= 1) s[j] += __shfl_xor_sync(kFull, s[j], off);
            }
        }
        const bool straddles = causal && j0 + kBK - 1 > row0;  // flag bit 4 of _pair_schedule
        const bool ragged = j0 + kBK > tk;
        float m_blk = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK; ++j) {
            float x = s[j] * scale;
            if (bias != nullptr) x += bs[r * BS + j];
            if (straddles && j0 + j > row) x = kNegInf;
            if (ragged && j0 + j >= tk) x = -INFINITY;  // no such key: weight exactly 0
            s[j] = x;
            m_blk = fmaxf(m_blk, x);
        }
        const float m_new = fmaxf(m, m_blk);
        // rows masked so far keep finite exps: their l stays 0 and their output 0
        const float m_safe = fmaxf(m_new, kNegInf / 2);
        const float corr = expf(m - m_safe);
        float l_blk = 0.f;
#pragma unroll
        for (int j = 0; j < kBK; ++j) {
            s[j] = expf(s[j] - m_safe);
            l_blk += s[j];
        }
        l = l * corr + l_blk;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[c] *= corr;
#pragma unroll
        for (int j = 0; j < kBK; ++j) {
#pragma unroll
            for (int i = 0; i < C4; ++i) {
                const float4 vv = *reinterpret_cast<const float4*>(vs + j * DP + 4 * (sub + TPR * i));
                acc[4 * i + 0] = fmaf(s[j], vv.x, acc[4 * i + 0]);
                acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
                acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
                acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
            }
        }
        m = m_new;
    }

    if (live) {
        const float lc = fmaxf(l, 1e-30f);
        T* orow = o + (bh * tq + row) * d;
#pragma unroll
        for (int i = 0; i < C4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * (sub + TPR * i) + e;
                if (c < d) orow[c] = from_f32<T>(acc[4 * i + e] / lc);
            }
        }
        if (sub == 0) lse[bh * tq + row] = fmaxf(m, kNegInf / 2) + logf(lc);
    }
}

namespace {

template <typename T, int DP, int TPR>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
                   int bh, int tq, int tk, int d, float scale, int causal, cudaStream_t stream) {
    constexpr int ROWS = rows_per_block(TPR);
    const size_t smem = smem_bytes(DP, TPR, bias != nullptr);
    const int q_tiles = (tq + ROWS - 1) / ROWS;
    const long long blocks = (long long)bh * q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    flash_attention_fwd_kernel<T, DP, TPR><<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<T*>(o), lse, tq, tk, d, scale, causal, q_tiles);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
                     int bh, int tq, int tk, int d, float scale, int causal, cudaStream_t stream) {
    if (d <= 64) return launch<T, 64, 1>(q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, stream);
    return launch<T, 128, 2>(q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. q (bh, tq, d), k and v (bh, tk, d) contiguous in
// that type, bias (tq, tk) f32 contiguous or null, o (bh, tq, d) and lse (bh, tq) f32
// allocated by the caller; 1 <= d <= 128. The kernel runs on `stream`; nothing is
// synchronised.
int flash_attention_fwd_launch(int device, int dtype, const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int bh, int tq, int tk, int d,
                               float scale, int causal, void* stream) {
    if (d < 1 || d > 128 || bh < 1 || tq < 1 || tk < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_d<float>(q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, s);
        case 1: return launch_d<__nv_bfloat16>(q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, s);
        case 2: return launch_d<__half>(q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, s);
        default: return cudaErrorInvalidValue;
    }
}

const char* flash_attention_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
