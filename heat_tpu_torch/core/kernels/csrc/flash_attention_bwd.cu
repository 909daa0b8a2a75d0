// The flash-attention backward for Hopper: the D pass, K4 (dQ) and K5 (dK, dV).
//
// Replaces the TPU kernels of heat_tpu/core/kernels/flash_attention.py: `_dq_kernel` (:422)
// and `_dkv_kernel` (:480), both launched by `_flash_bwd_pallas` (:578), and the jnp D
// pre-pass there (:592-596). For q, dO (bh, tq, d) and k, v (bh, tk, d) in f32, bf16 or f16,
// the forward's LSE (bh, tq) f32 and an optional additive bias (tq, tk) f32 shared by every
// batch·head, with s = scale·q·kᵀ + bias (causal: NEG_INF where key > query, top-left
// aligned for any tq, tk) and P = exp(s − LSE):
//   D pass : D_i  = Σ_c dO_ic·O_ic                                 (bh, tq) f32
//   K4     : dQ_i = scale·Σ_j dS_ij k_j,    dS = P∘(dO·vᵀ − D)      (bh, tq, d) in q's type
//   K5     : dK_j = scale·Σ_i dS_ij q_i,    dV_j = Σ_i P_ij dO_i    (bh, tk, d) in k's type
// P is recomputed exactly as the forward formed s (K2, flash_attention_fwd.cu): the product
// times scale, then the bias, masked scores at the finite NEG_INF (-FLT_MAX), never -inf. A
// fully masked row has LSE = NEG_INF/2 + log(1e-30) and O = 0, so its P is 0, its D is 0,
// its dQ is 0 and it adds nothing to dK and dV: inf − inf never occurs.
//
// What bounds them on an H100: K4 does 6·d operations per attended (query, key) pair
// (q·kᵀ, dO·vᵀ, dS·k) and K5 8·d (q·kᵀ, dO·vᵀ, dSᵀ·q, Pᵀ·dO) against a few hundred MB of
// inputs and outputs at the Transformer's shapes: both are bound by arithmetic, at the fp32
// rate of 67 TFLOP/s, since they compute in full fp32 (plain FMAs, accurate expf, no tensor
// cores). The D pass reads O and dO once and writes one float per row: it is bound by bytes.
// The design keeps the (tq, tk) scores out of device memory and every sum inside one block:
//   * K4 owns ROWS query rows of one batch·head and loops over the tiles of kTile keys that
//     those rows attend (`_pair_schedule`'s bound); K5 owns ROWS key rows and loops over the
//     tiles of kTile queries that attend them (`_pair_schedule_kv`'s bound). A tile of the
//     other side (k and v for K4; q, dO, LSE and D for K5) is staged once in shared memory
//     as f32 and read by every row of the block, all threads of a warp reading the same
//     tile row at once. Nothing is reduced across blocks and there are no atomics, so two
//     runs give identical bits; K5 writes its zeros itself for key rows that no query
//     attends (causal with tk > tq, flag bit 8 of `_pair_schedule_kv`).
//   * Registers are the scarce resource: a row's own vectors (q, dO and dQ in K4; k, v, dK
//     and dV in K5) live in them for the whole loop. A row is therefore owned by TPR
//     neighbouring threads, each holding 16 of its columns (head dim padded with zeros to
//     DP = 64 or 128, TPR = 4 or 8), and the two dot products of each (row, tile row) pair
//     are finished by butterfly shuffles among those TPR lanes. A tile is walked kSub rows
//     at a time: with all 32 at once the unrolled loads spilled kilobytes per thread, with
//     8 K5 still spilled hundreds of bytes; 2 keeps the spills to a few bytes (ptxas, as
//     chip_smoke.py's build phase prints it).
//   * Causal tiles wholly on the masked side are skipped by the loop bounds; only tiles
//     that straddle the diagonal pay the mask (flag bit 4). Ragged tq and tk are masked here.
// dS and P stay in f32 for the products (the TPU kernels round dS to k's type and P to dO's
// type first). Shared memory stays under the 48 KB a launch gets without an opt-in.
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

constexpr int kThreads = 128;        // threads per block of K4 and K5
constexpr int kTile = 32;            // keys per tile in K4, queries per tile in K5
constexpr int kSub = 2;              // tile rows per step of the loop over a tile
constexpr int kCols = 16;            // head-dim columns each thread holds
constexpr int kDWarps = 8;           // rows (one warp each) per block of the D pass
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, heat_tpu's _NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// DP: head dim padded to 64 or 128; TPR = DP / kCols threads per row
__host__ __device__ constexpr int tpr_of(int dp) { return dp / kCols; }
__host__ __device__ constexpr int rows_of(int dp) { return kThreads / tpr_of(dp); }

__host__ __device__ constexpr size_t dq_smem_bytes(int dp, bool has_bias) {
    return sizeof(float) * (2 * kTile * dp                                 // k and v tiles
                            + (has_bias ? rows_of(dp) * (kTile + 1) : 0));  // bias tile
}
__host__ __device__ constexpr size_t dkv_smem_bytes(int dp, bool has_bias) {
    return sizeof(float) * (2 * kTile * dp + 2 * kTile                      // q, dO tiles, LSE, D
                            + (has_bias ? kTile * (rows_of(dp) + 1) : 0));  // bias tile
}
// 34,944 bytes at most (d <= 128 with a bias): no cudaFuncSetAttribute call is needed
static_assert(dq_smem_bytes(128, true) <= 48 * 1024 && dkv_smem_bytes(128, true) <= 48 * 1024 &&
                  dq_smem_bytes(64, true) <= 48 * 1024 && dkv_smem_bytes(64, true) <= 48 * 1024,
              "the backward's shared memory needs cudaFuncSetAttribute");

// this thread's kCols columns of a row (chunk i holds columns 4*(sub + TPR*i) .. +3),
// zero beyond d or for a row that does not exist
template <typename T, int TPR>
__device__ __forceinline__ void load_row(const T* row, bool live, int sub, int d, float (&out)[kCols]) {
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = 4 * (sub + TPR * i) + e;
            out[4 * i + e] = (live && c < d) ? to_f32(row[c]) : 0.f;
        }
    }
}

template <typename T, int TPR>
__device__ __forceinline__ void store_row(T* row, int sub, int d, const float (&v)[kCols], float mul) {
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = 4 * (sub + TPR * i) + e;
            if (c < d) row[c] = from_f32<T>(v[4 * i + e] * mul);
        }
    }
}

// stage rows [r0, r0 + kTile) of a (n, d) matrix into smem (kTile, DP) as f32, zero-padded
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int r0, int n, int d, float* dst) {
    for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
        const int j = idx / DP;
        const int c = idx % DP;
        dst[idx] = (r0 + j < n && c < d) ? to_f32(src[(long long)(r0 + j) * d + c]) : 0.f;
    }
}

// a (own row) · b (tile row j) and c (own row) · e (tile row j) for the kSub rows j of a
// step, summed over this thread's columns and then over the row's TPR lanes
template <int DP, int TPR>
__device__ __forceinline__ void tile_dots(const float (&a)[kCols], const float* __restrict__ bs,
                                          const float (&c)[kCols], const float* __restrict__ es, int sub,
                                          float (&ab)[kSub], float (&ce)[kSub]) {
#pragma unroll
    for (int j = 0; j < kSub; ++j) ab[j] = ce[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
        const int col = 4 * (sub + TPR * i);
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(bs + j * DP + col);
            const float4 e = *reinterpret_cast<const float4*>(es + j * DP + col);
            ab[j] = fmaf(a[4 * i + 0], b.x, ab[j]);
            ab[j] = fmaf(a[4 * i + 1], b.y, ab[j]);
            ab[j] = fmaf(a[4 * i + 2], b.z, ab[j]);
            ab[j] = fmaf(a[4 * i + 3], b.w, ab[j]);
            ce[j] = fmaf(c[4 * i + 0], e.x, ce[j]);
            ce[j] = fmaf(c[4 * i + 1], e.y, ce[j]);
            ce[j] = fmaf(c[4 * i + 2], e.z, ce[j]);
            ce[j] = fmaf(c[4 * i + 3], e.w, ce[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) {
            ab[j] += __shfl_xor_sync(kFull, ab[j], off);
            ce[j] += __shfl_xor_sync(kFull, ce[j], off);
        }
    }
}

// acc += Σ_j w[j] · tile row j over the kSub rows of a step, on this thread's columns
template <int DP, int TPR>
__device__ __forceinline__ void tile_axpy(const float (&w)[kSub], const float* __restrict__ ts, int sub,
                                          float (&acc)[kCols]) {
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
#pragma unroll
        for (int i = 0; i < kCols / 4; ++i) {
            const float4 t = *reinterpret_cast<const float4*>(ts + j * DP + 4 * (sub + TPR * i));
            acc[4 * i + 0] = fmaf(w[j], t.x, acc[4 * i + 0]);
            acc[4 * i + 1] = fmaf(w[j], t.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(w[j], t.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(w[j], t.w, acc[4 * i + 3]);
        }
    }
}

}  // namespace

// D_i = Σ_c dO_ic·O_ic: one warp per row, lanes over columns, a fixed butterfly order
template <typename T>
__global__ void __launch_bounds__(kDWarps * 32) flash_attention_bwd_d_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dd, long long rows, int d) {
    const long long row = (long long)blockIdx.x * kDWarps + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const T* orow = o + row * d;
    const T* grow = dout + row * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(grow[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) dd[row] = acc;
}

// K4: dQ for ROWS query rows of one batch·head
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const float* __restrict__ bias,
    T* __restrict__ dq, int tq, int tk, int d, float scale, int causal, int q_tiles) {
    constexpr int TPR = tpr_of(DP);
    constexpr int ROWS = rows_of(DP);
    constexpr int BS = kTile + 1;  // bias tile row stride (no bank conflicts)
    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);  // (kTile, DP)
    float* vs = ks + kTile * DP;                 // (kTile, DP)
    float* bs = vs + kTile * DP;                 // (ROWS, BS) when bias

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int sub = tid % TPR;
    const long long bh = blockIdx.x / q_tiles;
    const int row0 = (blockIdx.x % q_tiles) * ROWS;
    const int row = row0 + r;
    const bool live = row < tq;
    const long long qoff = (bh * tq + (live ? row : 0)) * d;
    const T* kb = k + bh * tk * d;
    const T* vb = v + bh * tk * d;

    float qr[kCols], gr[kCols], acc[kCols];
    load_row<T, TPR>(q + qoff, live, sub, d, qr);
    load_row<T, TPR>(dout + qoff, live, sub, d, gr);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    const float lse_r = live ? lse[bh * tq + row] : 0.f;
    const float d_r = live ? dd[bh * tq + row] : 0.f;

    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + kTile - 1) / kTile;
    if (causal) {
        const int last_row = min(row0 + ROWS, tq) - 1;
        tiles = min(tiles, last_row / kTile + 1);
    }

    for (int t = 0; t < tiles; ++t) {
        const int j0 = t * kTile;
        __syncthreads();  // every thread is done with the previous tile
        stage_tile<T, DP>(kb, j0, tk, d, ks);
        stage_tile<T, DP>(vb, j0, tk, d, vs);
        if (bias != nullptr) {
            for (int idx = tid; idx < ROWS * kTile; idx += kThreads) {
                const int rr = idx / kTile;
                const int j = idx % kTile;
                const bool in = row0 + rr < tq && j0 + j < tk;
                bs[rr * BS + j] = in ? bias[(long long)(row0 + rr) * tk + j0 + j] : 0.f;
            }
        }
        __syncthreads();

        const bool straddles = causal && j0 + kTile - 1 > row0;  // flag bit 4 of _pair_schedule
        const bool ragged = j0 + kTile > tk;
        // kSub keys a step, so that the scores, products and loads in flight fit the registers
#pragma unroll 1
        for (int js = 0; js < kTile; js += kSub) {
            float s[kSub], dp[kSub];
            tile_dots<DP, TPR>(qr, ks + js * DP, gr, vs + js * DP, sub, s, dp);
#pragma unroll
            for (int jj = 0; jj < kSub; ++jj) {
                const int j = j0 + js + jj;
                float x = s[jj] * scale;
                if (bias != nullptr) x += bs[r * BS + js + jj];
                if (straddles && j > row) x = kNegInf;
                float p = expf(x - lse_r);
                if (ragged && j >= tk) p = 0.f;  // no such key
                s[jj] = p * (dp[jj] - d_r);      // dS
            }
            tile_axpy<DP, TPR>(s, ks + js * DP, sub, acc);
        }
    }

    if (live) store_row<T, TPR>(dq + qoff, sub, d, acc, scale);
}

// K5: dK and dV for ROWS key rows of one batch·head
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const float* __restrict__ bias,
    T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int d, float scale, int causal, int k_tiles) {
    constexpr int TPR = tpr_of(DP);
    constexpr int ROWS = rows_of(DP);
    constexpr int BS = ROWS + 1;  // bias tile row stride
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);  // (kTile, DP)
    float* gs = qs + kTile * DP;                 // (kTile, DP): dO
    float* ls = gs + kTile * DP;                 // (kTile): LSE
    float* ds = ls + kTile;                      // (kTile): D
    float* bs = ds + kTile;                      // (kTile, BS) when bias: bias[query][key]

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int sub = tid % TPR;
    const long long bh = blockIdx.x / k_tiles;
    const int row0 = (blockIdx.x % k_tiles) * ROWS;
    const int key = row0 + r;
    const bool live = key < tk;
    const long long koff = (bh * tk + (live ? key : 0)) * d;
    const T* qb = q + bh * tq * d;
    const T* gb = dout + bh * tq * d;

    float kr[kCols], vr[kCols], dka[kCols], dva[kCols];
    load_row<T, TPR>(k + koff, live, sub, d, kr);
    load_row<T, TPR>(v + koff, live, sub, d, vr);
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[c] = dva[c] = 0.f;

    // causal: query i attends key j iff i >= j, so the first query tile to visit holds
    // query row0; when row0 >= tq no query attends the block and the loop is empty
    const int tiles = (tq + kTile - 1) / kTile;
    const int t0 = causal ? row0 / kTile : 0;

    for (int t = t0; t < tiles; ++t) {
        const int i0 = t * kTile;
        __syncthreads();  // every thread is done with the previous tile
        stage_tile<T, DP>(qb, i0, tq, d, qs);
        stage_tile<T, DP>(gb, i0, tq, d, gs);
        if (tid < kTile) {
            const bool in = i0 + tid < tq;
            ls[tid] = in ? lse[bh * tq + i0 + tid] : 0.f;
            ds[tid] = in ? dd[bh * tq + i0 + tid] : 0.f;
        }
        if (bias != nullptr) {
            for (int idx = tid; idx < kTile * ROWS; idx += kThreads) {
                const int i = idx / ROWS;
                const int rr = idx % ROWS;
                const bool in = i0 + i < tq && row0 + rr < tk;
                bs[i * BS + rr] = in ? bias[(long long)(i0 + i) * tk + row0 + rr] : 0.f;
            }
        }
        __syncthreads();

        const bool straddles = causal && row0 + ROWS - 1 > i0;  // flag bit 4 of _pair_schedule_kv
        const bool ragged = i0 + kTile > tq;
#pragma unroll 1
        for (int is = 0; is < kTile; is += kSub) {
            float s[kSub], dp[kSub];
            tile_dots<DP, TPR>(kr, qs + is * DP, vr, gs + is * DP, sub, s, dp);
#pragma unroll
            for (int ii = 0; ii < kSub; ++ii) {
                const int i = i0 + is + ii;
                float x = s[ii] * scale;
                if (bias != nullptr) x += bs[(is + ii) * BS + r];
                if (straddles && key > i) x = kNegInf;
                float p = expf(x - ls[is + ii]);
                if (ragged && i >= tq) p = 0.f;         // no such query
                s[ii] = p;                               // P
                dp[ii] = p * (dp[ii] - ds[is + ii]);     // dS
            }
            tile_axpy<DP, TPR>(dp, qs + is * DP, sub, dka);
            tile_axpy<DP, TPR>(s, gs + is * DP, sub, dva);
        }
    }

    // written for every key row of the block, zeros where no query attends it
    if (live) {
        store_row<T, TPR>(dk + koff, sub, d, dka, scale);
        store_row<T, TPR>(dv + koff, sub, d, dva, 1.f);
    }
}

namespace {

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dd, const float* bias, void* dq, int bh, int tq, int tk, int d, float scale,
                      int causal, cudaStream_t stream) {
    const int q_tiles = (tq + rows_of(DP) - 1) / rows_of(DP);
    const long long blocks = (long long)bh * q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    flash_attention_bwd_dq_kernel<T, DP><<<(unsigned)blocks, kThreads, dq_smem_bytes(DP, bias != nullptr), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, dd, bias, static_cast<T*>(dq), tq, tk, d, scale, causal, q_tiles);
    return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, const float* bias, void* dk, void* dv, int bh, int tq, int tk, int d,
                       float scale, int causal, cudaStream_t stream) {
    const int k_tiles = (tk + rows_of(DP) - 1) / rows_of(DP);
    const long long blocks = (long long)bh * k_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    flash_attention_bwd_dkv_kernel<T, DP><<<(unsigned)blocks, kThreads, dkv_smem_bytes(DP, bias != nullptr), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, dd, bias, static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, scale, causal, k_tiles);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* o, const void* dout, float* dd, long long rows, int d, cudaStream_t stream) {
    const long long blocks = (rows + kDWarps - 1) / kDWarps;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    flash_attention_bwd_d_kernel<T><<<(unsigned)blocks, kDWarps * 32, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), dd, rows, d);
    return cudaGetLastError();
}

cudaError_t check(int device, int d, int bh, int tq, int tk) {
    if (d < 1 || d > 128 || bh < 1 || tq < 1 || tk < 1) return cudaErrorInvalidValue;
    return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. o and dout (rows, d) contiguous in that type,
// dd (rows) f32 allocated by the caller. Runs on `stream`; nothing is synchronised.
int flash_attention_bwd_d_launch(int device, int dtype, const void* o, const void* dout, float* dd,
                                 long long rows, int d, void* stream) {
    if (d < 1 || rows < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_d<float>(o, dout, dd, rows, d, s);
        case 1: return launch_d<__nv_bfloat16>(o, dout, dd, rows, d, s);
        case 2: return launch_d<__half>(o, dout, dd, rows, d, s);
        default: return cudaErrorInvalidValue;
    }
}

// q and dout (bh, tq, d), k and v (bh, tk, d) contiguous in the type `dtype`; lse and dd
// (bh, tq) f32; bias (tq, tk) f32 contiguous or null; dq (bh, tq, d) allocated by the
// caller; 1 <= d <= 128.
int flash_attention_bwd_dq_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* dd, const float* bias, void* dq,
                                  int bh, int tq, int tk, int d, float scale, int causal, void* stream) {
    cudaError_t err = check(device, d, bh, tq, tk);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool wide = d > 64;
#define HT_DQ(T) (wide ? launch_dq<T, 128>(q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal, s) \
                       : launch_dq<T, 64>(q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal, s))
    switch (dtype) {
        case 0: return HT_DQ(float);
        case 1: return HT_DQ(__nv_bfloat16);
        case 2: return HT_DQ(__half);
        default: return cudaErrorInvalidValue;
    }
#undef HT_DQ
}

// as flash_attention_bwd_dq_launch; dk and dv (bh, tk, d) allocated by the caller, every
// element written
int flash_attention_bwd_dkv_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* dd, const float* bias,
                                   void* dk, void* dv, int bh, int tq, int tk, int d, float scale, int causal,
                                   void* stream) {
    cudaError_t err = check(device, d, bh, tq, tk);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool wide = d > 64;
#define HT_DKV(T) (wide ? launch_dkv<T, 128>(q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale, causal, s) \
                        : launch_dkv<T, 64>(q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale, causal, s))
    switch (dtype) {
        case 0: return HT_DKV(float);
        case 1: return HT_DKV(__nv_bfloat16);
        case 2: return HT_DKV(__half);
        default: return cudaErrorInvalidValue;
    }
#undef HT_DKV
}

const char* flash_attention_bwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
