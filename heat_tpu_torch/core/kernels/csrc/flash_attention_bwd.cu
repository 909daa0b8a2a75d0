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
// (dQ, dK and dV in f32 through the `_f32_launch` entry points).
// P is recomputed from the scores as the forward forms them (K2, flash_attention_fwd.cu), in
// natural units: the product times scale, then the bias, masked scores at the finite
// NEG_INF (-FLT_MAX), never -inf. A fully masked row has LSE = NEG_INF/2 + log(1e-30) and
// O = 0, so its P is 0, its D is 0, its dQ is 0 and it adds nothing to dK and dV: inf − inf
// never occurs.
//
// Products in 3xTF32 on the tensor cores (mma_tf32x3.cuh), on tiles, fragments and
// products shared with the forwards (flash_tiles.cuh): each f32 operand splits into a
// TF32 big part and a TF32 residual, and a·b is taken as small·big + big·small + big·big
// with f32 accumulation. The dropped small·small term is below 2⁻²² of |a·b|, so the
// products keep fp32's level of accuracy, P and dS included: they stay f32 and split like
// any operand (the TPU kernels round them to the input type first). bf16 and f16 inputs are
// exact in TF32, so their instances skip the products with a zero small part: one product
// for q·kᵀ and dO·vᵀ, two for those with P or dS.
//
// What bounds them on an H100: K4 does 6·d operations per attended (query, key) pair
// (q·kᵀ, dO·vᵀ, dS·k) and K5 8·d (q·kᵀ, dO·vᵀ, dSᵀ·q, Pᵀ·dO) against a few hundred MB of
// inputs and outputs at the Transformer's shapes: both are bound by arithmetic, at the
// 3xTF32 rate of 495/3 = 165 TFLOP/s for f32 (the fp32 FMA pipe's 67 TFLOP/s is the bound
// of a kernel without tensor cores) and, for 2-byte inputs, at the bf16 rate of 989 (their
// products run here at the TF32 rate of 495, one or two per product). What holds mma.sync
// below that rate is the work that feeds it (loading fragments, splitting every f32 value,
// the softmax in between, two barriers a tile) and the warps there are to hide its
// latency: in trials on the card, the time fell as the warps an SM rose from four to
// eight to twelve, the last step gained at the non-causal shapes and lost some at the
// causal one (PERF.md, PR 5). The D pass reads O and dO once
// and writes one float per row: it is bound by bytes. The design:
//   * K4 owns 96 query rows of one batch·head (6 warps of 16: one m16 row block each) and
//     loops over the tiles of 32 keys they attend (`_pair_schedule`'s bound); K5 owns 96
//     key rows and loops over the tiles of 32 queries that attend them
//     (`_pair_schedule_kv`'s). S and dP of a tile and the accumulators (dQ; dK and dV) stay
//     in registers. Nothing is reduced across blocks and there are no atomics: every sum
//     has a fixed order and two runs give identical bits. K5 writes its zeros itself for key
//     rows that no query attends (causal with tk > tq, flag bit 8 of `_pair_schedule_kv`).
//     K4 launches its longest causal blocks first.
//   * Shared memory is what limits the warps on an SM, so the block's own rows (q and dO in
//     K4, k and v in K5) are kept once as f32 and split as each warp reads its fragments,
//     while each tile of the other side (k and v; q and dO), read by every warp, is split
//     once as it lands: f32 in place (big parts over the values, small parts beside),
//     2-byte values only widened (they are exact in TF32). 96 KB a block (f32, d <= 64)
//     lets two blocks, twelve warps, share an SM.
//   * The tiles come through a cp.async ring of two stages in the input type (LSE and D
//     beside them in K5): the next tile's copies are issued after the barrier that opens a
//     step and land while the step splits and computes, two barriers a step. Copies are 16,
//     8 or 4 bytes as the addresses and the row width allow, rows past the end are
//     zero-filled through src-size, and 2-byte rows of odd d (not 4-byte aligned) are
//     copied with plain loads. The head dim is padded to DP = 64 or 128 with zeros.
//   * Fragments: a row's 16-byte chunks are XOR-swizzled by row % 8, so ldmatrix reads an A
//     fragment, or the B fragments of two n-tiles, in one instruction without bank
//     conflicts. S and dP (Sᵀ and dPᵀ in K5) become P and dS in the accumulator registers
//     and feed straight back as the A operand of dS·k (Pᵀ·dO and dSᵀ·q): read with the k
//     index permuted within each 8-wide chunk, an accumulator fragment is an A fragment
//     (tf32x3::from_acc). The B operand of those products is then read down the columns;
//     with two n-tiles' columns interleaved, each lane reads two adjacent words a row, and
//     a thread's four output columns per 16 are adjacent.
//   * Causal tiles wholly on the masked side are skipped by the loop bounds; only tiles that
//     straddle the diagonal pay the mask (flag bit 4). Ragged tq and tk are masked here.
// Shared memory above 48 KB (96 KB f32 and 80 KB 2-byte at d <= 64, 192 KB and 160 KB at
// d <= 128) is opted into once per instance and device (cudaFuncSetAttribute).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with
// ctypes by heat_tpu_torch/core/kernels/flash_attention.py). Entry points return a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "flash_tiles.cuh"

using namespace flash;

namespace {

constexpr int kWarps = 6;              // warps per block of K4 and K5: two blocks fill an SM
constexpr int kThreads = 32 * kWarps;  // threads per block of K4 and K5
constexpr int kRows = 16 * kWarps;     // query rows of a K4 block, key rows of a K5 block
constexpr int kTile = 32;              // keys per tile in K4, queries per tile in K5
constexpr int kStages = 2;             // stages of the ring
constexpr int kDWarps = 8;             // rows (one warp each) per block of the D pass

// Shared memory of K4 (K5 in brackets), for the head dim padded to DP:
//   own   : q and dO (k and v) of the block's kRows rows as f32, (kRows, DP) words each
//   ring  : kStages stages of the k and v (q and dO) tiles as copied, in the input type,
//           (kTile, DP) each; for f32 a tile's big parts replace it in place
//   work  : (kTile, DP) words each for the current tile's k and v (q and dO): their small
//           parts (f32) or their values widened to f32 (2-byte types)
//   [K5]  : kStages stages of LSE and D, kTile floats each
// 96 KB for f32 and d <= 64 (K5: 96.5 KB), so two blocks (12 warps) share an SM.
__host__ __device__ constexpr int kOwnWords(int dp) { return 2 * kRows * dp; }
template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes(bool dkv) {
    return 4 * kOwnWords(DP) + sizeof(T) * 2 * kStages * kTile * DP + 4 * 2 * kTile * DP +
           (dkv ? 4 * 2 * kStages * kTile : 0);
}
static_assert(smem_bytes<float, 128>(true) <= 232448, "the backward's shared memory exceeds an H100 block's");

// entries i0 .. i0+kTile-1 of a per-row f32 vector, 0 past n
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int i0, int n) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool in = i0 + i < n;
        cp_async<4>(dst + i, in ? src + i0 + i : src, in);
    }
}

// X (16 × kTile) = A·Bᵀ and Y = C·Eᵀ over the padded head dim, for A and C rows m0.. of the
// block's own (kRows, DP) f32 tiles, split as they are read, and B and E (kTile, DP) tiles
// in parts: S and dP in K4, Sᵀ and dPᵀ in K5
template <bool kExact, int DP>
__device__ __forceinline__ void two_products(const uint32_t* a, Parts b, const uint32_t* c, Parts e, int m0,
                                             int lane, float (&x)[kTile / 8][4], float (&y)[kTile / 8][4]) {
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[n][i] = y[n][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
        uint32_t ab[4], as[4] = {}, cb[4], cs[4] = {};
        frag_a<DP>(ab, a, m0, 8 * kk, lane);
        frag_a<DP>(cb, c, m0, 8 * kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            tf32x3::split<kExact>(__uint_as_float(ab[i]), ab[i], as[i]);
            tf32x3::split<kExact>(__uint_as_float(cb[i]), cb[i], cs[i]);
        }
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
            uint32_t bb[4], bs[4] = {};
            frag_b_nk<DP>(bb, b.big, 16 * np, 8 * kk, lane);
            if constexpr (!kExact) frag_b_nk<DP>(bs, b.small, 16 * np, 8 * kk, lane);
            tf32x3::mma3<kExact, kExact>(x[2 * np], ab, as, {bb[0], bb[1]}, {bs[0], bs[1]});
            tf32x3::mma3<kExact, kExact>(x[2 * np + 1], ab, as, {bb[2], bb[3]}, {bs[2], bs[3]});
            frag_b_nk<DP>(bb, e.big, 16 * np, 8 * kk, lane);
            if constexpr (!kExact) frag_b_nk<DP>(bs, e.small, 16 * np, 8 * kk, lane);
            tf32x3::mma3<kExact, kExact>(y[2 * np], cb, cs, {bb[0], bb[1]}, {bs[0], bs[1]});
            tf32x3::mma3<kExact, kExact>(y[2 * np + 1], cb, cs, {bb[2], bb[3]}, {bs[2], bs[3]});
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


// element `off` of an output, in T, or in f32 for a caller that sums blocks' gradients
// (the ring attentions), so they round once, at the end
template <typename T>
__device__ __forceinline__ void store_out(void* out, long long off, float x, int out_f32) {
    if (out_f32) {
        static_cast<float*>(out)[off] = x;
    } else {
        static_cast<T*>(out)[off] = from_f32<T>(x);
    }
}

// K4: dQ for kRows query rows of one batch·head
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const float* __restrict__ bias,
    void* __restrict__ dq, int tq, int tk, int d, float scale, int causal, int q_tiles, int copy_bytes, int out_f32) {
    constexpr bool kExact = sizeof(T) == 2;
    constexpr int NT = kTile / 8;
    constexpr int DT = DP / 8;
    constexpr int kOwn = kRows * DP;
    extern __shared__ float4 smem4[];
    uint32_t* own = reinterpret_cast<uint32_t*>(smem4);  // q, dO as f32
    T* ring = reinterpret_cast<T*>(own + kOwnWords(DP));  // kStages x (k, v) tiles
    uint32_t* work = reinterpret_cast<uint32_t*>(ring + 2 * kStages * kTile * DP);  // k, v parts

    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int m0 = (threadIdx.x / 32) * 16;  // the warp's rows in the block
    const long long bh = blockIdx.x / q_tiles;
    const int row0 = (q_tiles - 1 - (int)(blockIdx.x % q_tiles)) * kRows;  // the longest causal blocks first
    const int r_lo = row0 + m0 + g;                                         // this thread's rows: r_lo, r_lo + 8
    const T* kb = k + bh * tk * d;
    const T* vb = v + bh * tk * d;

    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + kTile - 1) / kTile;
    if (causal) tiles = min(tiles, (min(row0 + kRows, tq) - 1) / kTile + 1);

    zero_pad<T, DP, kThreads>(ring, 2 * kStages * kTile, d);
    copy_rows<T, DP, kTile, kThreads>(ring, kb, 0, tk, d, copy_bytes);
    copy_rows<T, DP, kTile, kThreads>(ring + kTile * DP, vb, 0, tk, d, copy_bytes);
    cp_async_commit();
    load_own<T, DP, kRows, kThreads>(own, q + bh * tq * d, row0, tq, d);
    load_own<T, DP, kRows, kThreads>(own + kOwn, dout + bh * tq * d, row0, tq, d);

    float lse_r[2], d_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = r_lo + 8 * h;
        lse_r[h] = row < tq ? lse[bh * tq + row] : 0.f;
        d_r[h] = row < tq ? dd[bh * tq + row] : 0.f;
    }
    float acc[DT][4];
#pragma unroll
    for (int c = 0; c < DT; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
    }

    for (int it = 0; it < tiles; ++it) {
        cp_async_wait_all();
        __syncthreads();  // tile `it` has landed, and every warp is done with tile it-1
        if (it + 1 < tiles) {  // the next tile into the stage that tile it-1 released
            T* next = ring + ((it + 1) % kStages) * 2 * kTile * DP;
            copy_rows<T, DP, kTile, kThreads>(next, kb, (it + 1) * kTile, tk, d, copy_bytes);
            copy_rows<T, DP, kTile, kThreads>(next + kTile * DP, vb, (it + 1) * kTile, tk, d, copy_bytes);
        }
        cp_async_commit();
        T* cur = ring + (it % kStages) * 2 * kTile * DP;
        const Parts kp = split_tile<T, DP, kTile, kThreads>(cur, work);
        const Parts vp = split_tile<T, DP, kTile, kThreads>(cur + kTile * DP, work + kTile * DP);
        __syncthreads();  // the tile's parts are in place
        const int j0 = it * kTile;

        float s[NT][4], dp[NT][4];
        two_products<kExact, DP>(own, kp, own + kOwn, vp, m0, lane, s, dp);

        const bool straddles = causal && j0 + kTile - 1 > row0;  // flag bit 4 of _pair_schedule
        const bool ragged = j0 + kTile > tk;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = r_lo + 8 * (i / 2);
                const int key = j0 + 8 * n + 2 * t + (i & 1);
                float x = s[n][i] * scale;
                if (bias != nullptr) x += (row < tq && key < tk) ? bias[(long long)row * tk + key] : 0.f;
                if (straddles && key > row) x = kNegInf;
                float p = expf(x - lse_r[i / 2]);
                if (ragged && key >= tk) p = 0.f;       // no such key
                s[n][i] = p * (dp[n][i] - d_r[i / 2]);  // dS
            }
        }
        accumulate<kExact, DP>(s, kp, g, t, acc);  // dQ += dS·k
    }

#pragma unroll
    for (int c = 0; c < DT; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = r_lo + 8 * (i / 2);
            const int col = acc_col(c, i, t);
            if (row < tq && col < d) store_out<T>(dq, (bh * tq + row) * d + col, acc[c][i] * scale, out_f32);
        }
    }
}

// K5: dK and dV for kRows key rows of one batch·head
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, const float* __restrict__ bias,
    void* __restrict__ dk, void* __restrict__ dv, int tq, int tk, int d, float scale, int causal, int k_tiles,
    int copy_bytes, int out_f32) {
    constexpr bool kExact = sizeof(T) == 2;
    constexpr int NT = kTile / 8;
    constexpr int DT = DP / 8;
    constexpr int kOwn = kRows * DP;
    extern __shared__ float4 smem4[];
    uint32_t* own = reinterpret_cast<uint32_t*>(smem4);  // k, v as f32
    T* ring = reinterpret_cast<T*>(own + kOwnWords(DP));  // kStages x (q, dO) tiles
    uint32_t* work = reinterpret_cast<uint32_t*>(ring + 2 * kStages * kTile * DP);  // q, dO parts
    float* vecs = reinterpret_cast<float*>(work + 2 * kTile * DP);  // kStages x (LSE, D)

    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int m0 = (threadIdx.x / 32) * 16;
    const long long bh = blockIdx.x / k_tiles;
    const int key0 = (int)(blockIdx.x % k_tiles) * kRows;
    const int k_lo = key0 + m0 + g;  // this thread's keys: k_lo, k_lo + 8
    const T* qb = q + bh * tq * d;
    const T* gb = dout + bh * tq * d;
    const float* lb = lse + bh * tq;
    const float* db = dd + bh * tq;

    float dka[DT][4], dva[DT][4];
#pragma unroll
    for (int c = 0; c < DT; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dka[c][i] = dva[c][i] = 0.f;
    }

    // causal: query i attends key j iff i >= j, so the first query tile to visit holds
    // query key0; when key0 >= tq no query attends the block and the loop is empty
    const int tiles = (tq + kTile - 1) / kTile;
    const int t0 = causal ? key0 / kTile : 0;
    if (t0 < tiles) {
        zero_pad<T, DP, kThreads>(ring, 2 * kStages * kTile, d);
        copy_rows<T, DP, kTile, kThreads>(ring, qb, t0 * kTile, tq, d, copy_bytes);
        copy_rows<T, DP, kTile, kThreads>(ring + kTile * DP, gb, t0 * kTile, tq, d, copy_bytes);
        copy_vec(vecs, lb, t0 * kTile, tq);
        copy_vec(vecs + kTile, db, t0 * kTile, tq);
        cp_async_commit();
        load_own<T, DP, kRows, kThreads>(own, k + bh * tk * d, key0, tk, d);
        load_own<T, DP, kRows, kThreads>(own + kOwn, v + bh * tk * d, key0, tk, d);
    }

    for (int it = t0; it < tiles; ++it) {
        cp_async_wait_all();
        __syncthreads();  // tile `it` has landed, and every warp is done with tile it-1
        if (it + 1 < tiles) {
            const int st = (it + 1 - t0) % kStages;
            T* next = ring + st * 2 * kTile * DP;
            copy_rows<T, DP, kTile, kThreads>(next, qb, (it + 1) * kTile, tq, d, copy_bytes);
            copy_rows<T, DP, kTile, kThreads>(next + kTile * DP, gb, (it + 1) * kTile, tq, d, copy_bytes);
            copy_vec(vecs + st * 2 * kTile, lb, (it + 1) * kTile, tq);
            copy_vec(vecs + st * 2 * kTile + kTile, db, (it + 1) * kTile, tq);
        }
        cp_async_commit();
        const int st = (it - t0) % kStages;
        T* cur = ring + st * 2 * kTile * DP;
        const Parts qp = split_tile<T, DP, kTile, kThreads>(cur, work);
        const Parts gp = split_tile<T, DP, kTile, kThreads>(cur + kTile * DP, work + kTile * DP);
        const float* ls = vecs + st * 2 * kTile;
        const float* ds = ls + kTile;
        __syncthreads();  // the tile's parts are in place
        const int i0 = it * kTile;

        float s[NT][4], dp[NT][4];  // Sᵀ and dPᵀ: keys × queries
        two_products<kExact, DP>(own, qp, own + kOwn, gp, m0, lane, s, dp);

        const bool straddles = causal && key0 + kRows - 1 > i0;  // flag bit 4 of _pair_schedule_kv
        const bool ragged = i0 + kTile > tq;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int key = k_lo + 8 * (i / 2);
                const int c = 8 * n + 2 * t + (i & 1);
                const int query = i0 + c;
                float x = s[n][i] * scale;
                if (bias != nullptr) x += (query < tq && key < tk) ? bias[(long long)query * tk + key] : 0.f;
                if (straddles && key > query) x = kNegInf;
                float p = expf(x - ls[c]);
                if (ragged && query >= tq) p = 0.f;  // no such query
                s[n][i] = p;                          // Pᵀ
                dp[n][i] = p * (dp[n][i] - ds[c]);    // dSᵀ
            }
        }
        accumulate<kExact, DP>(s, gp, g, t, dva);   // dV += Pᵀ·dO
        accumulate<kExact, DP>(dp, qp, g, t, dka);  // dK += dSᵀ·q
    }

    // written for every key row of the block, zeros where no query attends it
#pragma unroll
    for (int c = 0; c < DT; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int key = k_lo + 8 * (i / 2);
            const int col = acc_col(c, i, t);
            if (key < tk && col < d) {
                const long long off = (bh * tk + key) * d + col;
                store_out<T>(dk, off, dka[c][i] * scale, out_f32);
                store_out<T>(dv, off, dva[c][i], out_f32);
            }
        }
    }
}

namespace {

template <typename T, int DP>
cudaError_t launch_dq(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dd, const float* bias, void* dq, int bh, int tq, int tk, int d, float scale,
                      int causal, int out_f32, cudaStream_t stream) {
    static std::atomic<unsigned long long> done{0};
    constexpr size_t smem = smem_bytes<T, DP>(false);
    const int q_tiles = (tq + kRows - 1) / kRows;
    const long long blocks = (long long)bh * q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const cudaError_t err = opt_in(flash_attention_bwd_dq_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dq_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, dd, bias, dq, tq, tk, d, scale, causal, q_tiles, copy_width<T>(d, q, k, v, dout), out_f32);
    return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, const float* bias, void* dk, void* dv, int bh, int tq, int tk, int d,
                       float scale, int causal, int out_f32, cudaStream_t stream) {
    static std::atomic<unsigned long long> done{0};
    constexpr size_t smem = smem_bytes<T, DP>(true);
    const int k_tiles = (tk + kRows - 1) / kRows;
    const long long blocks = (long long)bh * k_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const cudaError_t err = opt_in(flash_attention_bwd_dkv_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dkv_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, dd, bias, dk, dv, tq, tk, d, scale, causal, k_tiles, copy_width<T>(d, q, k, v, dout), out_f32);
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

int dispatch_dq(int device, int dtype, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* dd, const float* bias, void* dq, int bh, int tq, int tk, int d,
                float scale, int causal, void* stream, int out_f32) {
    cudaError_t err = check(device, d, bh, tq, tk);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool wide = d > 64;
#define HT_DQ(T) (wide ? launch_dq<T, 128>(device, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal, \
                                           out_f32, s)                                                          \
                       : launch_dq<T, 64>(device, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal,  \
                                          out_f32, s))
    switch (dtype) {
        case 0: return HT_DQ(float);
        case 1: return HT_DQ(__nv_bfloat16);
        case 2: return HT_DQ(__half);
        default: return cudaErrorInvalidValue;
    }
#undef HT_DQ
}

int dispatch_dkv(int device, int dtype, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* dd, const float* bias, void* dk, void* dv, int bh, int tq, int tk,
                 int d, float scale, int causal, void* stream, int out_f32) {
    cudaError_t err = check(device, d, bh, tq, tk);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool wide = d > 64;
#define HT_DKV(T) (wide ? launch_dkv<T, 128>(device, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale, \
                                             causal, out_f32, s)                                                  \
                        : launch_dkv<T, 64>(device, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale,  \
                                            causal, out_f32, s))
    switch (dtype) {
        case 0: return HT_DKV(float);
        case 1: return HT_DKV(__nv_bfloat16);
        case 2: return HT_DKV(__half);
        default: return cudaErrorInvalidValue;
    }
#undef HT_DKV
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
// (bh, tq) f32; bias (tq, tk) f32 contiguous or null; dq (bh, tq, d) in that type allocated
// by the caller; 1 <= d <= 128.
int flash_attention_bwd_dq_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* dd, const float* bias, void* dq,
                                  int bh, int tq, int tk, int d, float scale, int causal, void* stream) {
    return dispatch_dq(device, dtype, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal, stream, 0);
}

// as flash_attention_bwd_dq_launch; dk and dv (bh, tk, d) in that type allocated by the
// caller, every element written
int flash_attention_bwd_dkv_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* dd, const float* bias,
                                   void* dk, void* dv, int bh, int tq, int tk, int d, float scale, int causal,
                                   void* stream) {
    return dispatch_dkv(device, dtype, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale, causal, stream,
                        0);
}

// The same two with dq, dk and dv in f32 whatever the input type: a ring attention sums
// its blocks' gradients, which then round once, at the end.
int flash_attention_bwd_dq_f32_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* dd, const float* bias,
                                      void* dq, int bh, int tq, int tk, int d, float scale, int causal,
                                      void* stream) {
    return dispatch_dq(device, dtype, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal, stream, 1);
}

int flash_attention_bwd_dkv_f32_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* dd, const float* bias,
                                       void* dk, void* dv, int bh, int tq, int tk, int d, float scale, int causal,
                                       void* stream) {
    return dispatch_dkv(device, dtype, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale, causal, stream,
                        1);
}

const char* flash_attention_bwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
