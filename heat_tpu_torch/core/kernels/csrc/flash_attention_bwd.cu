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
// P is recomputed from the scores as the forward forms them (K2, flash_attention_fwd.cu): the
// product times scale, then the bias, masked scores at the finite NEG_INF (-FLT_MAX), never
// -inf (in natural units for f32, in log2 units for 2-byte types, below). A fully masked row
// has LSE = NEG_INF/2 + log(1e-30) and O = 0, so its P is 0, its D is 0, its dQ is 0 and it
// adds nothing to dK and dV: inf − inf never occurs.
//
// Two designs, by the input type.
//
// f32: products in 3xTF32 on the tensor cores (mma_tf32x3.cuh), on tiles, fragments and
// products shared with the forwards (flash_tiles.cuh): each f32 operand splits into a TF32 big
// part and a TF32 residual, and a·b is taken as small·big + big·small + big·big with f32
// accumulation. The dropped small·small term is below 2⁻²² of |a·b|, so the products keep
// fp32's level of accuracy, P and dS included: they stay f32 and split like any operand.
//
// What bounds them on an H100: K4 does 6·d operations per attended (query, key) pair
// (q·kᵀ, dO·vᵀ, dS·k) and K5 8·d (q·kᵀ, dO·vᵀ, dSᵀ·q, Pᵀ·dO) against a few hundred MB of
// inputs and outputs at the Transformer's shapes: both are bound by arithmetic, at the
// 3xTF32 rate of 495/3 = 165 TFLOP/s for f32 (the fp32 FMA pipe's 67 TFLOP/s is the bound
// of a kernel without tensor cores) and at the 16-bit rate of 989 for bf16 and f16. What
// holds mma.sync below its rate is the work that feeds it (loading fragments, splitting every
// f32 value, the softmax in between, two barriers a tile) and the warps there are to hide its
// latency: in trials on the card, the time fell as the warps an SM rose from four to
// eight to twelve, the last step gained at the non-causal shapes and lost some at the
// causal one (PERF.md). The D pass reads O and dO once
// and writes one float per row: it is bound by bytes, in every type one kernel of 16-byte
// loads with several rows in flight a lane (its design beside it, below). The f32 design:
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
//     once as it lands (big parts over the values, small parts beside). 96 KB a block
//     (d <= 64) lets two blocks, twelve warps, share an SM.
//   * The tiles come through a cp.async ring of two stages (LSE and D beside them in K5):
//     the next tile's copies are issued after the barrier that opens a step and land while
//     the step splits and computes, two barriers a step. Copies are 16, 8 or 4 bytes as the
//     addresses and the row width allow, rows past the end are zero-filled through src-size.
//     The head dim is padded to DP = 64 or 128 with zeros.
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
// Shared memory above 48 KB (96 KB at d <= 64, 192 KB at d <= 128) is opted into once per
// instance and device (cudaFuncSetAttribute).
//
// bf16 and f16: heat_tpu's arithmetic on Hopper's 16-bit tensor cores (wgmma_16bit.cuh). S
// and dP are products of 16-bit operands accumulated in f32; P = exp(S − LSE) and
// dS = P∘(dP − D) are f32 and are rounded to the input type, to nearest even, as the A
// operand of dS·k, dSᵀ·q and Pᵀ·dO (heat_tpu's `.astype` at flash_attention.py:460, :520 and
// :525), whose sums are f32 again. Their bound is 6·d and 8·d operations a pair at 989
// TFLOP/s; at bench.py's causal shape (128 × 4096² × 64) 0.417 ms for K4 and 0.556 for K5.
// The design (PERF.md):
//   * A block is a producer warpgroup and two consumer warpgroups of 64 own rows each: 128
//     query rows in K4, 128 key rows in K5. setmaxnreg hands the producer's registers to the
//     consumers (40 and 232 a thread), and a consumer holds its accumulators in registers:
//     dQ, or dK and dV, 64 x DP f32 each (DP / 2 a thread), S and dP of a tile (32 each) and
//     the 16-bit A registers of P and dS (16 each).
//   * TMA brings everything: the own rows once (q and dO in K4, k and v in K5), then a ring of
//     two stages of 64-row tiles of the other side (k and v; q and dO), a full and an empty
//     mbarrier a stage. Boxes are 64 columns (128 bytes) by 64 rows of one batch·head from
//     3-D tensor maps, 128-byte swizzled; rows past tq or tk and columns past d arrive as
//     zeros, which pads the head dim to DP = 64 or 128. TMA wants 16-byte row strides, so the
//     head dim must be a multiple of 8 and the tensors 16-byte aligned: the wrapper copies
//     other inputs into padded tensors (flash_attention.py, `_tma_ready`) and these entry
//     points refuse them. In K5 the producer's second warp copies each stage's LSE and D into
//     shared memory with plain loads (any tq: LSE and D rows need not be 16-byte aligned)
//     and arrives on the stage's full barrier beside the TMA thread. A bias is read from
//     global memory where it is added.
//   * A tile is three or four products of wgmma m64nNk16 (f32 accumulators). S = q·kᵀ and
//     dP = dO·vᵀ (Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ in K5) take both operands K-major from shared
//     memory, 64 x 64 each; the second is issued before the first is read, so the softmax of
//     S overlaps dP. The accumulator fragment of S or dP is an A fragment of the next product
//     once its f32 pairs are packed into the input type (as FlashAttention-3's forward does),
//     so P and dS never leave registers: dQ += dS·k (dV += Pᵀ·dO, dK += dSᵀ·q) take A from
//     registers and B from the ring tile read MN-major (the head dim is N), m64nDPk16.
//   * The softmax runs in log2 units: P = 2^(S·scale·log2 e + bias·log2 e − LSE·log2 e) by
//     ex2.approx (MUFU.EX2). Masked entries get P = 0: the causal mask where key > query, only
//     in tiles that straddle the diagonal, and keys past tk (K4) or queries past tq (K5). A
//     fully masked row has bias·log2 e = −inf, so its P is 0 and inf − inf never occurs.
//   * Causal tiles wholly on the masked side are not loaded (the loop bounds), and a consumer
//     warpgroup whose 64 rows a loaded tile does not reach skips its products. Blocks launch
//     longest first within a batch·head (K4 from its last query block, K5 from its first key
//     block), so neighbouring blocks share their batch·head's tiles in L2. K5 writes zeros
//     for key rows no query attends. No atomics and no sum across blocks: two runs give
//     identical bits.
//   * Shared memory (1024-byte aligned): 66 KB at d <= 64 and 130 KB at d <= 128, one block
//     an SM (its 384 threads take the register file).
//   * Trials on the card (tools/ab_flash.py --bwd-only, each variant in turns with this one,
//     PERF.md) chose this shape: a ring of 3 stages was no faster for K4 and 5% slower
//     for K5 at bench.py's causal bf16 shape; issuing a tile's S and dP before the products of
//     the tile before had ended (each consumer keeping two groups in flight) was 21% (K4) and
//     30% (K5) slower; blocks of one consumer warpgroup, two an SM, gained 0–4% at that shape
//     and 10% for K5 at the step's, but K5 then spills at d <= 128 (setmaxnreg 216).
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
#include "wgmma_16bit.cuh"

using namespace flash;

namespace {

constexpr int kWarps = 6;              // warps per block of K4 and K5: two blocks fill an SM
constexpr int kThreads = 32 * kWarps;  // threads per block of K4 and K5
constexpr int kRows = 16 * kWarps;     // query rows of a K4 block, key rows of a K5 block
constexpr int kTile = 32;              // keys per tile in K4, queries per tile in K5
constexpr int kStages = 2;             // stages of the ring
constexpr int kDThreads = 256;         // threads per block of the D pass
constexpr int kDRows = 4;              // rows of the D pass a thread's lane group owns at once

// Shared memory of K4 (K5 in brackets), for the head dim padded to DP:
//   own   : q and dO (k and v) of the block's kRows rows as f32, (kRows, DP) words each
//   ring  : kStages stages of the k and v (q and dO) tiles as copied, (kTile, DP) each; a
//           tile's big parts replace it in place
//   work  : (kTile, DP) words each for the current tile's k and v (q and dO): their small
//           parts
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
template <int DP>
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
            tf32x3::split<false>(__uint_as_float(ab[i]), ab[i], as[i]);
            tf32x3::split<false>(__uint_as_float(cb[i]), cb[i], cs[i]);
        }
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
            uint32_t bb[4], bs[4] = {};
            frag_b_nk<DP>(bb, b.big, 16 * np, 8 * kk, lane);
            frag_b_nk<DP>(bs, b.small, 16 * np, 8 * kk, lane);
            tf32x3::mma3<false, false>(x[2 * np], ab, as, {bb[0], bb[1]}, {bs[0], bs[1]});
            tf32x3::mma3<false, false>(x[2 * np + 1], ab, as, {bb[2], bb[3]}, {bs[2], bs[3]});
            frag_b_nk<DP>(bb, e.big, 16 * np, 8 * kk, lane);
            frag_b_nk<DP>(bs, e.small, 16 * np, 8 * kk, lane);
            tf32x3::mma3<false, false>(y[2 * np], cb, cs, {bb[0], bb[1]}, {bs[0], bs[1]});
            tf32x3::mma3<false, false>(y[2 * np + 1], cb, cs, {bb[2], bb[3]}, {bs[2], bs[3]});
        }
    }
}

}  // namespace

// The D pass: D_i = Σ_c dO_ic·O_ic in f32, one float a row of (rows, d) O and dO. It reads
// both once and writes 4 bytes a row: bound by bytes (4·d + 4 bytes a row in 2-byte types).
// A row is cut into 16-byte chunks (8 bf16/f16 or 4 f32 elements) and spread over L lanes,
// L the power of two at or above its chunk count, at most 32; a warp holds 32 / L rows side
// by side (at d = 64 in bf16, 8 lanes a row and 4 rows a warp), and each lane group owns
// kDRows rows at once, whose 16-byte loads it issues together before any product: 2·kDRows
// loads in flight a lane (x the chunks a lane walks). The elements before a row's first
// 16-byte boundary and after its last whole chunk (a row length or an address that does not
// allow 16-byte loads; O and dO with different offsets take every element so) are read one
// by one by the same lanes. Order, fixed, so two runs give the same bits: each lane sums its
// chunks in order, each chunk's elements in order by fmaf, then its single elements; the
// group adds its lanes by a butterfly of xor-shuffles.
template <typename T>
__device__ __forceinline__ float fma_chunk(const uint4& a, const uint4& b, float acc) {
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4) {
            acc = fmaf(__uint_as_float(aw[i]), __uint_as_float(bw[i]), acc);
        } else {
            const T* ah = reinterpret_cast<const T*>(&aw[i]);
            const T* bh = reinterpret_cast<const T*>(&bw[i]);
            acc = fmaf(to_f32(ah[0]), to_f32(bh[0]), acc);
            acc = fmaf(to_f32(ah[1]), to_f32(bh[1]), acc);
        }
    }
    return acc;
}

template <typename T>
__global__ void __launch_bounds__(kDThreads) flash_attention_bwd_d_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dd, long long rows, int d, int lanes) {
    constexpr int V = 16 / sizeof(T);  // elements a chunk
    const int lane = threadIdx.x % 32;
    const int sub = lane % lanes;                          // this lane's place in its row's group
    const int groups = kDThreads / lanes;                  // lane groups a block
    const int group = threadIdx.x / lanes;
    const long long first = ((long long)blockIdx.x * groups + group) * kDRows;
    // every row has the same byte offset from a 16-byte boundary only when a row is a whole
    // number of chunks; otherwise each row finds its own
    const bool same_offset = ((reinterpret_cast<uintptr_t>(o) ^ reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
    float acc[kDRows];
    int head[kDRows], chunks[kDRows];
    const T* orow[kDRows];
    const T* grow[kDRows];
    int most = 0;
#pragma unroll
    for (int r = 0; r < kDRows; ++r) {
        acc[r] = 0.f;
        const long long row = first + r < rows ? first + r : rows - 1;  // a repeat past the end, not stored
        orow[r] = o + row * d;
        grow[r] = dout + row * d;
        const int off = (int)((reinterpret_cast<uintptr_t>(orow[r]) & 15) / sizeof(T));
        head[r] = same_offset ? min(d, (V - off) % V) : d;
        chunks[r] = same_offset ? (d - head[r]) / V : 0;
        most = max(most, chunks[r]);
    }
    for (int c = sub; c < most; c += lanes) {
        uint4 a[kDRows], b[kDRows];
#pragma unroll
        for (int r = 0; r < kDRows; ++r) {
            if (c < chunks[r]) {
                a[r] = __ldg(reinterpret_cast<const uint4*>(orow[r] + head[r]) + c);
                b[r] = __ldg(reinterpret_cast<const uint4*>(grow[r] + head[r]) + c);
            }
        }
#pragma unroll
        for (int r = 0; r < kDRows; ++r) {
            if (c < chunks[r]) acc[r] = fma_chunk<T>(a[r], b[r], acc[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kDRows; ++r) {
        // the single elements: the head, then the tail past the last whole chunk
        const int body = head[r] + chunks[r] * V;
        const int singles = head[r] + (d - body);
        for (int j = sub; j < singles; j += lanes) {
            const int col = j < head[r] ? j : body + (j - head[r]);
            acc[r] = fmaf(to_f32(orow[r][col]), to_f32(grow[r][col]), acc[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kDRows; ++r) {
        for (int off = lanes / 2; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(kFull, acc[r], off);
        if (sub == 0 && first + r < rows) dd[first + r] = acc[r];
    }
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
    static_assert(sizeof(T) == 4, "2-byte types take the wgmma kernels below");
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
        two_products<DP>(own, kp, own + kOwn, vp, m0, lane, s, dp);

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
        accumulate<false, DP>(s, kp, g, t, acc);  // dQ += dS·k
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
    static_assert(sizeof(T) == 4, "2-byte types take the wgmma kernels below");
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
        two_products<DP>(own, qp, own + kOwn, gp, m0, lane, s, dp);

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
        accumulate<false, DP>(s, gp, g, t, dva);   // dV += Pᵀ·dO
        accumulate<false, DP>(dp, qp, g, t, dka);  // dK += dSᵀ·q
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


// ---------------------------------------------------------------- K4 and K5 for 2-byte types

namespace tc {

constexpr int kConsumers = 2;                  // consumer warpgroups a block, 64 own rows each
constexpr int kThreads = 128 * (1 + kConsumers);  // the producer warpgroup, then the consumers
constexpr int kRows = 64 * kConsumers;         // a block's own rows: queries in K4, keys in K5
constexpr int kTile = 64;                      // rows of a ring tile: keys in K4, queries in K5
constexpr int kStages = 2;                     // stages of the ring
constexpr int kBox = wg16::kBox;               // bytes of a 64 x 64 box of 2-byte values
constexpr int kVecFloats = 2 * kTile;          // K5: a stage's LSE and D, kTile floats each

// Shared memory, for the head dim padded to DP (DP / 64 column blocks of 64 values):
//   own  : the block's own two tensors (q, dO in K4; k, v in K5), each DP / 64 blocks of
//          (kRows x 64) values, rows 128 bytes apart, as TMA's 128-byte swizzle lays them out
//   ring : kStages stages of the other side's two tiles (k, v in K4; q, dO in K5), each DP / 64
//          boxes of (kTile x 64)
//   vecs : K5 only, kStages stages of LSE and D of the stage's queries
//   bars : full[kStages], empty[kStages], and the own tensors' barrier
// from a 1024-byte boundary, as the swizzle wants it.
template <int DP>
struct Smem {
    static constexpr int kCB = DP / 64;
    static constexpr int kOwnBlock = (kRows / 64) * kBox;  // one column block of an own tensor
    static constexpr int kOwn = kCB * kOwnBlock;           // one own tensor
    static constexpr int kTileBytes = kCB * kBox;          // one ring tile
    static constexpr int kStage = 2 * kTileBytes;
    static constexpr int kRing = 2 * kOwn;
    static constexpr int kVecs = kRing + kStages * kStage;
    static constexpr int kBars = kVecs + kStages * kVecFloats * 4;
    static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};
static_assert(Smem<128>::kBytes <= 232448, "the 2-byte backward's shared memory exceeds an H100 block's");

using wg16::a_frags;
using wg16::acc_by_tile;
using wg16::own_by_tile;
using wg16::store_pair;
static_assert(Smem<64>::kOwnBlock == wg16::kOwnBlock, "the backward's own rows are wgmma_16bit.cuh's");

}  // namespace tc

// K4 for bf16 and f16: dQ for tc::kRows query rows of one batch·head. A producer warpgroup,
// one thread of which keeps the ring of k and v tiles full by TMA, and two consumer
// warpgroups of 64 rows; thread t of a consumer holds rows 16·(t/32) + (t%32)/4 and 8 below,
// columns 8j + 2·(t%4) and the next of each accumulator (wgmma's layout).
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, 1) flash_attention_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
    const float* __restrict__ lse, const float* __restrict__ dd, const float* __restrict__ bias,
    void* __restrict__ dq, int tq, int tk, int d, float scale, int causal, int q_tiles, int out_f32) {
    using L = tc::Smem<DP>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_own = base, do_own = base + L::kOwn;
    const uint32_t bars = base + L::kBars;
    auto full = [&](int st) { return bars + 8u * st; };
    auto empty = [&](int st) { return bars + 8u * (tc::kStages + st); };
    const uint32_t own_bar = bars + 8u * 2 * tc::kStages;
    auto k_tile = [&](int st) { return base + L::kRing + st * L::kStage; };
    auto v_tile = [&](int st) { return k_tile(st) + L::kTileBytes; };

    const int bh = blockIdx.x / q_tiles;
    const int row0 = (q_tiles - 1 - (int)(blockIdx.x % q_tiles)) * tc::kRows;  // the longest causal blocks first
    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + tc::kTile - 1) / tc::kTile;
    if (causal) tiles = min(tiles, (min(row0 + tc::kRows, tq) - 1) / tc::kTile + 1);

    if (threadIdx.x == 0) {
        for (int st = 0; st < tc::kStages; ++st) {
            mbar_init(full(st), 1);                    // the producer's arrival, with the stage's bytes
            mbar_init(empty(st), 4 * tc::kConsumers);  // one arrival a consumer warp
        }
        mbar_init(own_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int warpgroup = threadIdx.x / 128;
    if (warpgroup == 0) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            mbar_expect_tx(own_bar, 2 * L::kOwn);
            for (int cb = 0; cb < L::kCB; ++cb) {
                for (int h = 0; h < tc::kRows / 64; ++h) {
                    const uint32_t at = cb * L::kOwnBlock + h * tc::kBox;
                    wg16::tma_load_3d(&map_q, q_own + at, own_bar, 64 * cb, row0 + 64 * h, bh);
                    wg16::tma_load_3d(&map_do, do_own + at, own_bar, 64 * cb, row0 + 64 * h, bh);
                }
            }
            int st = 0;
            uint32_t phase = 0;
            for (int it = 0; it < tiles; ++it) {
                mbar_wait(empty(st), phase ^ 1u);
                mbar_expect_tx(full(st), L::kStage);
                for (int cb = 0; cb < L::kCB; ++cb) {
                    wg16::tma_load_3d(&map_k, k_tile(st) + cb * tc::kBox, full(st), 64 * cb, it * tc::kTile, bh);
                    wg16::tma_load_3d(&map_v, v_tile(st) + cb * tc::kBox, full(st), 64 * cb, it * tc::kTile, bh);
                }
                if (++st == tc::kStages) {
                    st = 0;
                    phase ^= 1u;
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = warpgroup - 1;
        const int t = threadIdx.x % 128;
        const int lane = t % 32, qd = lane % 4;
        const int wrow0 = row0 + 64 * wg;            // the warpgroup's rows
        const int r_lo = wrow0 + 16 * (t / 32) + lane / 4;  // this thread's rows: r_lo, r_lo + 8
        const float c2 = scale * kLog2e;
        float lse_r[2], d_r[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = r_lo + 8 * h;
            lse_r[h] = row < tq ? lse[(long long)bh * tq + row] : 0.f;
            d_r[h] = row < tq ? dd[(long long)bh * tq + row] : 0.f;
        }
        float acc[DP / 2];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

        mbar_wait(own_bar, 0);
        int st = 0;
        uint32_t phase = 0;
        for (int it = 0; it < tiles; ++it) {
            mbar_wait(full(st), phase);
            const int j0 = it * tc::kTile;
            if (!causal || j0 <= wrow0 + 63) {  // else every key of the tile is past every row
                float s[32], dp[32];
                wg16::wgmma_fence();
                tc::own_by_tile<T, DP>(s, q_own + wg * tc::kBox, k_tile(st));  // S = q·kᵀ
                wg16::wgmma_commit();
                tc::own_by_tile<T, DP>(dp, do_own + wg * tc::kBox, v_tile(st));  // dP = dO·vᵀ
                wg16::wgmma_commit();
                wg16::wgmma_wait<1>();
                wg16::fence_operands(s);
                const bool straddles = causal && j0 + tc::kTile - 1 > wrow0;  // flag bit 4 of _pair_schedule
                const bool ragged = j0 + tc::kTile > tk;
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const int row = r_lo + 8 * ((i / 2) % 2);
                    const int key = j0 + 8 * (i / 4) + 2 * qd + (i & 1);
                    float x = s[i] * c2;
                    if (bias != nullptr && row < tq && key < tk) x = fmaf(bias[(long long)row * tk + key], kLog2e, x);
                    float p = exp2_approx(fmaf(lse_r[(i / 2) % 2], -kLog2e, x));
                    if ((straddles && key > row) || (ragged && key >= tk)) p = 0.f;
                    s[i] = p;
                }
                wg16::wgmma_wait<0>();
                wg16::fence_operands(dp);
#pragma unroll
                for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - d_r[(i / 2) % 2]);  // dS
                uint32_t da[tc::kTile / 16][4];
                tc::a_frags<T>(da, dp);  // dS rounded to T
                wg16::wgmma_fence();
                tc::acc_by_tile<T, DP>(acc, da, k_tile(st));  // dQ += dS·k
                wg16::wgmma_commit();
                wg16::wgmma_wait<0>();
                wg16::fence_operands(acc);
            }
            if (lane == 0) mbar_arrive(empty(st));
            if (++st == tc::kStages) {
                st = 0;
                phase ^= 1u;
            }
        }

#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = r_lo + 8 * h;
                const int col = 8 * j + 2 * qd;
                if (row < tq && col < d)
                    tc::store_pair<T>(dq, ((long long)bh * tq + row) * d + col, acc[4 * j + 2 * h] * scale,
                                      acc[4 * j + 2 * h + 1] * scale, out_f32);
            }
        }
    }
}

// K5 for bf16 and f16: dK and dV for tc::kRows key rows of one batch·head, in K4's layout of
// threads; the producer warpgroup's first thread brings the q and dO tiles by TMA, its second
// warp each stage's LSE and D by plain loads
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, 1) flash_attention_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
    const float* __restrict__ lse, const float* __restrict__ dd, const float* __restrict__ bias,
    void* __restrict__ dk, void* __restrict__ dv, int tq, int tk, int d, float scale, int causal, int k_tiles,
    int out_f32) {
    using L = tc::Smem<DP>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t k_own = base, v_own = base + L::kOwn;
    const uint32_t bars = base + L::kBars;
    auto full = [&](int st) { return bars + 8u * st; };
    auto empty = [&](int st) { return bars + 8u * (tc::kStages + st); };
    const uint32_t own_bar = bars + 8u * 2 * tc::kStages;
    auto q_tile = [&](int st) { return base + L::kRing + st * L::kStage; };
    auto do_tile = [&](int st) { return q_tile(st) + L::kTileBytes; };
    float* vecs = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kVecs);  // stage st: LSE, then D

    const int bh = blockIdx.x / k_tiles;
    const int key0 = (int)(blockIdx.x % k_tiles) * tc::kRows;  // the longest causal blocks first
    // causal: query i attends key j iff i >= j, so the first query tile to visit holds query
    // key0; when key0 >= tq no query attends the block and it only writes zeros
    const int t0 = causal ? key0 / tc::kTile : 0;
    const int tiles = max((tq + tc::kTile - 1) / tc::kTile - t0, 0);

    if (threadIdx.x == 0) {
        for (int st = 0; st < tc::kStages; ++st) {
            mbar_init(full(st), 1 + 32);               // the TMA thread's, with its bytes, and the LSE/D warp's
            mbar_init(empty(st), 4 * tc::kConsumers);  // one arrival a consumer warp
        }
        mbar_init(own_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int warpgroup = threadIdx.x / 128;
    if (warpgroup == 0) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        if (tiles > 0 && threadIdx.x == 0) {
            mbar_expect_tx(own_bar, 2 * L::kOwn);
            for (int cb = 0; cb < L::kCB; ++cb) {
                for (int h = 0; h < tc::kRows / 64; ++h) {
                    const uint32_t at = cb * L::kOwnBlock + h * tc::kBox;
                    wg16::tma_load_3d(&map_k, k_own + at, own_bar, 64 * cb, key0 + 64 * h, bh);
                    wg16::tma_load_3d(&map_v, v_own + at, own_bar, 64 * cb, key0 + 64 * h, bh);
                }
            }
            int st = 0;
            uint32_t phase = 0;
            for (int it = 0; it < tiles; ++it) {
                mbar_wait(empty(st), phase ^ 1u);
                mbar_expect_tx(full(st), L::kStage);
                const int i0 = (t0 + it) * tc::kTile;
                for (int cb = 0; cb < L::kCB; ++cb) {
                    wg16::tma_load_3d(&map_q, q_tile(st) + cb * tc::kBox, full(st), 64 * cb, i0, bh);
                    wg16::tma_load_3d(&map_do, do_tile(st) + cb * tc::kBox, full(st), 64 * cb, i0, bh);
                }
                if (++st == tc::kStages) {
                    st = 0;
                    phase ^= 1u;
                }
            }
        } else if (tiles > 0 && warp == 1) {
            const float* lb = lse + (long long)bh * tq;
            const float* db = dd + (long long)bh * tq;
            int st = 0;
            uint32_t phase = 0;
            for (int it = 0; it < tiles; ++it) {
                mbar_wait(empty(st), phase ^ 1u);
                const int i0 = (t0 + it) * tc::kTile;
                float* v = vecs + st * tc::kVecFloats;
                for (int c = lane; c < tc::kTile; c += 32) {
                    const bool in = i0 + c < tq;
                    v[c] = in ? lb[i0 + c] : 0.f;
                    v[tc::kTile + c] = in ? db[i0 + c] : 0.f;
                }
                mbar_arrive(full(st));
                if (++st == tc::kStages) {
                    st = 0;
                    phase ^= 1u;
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = warpgroup - 1;
        const int t = threadIdx.x % 128;
        const int lane = t % 32, qd = lane % 4;
        const int wkey0 = key0 + 64 * wg;                   // the warpgroup's keys
        const int k_lo = wkey0 + 16 * (t / 32) + lane / 4;  // this thread's keys: k_lo, k_lo + 8
        const float c2 = scale * kLog2e;
        float dka[DP / 2], dva[DP / 2];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

        if (tiles > 0) mbar_wait(own_bar, 0);
        int st = 0;
        uint32_t phase = 0;
        for (int it = 0; it < tiles; ++it) {
            mbar_wait(full(st), phase);
            const int i0 = (t0 + it) * tc::kTile;
            if (!causal || i0 + tc::kTile - 1 >= wkey0) {  // else every query of the tile is before every key
                float s[32], dp[32];  // Sᵀ and dPᵀ: keys x queries
                wg16::wgmma_fence();
                tc::own_by_tile<T, DP>(s, k_own + wg * tc::kBox, q_tile(st));  // Sᵀ = k·qᵀ
                wg16::wgmma_commit();
                tc::own_by_tile<T, DP>(dp, v_own + wg * tc::kBox, do_tile(st));  // dPᵀ = v·dOᵀ
                wg16::wgmma_commit();
                wg16::wgmma_wait<1>();
                wg16::fence_operands(s);
                const float* ls = vecs + st * tc::kVecFloats;
                const float* ds = ls + tc::kTile;
                const bool straddles = causal && wkey0 + 63 > i0;  // flag bit 4 of _pair_schedule_kv
                const bool ragged = i0 + tc::kTile > tq;
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const int key = k_lo + 8 * ((i / 2) % 2);
                    const int c = 8 * (i / 4) + 2 * qd + (i & 1);
                    const int query = i0 + c;
                    float x = s[i] * c2;
                    if (bias != nullptr && query < tq && key < tk)
                        x = fmaf(bias[(long long)query * tk + key], kLog2e, x);
                    float p = exp2_approx(fmaf(ls[c], -kLog2e, x));
                    if ((straddles && key > query) || (ragged && query >= tq)) p = 0.f;
                    s[i] = p;  // Pᵀ
                }
                uint32_t pa[tc::kTile / 16][4], da[tc::kTile / 16][4];
                tc::a_frags<T>(pa, s);  // Pᵀ rounded to T
                wg16::wgmma_wait<0>();
                wg16::fence_operands(dp);
#pragma unroll
                for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - ds[8 * (i / 4) + 2 * qd + (i & 1)]);  // dSᵀ
                tc::a_frags<T>(da, dp);  // dSᵀ rounded to T
                wg16::wgmma_fence();
                tc::acc_by_tile<T, DP>(dva, pa, do_tile(st));  // dV += Pᵀ·dO
                tc::acc_by_tile<T, DP>(dka, da, q_tile(st));  // dK += dSᵀ·q
                wg16::wgmma_commit();
                wg16::wgmma_wait<0>();
                wg16::fence_operands(dka);
                wg16::fence_operands(dva);
            }
            if (lane == 0) mbar_arrive(empty(st));
            if (++st == tc::kStages) {
                st = 0;
                phase ^= 1u;
            }
        }

        // written for every key row of the block, zeros where no query attends it
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int key = k_lo + 8 * h;
                const int col = 8 * j + 2 * qd;
                if (key < tk && col < d) {
                    const long long off = ((long long)bh * tk + key) * d + col;
                    tc::store_pair<T>(dk, off, dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale, out_f32);
                    tc::store_pair<T>(dv, off, dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1], out_f32);
                }
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
    const int per_row = (int)((d * (long long)sizeof(T) + 15) / 16);  // 16-byte chunks a row
    int lanes = 1;
    while (lanes < per_row && lanes < 32) lanes *= 2;
    const long long rows_a_block = (long long)(kDThreads / lanes) * kDRows;
    const long long blocks = (rows + rows_a_block - 1) / rows_a_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    flash_attention_bwd_d_kernel<T><<<(unsigned)blocks, kDThreads, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), dd, rows, d, lanes);
    return cudaGetLastError();
}

// the 2-byte K4 and K5: four TMA maps of q, k, v and dO (boxes of 64 rows), then one launch
template <typename T>
int make_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout, int bh, int tq,
              int tk, int d) {
    const void* ptrs[4] = {q, k, v, dout};
    const int rows[4] = {tq, tk, tk, tq};
    for (int i = 0; i < 4; ++i) {
        const int rc = wg16::make_map_3d<T>(&maps[i], ptrs[i], bh, rows[i], d, tc::kTile);
        if (rc != 0) return rc;
    }
    return 0;
}

template <typename T, int DP>
int launch_dq_wgmma(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                    const float* dd, const float* bias, void* dq, int bh, int tq, int tk, int d, float scale,
                    int causal, int out_f32, cudaStream_t stream) {
    static std::atomic<unsigned long long> done{0};
    constexpr size_t smem = tc::Smem<DP>::kBytes;
    const int q_tiles = (tq + tc::kRows - 1) / tc::kRows;
    const long long blocks = (long long)bh * q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    CUtensorMap maps[4];
    const int rc = make_maps<T>(maps, q, k, v, dout, bh, tq, tk, d);
    if (rc != 0) return rc;
    const cudaError_t err = opt_in(flash_attention_bwd_dq_wgmma_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dq_wgmma_kernel<T, DP><<<(unsigned)blocks, tc::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, dd, bias, dq, tq, tk, d, scale, causal, q_tiles, out_f32);
    return cudaGetLastError();
}

template <typename T, int DP>
int launch_dkv_wgmma(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                     const float* dd, const float* bias, void* dk, void* dv, int bh, int tq, int tk, int d,
                     float scale, int causal, int out_f32, cudaStream_t stream) {
    static std::atomic<unsigned long long> done{0};
    constexpr size_t smem = tc::Smem<DP>::kBytes;
    const int k_tiles = (tk + tc::kRows - 1) / tc::kRows;
    const long long blocks = (long long)bh * k_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    CUtensorMap maps[4];
    const int rc = make_maps<T>(maps, q, k, v, dout, bh, tq, tk, d);
    if (rc != 0) return rc;
    const cudaError_t err = opt_in(flash_attention_bwd_dkv_wgmma_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dkv_wgmma_kernel<T, DP><<<(unsigned)blocks, tc::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, dd, bias, dk, dv, tq, tk, d, scale, causal, k_tiles, out_f32);
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
    if (dtype == 1 || dtype == 2) {
        if (!wg16::tma_ready(d, q, k, v, dout)) return cudaErrorInvalidValue;
#define HT_DQ(T) (wide ? launch_dq_wgmma<T, 128>(device, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, \
                                                 causal, out_f32, s)                                              \
                       : launch_dq_wgmma<T, 64>(device, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale,  \
                                                causal, out_f32, s))
        return dtype == 1 ? HT_DQ(__nv_bfloat16) : HT_DQ(__half);
#undef HT_DQ
    }
    if (dtype != 0) return cudaErrorInvalidValue;
    return wide ? launch_dq<float, 128>(device, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal,
                                        out_f32, s)
                : launch_dq<float, 64>(device, q, k, v, dout, lse, dd, bias, dq, bh, tq, tk, d, scale, causal,
                                       out_f32, s);
}

int dispatch_dkv(int device, int dtype, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* dd, const float* bias, void* dk, void* dv, int bh, int tq, int tk,
                 int d, float scale, int causal, void* stream, int out_f32) {
    cudaError_t err = check(device, d, bh, tq, tk);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool wide = d > 64;
    if (dtype == 1 || dtype == 2) {
        if (!wg16::tma_ready(d, q, k, v, dout)) return cudaErrorInvalidValue;
#define HT_DKV(T) (wide ? launch_dkv_wgmma<T, 128>(device, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, \
                                                   scale, causal, out_f32, s)                                   \
                        : launch_dkv_wgmma<T, 64>(device, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d,  \
                                                  scale, causal, out_f32, s))
        return dtype == 1 ? HT_DKV(__nv_bfloat16) : HT_DKV(__half);
#undef HT_DKV
    }
    if (dtype != 0) return cudaErrorInvalidValue;
    return wide ? launch_dkv<float, 128>(device, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale, causal,
                                         out_f32, s)
                : launch_dkv<float, 64>(device, q, k, v, dout, lse, dd, bias, dk, dv, bh, tq, tk, d, scale, causal,
                                        out_f32, s);
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

const char* flash_attention_bwd_error_string(int code) { return tc_error_string(code); }

}  // extern "C"
