// K2 for Hopper: the flash-attention forward, on the tensor cores: bf16 and f16 on wgmma,
// f32 in 3xTF32.
//
// Replaces the Pallas TPU kernel heat_tpu/core/kernels/flash_attention.py:156 (`_kernel`,
// launched by `_flash_pallas`). For q (bh, tq, d) and k, v (bh, tk, d) in f32, bf16 or f16,
// and an optional additive bias (tq, tk) f32 shared by every batch·head, it writes
//   o   (bh, tq, d) in q's type : softmax(scale·q·kᵀ + bias) v, rows fully masked give 0
//                                 (in f32 through the `_f32_launch` entry point)
//   lse (bh, tq)    f32         : max(m, NEG_INF/2) + log(max(l, 1e-30)), m the row maximum
// by the online-softmax recurrence of `_online_softmax_update` (flash_attention.py:135).
// Causal attention is top-left aligned: row i attends columns j <= i, for any tq, tk.
//
// Two kernels, by the input type:
//   * flash_attention_fwd_wgmma_kernel, for bf16 and f16 with o in their type: heat_tpu's
//     arithmetic (P rounded to the input type before P·V, l summed over the f32 P) on
//     Hopper's 16-bit tensor cores with wgmma, fed by TMA; flash_fwd_16bit.cuh holds its
//     design, which it shares with K3. Its bound at bench.py's causal bf16 shape (128 x
//     4096² x 64) is 0.278 ms: 4·d operations a pair at 989 TFLOP/s. TMA wants a head dim of
//     8·n and 16-byte aligned tensors: the wrapper pads or copies others
//     (flash_attention.py, `_tma_ready`) and the entry point refuses them.
//   * flash_attention_fwd_kernel, below, for f32, and for bf16 and f16 through the
//     `_f32_launch` entry point, which keeps P in f32 as heat_tpu's ring attention does for
//     its blocks.
//
// What bounds the f32 kernel on an H100: 4·d operations per attended (query, key) pair
// (q·kᵀ and P·V) against q, k, v read and O written once, some 1e3 operations per byte:
// arithmetic. Every product runs on the tensor cores as m16n8k8 TF32 mma.sync in 3xTF32
// (mma_tf32x3.cuh): an f32 operand splits into a TF32 big part and a TF32 residual, a·b is
// small·big + big·small + big·big with f32 accumulation, and the dropped small·small term
// keeps the result at fp32's level of accuracy. So the bound is the 3xTF32 rate, 495/3 = 165 TFLOP/s:
// 1.666 ms at the Transformer forward's encoder shape, 64 × 4096² × 64 f32 (the fp32 FMA
// pipe's 67 TFLOP/s, this kernel's roof until it moved to the tensor cores, would put it at
// 4.103 ms). bf16 and f16 values are exact in TF32: their f32-output instances skip the
// products with a zero small part, one product for q·kᵀ and two for P·V. The design, as
// the backward's K4 (flash_attention_bwd.cu), on the tiles and fragments of flash_tiles.cuh:
//   * A block owns 128 query rows of one batch·head, eight warps of 16 (the m16 of
//     m16n8k8), and loops over the tiles of 32 keys they attend (16 for d <= 128). S of a
//     tile, the online-softmax state (m, l) and the output accumulator stay in registers,
//     in the accumulator's layout: lane 4g + t holds rows g and g + 8, so the row maximum
//     takes two __shfl_xor_sync within the quad, and the row sum is kept in four parts a
//     row until the end. o and lse are written once.
//   * q, the A operand of S, is loaded once as f32 and split once in place into its TF32
//     parts, which each warp reads with two ldmatrix a k chunk (flash_tiles.cuh's
//     `load_q`). k, the B operand, is key-major, the "col" layout m16n8k8 wants, and is
//     read with ldmatrix. P, the S accumulator, feeds straight back as
//     the A operand of P·V with k permuted within each 8-wide chunk (tf32x3::from_acc),
//     split into its TF32 parts (P stays f32: f32 inputs, and the ring attentions' blocks
//     of 2-byte ones); v is read down its columns to match.
//   * k and v tiles come through a cp.async ring of two stages in the input type: the next
//     tile's copies are issued after the barrier that opens a step and land while the step
//     computes (full 16-byte rows of d = 64 or 128 take copies whose indices are known at
//     compile time). Each tile is split once per block as it lands: f32 in place (big parts
//     over the values, small parts beside), 2-byte values only widened.
//   * Occupancy: at d <= 64, 112 KB of shared memory (f32; 64 KB for 2-byte types) and 128
//     registers a thread let two blocks, sixteen warps, share an SM; at d <= 128 one block
//     of 176 KB. Above 48 KB the shared memory is opted into once per instance and device
//     (cudaFuncSetAttribute), and a refusal goes back to the caller. Trials on the card
//     (tools/ab_flash.py, PERF.md) chose this shape over blocks of four or six warps, tiles
//     of 64 keys and q split into registers: those gave fewer warps an SM.
//   * The softmax runs in log2 units: x = s·scale·log2(e) (+ bias·log2(e)) and P = 2^(x − m)
//     by MUFU.EX2 (ex2.approx.ftz, relative error about 2⁻²², results below 2⁻¹²⁶ flushed
//     to 0: one instruction where the accurate expf takes about eight), m and LSE turned
//     back into natural units at the end.
//   * Causal tiles wholly above the diagonal are skipped by the loop bound; only tiles that
//     straddle the block's diagonal pay the mask (`_pair_schedule`'s flag bit 4), and the
//     longest causal blocks launch first. Key rows past tk are zero-filled by the copies
//     and get weight 0; rows past tq are never written; d is zero-padded to 64 or 128 once.
//     Rows of 2-byte values with an odd d are not 4-byte aligned and are copied with plain
//     loads into the same ring.
//   * Deterministic: no atomics and no reduction across blocks; each row sums its keys in a
//     fixed order, so two runs give identical bits.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with
// ctypes by heat_tpu_torch/core/kernels/flash_attention.py). Entry points return a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "flash_fwd_16bit.cuh"
#include "flash_tiles.cuh"

using namespace flash;
using namespace flash::fwd;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Shape<DP>::kBlocks) flash_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ bias,
    void* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d, float scale, int causal, int q_tiles,
    int copy_bytes, int out_f32) {
    constexpr bool kExact = sizeof(T) == 2;
    constexpr int TILE = Shape<DP>::kTile;
    extern __shared__ float4 smem4[];
    uint32_t* qs = reinterpret_cast<uint32_t*>(smem4);                             // q's parts
    T* ring = reinterpret_cast<T*>(qs + q_words<T, DP>());                         // kStages x (k, v) tiles
    uint32_t* work = reinterpret_cast<uint32_t*>(ring + 2 * kStages * TILE * DP);  // k, v parts

    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int m0 = (threadIdx.x / 32) * 16;  // the warp's rows in the block
    const long long bh = blockIdx.x / q_tiles;
    const int row0 = (q_tiles - 1 - (int)(blockIdx.x % q_tiles)) * kRows;  // the longest causal blocks first
    const T* kb = k + bh * tk * d;
    const T* vb = v + bh * tk * d;

    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + TILE - 1) / TILE;
    if (causal) tiles = min(tiles, (min(row0 + kRows, tq) - 1) / TILE + 1);

    zero_pad<T, DP, kThreads>(ring, 2 * kStages * TILE, d);
    copy_rows<T, DP, TILE, kThreads>(ring, kb, 0, tk, d, copy_bytes);
    copy_rows<T, DP, TILE, kThreads>(ring + TILE * DP, vb, 0, tk, d, copy_bytes);
    cp_async_commit();
    load_q<T, DP>(qs, q + bh * tq * d, row0, tq, d);
    const QRows<kExact, DP> qr{qs, m0, lane};
    Rows<DP> st;
    TileAt at{bias, 0, row0, row0 + m0 + g, tq, tk, g, t, scale * kLog2e, causal != 0};

    for (int it = 0; it < tiles; ++it) {
        cp_async_wait_all();
        __syncthreads();  // tile `it` has landed, and every warp is done with tile it-1
        if (it + 1 < tiles) {  // the next tile into the stage that tile it-1 released
            T* next = ring + ((it + 1) % kStages) * 2 * TILE * DP;
            copy_rows<T, DP, TILE, kThreads>(next, kb, (it + 1) * TILE, tk, d, copy_bytes);
            copy_rows<T, DP, TILE, kThreads>(next + TILE * DP, vb, (it + 1) * TILE, tk, d, copy_bytes);
        }
        cp_async_commit();
        T* cur = ring + (it % kStages) * 2 * TILE * DP;
        const Parts kp = split_tile<T, DP, TILE, kThreads>(cur, work);
        const Parts vp = split_tile<T, DP, TILE, kThreads>(cur + TILE * DP, work + TILE * DP);
        __syncthreads();  // the tile's parts are in place

        float s[TILE / 8][4];
        qk<kExact, DP>(s, qr, kp, lane);
        at.j0 = it * TILE;
        softmax_pv<kExact, DP>(s, vp, st, at);
    }
    // O in q's type, or in f32 for a caller that merges blocks (the ring attentions)
    if (out_f32) finalize<float, DP>(st, static_cast<float*>(o), lse, bh, at.r_lo, tq, d, t);
    else finalize<T, DP>(st, static_cast<T*>(o), lse, bh, at.r_lo, tq, d, t);
}

// K2 for bf16 and f16 on wgmma: O and LSE for fwd16::kRows query rows of one batch·head
// (flash_fwd_16bit.cuh), each tile's two products one after the other
template <typename T, int DP>
__global__ void __launch_bounds__(fwd16::kThreads, 1) flash_attention_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias, void* __restrict__ o,
    float* __restrict__ lse, int bh, int tq, int tk, int d, float scale, int causal, int group) {
    fwd16::forward<T, DP, false>(&map_q, &map_k, &map_v, bias, o, lse, bh, tq, tk, d, scale, causal, group);
}

namespace {

template <typename T, int DP>
cudaError_t launch(int device, const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
                   int bh, int tq, int tk, int d, float scale, int causal, int out_f32, cudaStream_t stream) {
    static std::atomic<unsigned long long> done{0};
    constexpr size_t smem = smem_bytes<T, DP>();
    const int q_tiles = (tq + kRows - 1) / kRows;
    const long long blocks = (long long)bh * q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const cudaError_t err = opt_in(flash_attention_fwd_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_fwd_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, o, lse, tq, tk, d, scale,
        causal, q_tiles, copy_width<T>(d, k, v), out_f32);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int device, const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
                     int bh, int tq, int tk, int d, float scale, int causal, int out_f32, cudaStream_t stream) {
    if (d <= 64) return launch<T, 64>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, out_f32, stream);
    return launch<T, 128>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, out_f32, stream);
}

template <typename T, int DP>
int launch_wgmma(int device, const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
                 int bh, int tq, int tk, int d, float scale, int causal, cudaStream_t stream) {
    static std::atomic<unsigned long long> done{0};
    constexpr size_t smem = fwd16::Smem<DP>::kBytes;
    const long long blocks = fwd16::grid_blocks(bh, tq);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    CUtensorMap maps[3];
    const int rc = fwd16::make_maps<T>(maps, q, k, v, bh, tq, tk, d);
    if (rc != 0) return rc;
    const cudaError_t err = opt_in(flash_attention_fwd_wgmma_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_fwd_wgmma_kernel<T, DP><<<(unsigned)blocks, fwd16::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], bias, o, lse, bh, tq, tk, d, scale, causal, fwd16::group(bias, bh));
    return cudaGetLastError();
}

// the entry points' checks and dispatch on the input type: 2-byte inputs with an output in
// their type take the wgmma kernel, whose inputs TMA must take (the wrapper pads and copies);
// f32 inputs, and 2-byte ones with an f32 output (the ring attentions' blocks), the 3xTF32 one
int dispatch(int device, int dtype, const void* q, const void* k, const void* v, const float* bias, void* o,
             float* lse, int bh, int tq, int tk, int d, float scale, int causal, void* stream, int out_f32) {
    if (d < 1 || d > 128 || bh < 1 || tq < 1 || tk < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((dtype == 1 || dtype == 2) && !out_f32) {
        if (!wg16::tma_ready(d, q, k, v)) return cudaErrorInvalidValue;
#define HT_K2(T) (d > 64 ? launch_wgmma<T, 128>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, s) \
                         : launch_wgmma<T, 64>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, s))
        return dtype == 1 ? HT_K2(__nv_bfloat16) : HT_K2(__half);
#undef HT_K2
    }
    switch (dtype) {
        case 0: return launch_d<float>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, out_f32, s);
        case 1: return launch_d<__nv_bfloat16>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, out_f32, s);
        case 2: return launch_d<__half>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, out_f32, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. q (bh, tq, d), k and v (bh, tk, d) contiguous in
// that type, bias (tq, tk) f32 contiguous or null, o (bh, tq, d) in that type and lse (bh, tq)
// f32 allocated by the caller; 1 <= d <= 128, and for 2-byte types d a multiple of 8 and q, k
// and v 16-byte aligned (TMA's). The kernel runs on `stream`; nothing is synchronised.
int flash_attention_fwd_launch(int device, int dtype, const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int bh, int tq, int tk, int d,
                               float scale, int causal, void* stream) {
    return dispatch(device, dtype, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, stream, 0);
}

// The same with o (bh, tq, d) f32 whatever the input type: blocks that a caller merges
// by their LSEs (the ring attentions) round once, at the end, and not once a block. 2-byte
// inputs keep the 3xTF32 kernel and P in f32 here, as heat_tpu's ring keeps its blocks' P in
// f32 (`_online_attend`, heat_tpu/nn/attention.py:198, :211-214).
int flash_attention_fwd_f32_launch(int device, int dtype, const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int bh, int tq, int tk, int d,
                               float scale, int causal, void* stream) {
    return dispatch(device, dtype, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, stream, 1);
}

const char* flash_attention_error_string(int code) { return tc_error_string(code); }

}  // extern "C"
