// K3 for Hopper: the pipelined flash-attention forward, on the tensor cores: bf16 and f16 on
// wgmma, f32 in 3xTF32.
//
// Replaces the Pallas TPU kernel heat_tpu/core/kernels/flash_attention.py:238
// (`_kernel_pipelined`, launched by `_flash_pallas` under HEAT_TPU_FLASH_PIPELINE=1 over the
// schedule `_pair_schedule_pipelined`). It computes what K2 (flash_attention_fwd.cu)
// computes: for q (bh, tq, d) and k, v (bh, tk, d) in f32, bf16 or f16, and an optional
// additive bias (tq, tk) f32 shared by every batch·head,
//   o   (bh, tq, d) in q's type : softmax(scale·q·kᵀ + bias) v, rows fully masked give 0
//                                 (in f32 through the `_f32_launch` entry point)
//   lse (bh, tq)    f32         : max(m, NEG_INF/2) + log(max(l, 1e-30)), m the row maximum
// Causal attention is top-left aligned (row i attends columns j <= i) for any tq, tk.
//
// Two kernels, by the input type, as K2's:
//   * flash_attention_fwd_pipelined_wgmma_kernel, for bf16 and f16 with o in their type: K2's
//     16-bit block (flash_fwd_16bit.cuh: P rounded to the input type before P·V as heat_tpu
//     rounds it, wgmma fed by TMA) with the one-step skew below, S_{j+1} in flight on the
//     tensor cores while the softmax of tile j runs. It walks K2's tiles with K2's
//     arithmetic, so the two give the same bits.
//   * flash_attention_fwd_pipelined_kernel, below, for f32, and for bf16 and f16 through the
//     `_f32_launch` entry point (the ring attentions' blocks, whose P stays f32 as in
//     heat_tpu's ring).
//
// What bounds the f32 kernel on an H100: as K2's, arithmetic, 4·d operations per attended
// (query, key) pair, every product an m16n8k8 TF32 mma.sync in 3xTF32 (mma_tf32x3.cuh), so
// the 3xTF32 rate of 165 TFLOP/s: 1.666 ms at the encoder shape 64 × 4096² × 64 f32 (4.103 ms at the
// fp32 FMA rate that bounded this kernel before). It shares K2's tiles, fragments, products
// and softmax step (flash_tiles.cuh); what makes it K3 and not a second K2 is the TPU
// kernel's one-step skew:
//   * The skew. Step j issues the tensor-core products of S_{j+1} = q·K_{j+1}ᵀ into one
//     set of accumulator fragments, then runs the softmax (scale, masks, the row maximum,
//     MUFU.EX2 of every score) and P·V_j on S_j in the other. The two chains share no
//     data, so the exps of tile j can issue while the products of tile j+1 are in flight
//     in the tensor pipe: the overlap the TPU kernel was written for. The loop is unrolled
//     by two so that the two sets keep static register indices. A first step forms only
//     S_0; a final flush step only updates and finalizes.
//   * The ring, one tile ahead: k and v tiles come through cp.async rings of two stages
//     each in the input type, the v ring one tile behind the k ring as the lagged v index
//     map is. Step j needs K_{j+1} and V_j; they were issued at the start of step j-1 and
//     land while it computes. Each is split once per block as it lands (f32 in place, big
//     parts over the values and small parts beside; 2-byte values widened).
//   * The block, K2's (flash_tiles.cuh's `fwd`): 128 query rows of one batch·head in eight
//     warps of 16, tiles of 32 keys (16 for d <= 128), q split once in place into its TF32
//     parts; 112 KB of shared memory (f32) and 128 registers a thread at d <= 64, so two
//     blocks share an SM (one at d <= 128; above 48 KB the shared memory is opted into
//     once per instance and device). Two sets of score fragments of 32 keys cost what one
//     of 64 would.
//   * As K2: the softmax in log2 units with MUFU.EX2, P f32, causal tiles above the
//     diagonal skipped by the loop bound and only straddling
//     ones masked, the longest causal blocks first, key rows past tk zero-filled and given
//     weight 0, rows of 2-byte values with an odd d copied with plain loads into the ring.
// Deterministic: no reduction crosses blocks and each row sums its keys in a fixed order.
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

namespace {

// The rings of one block: tile j of k lives in k stage j % kStages, tile j of v in v stage
// j % kStages, and a step reads the parts of K_{j+1} and V_j
template <typename T, int DP>
struct Rings {
    static constexpr int TILE = Shape<DP>::kTile;
    T* kr;         // kStages x (TILE, DP)
    T* vr;         // kStages x (TILE, DP)
    uint32_t* work;
    const T* kb;   // this batch·head's k (tk, d)
    const T* vb;   // and v
    int tk, d, w, tiles;

    __device__ __forceinline__ void load_k(int j) const {
        copy_rows<T, DP, TILE, kThreads>(kr + (j % kStages) * TILE * DP, kb, j * TILE, tk, d, w);
    }
    __device__ __forceinline__ void load_v(int j) const {
        copy_rows<T, DP, TILE, kThreads>(vr + (j % kStages) * TILE * DP, vb, j * TILE, tk, d, w);
    }

    // The start of step j (-1 <= j < tiles): K_{j+1} and V_j, issued at the start of step
    // j-1, have landed and every warp is done with step j-1; K_{j+2} and V_{j+1} are issued
    // into the stages that step j-1 released, to land while step j computes; K_{j+1} (but
    // in the flush step) and V_j (but in the first step) are split, into `k` and `v`.
    __device__ __forceinline__ void begin_step(int j, Parts& k, Parts& v) const {
        cp_async_wait_all();
        __syncthreads();
        if (j + 2 < tiles) load_k(j + 2);
        if (j + 1 < tiles) load_v(j + 1);
        cp_async_commit();
        if (j + 1 < tiles) k = split_tile<T, DP, TILE, kThreads>(kr + ((j + 1) % kStages) * TILE * DP, work);
        if (j >= 0) v = split_tile<T, DP, TILE, kThreads>(vr + (j % kStages) * TILE * DP, work + TILE * DP);
        __syncthreads();  // the parts are in place
    }
};

}  // namespace

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Shape<DP>::kBlocks) flash_attention_fwd_pipelined_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ bias,
    void* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d, float scale, int causal, int q_tiles,
    int copy_bytes, int out_f32) {
    constexpr bool kExact = sizeof(T) == 2;
    constexpr int TILE = Shape<DP>::kTile;
    extern __shared__ float4 smem4[];
    uint32_t* qs = reinterpret_cast<uint32_t*>(smem4);  // q's parts
    T* kr = reinterpret_cast<T*>(qs + q_words<T, DP>());
    T* vr = kr + kStages * TILE * DP;
    uint32_t* work = reinterpret_cast<uint32_t*>(vr + kStages * TILE * DP);

    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int m0 = (threadIdx.x / 32) * 16;  // the warp's rows in the block
    const long long bh = blockIdx.x / q_tiles;
    const int row0 = (q_tiles - 1 - (int)(blockIdx.x % q_tiles)) * kRows;  // the longest causal blocks first

    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + TILE - 1) / TILE;
    if (causal) tiles = min(tiles, (min(row0 + kRows, tq) - 1) / TILE + 1);
    const Rings<T, DP> rings{kr, vr, work, k + bh * tk * d, v + bh * tk * d, tk, d, copy_bytes, tiles};

    zero_pad<T, DP, kThreads>(kr, 2 * kStages * TILE, d);  // both rings: the padded columns
    rings.load_k(0);
    cp_async_commit();
    load_q<T, DP>(qs, q + bh * tq * d, row0, tq, d);
    const QRows<kExact, DP> qr{qs, m0, lane};
    Rows<DP> st;
    TileAt at{bias, 0, row0, row0 + m0 + g, tq, tk, g, t, scale * kLog2e, causal != 0};

    Parts kp{}, vp{};
    float sa[TILE / 8][4], sb[TILE / 8][4];
    // the first step: S_0 only
    rings.begin_step(-1, kp, vp);
    qk<kExact, DP>(sa, qr, kp, lane);
    // steps j and j+1 that both form a next tile, two at a time so sa and sb stay static
    int j = 0;
    for (; j + 2 < tiles; j += 2) {
        rings.begin_step(j, kp, vp);
        qk<kExact, DP>(sb, qr, kp, lane);  // S_{j+1}, beside
        at.j0 = j * TILE;
        softmax_pv<kExact, DP>(sa, vp, st, at);  // the softmax and P·V of tile j
        rings.begin_step(j + 1, kp, vp);
        qk<kExact, DP>(sa, qr, kp, lane);
        at.j0 = (j + 1) * TILE;
        softmax_pv<kExact, DP>(sb, vp, st, at);
    }
    if (j + 1 < tiles) {
        rings.begin_step(j, kp, vp);
        qk<kExact, DP>(sb, qr, kp, lane);
        at.j0 = j * TILE;
        softmax_pv<kExact, DP>(sa, vp, st, at);
        rings.begin_step(j + 1, kp, vp);  // the flush
        at.j0 = (j + 1) * TILE;
        softmax_pv<kExact, DP>(sb, vp, st, at);
    } else {
        rings.begin_step(j, kp, vp);  // the flush
        at.j0 = j * TILE;
        softmax_pv<kExact, DP>(sa, vp, st, at);
    }
    // O in q's type, or in f32 for a caller that merges blocks (the ring attentions)
    if (out_f32) finalize<float, DP>(st, static_cast<float*>(o), lse, bh, at.r_lo, tq, d, t);
    else finalize<T, DP>(st, static_cast<T*>(o), lse, bh, at.r_lo, tq, d, t);
}

// K3 for bf16 and f16 on wgmma: K2's block (flash_fwd_16bit.cuh) with heat_tpu's one-step
// skew, S_{j+1} in flight on the tensor cores while the softmax of tile j runs
template <typename T, int DP>
__global__ void __launch_bounds__(fwd16::kThreads, 1) flash_attention_fwd_pipelined_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias, void* __restrict__ o,
    float* __restrict__ lse, int bh, int tq, int tk, int d, float scale, int causal, int group) {
    fwd16::forward<T, DP, true>(&map_q, &map_k, &map_v, bias, o, lse, bh, tq, tk, d, scale, causal, group);
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
    const cudaError_t err = opt_in(flash_attention_fwd_pipelined_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_fwd_pipelined_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
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
    const cudaError_t err = opt_in(flash_attention_fwd_pipelined_wgmma_kernel<T, DP>, smem, device, done);
    if (err != cudaSuccess) return err;
    flash_attention_fwd_pipelined_wgmma_kernel<T, DP><<<(unsigned)blocks, fwd16::kThreads, smem, stream>>>(
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
#define HT_K3(T) (d > 64 ? launch_wgmma<T, 128>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, s) \
                         : launch_wgmma<T, 64>(device, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, s))
        return dtype == 1 ? HT_K3(__nv_bfloat16) : HT_K3(__half);
#undef HT_K3
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
int flash_attention_fwd_pipelined_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                         const float* bias, void* o, float* lse, int bh, int tq, int tk, int d,
                                         float scale, int causal, void* stream) {
    return dispatch(device, dtype, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, stream, 0);
}

// The same with o (bh, tq, d) f32 whatever the input type: blocks that a caller merges
// by their LSEs (the ring attentions) round once, at the end, and not once a block. 2-byte
// inputs keep the 3xTF32 kernel and P in f32 here, as heat_tpu's ring keeps its blocks' P in
// f32 (`_online_attend`, heat_tpu/nn/attention.py:198, :211-214).
int flash_attention_fwd_pipelined_f32_launch(int device, int dtype, const void* q, const void* k, const void* v,
                                         const float* bias, void* o, float* lse, int bh, int tq, int tk, int d,
                                         float scale, int causal, void* stream) {
    return dispatch(device, dtype, q, k, v, bias, o, lse, bh, tq, tk, d, scale, causal, stream, 1);
}

const char* flash_attention_fwd_pipelined_error_string(int code) { return tc_error_string(code); }

}  // extern "C"
