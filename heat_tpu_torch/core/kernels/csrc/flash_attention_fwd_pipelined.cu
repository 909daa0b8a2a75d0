// K3 for Hopper: the pipelined flash-attention forward.
//
// Replaces the Pallas TPU kernel heat_tpu/core/kernels/flash_attention.py:238
// (`_kernel_pipelined`, launched by `_flash_pallas` under HEAT_TPU_FLASH_PIPELINE=1 over the
// schedule `_pair_schedule_pipelined`). It computes what K2 (flash_attention_fwd.cu)
// computes: for q (bh, tq, d) and k, v (bh, tk, d) in f32, bf16 or f16, and an optional
// additive bias (tq, tk) f32 shared by every batch·head,
//   o   (bh, tq, d) in q's type : softmax(scale·q·kᵀ + bias) v, rows fully masked give 0
//   lse (bh, tq)    f32         : max(m, NEG_INF/2) + log(max(l, 1e-30)), m the row maximum
// Causal attention is top-left aligned (row i attends columns j <= i) for any tq, tk.
//
// What bounds it on an H100: as K2, arithmetic. 4·d operations per attended (query, key)
// pair (q·k and p·v) against q, k, v read and o written once, some 1e3 operations per
// byte; in full fp32 on the CUDA cores its roof is 67 TFLOP/s. What makes it K3 and not a
// second K2 is the TPU kernel's one-step skew, carried over as follows:
//   * The k/v ring. A block owns ROWS query rows of one batch·head and walks the key tiles
//     of kBK = 16 keys. k and v tiles come through rings of kStages = 2 shared-memory
//     stages each, filled with cp.async in the input type, the bias tile riding with its
//     k tile. The copies of the next tiles are in flight while the current ones are
//     computed: the counterpart of Pallas's double-buffered DMA, with the v ring one tile
//     behind the k ring as the lagged v index map is. f32 tiles are read where they land;
//     bf16 and f16 tiles are widened once per step into one f32 tile each of k and v,
//     so the inner loops read f32 whatever the input type (converting at every read
//     would cost about one more instruction per FMA).
//   * The skew. Step j first forms the scores S_{j+1} = scale·q·K_{j+1}ᵀ (+ bias, masked
//     where the tile straddles the diagonal or passes tk) in one score buffer, then runs
//     exp, rescale and P·V_j on S_j in the other. The two chains share no data, so the
//     FMAs of the dot products and the exps (MUFU) of the softmax can issue side by side.
//     The loop is unrolled by two so the two buffers keep static register indices, and a
//     step is one basic block: no branch between the two chains (the bias is a zero tile
//     when there is none).
//   * The ends of the loop. A first step forms only S_0; a final flush step only updates
//     and finalizes.
//   * Registers. Two score buffers of 16 keys cost what K2's one of 32 costs: q and the
//     accumulator of a row (DP/TPR floats each) plus 32 scores. TPR threads own a row (1
//     for d <= 64, 2 for d <= 128), each holding 64 columns.
//   * Copies. cp.async of 16 bytes where k, v and the row width (d·sizeof) allow, else 8
//     or 4 bytes; key rows past tk are zero-filled through the src-size operand (and then
//     masked). A row of 2-byte elements with an odd d is not 4-byte aligned, and cp.async
//     copies at least 4 bytes: such tiles are copied with plain loads into the same ring.
// Deterministic: no reduction crosses blocks and each row sums its keys in a fixed order.
// Probabilities stay f32 for p·v (the TPU kernel rounds them to v's type), exp is expf.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with
// ctypes by heat_tpu_torch/core/kernels/flash_attention.py). Entry points return a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;            // threads per block
constexpr int kBK = 16;                  // keys per tile
constexpr int kStages = 2;               // stages of each ring
constexpr int kBS = kBK + 1;             // bias tile row stride (no bank conflicts)
constexpr float kNegInf = -FLT_MAX;      // finfo(float32).min, heat_tpu's _NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__host__ __device__ constexpr int rows_per_block(int tpr) { return kThreads / tpr; }

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int dp, int tpr) {
    return 2 * kStages * kBK * dp * sizeof(T)                                // k and v rings
           + kStages * rows_per_block(tpr) * kBS * sizeof(float)            // bias ring
           + (sizeof(T) == sizeof(float) ? 0 : 2 * kBK * dp * sizeof(float));  // widened k and v tiles
}
// 41,472 bytes at most (f32 or 2-byte types, d <= 128): within the 48 KB a launch gets
// without opting in
static_assert(smem_bytes<float>(64, 1) <= 48 * 1024 && smem_bytes<float>(128, 2) <= 48 * 1024 &&
              smem_bytes<__half>(64, 1) <= 48 * 1024 && smem_bytes<__half>(128, 2) <= 48 * 1024,
              "K3's shared memory needs cudaFuncSetAttribute");

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

// rows j0 .. j0+kBK-1 of a (tk, d) matrix into a (kBK, DP) stage, W bytes a copy (W divides
// d·sizeof(T) and the source's alignment); rows past tk are zero-filled. Columns d .. DP-1
// are never written here (zeroed once).
template <typename T, int DP, int W>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int j0, int tk, int d, int tid) {
    constexpr int E = W / sizeof(T);
    const int per_row = d / E;
    for (int idx = tid; idx < kBK * per_row; idx += kThreads) {
        const int j = idx / per_row;
        const int c = (idx - j * per_row) * E;
        const bool in = j0 + j < tk;
        cp_async<W>(dst + j * DP + c, in ? src + (long long)(j0 + j) * d + c : src, in);
    }
}

// the same with plain loads, for rows that are not 4-byte aligned (2-byte types, odd d)
template <typename T, int DP>
__device__ __forceinline__ void copy_tile_sync(T* dst, const T* src, int j0, int tk, int d, int tid) {
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
        const int j = idx / d;
        const int c = idx - j * d;
        dst[j * DP + c] = (j0 + j < tk) ? src[(long long)(j0 + j) * d + c] : from_f32<T>(0.f);
    }
}

template <typename T, int DP>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int j0, int tk, int d, int w, int tid) {
    if (w == 16) {
        copy_tile<T, DP, 16>(dst, src, j0, tk, d, tid);
    } else if (w == 8) {
        copy_tile<T, DP, 8>(dst, src, j0, tk, d, tid);
    } else if (w == 4) {
        copy_tile<T, DP, 4>(dst, src, j0, tk, d, tid);
    } else {
        copy_tile_sync<T, DP>(dst, src, j0, tk, d, tid);
    }
}

// the (ROWS, kBK) bias tile of query rows row0.. and keys j0.., 0 outside (tq, tk)
template <int ROWS>
__device__ __forceinline__ void copy_bias(float* dst, const float* bias, int row0, int j0, int tq, int tk, int tid) {
    for (int idx = tid; idx < ROWS * kBK; idx += kThreads) {
        const int rr = idx / kBK;
        const int j = idx % kBK;
        const bool in = row0 + rr < tq && j0 + j < tk;
        cp_async<4>(dst + rr * kBS + j, in ? bias + (long long)(row0 + rr) * tk + j0 + j : bias, in);
    }
}

// a (kBK, DP) stage of 2-byte values widened to f32, 8 values (16 bytes) a thread at a time
template <typename T, int DP>
__device__ __forceinline__ void widen(float* dst, const T* src, int tid) {
    for (int i = tid * 8; i < kBK * DP; i += kThreads * 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + i);
        const T* h = reinterpret_cast<const T*>(&u);
        *reinterpret_cast<float4*>(dst + i) = make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
        *reinterpret_cast<float4*>(dst + i + 4) = make_float4(to_f32(h[4]), to_f32(h[5]), to_f32(h[6]), to_f32(h[7]));
    }
}

// The rings of one block: tile t of k (with its bias tile) and of v lives in stage t % kStages.
template <typename T, int DP, int ROWS>
struct Rings {
    static constexpr bool kWiden = sizeof(T) != sizeof(float);
    T* kr;            // kStages x (kBK, DP)
    T* vr;            // kStages x (kBK, DP)
    float* br;        // kStages x (ROWS, kBS)
    float* kf;        // (kBK, DP): K_{j+1} widened to f32 during step j (2-byte types)
    float* vf;        // (kBK, DP): V_j widened
    const T* kb;      // this batch·head's k (tk, d)
    const T* vb;      // and v
    const float* bias;
    int row0, tq, tk, d, w, tid, tiles;

    // the f32 tiles that step t-1 (for k) and step t (for v) read
    __device__ __forceinline__ const float* k_tile(int t) const {
        if constexpr (kWiden) return kf;
        else return kr + (t % kStages) * kBK * DP;
    }
    __device__ __forceinline__ const float* v_tile(int t) const {
        if constexpr (kWiden) return vf;
        else return vr + (t % kStages) * kBK * DP;
    }
    __device__ __forceinline__ const float* b_tile(int t) const { return br + (t % kStages) * ROWS * kBS; }

    __device__ __forceinline__ void load_k(int t) const {
        copy_rows<T, DP>(kr + (t % kStages) * kBK * DP, kb, t * kBK, tk, d, w, tid);
        if (bias != nullptr) copy_bias<ROWS>(br + (t % kStages) * ROWS * kBS, bias, row0, t * kBK, tq, tk, tid);
    }
    __device__ __forceinline__ void load_v(int t) const {
        copy_rows<T, DP>(vr + (t % kStages) * kBK * DP, vb, t * kBK, tk, d, w, tid);
    }

    // The start of step j (-1 <= j < tiles): K_{j+1} and V_j, issued at the start of step
    // j-1, have landed for every thread; then K_{j+2} and V_{j+1} are issued into the
    // stages that step j-1 has released, to land while step j computes. 2-byte tiles are
    // widened then (K_{j+1} past the last tile holds stale values that no one reads).
    __device__ __forceinline__ void begin_step(int j) const {
        cp_async_wait_all();
        __syncthreads();
        if (j + 2 < tiles) load_k(j + 2);
        if (j + 1 < tiles) load_v(j + 1);
        cp_async_commit();
        if constexpr (kWiden) {
            widen<T, DP>(kf, kr + ((j + 1) % kStages) * kBK * DP, tid);
            if (j >= 0) widen<T, DP>(vf, vr + (j % kStages) * kBK * DP, tid);
            __syncthreads();
        }
    }
};

// s = scale·q·kᵀ + bias for the kBK keys of tile j0 (this thread's columns, summed over
// the row's TPR threads); keys past the diagonal get the finite NEG_INF (straddling tiles
// only), keys past tk -inf (weight exactly 0)
template <int DP, int TPR>
__device__ __forceinline__ void scores(float (&s)[kBK], const float (&qr)[DP / TPR], const float* kt, const float* bt,
                                       int sub, int r, int row, int j0, bool straddles, int tk, float scale) {
    constexpr int C4 = DP / TPR / 4;  // chunk i holds columns 4*(sub + TPR*i) ..+3
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < C4; ++i) {
        const int c = 4 * (sub + TPR * i);
#pragma unroll
        for (int j = 0; j < kBK; ++j) {
            const float4 kv = load4(kt + j * DP + c);
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
    const bool ragged = j0 + kBK > tk;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
        float x = s[j] * scale;
        x += bt[r * kBS + j];
        x = (straddles && j0 + j > row) ? kNegInf : x;
        x = (ragged && j0 + j >= tk) ? -INFINITY : x;
        s[j] = x;
    }
}

// one tile of the online-softmax recurrence (`_online_softmax_update`, flash_attention.py:135)
// on the scores s, with the v tile vt
template <int DP, int TPR>
__device__ __forceinline__ void update(float (&s)[kBK], float (&acc)[DP / TPR], float& m, float& l, const float* vt,
                                       int sub) {
    constexpr int C4 = DP / TPR / 4;
    float m_blk = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) m_blk = fmaxf(m_blk, s[j]);
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
    for (int c = 0; c < DP / TPR; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
        for (int i = 0; i < C4; ++i) {
            const float4 vv = load4(vt + j * DP + 4 * (sub + TPR * i));
            acc[4 * i + 0] = fmaf(s[j], vv.x, acc[4 * i + 0]);
            acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
        }
    }
    m = m_new;
}

}  // namespace

template <typename T, int DP, int TPR>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_pipelined_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
    int tq, int tk, int d, float scale, int causal, int q_tiles, int copy_bytes) {
    constexpr int ROWS = rows_per_block(TPR);
    constexpr int DPT = DP / TPR;   // columns of one thread
    constexpr int C4 = DPT / 4;
    extern __shared__ float4 smem4[];
    T* kr = reinterpret_cast<T*>(smem4);
    T* vr = kr + kStages * kBK * DP;
    float* br = reinterpret_cast<float*>(vr + kStages * kBK * DP);
    float* kf = br + kStages * ROWS * kBS;  // used for 2-byte types only
    float* vf = kf + kBK * DP;

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int sub = tid % TPR;
    const long long bh = blockIdx.x / q_tiles;
    const int row0 = (blockIdx.x % q_tiles) * ROWS;
    const int row = row0 + r;
    const bool live = row < tq;

    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + kBK - 1) / kBK;
    if (causal) {
        const int last_row = min(row0 + ROWS, tq) - 1;
        tiles = min(tiles, last_row / kBK + 1);
    }
    const Rings<T, DP, ROWS> rings{kr, vr, br, kf, vf, k + bh * tk * d, v + bh * tk * d, bias,
                                   row0, tq, tk, d, copy_bytes, tid, tiles};

    // the copies never write the padded columns d .. DP-1 of the rings, nor, without a
    // bias, the bias ring: zero them once (made visible by the first step's barrier)
    if (d < DP) {
        for (int idx = tid; idx < 2 * kStages * kBK * (DP - d); idx += kThreads) {
            kr[(idx / (DP - d)) * DP + d + idx % (DP - d)] = from_f32<T>(0.f);
        }
    }
    if (bias == nullptr) {
        for (int idx = tid; idx < kStages * ROWS * kBS; idx += kThreads) br[idx] = 0.f;
    }
    rings.load_k(0);
    cp_async_commit();

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
    // flag bit 4 of _pair_schedule: the tile's last key passes the block's first row
    auto straddles = [&](int t) { return causal && t * kBK + kBK - 1 > row0; };

    float sa[kBK], sb[kBK];
    // the first step: S_0 only
    rings.begin_step(-1);
    scores<DP, TPR>(sa, qr, rings.k_tile(0), rings.b_tile(0), sub, r, row, 0, straddles(0), tk, scale);
    // steps j and j+1 that both form a next tile, two at a time so sa and sb stay static
    int j = 0;
    for (; j + 2 < tiles; j += 2) {
        rings.begin_step(j);
        scores<DP, TPR>(sb, qr, rings.k_tile(j + 1), rings.b_tile(j + 1), sub, r, row, (j + 1) * kBK,
                           straddles(j + 1), tk, scale);
        update<DP, TPR>(sa, acc, m, l, rings.v_tile(j), sub);
        rings.begin_step(j + 1);
        scores<DP, TPR>(sa, qr, rings.k_tile(j + 2), rings.b_tile(j + 2), sub, r, row, (j + 2) * kBK,
                           straddles(j + 2), tk, scale);
        update<DP, TPR>(sb, acc, m, l, rings.v_tile(j + 1), sub);
    }
    if (j + 1 < tiles) {
        rings.begin_step(j);
        scores<DP, TPR>(sb, qr, rings.k_tile(j + 1), rings.b_tile(j + 1), sub, r, row, (j + 1) * kBK,
                           straddles(j + 1), tk, scale);
        update<DP, TPR>(sa, acc, m, l, rings.v_tile(j), sub);
        rings.begin_step(j + 1);  // the flush
        update<DP, TPR>(sb, acc, m, l, rings.v_tile(j + 1), sub);
    } else {
        rings.begin_step(j);  // the flush
        update<DP, TPR>(sa, acc, m, l, rings.v_tile(j), sub);
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
    const size_t smem = smem_bytes<T>(DP, TPR);
    const int q_tiles = (tq + ROWS - 1) / ROWS;
    const long long blocks = (long long)bh * q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    // the widest copy that k's and v's addresses and the row width all allow
    const uintptr_t bits = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                           static_cast<uintptr_t>(d * sizeof(T));
    int w = 16;
    while (w > 2 && bits % w != 0) w /= 2;
    flash_attention_fwd_pipelined_kernel<T, DP, TPR><<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<T*>(o), lse, tq, tk, d, scale, causal, q_tiles, w);
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
int flash_attention_fwd_pipelined_launch(int device, int dtype, const void* q, const void* k, const void* v,
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

const char* flash_attention_fwd_pipelined_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
