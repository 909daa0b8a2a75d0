// The bf16 and f16 flash forward on Hopper's 16-bit tensor cores: the block, its producer and
// consumers and the host side of a launch, shared by K2 (flash_attention_fwd.cu's
// flash_attention_fwd_wgmma_kernel) and K3 (flash_attention_fwd_pipelined.cu's
// flash_attention_fwd_pipelined_wgmma_kernel).
//
// Each key tile of 64 is one step of heat_tpu's `_online_softmax_update`
// (flash_attention.py:135-152), in log2 units (x = s·scale·log2 e + bias·log2 e):
//   m_new = max(m, rowmax(x)),  m_safe = max(m_new, NEG_INF/2),  P = 2^(x − m_safe) in f32,
//   corr = 2^(m − m_safe),  l = l·corr + Σ P (the f32 P),  acc = acc·corr + round(P → T)·v,
// the last product with f32 accumulation. P is rounded to the input type, to nearest even, as
// heat_tpu rounds it before its P·V (`p_tile.astype(vb.dtype)`, :147-151); that is also what
// wgmma takes as its A operand. The finalize writes O = acc / max(l, 1e-30) in T and
// LSE = max(m, NEG_INF/2) + log(max(l, 1e-30)) in natural units.
//
// The block (as the backward's K4, flash_attention_bwd.cu): a producer warpgroup and two
// consumer warpgroups of 64 query rows each, 128 rows of one batch·head; setmaxnreg hands the
// producer's registers to the consumers (40 and 232 a thread). The producer's first thread
// loads q once by TMA, then keeps two rings of two stages full, one of k tiles and one of v
// tiles of 64 keys, a full and an empty mbarrier a stage. Boxes are 64 columns (128 bytes) by
// 64 rows of one batch·head from 3-D tensor maps, 128-byte swizzled; rows past tq or tk and
// columns past d arrive as zeros, which pads the head dim to DP = 64 or 128. A consumer holds
// its rows' O accumulator (64 x DP f32, DP / 2 a thread), the scores of a tile (32 a thread)
// and P packed into T (16 registers, the register A operand of P·V):
//   * S = q·kᵀ is wgmma m64n64k16 over DP / 16 steps, both operands K-major from shared
//     memory; O += P·V is m64nDPk16 over the tile's 4 steps of 16 keys, A from registers, B
//     the v tile read MN-major.
//   * The softmax runs in registers: the row maximum over the thread's 16 values of a row and
//     its quad (two shuffles), P by ex2.approx (MUFU.EX2), l kept a quarter row a thread and
//     summed over the quad at the end.
//   * Masks: the causal mask (top-left aligned: key > query) only in tiles that straddle the
//     warpgroup's diagonal, at the finite NEG_INF; keys past tk, which TMA brought as zeros
//     (score 0), at −inf, weight exactly 0; a bias is read from global memory into registers,
//     two keys a load, while the tile's S = q·kᵀ runs. A fully masked row keeps l = 0 (its
//     maximum is clamped at NEG_INF/2), so O is exactly 0 and LSE exactly NEG_INF/2 +
//     log(1e-30). Rows past tq are never written.
//   * Causal tiles wholly above the block's diagonal are not loaded (the loop bound), and a
//     consumer warpgroup skips the products of the tiles wholly above its own.
//   * Blocks launch by query block from the last (the longest causal ones first) across the
//     batch·heads of a group: one batch·head a group without a bias, so a batch·head's blocks
//     run side by side and share its k and v tiles in L2; kBiasGroup with one, so the
//     batch·heads' blocks of one query block also share the bias's rows, 2 MB of f32 at
//     bench.py's padding mask, where the whole bias (64 MB) exceeds the L2.
//   * No atomics and no sum across blocks: two runs give identical bits.
// K2 runs a tile's two products one after the other in each warpgroup. K3 skews them by one
// tile: step j issues S_{j+1} = q·K_{j+1}ᵀ, runs the softmax of tile j and issues P_j·V_j,
// and keeps one group in flight (wgmma.wait_group 1), so the exps of tile j run while the
// tensor cores work on tile j+1; its k ring runs one tile ahead of its v ring. The two walk
// the same tiles with the same arithmetic, so they give the same bits.

#pragma once

#include "flash_tiles.cuh"
#include "wgmma_16bit.cuh"

namespace fwd16 {

constexpr int kConsumers = 2;                     // consumer warpgroups a block, 64 query rows each
constexpr int kThreads = 128 * (1 + kConsumers);  // the producer warpgroup, then the consumers
constexpr int kRows = wg16::kOwnRows;             // query rows a block
constexpr int kTile = 64;                         // keys a ring tile
constexpr int kStages = 2;                        // stages of each ring
constexpr int kBiasGroup = 16;                    // batch·heads side by side under a bias

// Shared memory, for the head dim padded to DP, from a 1024-byte boundary (the swizzle's):
//   q      : DP / 64 column blocks of the block's (kRows x 64) values
//   k ring : kStages tiles of DP / 64 boxes of (kTile x 64); then the v ring, the same
//   bars   : k full[kStages], k empty[kStages], v full[kStages], v empty[kStages], q
template <int DP>
struct Smem {
    static constexpr int kQ = (DP / 64) * wg16::kOwnBlock;
    static constexpr int kTileBytes = (DP / 64) * wg16::kBox;
    static constexpr int kKRing = kQ;
    static constexpr int kVRing = kKRing + kStages * kTileBytes;
    static constexpr int kBars = kVRing + kStages * kTileBytes;
    static constexpr int kBytes = kBars + 8 * (4 * kStages + 1) + 1024;
};
static_assert(Smem<128>::kBytes <= 232448, "the 16-bit forward's shared memory exceeds an H100 block's");

template <int DP>
struct Block {
    uint32_t base;
    __device__ __forceinline__ uint32_t q() const { return base; }
    __device__ __forceinline__ uint32_t k(int st) const { return base + Smem<DP>::kKRing + st * Smem<DP>::kTileBytes; }
    __device__ __forceinline__ uint32_t v(int st) const { return base + Smem<DP>::kVRing + st * Smem<DP>::kTileBytes; }
    __device__ __forceinline__ uint32_t bar(int i) const { return base + Smem<DP>::kBars + 8u * i; }
    __device__ __forceinline__ uint32_t k_full(int st) const { return bar(st); }
    __device__ __forceinline__ uint32_t k_empty(int st) const { return bar(kStages + st); }
    __device__ __forceinline__ uint32_t v_full(int st) const { return bar(2 * kStages + st); }
    __device__ __forceinline__ uint32_t v_empty(int st) const { return bar(3 * kStages + st); }
    __device__ __forceinline__ uint32_t q_bar() const { return bar(4 * kStages); }
};

// the stage and the phase parity of tile j of a ring
__device__ __forceinline__ int stage(int j) { return j % kStages; }
__device__ __forceinline__ uint32_t parity(int j) { return (j / kStages) & 1u; }

// tile j of a ring (k or v) into its stage once the consumers have released the stage's
// previous tile
template <int DP>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t tile, uint32_t full, uint32_t empty, int j,
                                          int bh) {
    mbar_wait(empty, parity(j) ^ 1u);
    mbar_expect_tx(full, Smem<DP>::kTileBytes);
#pragma unroll
    for (int cb = 0; cb < DP / 64; ++cb) wg16::tma_load_3d(map, tile + cb * wg16::kBox, full, 64 * cb, j * kTile, bh);
}

// What a consumer thread needs to form P from a tile's scores: the thread's rows r_lo and
// r_lo + 8 (and its warpgroup's first, wrow0), its column pair 2·qd within each 8 of the
// accumulator (wgmma's layout: element i of a 64 x 64 accumulator is row r_lo + 8·((i/2)%2),
// column 8·(i/4) + 2·qd + (i&1))
struct Tile {
    const float* bias;  // (tq, tk) f32 or null
    int tq, tk, wrow0, r_lo, qd;
    float c2;           // scale·log2(e)
    bool causal;
};

// The bias of the thread's elements of keys j0 .. j0+63 (0 past tq or tk), two neighbouring
// keys a load where the rows' length tk is even; issued before the tile's scores are waited
// for, so that the loads run beside the product
__device__ __forceinline__ void load_bias(float (&bv)[32], const Tile& at, int j0) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
        const int row = at.r_lo + 8 * ((i / 2) % 2);
        const int key = j0 + 8 * (i / 4) + 2 * at.qd;
        const float* at_key = at.bias + (long long)row * at.tk + key;
        bv[i] = bv[i + 1] = 0.f;
        if (row < at.tq && at.tk % 2 == 0 && key < at.tk) {
            const float2 pair = *reinterpret_cast<const float2*>(at_key);
            bv[i] = pair.x;
            bv[i + 1] = pair.y;
        } else if (row < at.tq) {
            if (key < at.tk) bv[i] = at_key[0];
            if (key + 1 < at.tk) bv[i + 1] = at_key[1];
        }
    }
}

// The scores S of keys j0 .. j0+63 turned into P in place (with the bias `bv` of load_bias
// where there is one), the rows' maximum m (log2 units) and partial sum l updated, and the
// factor `corr` by which the rows' O accumulators rescale
__device__ __forceinline__ void softmax(float (&s)[32], const float (&bv)[32], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], const Tile& at, int j0) {
    const bool straddles = at.causal && j0 + kTile - 1 > at.wrow0;  // flag bit 4 of _pair_schedule
    const bool ragged = j0 + kTile > at.tk;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= at.c2;
    if (at.bias != nullptr) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = fmaf(bv[i], flash::kLog2e, s[i]);  // + 0 exactly past tq or tk
    }
    if (straddles || ragged) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int row = at.r_lo + 8 * ((i / 2) % 2);
            const int key = j0 + 8 * (i / 4) + 2 * at.qd + (i & 1);
            if (straddles && key > row) s[i] = flash::kNegInf;
            if (key >= at.tk) s[i] = -INFINITY;  // no such key: TMA's zeros get weight 0
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row's maximum over its quad
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(flash::kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(flash::kFull, mx[h], 2));
        ms[h] = fmaxf(mx[h], flash::kNegInf / 2);
        corr[h] = flash::exp2_approx(m[h] - ms[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        s[i] = flash::exp2_approx(s[i] - ms[(i / 2) % 2]);
        l[(i / 2) % 2] += s[i];
    }
}

template <int DP>
__device__ __forceinline__ void rescale(float (&acc)[DP / 2], const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i / 2) % 2];
}

// O = acc / max(l, 1e-30) in T and LSE = max(m, NEG_INF/2) + log(max(l, 1e-30)) for the
// thread's rows that exist, the quad's parts of l added first
template <typename T, int DP>
__device__ __forceinline__ void finalize(const float (&acc)[DP / 2], const float (&m)[2], const float (&l)[2],
                                         void* o, float* lse, int bh, const Tile& at, int d) {
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float x = l[h];
        x += __shfl_xor_sync(flash::kFull, x, 1);
        x += __shfl_xor_sync(flash::kFull, x, 2);
        lc[h] = fmaxf(x, 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = at.r_lo + 8 * h;
            const int col = 8 * j + 2 * at.qd;
            if (row < at.tq && col < d)
                wg16::store_pair<T>(o, ((long long)bh * at.tq + row) * d + col, acc[4 * j + 2 * h] / lc[h],
                                    acc[4 * j + 2 * h + 1] / lc[h], 0);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = at.r_lo + 8 * h;
        if (at.qd == 0 && row < at.tq)
            lse[(long long)bh * at.tq + row] = fmaxf(m[h] * flash::kLn2, flash::kNegInf / 2) + logf(lc[h]);
    }
}

// Step j of K3 on the scores S_j in `cur`: S_{j+1} issued into `next` when there is one
// (kMore), the softmax of tile j, P_j·V_j issued once P_{j-1}·V_{j-1} has ended (and V_{j-1}'s
// stage released); S_{j+1} has ended (and K_{j+1}'s stage is released) when it returns, P_j·V_j
// may still run
template <typename T, int DP, bool kMore>
__device__ __forceinline__ void skew_step(int j, float (&cur)[32], float (&next)[32], float (&acc)[DP / 2],
                                          float (&m)[2], float (&l)[2], uint32_t (&pa)[4][4], const Block<DP>& b,
                                          const Tile& at, uint32_t q, int lane) {
    float bv[32];
    if (at.bias != nullptr) load_bias(bv, at, j * kTile);
    if constexpr (kMore) {
        mbar_wait(b.k_full(stage(j + 1)), parity(j + 1));
        wg16::wgmma_fence();
        wg16::own_by_tile<T, DP>(next, q, b.k(stage(j + 1)));  // S_{j+1}, beside
        wg16::wgmma_commit();
    }
    float corr[2];
    softmax(cur, bv, m, l, corr, at, j * kTile);
    if constexpr (kMore) wg16::wgmma_wait<1>();  // all but S_{j+1}: P_{j-1}·V_{j-1} has ended
    else wg16::wgmma_wait<0>();
    wg16::fence_operands(acc);
    wg16::fence_operands(cur);
    if (j > 0 && lane == 0) mbar_arrive(b.v_empty(stage(j - 1)));
    rescale<DP>(acc, corr);
    wg16::a_frags<T>(pa, cur);  // P_j rounded to T
    mbar_wait(b.v_full(stage(j)), parity(j));
    wg16::wgmma_fence();
    wg16::acc_by_tile<T, DP>(acc, pa, b.v(stage(j)));  // O += P_j·V_j
    wg16::wgmma_commit();
    if constexpr (kMore) {
        wg16::wgmma_wait<1>();  // all but P_j·V_j: S_{j+1} has ended
        wg16::fence_operands(next);
        if (lane == 0) mbar_arrive(b.k_empty(stage(j + 1)));
    }
}

// The whole forward of a block: K2 with kSkew false, K3 with kSkew true. Blocks walk
// `group` batch·heads at a time, query block by query block from the last.
template <typename T, int DP, bool kSkew>
__device__ __forceinline__ void forward(const CUtensorMap* map_q, const CUtensorMap* map_k, const CUtensorMap* map_v,
                                        const float* bias, void* o, float* lse, int bh_count, int tq, int tk, int d,
                                        float scale, int causal, int group) {
    extern __shared__ uint8_t smem_raw[];
    const Block<DP> b{(smem_u32(smem_raw) + 1023u) & ~1023u};

    const int q_tiles = (tq + kRows - 1) / kRows;
    const int per_group = group * q_tiles;
    const int g0 = (blockIdx.x / per_group) * group;
    const int size = min(group, bh_count - g0);
    const int in = blockIdx.x % per_group;
    const int bh = g0 + in % size;
    const int row0 = (q_tiles - 1 - in / size) * kRows;
    // causal: the last key any row of this block attends is its last row
    int tiles = (tk + kTile - 1) / kTile;
    if (causal) tiles = min(tiles, (min(row0 + kRows, tq) - 1) / kTile + 1);

    if (threadIdx.x == 0) {
        for (int st = 0; st < kStages; ++st) {
            mbar_init(b.k_full(st), 1);                    // the producer's arrival, with the tile's bytes
            mbar_init(b.v_full(st), 1);
            mbar_init(b.k_empty(st), 4 * kConsumers);      // one arrival a consumer warp
            mbar_init(b.v_empty(st), 4 * kConsumers);
        }
        mbar_init(b.q_bar(), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int warpgroup = threadIdx.x / 128;
    if (warpgroup == 0) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            mbar_expect_tx(b.q_bar(), Smem<DP>::kQ);
            for (int cb = 0; cb < DP / 64; ++cb) {
                for (int h = 0; h < kRows / 64; ++h)
                    wg16::tma_load_3d(map_q, b.q() + cb * wg16::kOwnBlock + h * wg16::kBox, b.q_bar(), 64 * cb,
                                      row0 + 64 * h, bh);
            }
            // K3's step j reads K_{j+1} and V_j: its k tiles go one ahead of its v tiles
            constexpr int ahead = kSkew ? 1 : 0;
            for (int i = 0; i < tiles + ahead; ++i) {
                if (i < tiles) load_tile<DP>(map_k, b.k(stage(i)), b.k_full(stage(i)), b.k_empty(stage(i)), i, bh);
                if (i >= ahead) {
                    const int j = i - ahead;
                    load_tile<DP>(map_v, b.v(stage(j)), b.v_full(stage(j)), b.v_empty(stage(j)), j, bh);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = warpgroup - 1;
        const int t = threadIdx.x % 128;
        const int lane = t % 32;
        Tile at{bias, tq, tk, row0 + 64 * wg, 0, lane % 4, scale * flash::kLog2e, causal != 0};
        at.r_lo = at.wrow0 + 16 * (t / 32) + lane / 4;
        // the tiles this warpgroup attends: causal ones wholly above its rows are skipped
        const int n = causal ? min(tiles, (at.wrow0 + kTile - 1) / kTile + 1) : tiles;
        const uint32_t q = b.q() + wg * wg16::kBox;  // the warpgroup's 64 rows of each column block
        float acc[DP / 2];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
        float m[2] = {flash::kNegInf, flash::kNegInf}, l[2] = {0.f, 0.f};
        uint32_t pa[4][4];  // P in T: the A operand of P·V
        mbar_wait(b.q_bar(), 0);

        if constexpr (!kSkew) {
            for (int j = 0; j < n; ++j) {
                float s[32], bv[32];
                mbar_wait(b.k_full(stage(j)), parity(j));
                wg16::wgmma_fence();
                wg16::own_by_tile<T, DP>(s, q, b.k(stage(j)));  // S = q·kᵀ
                wg16::wgmma_commit();
                if (at.bias != nullptr) load_bias(bv, at, j * kTile);
                wg16::wgmma_wait<0>();
                wg16::fence_operands(s);
                if (lane == 0) mbar_arrive(b.k_empty(stage(j)));
                float corr[2];
                softmax(s, bv, m, l, corr, at, j * kTile);
                rescale<DP>(acc, corr);
                wg16::a_frags<T>(pa, s);  // P rounded to T
                mbar_wait(b.v_full(stage(j)), parity(j));
                wg16::wgmma_fence();
                wg16::acc_by_tile<T, DP>(acc, pa, b.v(stage(j)));  // O += P·V
                wg16::wgmma_commit();
                wg16::wgmma_wait<0>();
                wg16::fence_operands(acc);
                if (lane == 0) mbar_arrive(b.v_empty(stage(j)));
            }
        } else {
            float sa[32], sb[32];
            mbar_wait(b.k_full(0), 0);
            wg16::wgmma_fence();
            wg16::own_by_tile<T, DP>(sa, q, b.k(0));  // S_0
            wg16::wgmma_commit();
            wg16::wgmma_wait<0>();
            wg16::fence_operands(sa);
            if (lane == 0) mbar_arrive(b.k_empty(0));
            // steps that form a next tile two at a time, so that sa and sb stay static, then the
            // last one or two
            int j = 0;
            for (; j + 2 < n; j += 2) {
                skew_step<T, DP, true>(j, sa, sb, acc, m, l, pa, b, at, q, lane);
                skew_step<T, DP, true>(j + 1, sb, sa, acc, m, l, pa, b, at, q, lane);
            }
            if (j + 1 < n) {
                skew_step<T, DP, true>(j, sa, sb, acc, m, l, pa, b, at, q, lane);
                skew_step<T, DP, false>(j + 1, sb, sa, acc, m, l, pa, b, at, q, lane);
            } else {
                skew_step<T, DP, false>(j, sa, sb, acc, m, l, pa, b, at, q, lane);
            }
            wg16::wgmma_wait<0>();
            wg16::fence_operands(acc);
            if (lane == 0) mbar_arrive(b.v_empty(stage(n - 1)));
        }
        for (int j = n; j < tiles; ++j) {  // tiles wholly above this warpgroup's rows: released unread
            mbar_wait(b.k_full(stage(j)), parity(j));
            if (lane == 0) mbar_arrive(b.k_empty(stage(j)));
            mbar_wait(b.v_full(stage(j)), parity(j));
            if (lane == 0) mbar_arrive(b.v_empty(stage(j)));
        }
        finalize<T, DP>(acc, m, l, o, lse, bh, at, d);
    }
}

// ---------------------------------------------------------------- host side

// the TMA maps of q, k and v of a 2-byte forward (boxes of 64 rows); 0 or an error code
template <typename T>
int make_maps(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int bh, int tq, int tk, int d) {
    const void* ptrs[3] = {q, k, v};
    const int rows[3] = {tq, tk, tk};
    for (int i = 0; i < 3; ++i) {
        const int rc = wg16::make_map_3d<T>(&maps[i], ptrs[i], bh, rows[i], d, kTile);
        if (rc != 0) return rc;
    }
    return 0;
}

// the blocks of a launch, and the batch·heads whose blocks of one query block launch side by side
inline long long grid_blocks(int bh, int tq) { return (long long)bh * ((tq + kRows - 1) / kRows); }
inline int group(const float* bias, int bh) { return bias != nullptr ? (bh < kBiasGroup ? bh : kBiasGroup) : 1; }

}  // namespace fwd16
