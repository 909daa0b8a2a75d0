// K1 for Hopper: fused nearest-centroid assignment and per-cluster accumulation.
//
// Replaces the Pallas TPU kernel heat_tpu/core/kernels/kmeans.py:44 (`_kernel`, launched by
// `_fused_pallas`). One pass over x (n, d) f32 against centers (k, d) f32 gives
//   labels (n,) int32 : first index j of the row minimum of d2_j = max(|x|^2 + |c_j|^2 - 2 x.c_j, 0)
//   sums   (k, d)     : sum of the rows assigned to each cluster
//   counts (k,)       : rows per cluster, as f32 (exact below 2^24 rows per cluster)
//   sse               : sum over rows of the minimum d2
// packed into one record of k*d + k + 1 floats: sums, then counts, then sse. The Lloyd loop
// all-reduces exactly this record across ranks.
//
// What bounds it on an H100: each call reads x once, 4*n*d bytes, and does 2*n*k*d fp32
// operations for the dot products. At 10M x 64 x 8 that is 2.56 GB, 0.776 ms at 3.35 TB/s,
// against 0.17 ms of fp32 FMA work at 67 TFLOP/s: 4 operations a byte, where the FMA pipe
// balances the memory at 20. So K1 is bound by the bytes of x up to k of about 40, and
// tensor cores would not help there; they would also need TF32, which the quadratic
// expansion cannot take (it cancels for near points, the reason the TPU kernel asks for
// Precision.HIGHEST). Every product here is a plain fp32 FMA.
//
// Below its bound the SM runs out of issue slots, not bytes: streaming a tile, assigning its
// rows and summing them by cluster each hide behind the stream alone, but not all three in
// the same warps between block-wide barriers, where every thread issued copies (with an
// integer division each where 256 threads do not split a tile's chunks evenly, as at
// d = 28) and a tile's largest cluster held every warp. So the two phases have warps of
// their own, paced by mbarriers in shared memory, and no block-wide barrier inside the tile
// loop:
//   * A ring of `stages` tiles of whole rows (the planner's depth, shrunk to fit shared
//     memory). Where x is 16-byte aligned, d % 4 == 0 and a tile row's stride is its natural
//     one (always with the centers in registers: d = 28, d = 64), a tile is one contiguous
//     span and one lane copies it with one TMA bulk copy, which completes on the stage's full
//     barrier with its bytes. Otherwise every accumulating thread copies its share of a tile
//     with cp.async (16-byte chunks where x allows, else 4 bytes, so any contiguous x, at any
//     4-byte offset, streams without a host copy), each thread's copies arriving on the full
//     barrier when they land. (One bulk copy a row into padded rows streams at a third of the
//     card's bandwidth, tools/k1_probe.py --stream; one warp's cp.async into them makes a
//     stage wait for its copies.)
//   * Assigning warps (one thread a row, or TPR threads a row) wait on a stage's full
//     barrier, write each row's label to the stage's label slots (-1 past the last row),
//     arrive on its assigned barrier, and then store the labels to global memory.
//   * Accumulating warps, as many, wait on the assigned barrier and run up to the ring's
//     depth behind. Warp w owns clusters w, w + warps, ...: it lists the tile's rows of
//     the cluster in row order from the label slots (a ballot and a popc a 32-row chunk),
//     its lane c adds columns c, c + 32, ... of those rows, 8 rows' loads in flight at once,
//     to register partials, and adds the partials to the block's record in tile order.
//     Counts are integers. A stage goes back to its copies once every accumulating warp is
//     done with it. With bulk copies by a ticket: the last accumulating warp done with it (an
//     integer count a stage in shared memory) refills it with the tile S later, so no warp
//     waits for another to hand a stage back (the last warp fills the first S stages). With
//     cp.async the accumulating warps meet at a named barrier and all refill it.
//   * With the centers in registers setmaxnreg hands the accumulating warps' registers to the
//     assigning warps (the centers take 128 of them at d = 64): each scheduler holds two
//     warps of each role, 128 registers a thread at launch, and each role is whole
//     warpgroups. Otherwise every thread keeps 128, and a role may be one warp where shared
//     memory is short.
//   * Assignment at d <= 64 and k <= 8: a quad of threads shares a row, each with a quarter
//     of its columns, and keeps those columns of all 8 centers in registers, so the centers
//     cost no shared-memory traffic. Each product is one running FMA sum over the thread's
//     columns; two xor shuffles reduce-scatter the quad's partials, so each thread completes
//     two centers, and two more pick the quad's first minimum. A quad computes its 4 rows in
//     turn; thread q keeps row 4 * quad + q. Otherwise one thread owns a row (2 or 4
//     threads above d = 64, 64 columns each, combined by one or two shuffles), with 4
//     running sums per product, and reads the centers as shared-memory broadcasts. d is a
//     template bound (32, 64, 128, 256): at d = 64 every loop is unrolled with no guard. With
//     the centers in shared memory a tile row's stride is padded so that 16-byte reads of
//     neighbouring rows fall on distinct banks.
//   * The order: tile t goes to block t mod G of a grid of G blocks, each block adds its
//     tiles' partials in tile order and a tile row's minimum d² to its slot, summed over
//     tiles. One CTA an SM walks tiles p, p + P, p + 2P, ... (P CTAs) and hosts the blocks
//     p, p + P, ... of G = V * P: tile i of the CTA belongs to block p + P * (i mod V).
//     V is 2 where the launch before this pipeline kept two blocks resident on an SM (the
//     centers in registers and rows of at most 7 chunks), else 1, so that the order, and
//     every bit of the output, is the same as that launch's. Where no block has more than one
//     tile, V is 1: a CTA a block gives the same order, and no CTA takes two tiles in turn.
//   * One launch a call: the accumulating warps write each block's record to a scratch row
//     (a grid of one block writes the output). The last block of each group of 16 (an
//     integer ticket) adds the group's records in block order, and the last group the
//     groups' sums in group order; each ticket returns to zero for the next call. Only
//     integer tickets are atomic, so two runs on one card give identical bits.
// The order is written out in heat_tpu_torch/core/kernels/kmeans.py (`rounding_depths` bounds
// its rounding, `ordered_sums` replays the sums), and tests/_torch_k1_order.py emulates it.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with
// ctypes by heat_tpu_torch/core/kernels/kmeans.py). Every entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kMaxAssign = 256;              // assigning threads a block, at most
constexpr int kMaxThreads = 2 * kMaxAssign;  // and as many accumulating threads
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 232448;  // dynamic shared memory a block may opt into on sm_90
constexpr int kFoldGroup = 16;       // blocks whose records one block folds
constexpr int kMaxGroups = 512;      // groups the ticket counters cover (1 + kMaxGroups of them)

// how a stage is filled
constexpr int kRouteBulk = 0;    // one TMA bulk copy a tile (x 16-byte aligned, d % 4 == 0, unpadded rows)
constexpr int kRouteChunks = 1;  // 16-byte cp.async (x 16-byte aligned, d % 4 == 0)
constexpr int kRouteWords = 2;   // 4-byte cp.async

// named barriers (0 is __syncthreads)
constexpr int kBarHandoff = 1;  // assigning warps' sse slots to the accumulating warps
constexpr int kBarAssign = 2;   // among the assigning warps
constexpr int kBarAcc = 3;      // among the accumulating warps

struct Args {
    const float* x;
    const float* centers;
    int* labels;
    float* scratch;  // (blocks + groups, k*d + k + 1 rounded up to a multiple of 4)
    float* out;      // (k*d + k + 1,)
    unsigned* counter;  // 1 + kMaxGroups tickets
    long long n;
    int d, k, stages;
    int assign;      // assigning threads (and accumulating threads) of a CTA
    int p4;          // a tile row's stride in 16-byte chunks
    int tiles;
    int blocks;      // G, the order's grid: tile t to block t mod G
    int per_cta;     // V, the order's blocks a CTA hosts
    int route;       // kRoute*
    int vec_c;       // the centers 16-byte aligned with d % 4 == 0
};

constexpr int kRegK = 8;  // the most clusters whose centers a thread holds in registers

// The launch's shape for (d, k): the template bound on d, whether the centers sit in
// registers (d <= 64 and k <= 8: four threads share a row, each with a quarter of its
// columns and of every center's), else the threads that share a row (64 columns each above
// d = 64) with the centers in shared memory.
int dmax_of(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }
bool reg_of(int d, int k) { return d <= 64 && k <= kRegK; }
int tpr_of(int d, int k) { return reg_of(d, k) ? 4 : dmax_of(d) <= 64 ? 1 : dmax_of(d) / 64; }
// rows in a tile: one an assigning thread with the centers in registers (a quad computes
// four rows together), else one a group of tpr threads
int tile_rows(int d, int k, int assign) { return reg_of(d, k) ? assign : assign / tpr_of(d, k); }

// A tile row's stride in 16-byte chunks. With the centers in registers, ceil(d/4): rows are
// not padded, so a tile is one span and lands by one bulk copy where d % 4 == 0; a quarter
// warp then reads two rows four apart, and where ceil(d/4) is even (d = 64) their 16-byte
// reads share bank groups two ways, which costs far less than copying a tile into padded
// rows with cp.async (1.30 against 0.89 ms at 10M x 64 x 8 on an H100 SXM at 700 W).
// Otherwise at least ceil(d/4) and congruent to s modulo 2s, s the threads that read one row
// at once, so that the 8 threads of a quarter warp reading 16 bytes each hit 8 distinct bank
// groups.
int row_stride4(int d, int k) {
    int p = (d + 3) / 4;
    if (reg_of(d, k)) return p;
    const int s = tpr_of(d, k);
    while (p % (2 * s) != s) ++p;
    return p;
}

// V: the order's blocks a CTA hosts (see the note at the top)
int per_cta_of(int d, int k) { return reg_of(d, k) && row_stride4(d, k) <= 7 ? 2 : 1; }

size_t smem_bytes(int d, int k, int assign, int stages) {
    const size_t bn = tile_rows(d, k, assign), v = per_cta_of(d, k), warps = assign / 32;
    const size_t chunks = (size_t)stages * bn * row_stride4(d, k) + (size_t)k * ((d + 3) / 4);  // ring, centers
    const size_t words = warps * bn + (size_t)stages + k + v * k * d + v * k + (size_t)stages * bn + v * bn + 1;
    // row lists, 2 barriers and a ticket a stage, |c|², records, counts, label slots,
    // per-row-slot sse, flag
    return 16 * chunks + 8 * 2 * (size_t)stages + 4 * words;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
// the barrier counts one arrival when every cp.async this thread issued before has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Thread t's cp.async copies, of T threads, of a tile of `rows` rows of `e` elements of
// BYTES bytes (src contiguous) into rows of `pitch` floats: element idx = t, t + T, ..., its
// row and column stepped without a division.
template <int BYTES>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int rows, int e, int pitch, int t, int T) {
    constexpr int W = BYTES / 4;  // floats an element
    const int total = rows * e, dr = T / e, dc = T - dr * e;
    int r = t / e, c = t - r * e;
    for (int idx = t; idx < total; idx += T) {
        if (BYTES == 16) cp_async16(dst + r * pitch + W * c, src + (size_t)W * idx);
        else cp_async4(dst + r * pitch + c, src + idx);
        c += dc;
        r += dr;
        if (c >= e) {
            c -= e;
            ++r;
        }
    }
}

// The quad's four partials of 8 values, added as a butterfly adds them ((p0 + p1) + (p2 +
// p3), the same bits in every order) but scattered: after two xor shuffles thread q holds
// values j0 = 4 (q & 1) + (q & 2) and j0 + 1 whole, in out[0] and out[1].
__device__ __forceinline__ void quad_scatter(const float (&v)[8], int q, float (&out)[2]) {
    const bool odd = q & 1, upper = q & 2;
    float s1[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const float send = odd ? v[u] : v[u + 4];
        s1[u] = (odd ? v[u + 4] : v[u]) + __shfl_xor_sync(0xffffffffu, send, 1);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const float send = upper ? s1[u] : s1[u + 2];
        out[u] = (upper ? s1[u + 2] : s1[u]) + __shfl_xor_sync(0xffffffffu, send, 2);
    }
}

template <int TPR>
__device__ __forceinline__ float row_sum(float v) {  // the row's TPR partials, same bits in each
    if (TPR >= 2) v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (TPR >= 4) v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

}  // namespace

// DMAX: bound on d; TPR: threads that share a row; REG: centers in registers (TPR = 4,
// DMAX <= 64, k <= kRegK); FULL: d == DMAX.
template <int DMAX, int TPR, int REG, int FULL>
__global__ void __launch_bounds__(kMaxThreads, 1) kmeans_assign_kernel(const Args a) {
    constexpr int NCH = DMAX / (4 * TPR);  // 16-byte chunks of a row per thread, at most
    constexpr int CPT = DMAX / 32;         // record columns an accumulating lane owns, at most
    constexpr int RK = REG ? kRegK : 1;    // centers in registers
    constexpr int RC = REG ? NCH : 1;      // their chunks a thread holds
    // registers a thread after the rebalance, with the centers in registers (whole
    // warpgroups a role): the launch gives each of the 512 threads 128 (a scheduler's 16,384
    // over its 4 warps); an accumulating thread keeps ACC and an assigning thread, its
    // partner on the scheduler, takes the rest. Otherwise every thread keeps its 128.
    constexpr int ACC = 56;
    constexpr int ASSIGN = 256 - ACC;
    const int TA = a.assign, wa = TA >> 5;  // assigning threads, and warps; as many accumulating
    const bool bulk = a.route == kRouteBulk;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bn = REG ? TA : TA / TPR;  // rows in a tile; row i's slot for the sse is i
    const int d = FULL ? DMAX : a.d;
    const int dq4 = FULL ? DMAX / 4 : (a.d + 3) >> 2;
    const int k = a.k, kd = k * d, p4 = a.p4, S = a.stages, V = a.per_cta;
    const int P = gridDim.x, p = blockIdx.x;
    const int my_tiles = a.tiles > p ? (a.tiles - 1 - p) / P + 1 : 0;

    extern __shared__ float4 smem4[];
    float4* ring = smem4;                                         // S x bn x p4 chunks
    float4* cs = ring + (size_t)S * bn * p4;                       // k x dq4 chunks, zero-padded
    int* lists = reinterpret_cast<int*>(cs + (size_t)k * dq4);      // wa x bn: a warp's rows of one cluster
    uint64_t* bars = reinterpret_cast<uint64_t*>(lists + wa * bn);  // full, assigned: S of each
    unsigned* done = reinterpret_cast<unsigned*>(bars + 2 * S);     // S: accumulating warps done with a stage
    float* cc = reinterpret_cast<float*>(done + S);                // k
    float* rec = cc + k;                                           // V x k x d
    int* cnt = reinterpret_cast<int*>(rec + V * kd);                // V x k
    int* slots = cnt + V * k;                                      // S x bn: each tile row's label, -1 past n
    float* ssep = reinterpret_cast<float*>(slots + S * bn);         // V x bn
    int* last = reinterpret_cast<int*>(ssep + V * bn);               // 1
    const uint32_t full0 = smem_u32(bars), assigned0 = full0 + 8 * S;

    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full0 + 8 * s, bulk ? 1 : TA);  // the copying lane, or every accumulating thread
            mbar_init(assigned0 + 8 * s, wa);                          // a lane of each assigning warp
            done[s] = 0u;
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // where rows end inside a 16-byte chunk the ring's columns past d are zeroed once: the
    // copies never write them
    if (d & 3)
        for (int i = tid; i < 4 * S * bn * p4; i += blockDim.x) reinterpret_cast<float*>(ring)[i] = 0.f;
    __syncthreads();

    if (warp >= wa) {
        // accumulation: warp aw owns clusters aw, aw + wa, ...; its lane c columns c, c + 32,
        // ... of them. For each tile it lists the tile's rows of the cluster in row order (each
        // lane places its own row of a 32-row chunk by one popc), then every lane adds those
        // rows' columns, four rows at a time, to its partials.
        if constexpr (REG != 0) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(ACC));
        const int aw = warp - wa, et = tid - TA, c = lane;
        // my i-th tile (tile p + i*P) into stage i % S: by one lane of the calling warp with a
        // bulk copy, else by every accumulating thread
        auto produce = [&](int i) {
            const int s = i % S;
            const long long r0 = ((long long)p + (long long)i * P) * bn;
            const int rows = (int)min((long long)bn, a.n - r0);
            float* dst = reinterpret_cast<float*>(ring + (size_t)s * bn * p4);
            const float* src = a.x + r0 * d;
            const uint32_t full = full0 + 8 * s;
            if (a.route == kRouteBulk) {
                if (lane == 0) {
                    const uint32_t bytes = 4u * rows * d;
                    // the stage's reads by every warp, ordered before the ticket, before the copy's writes
                    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                    mbar_expect_tx(full, bytes);
                    bulk_copy(dst, src, bytes, full);
                }
            } else {
                if (a.route == kRouteChunks) copy_tile<16>(dst, src, rows, dq4, 4 * p4, et, TA);
                else copy_tile<4>(dst, src, rows, d, 4 * p4, et, TA);
                cp_async_arrive(full);
            }
        };
        // the first tiles; then by bulk copies each stage's next by the last warp done with
        // it, else by every accumulating thread once all are done with it
        if (!bulk || aw == wa - 1)
            for (int i = 0; i < min(S, my_tiles); ++i) produce(i);
        for (int j = aw; j < k; j += wa)
            for (int v = 0; v < V; ++v) {
                for (int col = lane; col < d; col += 32) rec[v * kd + j * d + col] = 0.f;
                if (lane == 0) cnt[v * k + j] = 0;
            }
        int* lst = lists + aw * bn;
        const unsigned below = (1u << lane) - 1u;
        // tile i's stage s, the stage's laps of the ring before it (i / S) and its hosted block
        // v, stepped
        for (int i = 0, s = 0, lap = 0, v = 0; i < my_tiles; ++i) {
            mbar_wait(assigned0 + 8 * s, lap & 1);
            const float* tf = reinterpret_cast<const float*>(ring + (size_t)s * bn * p4);
            const int* lab = slots + s * bn;
            float* rv = rec + v * kd;
            int* cv = cnt + v * k;
            int lv[8];  // the tile's labels, lane l holding rows l, 32 + l, ... (bn <= 256)
#pragma unroll
            for (int u = 0; u < 8; ++u) lv[u] = 32 * u + lane < bn ? lab[32 * u + lane] : -1;
            for (int j = aw; j < k; j += wa) {
                int total = 0;
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const bool hit = lv[u] == j;
                    const unsigned m = __ballot_sync(0xffffffffu, hit);
                    if (hit) lst[total + __popc(m & below)] = 4 * p4 * (32 * u + lane);
                    total += __popc(m);
                }
                __syncwarp();
                float part[CPT];
#pragma unroll
                for (int u = 0; u < CPT; ++u) part[u] = 0.f;
                constexpr int RB = CPT <= 2 ? 8 : 4;  // rows whose loads are in flight together
                int r = 0;
                for (; r + RB <= total; r += RB) {
                    int o[RB];
#pragma unroll
                    for (int u = 0; u < RB; u += 4) {
                        const int4 at = *reinterpret_cast<const int4*>(lst + r + u);
                        o[u] = at.x, o[u + 1] = at.y, o[u + 2] = at.z, o[u + 3] = at.w;
                    }
                    float v[RB][CPT];
#pragma unroll
                    for (int u = 0; u < RB; ++u)
#pragma unroll
                        for (int cc2 = 0; cc2 < CPT; ++cc2)
                            v[u][cc2] = FULL || c + 32 * cc2 < d ? tf[o[u] + c + 32 * cc2] : 0.f;
#pragma unroll
                    for (int u = 0; u < RB; ++u)
#pragma unroll
                        for (int cc2 = 0; cc2 < CPT; ++cc2) part[cc2] += v[u][cc2];
                }
                for (; r < total; ++r) {  // the last rows, one at a time, in order
                    const int o = lst[r];
#pragma unroll
                    for (int cc2 = 0; cc2 < CPT; ++cc2)
                        if (FULL || c + 32 * cc2 < d) part[cc2] += tf[o + c + 32 * cc2];
                }
                __syncwarp();  // the list is read before the warp's next cluster overwrites it
#pragma unroll
                for (int cc2 = 0; cc2 < CPT; ++cc2)
                    if (FULL || c + 32 * cc2 < d) rv[j * d + c + 32 * cc2] += part[cc2];
                if (c == 0) cv[j] += total;
            }
            __syncwarp();  // every lane's reads of the stage are done
            if (i + S < my_tiles && !bulk) {
                bar_sync(kBarAcc, TA);  // every accumulating warp is done with the stage
                produce(i + S);
            } else if (i + S < my_tiles) {
                // a ticket: the last accumulating warp done with the stage fills it with my tile
                // i + S, so that no warp waits for another to hand a stage back
                unsigned last_one = 0;
                if (lane == 0) {
                    __threadfence_block();
                    last_one = atomicAdd(done + s, 1u) == (unsigned)((lap + 1) * wa - 1);
                    __threadfence_block();
                }
                if (__shfl_sync(0xffffffffu, last_one, 0)) produce(i + S);
            }
            if (++s == S) s = 0, ++lap;
            v = V - 1 - v;
        }
        bar_sync(kBarHandoff, 2 * TA);  // every record and sse slot is written

        // each hosted block's record: its sums and counts, and its sse, the slots' sums added
        // by the 32 lanes of warp 0 in runs of ceil(bn / 32) slots, then the runs in lane order
        const int G = a.blocks;
        const int m = kd + k + 1, m4 = (m + 3) & ~3;  // a record, and the scratch's row stride
        const int groups = (G + kFoldGroup - 1) / kFoldGroup;
        for (int v = 0; v < V && p + P * v < G; ++v) {
            float* mine = G == 1 ? a.out : a.scratch + (size_t)(p + P * v) * m4;
            for (int i = et; i < kd; i += TA) mine[i] = rec[v * kd + i];
            for (int j = et; j < k; j += TA) mine[kd + j] = (float)cnt[v * k + j];
            if (aw == 0) {
                const int run = (bn + 31) / 32;
                const float* sv = ssep + v * bn;
                float s = 0.f;
                for (int r = lane * run; r < min(bn, (lane + 1) * run); ++r) s += sv[r];
                float total = 0.f;
                for (int l = 0; l < 32; ++l) total += __shfl_sync(0xffffffffu, s, l);
                if (lane == 0) mine[kd + k] = total;
            }
        }
        if (G == 1) return;

        // the fold, in a fixed order without float atomics: the last block of each group of
        // kFoldGroup consecutive blocks (an integer ticket per group) adds the group's records
        // in block order; with more than one group, the last group to finish (a ticket of its
        // own) adds the groups' sums in group order. Each ticket is returned to zero for the
        // next call.
        float* buf = reinterpret_cast<float*>(smem4);  // the ring and the centers' room, free now
        const int room = 4 * (S * bn * p4 + k * dq4);
        auto fold = [&](const float* rows, int count, float* to) {  // to = rows[0] + rows[1] + ...
            const int cw = (room / count) & ~3;  // columns a slab
            if (count > 4 && cw >= 4) {
                for (int c0 = 0; c0 < m; c0 += cw) {
                    const int w4 = min(cw, m4 - c0) >> 2;
                    for (int idx = et; idx < count * w4; idx += TA) {
                        const int bb = idx / w4, c4 = idx - bb * w4;
                        cp_async16(buf + 4 * (bb * w4 + c4), rows + (size_t)bb * m4 + c0 + 4 * c4);
                    }
                    cp_async_commit();
                    cp_async_wait<0>();
                    bar_sync(kBarAcc, TA);
                    for (int i0 = et; i0 < 4 * w4; i0 += 4 * TA) {  // four columns at once
                        float s[4] = {0.f, 0.f, 0.f, 0.f};
                        for (int bb = 0; bb < count; ++bb)
#pragma unroll
                            for (int u = 0; u < 4; ++u)
                                if (i0 + u * TA < 4 * w4) s[u] += buf[4 * bb * w4 + i0 + u * TA];
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            if (i0 + u * TA < 4 * w4 && c0 + i0 + u * TA < m) to[c0 + i0 + u * TA] = s[u];
                    }
                    bar_sync(kBarAcc, TA);
                }
            } else {  // a few rows, or too many for the room: straight from L2
                for (int i = et; i < m; i += TA) {
                    float s = 0.f;
                    for (int bb = 0; bb < count; ++bb) s += __ldcg(rows + (size_t)bb * m4 + i);
                    to[i] = s;
                }
            }
        };
        // a ticket: the block's writes, ordered before thread 0's by the barrier, are released
        // by its fence before the atomic; the last block's fence acquires everyone's
        auto ticket = [&](unsigned* counter, int of) {
            bar_sync(kBarAcc, TA);
            if (et == 0) {
                __threadfence();
                *last = atomicAdd(counter, 1u) == (unsigned)(of - 1);
                __threadfence();
            }
            bar_sync(kBarAcc, TA);
            return *last != 0;
        };
        float* group_sums = a.scratch + (size_t)G * m4;
        for (int v = 0; v < V && p + P * v < G; ++v) {
            const int g = (p + P * v) / kFoldGroup, first = g * kFoldGroup, members = min(kFoldGroup, G - first);
            if (!ticket(a.counter + 1 + g, members)) continue;
            fold(a.scratch + (size_t)first * m4, members, groups == 1 ? a.out : group_sums + (size_t)g * m4);
            if (et == 0) a.counter[1 + g] = 0u;
            if (groups == 1 || !ticket(a.counter, groups)) continue;
            fold(group_sums, groups, a.out);
            if (et == 0) *a.counter = 0u;
        }
    } else {
        // assignment: this thread's label and minimum d² for tile row `row`
        if constexpr (REG != 0) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(ASSIGN));
        const int rho = tid / TPR, q = tid % TPR;
        // With the centers in registers each thread loads its chunks q, q + 4, ... of every
        // center straight from device memory while the first tiles stream in.
        const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 creg[RK][RC];
        if constexpr (REG != 0) {
#pragma unroll
            for (int j = 0; j < RK; ++j)
#pragma unroll
                for (int t = 0; t < RC; ++t) {
                    const int ch = q + TPR * t;
                    creg[j][t] = zero4;
                    if (j < k && (FULL || ch < dq4)) {
                        const float* cp = a.centers + (size_t)j * d + 4 * ch;
                        if (a.vec_c) {  // 16-byte aligned rows of whole chunks
                            creg[j][t] = __ldg(reinterpret_cast<const float4*>(cp));
                        } else if (FULL || 4 * ch + 3 < d) {
                            creg[j][t].x = __ldg(cp);
                            creg[j][t].y = __ldg(cp + 1);
                            creg[j][t].z = __ldg(cp + 2);
                            creg[j][t].w = __ldg(cp + 3);
                        } else {  // the row's last chunk, past d: zeros
                            creg[j][t].x = __ldg(cp);
                            if (4 * ch + 1 < d) creg[j][t].y = __ldg(cp + 1);
                            if (4 * ch + 2 < d) creg[j][t].z = __ldg(cp + 2);
                        }
                    }
                }
        }
        float ccq[2] = {0.f, 0.f};  // with the centers in registers, |c|² of the two this thread completes
        if constexpr (REG != 0) {
            // |c_j|² as the products: one running sum over the thread's chunks, the quad's four
            // reduce-scattered (see the assignment below)
            float pc[RK];
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                pc[j] = 0.f;
#pragma unroll
                for (int t = 0; t < RC; ++t) {
                    pc[j] = fmaf(creg[j][t].x, creg[j][t].x, pc[j]);
                    pc[j] = fmaf(creg[j][t].y, creg[j][t].y, pc[j]);
                    pc[j] = fmaf(creg[j][t].z, creg[j][t].z, pc[j]);
                    pc[j] = fmaf(creg[j][t].w, creg[j][t].w, pc[j]);
                }
            }
            quad_scatter(pc, q, ccq);
        } else {
            float* csf = reinterpret_cast<float*>(cs);
            for (int i = tid; i < 4 * k * dq4; i += TA) {  // the centers, zero-padded to whole chunks
                const int j = i / (4 * dq4), c = i - j * 4 * dq4;
                csf[i] = c < d ? a.centers[j * d + c] : 0.f;
            }
            bar_sync(kBarAssign, TA);
            for (int j = tid; j < k; j += TA) {
                float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
                for (int ch = 0; ch < dq4; ++ch) {
                    const float4 v = cs[j * dq4 + ch];
                    p0 = fmaf(v.x, v.x, p0);
                    p1 = fmaf(v.y, v.y, p1);
                    p2 = fmaf(v.z, v.z, p2);
                    p3 = fmaf(v.w, v.w, p3);
                }
                cc[j] = (p0 + p1) + (p2 + p3);
            }
            bar_sync(kBarAssign, TA);
        }

        float sse0 = 0.f, sse1 = 0.f;  // this slot's rows of the CTA's even and odd tiles, in row order
        for (int i = 0, s = 0, phase = 0; i < my_tiles; ++i) {  // tile i's stage and its barrier's phase
            const long long r0 = ((long long)p + (long long)i * P) * bn;
            const int rows = (int)min((long long)bn, a.n - r0);
            const float4* tile = ring + (size_t)s * bn * p4;
            mbar_wait(full0 + 8 * s, phase);
            int label = 0;
            float best = 0.f;
            int row;
            bool holder;  // the thread that stores the row's label and adds its d² to its slot
            if constexpr (REG != 0) {
                // a quad computes rows 4*rho .. 4*rho + 3 in turn; thread q keeps row 4*rho + q =
                // tid. Each product is one running sum over the thread's columns (chunk by chunk,
                // x, y, z, w), and the quad's four are added by two shuffles.
#pragma unroll 1
                for (int rr = 0; rr < TPR; ++rr) {
                    const float4* xr = tile + (rho * TPR + rr) * p4 + q;
                    float4 xv[RC];
#pragma unroll
                    for (int t = 0; t < RC; ++t) xv[t] = (FULL || q + TPR * t < dq4) ? xr[TPR * t] : zero4;
                    float xx = 0.f, dot[RK];
#pragma unroll
                    for (int j = 0; j < RK; ++j) dot[j] = 0.f;
#pragma unroll
                    for (int t = 0; t < RC; ++t) {
                        xx = fmaf(xv[t].x, xv[t].x, xx);
                        xx = fmaf(xv[t].y, xv[t].y, xx);
                        xx = fmaf(xv[t].z, xv[t].z, xx);
                        xx = fmaf(xv[t].w, xv[t].w, xx);
#pragma unroll
                        for (int j = 0; j < RK; ++j) {
                            dot[j] = fmaf(xv[t].x, creg[j][t].x, dot[j]);
                            dot[j] = fmaf(xv[t].y, creg[j][t].y, dot[j]);
                            dot[j] = fmaf(xv[t].z, creg[j][t].z, dot[j]);
                            dot[j] = fmaf(xv[t].w, creg[j][t].w, dot[j]);
                        }
                    }
                    // the quad's four partials of every product, reduce-scattered: thread q
                    // completes centers j0 = 4 (q & 1) + (q & 2) and j0 + 1
                    xx = row_sum<TPR>(xx);
                    float s2[2];
                    quad_scatter(dot, q, s2);
                    const int j0 = 4 * (q & 1) + (q & 2);
                    float bst = INFINITY;
                    int bjj = j0;
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const float d2 = fmaxf(xx + ccq[u] - 2.f * s2[u], 0.f);
                        if (j0 + u < k && (u == 0 || d2 < bst)) {  // strict <: the lower index wins ties
                            bst = d2;
                            bjj = j0 + u;
                        }
                    }
#pragma unroll
                    for (int o = 1; o <= 2; o <<= 1) {  // the quad's least (d², j): the first minimum
                        const float od = __shfl_xor_sync(0xffffffffu, bst, o);
                        const int oj = __shfl_xor_sync(0xffffffffu, bjj, o);
                        if (od < bst || (od == bst && oj < bjj)) {
                            bst = od;
                            bjj = oj;
                        }
                    }
                    if (q == rr) {
                        best = bst;
                        label = bjj;
                    }
                }
                row = tid;
                holder = true;
            } else {
                // one row per group of TPR threads: 4 running sums per product over the
                // thread's chunks, the group's added by shuffles; the centers are
                // shared-memory broadcasts
                const float4* xr = tile + rho * p4 + q;
                float4 xv[NCH];
                float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
                for (int t = 0; t < NCH; ++t) {
                    xv[t] = (FULL || q + TPR * t < dq4) ? xr[TPR * t] : zero4;
                    p0 = fmaf(xv[t].x, xv[t].x, p0);
                    p1 = fmaf(xv[t].y, xv[t].y, p1);
                    p2 = fmaf(xv[t].z, xv[t].z, p2);
                    p3 = fmaf(xv[t].w, xv[t].w, p3);
                }
                const float xx = row_sum<TPR>((p0 + p1) + (p2 + p3));
                for (int j = 0; j < k; ++j) {
                    const float4* cj = cs + j * dq4 + q;
                    p0 = p1 = p2 = p3 = 0.f;
#pragma unroll
                    for (int t = 0; t < NCH; ++t) {
                        const float4 c4 = (FULL || q + TPR * t < dq4) ? cj[TPR * t] : zero4;
                        p0 = fmaf(xv[t].x, c4.x, p0);
                        p1 = fmaf(xv[t].y, c4.y, p1);
                        p2 = fmaf(xv[t].z, c4.z, p2);
                        p3 = fmaf(xv[t].w, c4.w, p3);
                    }
                    const float dot = row_sum<TPR>((p0 + p1) + (p2 + p3));
                    const float d2 = fmaxf(xx + cc[j] - 2.f * dot, 0.f);
                    if (j == 0 || d2 < best) {  // strict <: the lowest index wins ties
                        best = d2;
                        label = j;
                    }
                }
                row = rho;
                holder = q == 0;
            }
            const bool mine = holder && row < rows;
            if (holder) slots[s * bn + row] = mine ? label : -1;
            __syncwarp();  // the warp's slots are written
            if (lane == 0) mbar_arrive(assigned0 + 8 * s);
            if (mine) {  // after the arrival, which then orders shared-memory writes alone
                a.labels[r0 + row] = label;
                if (V == 2 && (i & 1)) sse1 += best;
                else sse0 += best;
            }
            if (++s == S) s = 0, phase ^= 1;
        }
        if (REG || q == 0) {
            ssep[REG ? tid : rho] = sse0;
            if (V == 2) ssep[bn + (REG ? tid : rho)] = sse1;
        }
        bar_arrive(kBarHandoff, 2 * TA);
    }
}

namespace {

using Kernel = void (*)(Args);

// every instance: (DMAX, TPR, REG, FULL)
const Kernel kInstances[] = {
    kmeans_assign_kernel<32, 1, 0, 0>,  kmeans_assign_kernel<32, 1, 0, 1>,
    kmeans_assign_kernel<64, 1, 0, 0>,  kmeans_assign_kernel<64, 1, 0, 1>,
    kmeans_assign_kernel<128, 2, 0, 0>, kmeans_assign_kernel<128, 2, 0, 1>,
    kmeans_assign_kernel<256, 4, 0, 0>, kmeans_assign_kernel<256, 4, 0, 1>,
    kmeans_assign_kernel<32, 4, 1, 0>,  kmeans_assign_kernel<32, 4, 1, 1>,
    kmeans_assign_kernel<64, 4, 1, 0>,  kmeans_assign_kernel<64, 4, 1, 1>,
};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);
std::atomic<unsigned long long> g_opted[kNumInstances];  // per instance, a bit per device

int instance(int d, int k) {
    const int dmax = dmax_of(d);
    const int full = d == dmax;
    if (reg_of(d, k)) return (dmax == 32 ? 8 : 10) + full;
    return (dmax == 32 ? 0 : dmax == 64 ? 2 : dmax == 128 ? 4 : 6) + full;
}

cudaError_t check_config(int d, int k, int assign, int stages) {
    if (d < 1 || d > 256 || k < 1) return cudaErrorInvalidValue;
    if (assign % 32 != 0 || assign < 32 || assign > kMaxAssign) return cudaErrorInvalidValue;
    if (reg_of(d, k) && assign % 128 != 0) return cudaErrorInvalidValue;  // setmaxnreg: whole warpgroups a role
    if (stages < 2 || stages > kMaxStages) return cudaErrorInvalidValue;
    if (smem_bytes(d, k, assign, stages) > (size_t)kSmemBudget) return cudaErrorInvalidValue;
    return cudaSuccess;
}

// the opt-in to the whole shared-memory budget, once per instance and device
cudaError_t opt_in(int inst, int device) {
    const unsigned long long bit = 1ull << (device & 63);
    if (g_opted[inst].load(std::memory_order_acquire) & bit) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kInstances[inst]),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err == cudaSuccess) g_opted[inst].fetch_or(bit, std::memory_order_acq_rel);
    return err;
}

bool vec_ok(const void* p, int d) { return reinterpret_cast<uintptr_t>(p) % 16 == 0 && d % 4 == 0; }

}  // namespace

extern "C" {

// The interface's version: 3 for this one (one launch, a ticket counter, the assigning
// threads, the stages and the copy route).
int kmeans_assign_abi() { return 3; }

// Shared memory of one block for (d, k) with `assign` assigning threads and `stages` ring
// stages; the caller's planner keeps it within the budget.
long long kmeans_assign_smem_bytes(int d, int k, int assign, int stages) {
    return (long long)smem_bytes(d, k, assign, stages);
}

// The order's grid on `device` for this configuration, the most blocks worth asking for:
// SMs x the order's blocks a CTA hosts, where one CTA fits an SM. Also opts the instance
// into the shared-memory budget on `device`.
int kmeans_assign_max_blocks(int device, int d, int k, int assign, int stages, int* blocks) {
    cudaError_t err = check_config(d, k, assign, stages);
    if (err != cudaSuccess) return err;
    if ((err = use_device(device)) != cudaSuccess) return err;
    const int inst = instance(d, k);
    if ((err = opt_in(inst, device)) != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kInstances[inst], 2 * assign,
                                                        smem_bytes(d, k, assign, stages));
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *blocks = sms * per_cta_of(d, k);
    return cudaSuccess;
}

// labels (n,) int32, scratch (blocks + ceil(blocks / 16), m4) f32 with m4 = k*d+k+1 rounded
// up to a multiple of 4 and 16-byte aligned, out (k*d+k+1,) f32 and counter (1 + 512 uint32,
// zero between calls, used by one stream at a time) are allocated by the caller. `blocks` is
// the order's grid (kmeans_assign_max_blocks at most); `route` 0 (bulk copies: x 16-byte
// aligned, d % 4 == 0 and unpadded rows), 1 (16-byte cp.async: x 16-byte aligned, d % 4 ==
// 0) or 2 (4-byte cp.async). One kernel launch on `stream`; nothing is synchronised.
int kmeans_assign_launch(int device, const float* x, const float* centers, long long n, int d, int k, int* labels,
                         float* scratch, int blocks, float* out, unsigned* counter, int assign, int stages, int route,
                         void* stream) {
    cudaError_t err = check_config(d, k, assign, stages);
    if (err != cudaSuccess) return err;
    if (n < 0 || blocks < 1 || (blocks + kFoldGroup - 1) / kFoldGroup > kMaxGroups) return cudaErrorInvalidValue;
    const int p4 = row_stride4(d, k);
    if (route < kRouteBulk || route > kRouteWords || (route != kRouteWords && !vec_ok(x, d)) ||
        (route == kRouteBulk && p4 != d / 4))
        return cudaErrorInvalidValue;
    if ((err = use_device(device)) != cudaSuccess) return err;
    const int inst = instance(d, k);
    if ((err = opt_in(inst, device)) != cudaSuccess) return err;
    const long long bn = tile_rows(d, k, assign);
    const long long tiles = (n + bn - 1) / bn;
    const int per_cta = blocks >= tiles ? 1 : per_cta_of(d, k);
    if (tiles > 0x7fffffffLL || blocks % per_cta != 0) return cudaErrorInvalidValue;  // whole sets of blocks a CTA
    Args a{x, centers, labels, scratch, out, counter, n, d, k, stages, assign, p4, (int)tiles, blocks, per_cta, route,
           vec_ok(centers, d) ? 1 : 0};
    void* params[] = {&a};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kInstances[inst]), dim3((blocks + per_cta - 1) / per_cta),
                           dim3(2 * assign), params, smem_bytes(d, k, assign, stages),
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

const char* kmeans_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
