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
// operations for the dot products. At the north-star shape, 10M x 64 x 8, that is 2.56 GB,
// 0.776 ms at 3.35 TB/s, against 0.17 ms of fp32 FMA work at 67 TFLOP/s: 4 operations a
// byte, where the FMA pipe balances the memory at 20. So K1 is bound by the bytes of x up to
// k of about 40, and tensor cores would not help there; they would also need TF32, which the
// quadratic expansion cannot take (it cancels for near points, the reason the TPU kernel asks
// for Precision.HIGHEST). Every product here is a plain fp32 FMA.
//
// The first version of this kernel gave each row a warp and reduced each of the k + 1 dot
// products across the warp with five dependent shuffles: some 45 dependent shuffles a row,
// one row in flight per warp, about 16 KB in flight an SM where the memory's latency wants
// ~20 KB all the time, and it ran at 11% of its bound, two launches a call. This design
// keeps the loads in flight and the reductions off each row's critical path:
//   * Rows come in tiles of whole rows through a ring of shared-memory stages filled by
//     cp.async (16 bytes a thread where x is 16-byte aligned and d % 4 == 0, else 4 bytes, so
//     any contiguous x, at any 4-byte offset, streams without a host copy). A persistent grid,
//     one block an SM, walks the tiles, and a tile row's stride is padded so that 16-byte
//     reads of neighbouring rows fall on distinct banks.
//   * Software-pipelined: a step assigns tile i and accumulates tile i - 1 between the same
//     two barriers, while tile i + stages - 2 streams in.
//   * Assignment at d <= 64 and k <= 8 (the north-star path): a quad of threads shares a row,
//     each with a quarter of its columns, and keeps those columns of all 8 centers in
//     registers (128 at d = 64), so the centers cost no shared-memory traffic. Each product
//     is one running FMA sum over the thread's columns; two xor shuffles reduce-scatter the
//     quad's partials, so each thread completes two centers, and two more pick the quad's
//     first minimum. A quad computes its 4 rows in turn; thread q keeps row 4 * quad + q.
//     Otherwise one thread owns a row (2 or 4 threads above d = 64, 64 columns each,
//     combined by one or two shuffles), with 4 running sums per product, and reads the
//     centers as shared-memory broadcasts. d is a template bound (32, 64, 128, 256): at
//     d = 64 every loop is unrolled with no guard.
//   * Accumulation without float atomics: each warp ballots, for each cluster, a 32-bit mask
//     of its rows with that label. A warp then owns a cluster and lane c columns c, c + 32, ...
//     of the block's record: it lists the tile's rows of the cluster in row order (each lane
//     places its own row by one popc), adds them to register partials, and adds the partials
//     to the record in tile order. Counts are integers; a tile row's minimum d² goes to its
//     slot, summed over tiles, and the slots are added in runs, then the runs in order.
//   * One launch a call: each block writes its record to a scratch row (a grid of one block
//     writes the output). The last block of each group of 16 (an integer ticket) adds the
//     group's records in block order, and the last group the groups' sums in group order;
//     each ticket returns to zero for the next call. Only integer tickets are atomic, so two
//     runs on one card give identical bits.
// The order is written out in heat_tpu_torch/core/kernels/kmeans.py (`rounding_depths` bounds
// its rounding, `ordered_sums` replays the sums), and tests/_torch_k1_order.py emulates it.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with
// ctypes by heat_tpu_torch/core/kernels/kmeans.py). Every entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 232448;  // dynamic shared memory a block may opt into on sm_90
constexpr int kFoldGroup = 16;       // blocks whose records one block folds
constexpr int kMaxGroups = 512;      // groups the ticket counters cover (1 + kMaxGroups of them)

struct Args {
    const float* x;
    const float* centers;
    int* labels;
    float* scratch;  // (gridDim.x + groups, k*d + k + 1 rounded up to a multiple of 4)
    float* out;      // (k*d + k + 1,)
    unsigned* counter;  // 1 + kMaxGroups tickets
    long long n;
    int d, k, stages;
    int p4;          // a tile row's stride in 16-byte chunks
    int tiles;
    int vec, vec_c;  // x, and the centers, 16-byte aligned with d % 4 == 0
};

constexpr int kRegK = 8;  // the most clusters whose centers a thread holds in registers

// The launch's shape for (d, k): the template bound on d, whether the centers sit in
// registers (d <= 64 and k <= 8: four threads share a row, each with a quarter of its
// columns and of every center's), else the threads that share a row (64 columns each above
// d = 64) with the centers in shared memory.
int dmax_of(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }
bool reg_of(int d, int k) { return d <= 64 && k <= kRegK; }
int tpr_of(int d, int k) { return reg_of(d, k) ? 4 : dmax_of(d) <= 64 ? 1 : dmax_of(d) / 64; }
// rows in a tile: one a thread with the centers in registers (a quad computes four rows
// together), else one a group of tpr threads
int tile_rows(int d, int k, int threads) { return reg_of(d, k) ? threads : threads / tpr_of(d, k); }

// A tile row's stride in 16-byte chunks: at least ceil(d/4), and congruent to s modulo 2s,
// so that the 8 threads of a quarter warp reading 16 bytes each hit 8 distinct bank groups.
// s is the threads that read one row at once: with the centers in registers a quarter warp
// reads two rows four apart, four chunks of each, and an odd stride separates them (s = 1).
int row_stride4(int d, int k) {
    const int s = reg_of(d, k) ? 1 : tpr_of(d, k);
    int p = (d + 3) / 4;
    while (p % (2 * s) != s) ++p;
    return p;
}

size_t smem_bytes(int d, int k, int threads, int stages) {
    const size_t bn = tile_rows(d, k, threads);
    const size_t chunks = (size_t)stages * bn * row_stride4(d, k) + (size_t)k * ((d + 3) / 4);  // ring, centers
    const size_t words = (threads / 32) * bn + (size_t)k + (size_t)k * d + k + (size_t)2 * (threads / 32) * k + bn + 1;
    return 16 * chunks + 4 * words;  // row lists, |c|^2, record, counts, two sets of masks, per-row-slot sse, flag
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most `pending` groups are in flight (an immediate in PTX, so a switch)
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
    switch (pending) {
        case 6: cp_async_wait<6>(); break;
        case 5: cp_async_wait<5>(); break;
        case 4: cp_async_wait<4>(); break;
        case 3: cp_async_wait<3>(); break;
        case 2: cp_async_wait<2>(); break;
        case 1: cp_async_wait<1>(); break;
        default: cp_async_wait<0>(); break;
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
__global__ void __launch_bounds__(kMaxThreads) kmeans_assign_kernel(const Args a) {
    constexpr int NCH = DMAX / (4 * TPR);  // 16-byte chunks of a row per thread, at most
    constexpr int CPT = DMAX / 32;         // record columns an accumulating thread owns, at most
    constexpr int RK = REG ? kRegK : 1;    // centers in registers
    constexpr int RC = REG ? NCH : 1;      // their chunks a thread holds
    const int T = blockDim.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = T >> 5;
    const int bn = REG ? T : T / TPR;  // rows in a tile; row i's slot for the sse is i
    const int rho = tid / TPR, q = tid % TPR;
    const int d = FULL ? DMAX : a.d;
    const int dq4 = FULL ? DMAX / 4 : (a.d + 3) >> 2;
    const int k = a.k, kd = k * d, p4 = a.p4, S = a.stages;
    const int G = gridDim.x, b = blockIdx.x;
    const int my_tiles = a.tiles > b ? (a.tiles - 1 - b) / G + 1 : 0;

    extern __shared__ float4 smem4[];
    float4* ring = smem4;                                        // S x bn x p4 chunks
    float4* cs = ring + (size_t)S * bn * p4;                      // k x dq4 chunks, zero-padded
    int* lists = reinterpret_cast<int*>(cs + (size_t)k * dq4);     // warps x bn: a warp's rows of one cluster
    float* cc = reinterpret_cast<float*>(lists + warps * bn);     // k
    float* rec = cc + k;                                          // k x d
    int* cnt = reinterpret_cast<int*>(rec + kd);                  // k
    unsigned* masks = reinterpret_cast<unsigned*>(cnt + k);       // 2 x k x warps: bit b of [j][w] is row 32w + b (/ TPR)
    float* ssep = reinterpret_cast<float*>(masks + 2 * k * warps);  // bn
    int* last = reinterpret_cast<int*>(ssep + bn);                  // 1

    // my i-th tile (tile b + i*G) into stage i % S
    auto issue = [&](int i) {
        const long long r0 = ((long long)b + (long long)i * G) * bn;
        const int rows = (int)min((long long)bn, a.n - r0);
        float* dst = reinterpret_cast<float*>(ring + (size_t)(i % S) * bn * p4);
        const float* src = a.x + r0 * d;
        if (a.vec && T % dq4 == 0) {  // 16-byte chunks, each thread one column of chunks
            const int step = T / dq4, c4 = tid % dq4;
            float* to = dst + 4 * ((tid / dq4) * p4 + c4);
            const float* from = src + 4LL * tid;
            for (int r = tid / dq4; r < rows; r += step, to += 4 * step * p4, from += 4 * T) cp_async16(to, from);
        } else if (a.vec) {  // 16-byte chunks; a tile is one contiguous span
            const int total = rows * dq4;
            for (int idx = tid; idx < total; idx += T) {
                const int r = idx / dq4, c4 = idx - r * dq4;
                cp_async16(dst + 4 * (r * p4 + c4), src + 4LL * idx);
            }
        } else {
            const int total = rows * d;
            for (int idx = tid; idx < total; idx += T) {
                const int r = idx / d, c = idx - r * d;
                cp_async4(dst + 4 * r * p4 + c, src + idx);
            }
        }
    };

    // With the centers in registers each thread loads its chunks q, q + 4, ... of every
    // center straight from device memory, first, so that their latency overlaps the tiles'.
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
    // the first tiles are on their way before the centers are set up; where rows end inside
    // a 16-byte chunk the ring's columns past d are zeroed first
    if (d & 3) {
        for (int i = tid; i < 4 * S * bn * p4; i += T) reinterpret_cast<float*>(ring)[i] = 0.f;
        __syncthreads();
    }
    for (int s = 0; s < S - 2; ++s) {
        if (s < my_tiles) issue(s);
        cp_async_commit();
    }
    for (int i = tid; i < kd; i += T) rec[i] = 0.f;
    for (int i = tid; i < k; i += T) cnt[i] = 0;
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
        for (int i = tid; i < 4 * k * dq4; i += T) {  // the centers, zero-padded to whole chunks
            const int j = i / (4 * dq4), c = i - j * 4 * dq4;
            csf[i] = c < d ? a.centers[j * d + c] : 0.f;
        }
        __syncthreads();
        for (int j = tid; j < k; j += T) {
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
    }  // the first barrier of the loop below orders these before their use

    // Software-pipelined: step i assigns tile i and accumulates tile i - 1 between the same
    // two barriers, so warps done with one phase go on with the other; the masks are double
    // buffered and tile i + S - 2 streams in meanwhile.
    float sse = 0.f;  // this slot's rows, in row order
    for (int i = 0; i <= my_tiles; ++i) {
        __syncthreads();  // step i - 1 is done: the stage of tile i - 2 is free
        if (i + S - 2 < my_tiles) issue(i + S - 2);
        cp_async_commit();
        cp_async_wait_dyn(S - 2);  // my copies of tile i have landed
        __syncthreads();           // and everyone's

        if (i < my_tiles) {
            // assignment: this thread's label and minimum d² for tile row `row`
            const long long r0 = ((long long)b + (long long)i * G) * bn;
            const int rows = (int)min((long long)bn, a.n - r0);
            const float4* tile = ring + (size_t)(i % S) * bn * p4;
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
            if (mine) {
                a.labels[r0 + row] = label;
                sse += best;
            }
            unsigned* mi = masks + (i & 1) * k * warps;
            for (int j = 0; j < k; ++j) {
                const unsigned bits = __ballot_sync(0xffffffffu, mine && label == j);
                if (lane == (j & 31)) mi[j * warps + warp] = bits;
            }
        }

        if (i > 0) {
            // accumulation of tile i - 1: a warp owns cluster j, its lane c columns c, c + 32,
            // ... of the record. The warp lists the tile's rows of cluster j in row order (each
            // lane places its own row of a mask by one popc), then every lane adds those rows'
            // columns, four rows at a time, to its partials.
            const float* tf = reinterpret_cast<const float*>(ring + (size_t)((i - 1) % S) * bn * p4);
            const unsigned* mp = masks + ((i - 1) & 1) * k * warps;
            int* lst = lists + warp * bn;
            const unsigned below = (1u << lane) - 1u;
            for (int it = tid; it < 32 * k; it += T) {
                const int j = it >> 5, c = lane;
                int total = 0;
                for (int w = 0; w < warps; ++w) {
                    const unsigned m = mp[j * warps + w];
                    if ((m >> lane) & 1u)
                        lst[total + __popc(m & below)] = 4 * p4 * (REG ? (w << 5) + lane : ((w << 5) + lane) / TPR);
                    total += __popc(m);
                }
                __syncwarp();
                float part[CPT];
#pragma unroll
                for (int u = 0; u < CPT; ++u) part[u] = 0.f;
                for (int r = 0; r < total; r += 4) {
                    const int4 at = *reinterpret_cast<const int4*>(lst + r);
                    const int o[4] = {at.x, at.y, at.z, at.w};
                    float v[4][CPT];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
#pragma unroll
                        for (int cc2 = 0; cc2 < CPT; ++cc2)
                            v[u][cc2] = r + u < total && (FULL || c + 32 * cc2 < d) ? tf[o[u] + c + 32 * cc2] : 0.f;
#pragma unroll
                    for (int u = 0; u < 4; ++u)
#pragma unroll
                        for (int cc2 = 0; cc2 < CPT; ++cc2) part[cc2] += v[u][cc2];  // + 0 leaves a partial as it is
                }
                __syncwarp();  // the list is read before the warp's next cluster overwrites it
#pragma unroll
                for (int cc2 = 0; cc2 < CPT; ++cc2)
                    if (FULL || c + 32 * cc2 < d) rec[j * d + c + 32 * cc2] += part[cc2];
                if (c == 0) cnt[j] += total;
            }
        }
    }
    if (REG || q == 0) ssep[REG ? tid : rho] = sse;
    __syncthreads();

    // this block's record: its sums and counts, and its sse, the slots' sums added by the 32
    // lanes of warp 0 in runs of ceil(bn / 32) slots, then the runs in lane order
    const int m = kd + k + 1, m4 = (m + 3) & ~3;  // a record, and the scratch's row stride
    const int groups = (G + kFoldGroup - 1) / kFoldGroup;
    float* mine = G == 1 ? a.out : a.scratch + (size_t)b * m4;
    for (int i = tid; i < kd; i += T) mine[i] = rec[i];
    for (int j = tid; j < k; j += T) mine[kd + j] = (float)cnt[j];
    if (warp == 0) {
        const int run = (bn + 31) / 32;
        float s = 0.f;
        for (int r = lane * run; r < min(bn, (lane + 1) * run); ++r) s += ssep[r];
        float total = 0.f;
        for (int l = 0; l < 32; ++l) total += __shfl_sync(0xffffffffu, s, l);
        if (lane == 0) mine[kd + k] = total;
    }
    if (G == 1) return;

    // the fold, in a fixed order without float atomics: the last block of each group of
    // kFoldGroup consecutive blocks (an integer ticket per group) adds the group's records in
    // block order; with more than one group, the last group to finish (a ticket of its own)
    // adds the groups' sums in group order. Each ticket is returned to zero for the next call.
    float* buf = reinterpret_cast<float*>(smem4);  // the ring and the centers' room, free now
    const int room = 4 * (S * bn * p4 + k * dq4);
    auto fold = [&](const float* rows, int count, float* to) {  // to = rows[0] + rows[1] + ...
        const int cw = (room / count) & ~3;  // columns a slab
        if (count > 4 && cw >= 4) {
            for (int c0 = 0; c0 < m; c0 += cw) {
                const int w4 = min(cw, m4 - c0) >> 2;
                for (int idx = tid; idx < count * w4; idx += T) {
                    const int bb = idx / w4, c4 = idx - bb * w4;
                    cp_async16(buf + 4 * (bb * w4 + c4), rows + (size_t)bb * m4 + c0 + 4 * c4);
                }
                cp_async_commit();
                cp_async_wait<0>();
                __syncthreads();
                for (int i0 = tid; i0 < 4 * w4; i0 += 4 * T) {  // four columns at once
                    float s[4] = {0.f, 0.f, 0.f, 0.f};
                    for (int bb = 0; bb < count; ++bb)
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            if (i0 + u * T < 4 * w4) s[u] += buf[4 * bb * w4 + i0 + u * T];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (i0 + u * T < 4 * w4 && c0 + i0 + u * T < m) to[c0 + i0 + u * T] = s[u];
                }
                __syncthreads();
            }
        } else {  // a few rows, or too many for the room: straight from L2
            for (int i = tid; i < m; i += T) {
                float s = 0.f;
                for (int bb = 0; bb < count; ++bb) s += __ldcg(rows + (size_t)bb * m4 + i);
                to[i] = s;
            }
        }
    };
    // a ticket: the block's writes, ordered before thread 0's by the barrier, are released by
    // its fence before the atomic; the last block's fence acquires everyone's
    auto ticket = [&](unsigned* counter, int of) {
        __syncthreads();
        if (tid == 0) {
            __threadfence();
            *last = atomicAdd(counter, 1u) == (unsigned)(of - 1);
            __threadfence();
        }
        __syncthreads();
        return *last != 0;
    };
    const int g = b / kFoldGroup, first = g * kFoldGroup, members = min(kFoldGroup, G - first);
    if (!ticket(a.counter + 1 + g, members)) return;
    float* group_sums = a.scratch + (size_t)G * m4;
    fold(a.scratch + (size_t)first * m4, members, groups == 1 ? a.out : group_sums + (size_t)g * m4);
    if (tid == 0) a.counter[1 + g] = 0u;
    if (groups == 1 || !ticket(a.counter, groups)) return;
    fold(group_sums, groups, a.out);
    if (tid == 0) *a.counter = 0u;
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

cudaError_t check_config(int d, int k, int threads, int stages) {
    if (d < 1 || d > 256 || k < 1) return cudaErrorInvalidValue;
    if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads) return cudaErrorInvalidValue;
    if (stages < 2 || stages > kMaxStages) return cudaErrorInvalidValue;
    if (smem_bytes(d, k, threads, stages) > (size_t)kSmemBudget) return cudaErrorInvalidValue;
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

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// The interface's version: 2 for this one (one launch, a ticket counter, threads and stages).
int kmeans_assign_abi() { return 2; }

// Shared memory of one block for (d, k) with `threads` threads and `stages` ring stages;
// the caller's planner keeps it within the budget.
long long kmeans_assign_smem_bytes(int d, int k, int threads, int stages) {
    return (long long)smem_bytes(d, k, threads, stages);
}

// The most blocks worth launching on `device` for this configuration: resident blocks per
// SM x SMs. Also opts the instance into the shared-memory budget on `device`.
int kmeans_assign_max_blocks(int device, int d, int k, int threads, int stages, int* blocks) {
    cudaError_t err = check_config(d, k, threads, stages);
    if (err != cudaSuccess) return err;
    if ((err = use_device(device)) != cudaSuccess) return err;
    const int inst = instance(d, k);
    if ((err = opt_in(inst, device)) != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kInstances[inst], threads,
                                                        smem_bytes(d, k, threads, stages));
    if (err != cudaSuccess) return err;
    *blocks = sms * (per_sm > 0 ? per_sm : 1);
    return cudaSuccess;
}

// labels (n,) int32, scratch (blocks + ceil(blocks / 16), m4) f32 with m4 = k*d+k+1 rounded
// up to a multiple of 4 and 16-byte aligned, out (k*d+k+1,) f32 and counter (1 + 512 uint32,
// zero between calls, used by one stream at a time) are allocated by the caller.
// One kernel launch on `stream`; nothing is synchronised.
int kmeans_assign_launch(int device, const float* x, const float* centers, long long n, int d, int k, int* labels,
                         float* scratch, int blocks, float* out, unsigned* counter, int threads, int stages,
                         void* stream) {
    cudaError_t err = check_config(d, k, threads, stages);
    if (err != cudaSuccess) return err;
    if (n < 0 || blocks < 1 || (blocks + kFoldGroup - 1) / kFoldGroup > kMaxGroups) return cudaErrorInvalidValue;
    if ((err = use_device(device)) != cudaSuccess) return err;
    const int inst = instance(d, k);
    if ((err = opt_in(inst, device)) != cudaSuccess) return err;
    const long long bn = tile_rows(d, k, threads);
    const long long tiles = (n + bn - 1) / bn;
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    Args a{x, centers, labels, scratch, out, counter, n, d, k, stages, row_stride4(d, k), (int)tiles,
           (reinterpret_cast<uintptr_t>(x) % 16 == 0 && d % 4 == 0) ? 1 : 0,
           (reinterpret_cast<uintptr_t>(centers) % 16 == 0 && d % 4 == 0) ? 1 : 0};
    void* params[] = {&a};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kInstances[inst]), dim3(blocks), dim3(threads), params,
                           smem_bytes(d, k, threads, stages), static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

const char* kmeans_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
