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
// What bounds it on an H100: each call reads x once, 4*n*d bytes, against 2*n*k*d fp32 FLOPs
// for the dot products: about 2 FLOP per byte at k = 8, far below the card's ~20 FLOP/byte
// fp32 balance point, so it is memory-bound. The design reads x exactly once and writes
// O(k*d) per block besides the labels:
//   * A grid of a few blocks per SM walks the rows with a grid stride, one warp per row.
//     Lane l holds columns l, l+32, ... of the row in registers (coalesced 128-byte loads).
//   * Each block keeps the centers and |c|^2 in shared memory. |x|^2 and the k dot products
//     are plain fp32 FMAs reduced across the warp by a butterfly, which leaves every lane
//     with the same bits. No tensor cores and no TF32: the quadratic expansion cancels for
//     near points, the reason the TPU kernel asks for Precision.HIGHEST.
//   * The argmin scans j = 0..k-1 with strict `<`, so the lowest index wins ties.
//   * Deterministic accumulation, no float atomics: each warp owns one record in shared
//     memory and each lane adds only its own columns; the warps of a block are folded in
//     a fixed order into the block's row of a (blocks, k*d+k+1) scratch, and a second
//     kernel sums the blocks in a fixed order. Two runs on one card give identical bits.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with
// ctypes by heat_tpu_torch/core/kernels/kmeans.py). Every entry point returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps (rows in flight) per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxColsPerLane = 8;         // d <= 256
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

size_t smem_bytes(int d, int k) {
    const size_t m = (size_t)k * d + k + 1;
    return sizeof(float) * ((size_t)k * d + k + kWarps * m);
}

}  // namespace

__global__ void __launch_bounds__(kThreads) kmeans_assign_partial(
    const float* __restrict__ x, const float* __restrict__ centers, long long n, int d, int k,
    int* __restrict__ labels, float* __restrict__ partials) {
    extern __shared__ float smem[];
    const int kd = k * d;
    const int m = kd + k + 1;
    float* cs = smem;            // (k, d) centers
    float* cc = cs + kd;         // (k,) |c|^2
    float* acc = cc + k;         // (kWarps, m) one record per warp
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;

    for (int i = tid; i < kd; i += kThreads) cs[i] = centers[i];
    for (int i = tid; i < kWarps * m; i += kThreads) acc[i] = 0.f;
    __syncthreads();
    for (int j = warp; j < k; j += kWarps) {
        float s = 0.f;
        for (int col = lane; col < d; col += 32) s = fmaf(cs[j * d + col], cs[j * d + col], s);
        s = warp_sum(s);
        if (lane == 0) cc[j] = s;
    }
    __syncthreads();

    float* rec = acc + warp * m;
    const long long step = (long long)gridDim.x * kWarps;
    for (long long row = (long long)blockIdx.x * kWarps + warp; row < n; row += step) {
        const float* xr = x + row * d;
        float xv[kMaxColsPerLane];
        float xx = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxColsPerLane; ++t) {
            const int col = lane + 32 * t;
            xv[t] = col < d ? __ldcs(xr + col) : 0.f;  // streamed once: evict-first
            xx = fmaf(xv[t], xv[t], xx);
        }
        xx = warp_sum(xx);

        float best = 0.f;
        int bj = 0;
        for (int j = 0; j < k; ++j) {
            const float* c = cs + j * d;
            float dot = 0.f;
#pragma unroll
            for (int t = 0; t < kMaxColsPerLane; ++t) {
                const int col = lane + 32 * t;
                if (col < d) dot = fmaf(xv[t], c[col], dot);
            }
            dot = warp_sum(dot);
            const float d2 = fmaxf(xx + cc[j] - 2.f * dot, 0.f);
            if (j == 0 || d2 < best) {
                best = d2;
                bj = j;
            }
        }

        float* srow = rec + bj * d;
#pragma unroll
        for (int t = 0; t < kMaxColsPerLane; ++t) {
            const int col = lane + 32 * t;
            if (col < d) srow[col] += xv[t];
        }
        if (lane == 0) {
            rec[kd + bj] += 1.f;
            rec[kd + k] += best;
            labels[row] = bj;
        }
    }
    __syncthreads();

    float* out = partials + (long long)blockIdx.x * m;
    for (int i = tid; i < m; i += kThreads) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += acc[w * m + i];
        out[i] = s;
    }
}

__global__ void kmeans_reduce_partials(const float* __restrict__ partials, int blocks, int m,
                                       float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partials[(long long)b * m + i];
    out[i] = s;
}

extern "C" {

// Shared memory the assignment kernel needs for (d, k); the caller gates on it.
long long kmeans_assign_smem_bytes(int d, int k) { return (long long)smem_bytes(d, k); }

// The most blocks worth launching on `device` for (d, k): resident blocks per SM x SMs.
int kmeans_assign_max_blocks(int device, int d, int k, int* blocks) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const size_t smem = smem_bytes(d, k);
    err = cudaFuncSetAttribute(kmeans_assign_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kmeans_assign_partial, kThreads, smem);
    if (err != cudaSuccess) return err;
    *blocks = sms * (per_sm > 0 ? per_sm : 1);
    return cudaSuccess;
}

// labels (n,) int32, scratch (blocks, k*d+k+1) f32 and out (k*d+k+1,) f32 are allocated by
// the caller; both kernels run on `stream` and nothing is synchronised.
int kmeans_assign_launch(int device, const float* x, const float* centers, long long n, int d, int k,
                         int* labels, float* scratch, int blocks, float* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const size_t smem = smem_bytes(d, k);
    err = cudaFuncSetAttribute(kmeans_assign_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    kmeans_assign_partial<<<blocks, kThreads, smem, s>>>(x, centers, n, d, k, labels, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int m = k * d + k + 1;
    kmeans_reduce_partials<<<(m + 255) / 256, 256, 0, s>>>(scratch, blocks, m, out);
    return cudaGetLastError();
}

const char* kmeans_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
