// The streaming floor of K1's access pattern on the card, for tools/k1_probe.py --stream:
// x (n, 4 * d4) f32 read once, summed trivially, by four routes of the same grid shape as K1
// (a persistent grid, tiles of 256 rows):
//   ring_cpasync : the route of K1 before its bulk copies, a ring of `stages` tiles filled by
//                  16-byte cp.async from every thread into a padded row stride of p4 chunks;
//   ring_bulk    : the same ring filled by one 1-D TMA bulk copy a tile, completing on an
//                  mbarrier, into unpadded rows (p4 = d4);
//   ring_rows    : the same ring filled by one bulk copy a row, issued by the 32 lanes of
//                  one warp, into the padded stride p4;
//   plain_ld     : 16-byte loads by a grid-stride loop, no shared memory.
// Built by tools/k1_probe.py with the package's nvcc flags; a plain C interface, `run`.

#include <cuda_runtime.h>

#include <cstdint>

namespace {
__device__ __forceinline__ unsigned sa(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
constexpr int kRows = 256, kThreads = 256, kMaxStages = 8;

__device__ __forceinline__ void wait_groups(int pending) {  // cp.async.wait_group takes an immediate
    switch (pending) {
        case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
        case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
        case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
        case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    }
}

__device__ __forceinline__ float row_sum(const float4* row, int d4) {
    float acc = 0.f;
    for (int t = 0; t < d4; ++t) acc += row[t].x + row[t].y + row[t].z + row[t].w;
    return acc;
}
}  // namespace

__global__ void __launch_bounds__(kThreads) ring_cpasync(const float* x, long long n, int d4, int p4, int stages,
                                                         float* out) {
    extern __shared__ float4 sm[];
    const int tid = threadIdx.x;
    const int tiles = (int)((n + kRows - 1) / kRows), G = gridDim.x, b = blockIdx.x;
    const int mine = tiles > b ? (tiles - 1 - b) / G + 1 : 0;
    auto issue = [&](int i) {
        const long long r0 = ((long long)b + (long long)i * G) * kRows;
        const int rows = (int)min((long long)kRows, n - r0);
        float* dst = reinterpret_cast<float*>(sm + (size_t)(i % stages) * kRows * p4);
        for (int idx = tid; idx < rows * d4; idx += kThreads) {
            const int r = idx / d4, c = idx - r * d4;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa(dst + 4 * (r * p4 + c))),
                         "l"(x + r0 * 4 * d4 + 4LL * idx) : "memory");
        }
    };
    for (int s = 0; s < stages - 1; ++s) {
        if (s < mine) issue(s);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    float acc = 0.f;
    for (int i = 0; i < mine; ++i) {
        wait_groups(stages - 2);
        __syncthreads();
        if (i + stages - 1 < mine) issue(i + stages - 1);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        acc += row_sum(sm + (size_t)(i % stages) * kRows * p4 + tid * p4, d4);
    }
    out[b * kThreads + tid] = acc;
}

// per_row 0: one bulk copy a tile into rows of d4 chunks (p4 must equal d4); 1: one a row,
// by the lanes of warp 0, into rows of p4 chunks
__global__ void __launch_bounds__(kThreads) ring_bulk(const float* x, long long n, int d4, int p4, int stages,
                                                      int per_row, float* out) {
    extern __shared__ float4 sm[];
    __shared__ __align__(8) unsigned long long bar[kMaxStages];
    const int tid = threadIdx.x;
    const int tiles = (int)((n + kRows - 1) / kRows), G = gridDim.x, b = blockIdx.x;
    const int mine = tiles > b ? (tiles - 1 - b) / G + 1 : 0;
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(&bar[s])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    auto issue = [&](int i) {  // by warp 0
        const long long r0 = ((long long)b + (long long)i * G) * kRows;
        const int rows = (int)min((long long)kRows, n - r0);
        const unsigned row_bytes = 16u * d4, at = sa(&bar[i % stages]);
        float* dst = reinterpret_cast<float*>(sm + (size_t)(i % stages) * kRows * p4);
        if (tid == 0)
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(at), "r"(rows * row_bytes) : "memory");
        __syncwarp();
        if (!per_row) {
            if (tid == 0)
                asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                             ::"r"(sa(dst)), "l"(x + r0 * 4 * d4), "r"(rows * row_bytes), "r"(at) : "memory");
        } else {
            for (int r = tid; r < rows; r += 32)
                asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                             ::"r"(sa(dst + 4 * r * p4)), "l"(x + (r0 + r) * 4 * d4), "r"(row_bytes), "r"(at) : "memory");
        }
    };
    if (tid < 32)
        for (int s = 0; s < stages - 1 && s < mine; ++s) issue(s);
    float acc = 0.f;
    for (int i = 0; i < mine; ++i) {
        const unsigned parity = (i / stages) & 1, at = sa(&bar[i % stages]);
        asm volatile("{\n .reg .pred p;\n W: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra W;\n}\n"
                     ::"r"(at), "r"(parity) : "memory");
        __syncthreads();
        if (tid < 32 && i + stages - 1 < mine) issue(i + stages - 1);
        acc += row_sum(sm + (size_t)(i % stages) * kRows * p4 + tid * p4, d4);
    }
    out[b * kThreads + tid] = acc;
}

__global__ void plain_ld(const float4* x, long long n4, float* out) {
    float acc = 0.f;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
        const float4 v = __ldcs(x + i);
        acc += v.x + v.y + v.z + v.w;
    }
    out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" {

// route 0 ring_cpasync, 1 ring_bulk (a copy a tile, p4 = d4), 2 plain_ld, 3 ring_bulk (a copy
// a row); x (n, 4 * d4) f32, 16-byte aligned; rows of p4 chunks in shared memory; 2 to 8
// stages; out holds blocks * 256 floats
int run(int route, const float* x, long long n, int d4, int p4, int stages, float* out, int blocks, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (stages < 2 || stages > kMaxStages || p4 < d4 || (route == 1 && p4 != d4)) return cudaErrorInvalidValue;
    if (route == 2) {
        plain_ld<<<blocks, kThreads, 0, s>>>(reinterpret_cast<const float4*>(x), n * d4, out);
        return cudaGetLastError();
    }
    const size_t smem = (size_t)stages * kRows * p4 * 16;
    const void* fn = route == 0 ? (const void*)ring_cpasync : (const void*)ring_bulk;
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (route == 0) ring_cpasync<<<blocks, kThreads, smem, s>>>(x, n, d4, p4, stages, out);
    else ring_bulk<<<blocks, kThreads, smem, s>>>(x, n, d4, p4, stages, route == 3 ? 1 : 0, out);
    return cudaGetLastError();
}

}  // extern "C"
