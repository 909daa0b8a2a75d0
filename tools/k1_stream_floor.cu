// The streaming floor of K1's access pattern on the card, for tools/k1_probe.py --stream:
// x (n, 64) f32 read once, summed trivially, by three routes of the same grid shape as K1
// (a persistent grid, tiles of 256 rows):
//   ring_cpasync : K1's route, a ring of `stages` tiles filled by 16-byte cp.async into a
//                  padded row stride (68 floats);
//   ring_bulk    : the same ring filled by one 1-D TMA bulk copy a tile, completing on an
//                  mbarrier, into unpadded rows;
//   plain_ld     : 16-byte loads by a grid-stride loop, no shared memory.
// Built by tools/k1_probe.py with the package's nvcc flags; a plain C interface, `run`.

#include <cuda_runtime.h>

#include <cstdint>

namespace {
__device__ __forceinline__ unsigned sa(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
constexpr int kRows = 256, kThreads = 256;
}  // namespace

__global__ void __launch_bounds__(kThreads) ring_cpasync(const float* x, long long n, int stages, float* out) {
    extern __shared__ float4 sm[];
    const int p4 = 17, tid = threadIdx.x;
    const int tiles = (int)((n + kRows - 1) / kRows), G = gridDim.x, b = blockIdx.x;
    const int mine = tiles > b ? (tiles - 1 - b) / G + 1 : 0;
    auto issue = [&](int i) {
        const long long r0 = ((long long)b + (long long)i * G) * kRows;
        const int rows = (int)min((long long)kRows, n - r0);
        float* dst = reinterpret_cast<float*>(sm + (size_t)(i % stages) * kRows * p4);
        for (int idx = tid; idx < rows * 16; idx += kThreads) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa(dst + 4 * ((idx >> 4) * p4 + (idx & 15)))),
                         "l"(x + r0 * 64 + 4LL * idx) : "memory");
        }
    };
    for (int s = 0; s < stages - 1; ++s) {
        if (s < mine) issue(s);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    float acc = 0.f;
    for (int i = 0; i < mine; ++i) {
        if (stages == 2) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        else asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();
        if (i + stages - 1 < mine) issue(i + stages - 1);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        const float4* row = sm + (size_t)(i % stages) * kRows * p4 + tid * p4;
#pragma unroll
        for (int t = 0; t < 16; ++t) acc += row[t].x + row[t].y + row[t].z + row[t].w;
    }
    out[b * kThreads + tid] = acc;
}

__global__ void __launch_bounds__(kThreads) ring_bulk(const float* x, long long n, int stages, float* out) {
    extern __shared__ float4 sm[];
    __shared__ __align__(8) unsigned long long bar[3];
    const int tid = threadIdx.x;
    const int tiles = (int)((n + kRows - 1) / kRows), G = gridDim.x, b = blockIdx.x;
    const int mine = tiles > b ? (tiles - 1 - b) / G + 1 : 0;
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(&bar[s])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    auto issue = [&](int i) {
        const long long r0 = ((long long)b + (long long)i * G) * kRows;
        const unsigned bytes = (unsigned)min((long long)kRows, n - r0) * 256u;
        float* dst = reinterpret_cast<float*>(sm + (size_t)(i % stages) * kRows * 16);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sa(&bar[i % stages])), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                     ::"r"(sa(dst)), "l"(x + r0 * 64), "r"(bytes), "r"(sa(&bar[i % stages])) : "memory");
    };
    if (tid == 0)
        for (int s = 0; s < stages - 1 && s < mine; ++s) issue(s);
    float acc = 0.f;
    for (int i = 0; i < mine; ++i) {
        const unsigned parity = (i / stages) & 1, at = sa(&bar[i % stages]);
        asm volatile("{\n .reg .pred p;\n W: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra W;\n}\n"
                     ::"r"(at), "r"(parity) : "memory");
        __syncthreads();
        if (tid == 0 && i + stages - 1 < mine) issue(i + stages - 1);
        const float4* row = sm + (size_t)(i % stages) * kRows * 16 + tid * 16;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            const float4 v = row[(t + tid) & 15];
            acc += v.x + v.y + v.z + v.w;
        }
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

// route 0 ring_cpasync, 1 ring_bulk (stages 2 or 3), 2 plain_ld; x (n, 64) f32; out holds
// blocks * 256 floats
int run(int route, const float* x, long long n, int stages, float* out, int blocks, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == 0 || route == 1) {
        const size_t smem = (size_t)stages * kRows * (route == 0 ? 17 : 16) * 16;
        const void* fn = route == 0 ? (const void*)ring_cpasync : (const void*)ring_bulk;
        cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        if (route == 0) ring_cpasync<<<blocks, kThreads, smem, s>>>(x, n, stages, out);
        else ring_bulk<<<blocks, kThreads, smem, s>>>(x, n, stages, out);
    } else {
        plain_ld<<<blocks, kThreads, 0, s>>>(reinterpret_cast<const float4*>(x), n * 16, out);
    }
    return cudaGetLastError();
}

}  // extern "C"
