// The pieces of a TMA ring that every wgmma source shares (wgmma_int8.cuh for the integer
// products, wgmma_16bit.cuh for the 16-bit attention backward): shared-memory addresses, the
// mbarrier operations of a ring's full and empty barriers, cuTensorMapEncodeTiled from
// libcuda.so.1 by dlsym, and the error codes these sources return above CUDA's.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdio>

namespace {

// the error codes of the sources that include this header, above CUDA's
constexpr int kErrNoEncode = 100001;     // no cuTensorMapEncodeTiled in libcuda.so.1
constexpr int kErrEncode = 100002;       // cuTensorMapEncodeTiled refused a map
constexpr int kErrShape = 100003;        // a size past what the kernel addresses

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@p bra DONE;\n"
        "bra WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded (the runtime links no libcuda)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
        return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }();
    return fn;
}

CUresult last_encode_result = CUDA_SUCCESS;

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

// the message of a code of this header's sources
const char* tc_error_string(int code) {
    static thread_local char buf[160];
    switch (code) {
        case kErrNoEncode: return "no cuTensorMapEncodeTiled in libcuda.so.1";
        case kErrEncode:
            snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled refused a map (CUresult %d)", (int)last_encode_result);
            return buf;
        case kErrShape: return "a size past what the kernel addresses (rows, k or tiles past 2^31, or 65535 batches)";
        default: return cudaGetErrorString(static_cast<cudaError_t>(code));
    }
}

}  // namespace
