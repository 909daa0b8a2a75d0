// The integer and bool 1-D dot for Hopper: c = Σᵢ a[i]·b[i] in the operands' (promoted) type.
//
// Replaces no Pallas kernel. heat_tpu leaves an integer or bool product to XLA's dot_general
// (jnp.matmul, jnp.dot, jnp.vdot), which gives the product modulo 2^bits of the type and, for
// bool, the OR of ANDs. cuBLAS has no integer GEMM or dot, so torch.matmul and torch.dot raise on
// CUDA integer tensors; the port computes them with hand kernels: the matrices of bool, uint8 and
// int8 on the int8 tensor cores (int_gemm_tc.cu), those of int16, int32 and int64 on the same
// cores as products of byte planes (int_gemm_planes.cu), and the 1-D dot of every type here,
// which is all this source keeps (its IMAD matrix kernel lost to the byte planes at every shape
// the card was asked, matrix-vector steps included).
//
//   int8, uint8, int16, int32 : each product and sum in uint32, wrapping, the result cut to the
//                               type's width (the same bits as any order of wrapping sums)
//   int64                     : products and sums in uint64, wrapping
//   bool                      : acc |= a & b
// Every order of these sums gives the same bits, so the result is exact and equal to XLA's.
//
// What bounds it on an H100: the bytes of the two vectors (a 40M int64 dot reads 640 MB, 0.19 ms
// at 3.35 TB/s). The design: a grid-stride loop a thread, a warp reduction by shuffles and one
// integer atomic a warp (atomicAdd, or atomicOr for bool: they commute exactly) into a zeroed
// accumulator, which a second kernel cuts to the type.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with ctypes
// by heat_tpu_torch/core/kernels/int_matmul.py). Every entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDotThreads = 256;

// The arithmetic of one element type: its storage, accumulator, multiply-add, combination of
// partials (the atomic's operation) and the cut to the output.
template <typename T, typename Acc>
struct Ring {
    using elem = T;
    using acc = Acc;
    __device__ __forceinline__ static acc widen(elem v) { return static_cast<acc>(v); }
    __device__ __forceinline__ static acc mac(acc c, acc a, acc b) { return c + a * b; }
    __device__ __forceinline__ static acc combine(acc x, acc y) { return x + y; }
    __device__ __forceinline__ static void atomic(acc* p, acc v) { atomicAdd(p, v); }
    __device__ __forceinline__ static elem out(acc v) { return static_cast<elem>(v); }
};

struct BoolRing {
    using elem = uint8_t;  // torch.bool: one byte, 0 or 1
    using acc = uint32_t;
    __device__ __forceinline__ static acc widen(elem v) { return v; }
    __device__ __forceinline__ static acc mac(acc c, acc a, acc b) { return c | (a & b); }
    __device__ __forceinline__ static acc combine(acc x, acc y) { return x | y; }
    __device__ __forceinline__ static void atomic(acc* p, acc v) { atomicOr(p, v); }
    __device__ __forceinline__ static elem out(acc v) { return v != 0; }
};

using U32 = uint32_t;
using U64 = unsigned long long;  // atomicAdd's 64-bit type

// sum_i a[i] * b[i] (or OR of ANDs) into partial[0]: a grid-stride loop a thread, a warp's
// lanes combined by shuffles, one atomic a warp
template <class R>
__global__ void __launch_bounds__(kDotThreads) int_dot_kernel(const typename R::elem* __restrict__ a,
                                                             const typename R::elem* __restrict__ b,
                                                             typename R::acc* partial, long long k) {
    using A = typename R::acc;
    A acc = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < k; i += stride)
        acc = R::mac(acc, R::widen(a[i]), R::widen(b[i]));
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc = R::combine(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if ((threadIdx.x & 31) == 0) R::atomic(partial, acc);
}

// the dot's accumulator cut to the output type
template <class R>
__global__ void int_dot_finish_kernel(const typename R::acc* __restrict__ partial, typename R::elem* __restrict__ c) {
    *c = R::out(*partial);
}

// the interface's dtype codes, in int_matmul.py's order
enum Dtype { kBool = 0, kUInt8 = 1, kInt8 = 2, kInt16 = 3, kInt32 = 4, kInt64 = 5 };

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

template <class R>
cudaError_t dot(const void* a, const void* b, void* c, void* partial, long long k, int blocks, cudaStream_t stream) {
    using E = typename R::elem;
    using A = typename R::acc;
    int_dot_kernel<R><<<blocks, kDotThreads, 0, stream>>>(static_cast<const E*>(a), static_cast<const E*>(b),
                                                          static_cast<A*>(partial), k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    int_dot_finish_kernel<R><<<1, 1, 0, stream>>>(static_cast<const A*>(partial), static_cast<E*>(c));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The interface's version.
int int_gemm_abi() { return 2; }

int int_gemm_sm_count(int device, int* sms) {
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// c (a scalar) = sum a[i] b[i] over k contiguous elements (bool: OR of ANDs), through `partial`,
// one zeroed accumulator (uint32, uint64 for int64); `blocks` blocks of 256 threads. Two launches
// on `stream` (the sum, the cut to the type); nothing is synchronised.
int int_dot_launch(int device, int dtype, const void* a, const void* b, void* c, void* partial, long long k, int blocks,
                   void* stream) {
    if (k < 1 || blocks < 1 || partial == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case kBool: return dot<BoolRing>(a, b, c, partial, k, blocks, s);
        case kUInt8: return dot<Ring<uint8_t, U32>>(a, b, c, partial, k, blocks, s);
        case kInt8: return dot<Ring<int8_t, U32>>(a, b, c, partial, k, blocks, s);
        case kInt16: return dot<Ring<int16_t, U32>>(a, b, c, partial, k, blocks, s);
        case kInt32: return dot<Ring<int32_t, U32>>(a, b, c, partial, k, blocks, s);
        case kInt64: return dot<Ring<int64_t, U64>>(a, b, c, partial, k, blocks, s);
        default: return cudaErrorInvalidValue;
    }
}

const char* int_gemm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
