// Integer and bool matrix product for Hopper: C = A·B in the operands' (promoted) type.
//
// Replaces no Pallas kernel. heat_tpu leaves an integer or bool product to XLA's dot_general
// (jnp.matmul, jnp.dot, jnp.vdot), which gives the product modulo 2^bits of the type and, for
// bool, the OR of ANDs. cuBLAS has no integer GEMM, so torch.matmul raises on CUDA integer
// tensors; this kernel is the port's only route for them on the card.
//
//   int8, uint8, int16, int32 : each product and sum in uint32, wrapping, the result cut to the
//                               type's width (the same bits as any order of wrapping sums)
//   int64                     : products and sums in uint64, wrapping
//   bool                      : acc |= a & b
// Every order of these sums gives the same bits, so the result is exact and equal to XLA's.
//
// Since the tensor-core product (int_gemm_tc.cu) takes the matrices of bool, uint8 and int8, the
// product here serves int16, int32 and int64, and the 1-D dot every type.
//
// What bounds this design on an H100: nothing here runs on the tensor cores. A multiply-add of
// 8 to 32 bits is one IMAD (64 a clock an SM: 16.7e12 a second at 1.98 GHz on 132 SMs); an
// int64 one is three (IMAD.WIDE.U32 for the low words with the 64-bit sum, and one IMAD for
// each cross term); a bool one is one LOP3 on the same pipe. At the sizes users run (8192^3)
// that is ~33 ms of int32 IMAD against 0.8 ms of bytes, so the kernel is bound by integer
// instructions. The card itself could go lower on its int8 tensor cores (1,979 TOP/s: int8 and
// bool in one product, wider types as products of byte planes), which is what chip_smoke.py's
// bound counts. The design keeps the work on IMAD: a 128 x 128 tile of C a block, 16 x 16 threads, each with
// an 8 x 8 block of accumulators in registers (its rows ty + 16 i and columns tx + 16 j), so a
// step of the k loop reads 16 values from shared memory for 64 multiply-adds. A and B come in
// 16-deep slabs through shared memory (A stored transposed, so a thread's 8 A values are
// broadcasts and its 8 B values fall on 8 distinct banks across the warp).
//   * Batched products: blockIdx.z is the batch, with a batch stride an operand (0 where an
//     operand is shared by every batch).
//   * The 1-D dot (m = n = 1), which one output tile would leave to one block: a grid-stride
//     loop a thread, a warp reduction by shuffles and one integer atomic a warp (atomicAdd, or
//     atomicOr for bool: they commute exactly) into a zeroed accumulator, which a second
//     kernel cuts to the type.
// Later work (ROADMAP Queue 2): the wider types as int8 tensor-core products of their byte
// planes, k split over blocks where m·n gives few tiles, and a pipelined cp.async ring.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface (loaded with ctypes
// by heat_tpu_torch/core/kernels/int_matmul.py). Every entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;  // 16 x 16, each 8 x 8 outputs
constexpr int kTM = 8, kTN = 8;
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

struct Args {
    const void* a;
    const void* b;
    void* c;
    long long m, n, k;
    long long a_batch, b_batch;  // element strides between batches (0: shared)
    long long tiles_n;
};

template <class R>
__global__ void __launch_bounds__(kThreads) int_gemm_kernel(Args p) {
    using E = typename R::elem;
    using A = typename R::acc;
    __shared__ E as[kBK][kBM];  // A's slab, transposed
    __shared__ E bs[kBK][kBN];
    const E* a = static_cast<const E*>(p.a) + blockIdx.z * p.a_batch;
    const E* b = static_cast<const E*>(p.b) + blockIdx.z * p.b_batch;
    const long long row0 = (blockIdx.x / p.tiles_n) * kBM;
    const long long col0 = (blockIdx.x % p.tiles_n) * kBN;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

    A acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

    for (long long k0 = 0; k0 < p.k; k0 += kBK) {
        // A's slab: kBM rows of kBK, neighbouring threads on neighbouring k
#pragma unroll
        for (int i = 0; i < kBM * kBK / kThreads; ++i) {
            const int e = tid + i * kThreads, r = e / kBK, kk = e % kBK;
            const long long gr = row0 + r, gk = k0 + kk;
            as[kk][r] = (gr < p.m && gk < p.k) ? a[gr * p.k + gk] : E(0);
        }
        // B's slab: kBK rows of kBN, neighbouring threads on neighbouring columns
#pragma unroll
        for (int i = 0; i < kBK * kBN / kThreads; ++i) {
            const int e = tid + i * kThreads, kk = e / kBN, cc = e % kBN;
            const long long gk = k0 + kk, gc = col0 + cc;
            bs[kk][cc] = (gk < p.k && gc < p.n) ? b[gk * p.n + gc] : E(0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
            A av[kTM], bv[kTN];
#pragma unroll
            for (int i = 0; i < kTM; ++i) av[i] = R::widen(as[kk][ty + 16 * i]);
#pragma unroll
            for (int j = 0; j < kTN; ++j) bv[j] = R::widen(bs[kk][tx + 16 * j]);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
                for (int j = 0; j < kTN; ++j) acc[i][j] = R::mac(acc[i][j], av[i], bv[j]);
        }
        __syncthreads();
    }

    const long long mn = p.m * p.n;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const long long gr = row0 + ty + 16 * i;
        if (gr >= p.m) continue;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const long long gc = col0 + tx + 16 * j;
            if (gc >= p.n) continue;
            static_cast<E*>(p.c)[blockIdx.z * mn + gr * p.n + gc] = R::out(acc[i][j]);
        }
    }
}

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
cudaError_t gemm(const Args& p, long long batch, cudaStream_t stream) {
    const long long tiles = ((p.m + kBM - 1) / kBM) * p.tiles_n;
    if (tiles > 0x7fffffffLL || batch > 65535) return cudaErrorInvalidValue;
    int_gemm_kernel<R><<<dim3((unsigned)tiles, 1, (unsigned)batch), kThreads, 0, stream>>>(p);
    return cudaGetLastError();
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
int int_gemm_abi() { return 1; }

int int_gemm_sm_count(int device, int* sms) {
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// c (batch, m, n) = a (batch, m, k) · b (batch, k, n) of int16, int32 or int64, each contiguous,
// a batch's stride a_batch (b_batch) elements, 0 where one matrix serves every batch (bool, uint8
// and int8 products go to int_gemm_tc.cu). One launch on `stream`; nothing is synchronised.
int int_gemm_launch(int device, int dtype, const void* a, const void* b, void* c, long long batch, long long m,
                    long long n, long long k, long long a_batch, long long b_batch, void* stream) {
    if (batch < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const Args p{a, b, c, m, n, k, a_batch, b_batch, (n + kBN - 1) / kBN};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case kInt16: return gemm<Ring<int16_t, U32>>(p, batch, s);
        case kInt32: return gemm<Ring<int32_t, U32>>(p, batch, s);
        case kInt64: return gemm<Ring<int64_t, U64>>(p, batch, s);
        default: return cudaErrorInvalidValue;
    }
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
