// A host stand-in for the little of the CUDA runtime that the port's kernel
// sources (latentaugment_tpu_torch/csrc) use, so that a host compiler can
// build them and the CPU tests can run their index arithmetic: a launch
// runs the blocks one after another, each as one std::thread per CUDA
// thread with a std::barrier for __syncthreads(). Dynamic shared memory is
// one global array, filled with NaN before every block so that a read of a
// word no thread wrote shows in the result. No warp intrinsics, no static
// __shared__ arrays, no atomics: the sources use none.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <tuple>
#include <utility>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __shared__
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* g_barrier = nullptr;
alignas(16) inline float4 smem4[232448 / 16];
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int v) { return v > 232448 ? 1 : 0; }
inline cudaError_t cudaGetLastError() { return 0; }
template <typename... K, size_t... I>
void emu_call(void (*f)(K...), void** a, std::index_sequence<I...>) { f(*(std::remove_reference_t<K>*)a[I]...); }
template <typename... K>
cudaError_t cudaLaunchKernel(void (*f)(K...), dim3 grid, dim3 block, void** args, size_t smem, cudaStream_t) {
    if (smem > 232448) return 1;
    const unsigned nt = block.x * block.y * block.z;
    for (unsigned bz = 0; bz < grid.z; ++bz) for (unsigned by = 0; by < grid.y; ++by) for (unsigned bx = 0; bx < grid.x; ++bx) {
        // poison shared memory so reads of unwritten words show
        for (auto& v : smem4) v = float4{NAN, NAN, NAN, NAN};
        std::barrier<> bar(nt);
        g_barrier = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
            ts.emplace_back([=, &bar] {
                threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
                blockIdx = dim3(bx, by, bz); blockDim = block; gridDim = grid;
                emu_call(f, args, std::index_sequence_for<K...>{});
                bar.arrive_and_drop();
            });
        for (auto& t : ts) t.join();
    }
    return 0;
}
