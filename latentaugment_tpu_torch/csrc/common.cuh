// Shared by the kernels' sources: element loads and stores in f32 or
// bf16, index helpers, and the launch helper. ops/_build.py names a built
// library by the content of every file in this directory, so an edit
// here rebuilds all of them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Four consecutive elements in one store; `p` must be aligned to 4 elements.
__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
}

// Two consecutive elements in one store; `p` must be aligned to 2 elements.
__device__ __forceinline__ void store2(float* p, float a, float b) {
    float2 v;
    v.x = a;
    v.y = b;
    *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Floor division and non-negative remainder for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int pos_mod(int a, int b) {
    const int r = a % b;
    return r < 0 ? r + b : r;
}

__device__ __forceinline__ float stage_load(const float* p, float add) { return *p + add; }
__device__ __forceinline__ float stage_load(const __nv_bfloat16* p, float add) {
    return __bfloat162float(*p) + add;
}
__device__ __forceinline__ uint8_t stage_load(const uint8_t* p, float) { return *p; }

// Stage a [rows][cols] window of the [src_h][src_w] image `src`, whose
// corner is image position (y0, x0), into shared memory at `dst` with row
// pitch `pitch`: `add` is added to what lies inside the image, positions
// outside it and columns from `live_cols` on are 0. With GAP > 0, column
// c of a row lies at c + GAP * (c / 32) (gaps that spread a warp's strided
// reads over the banks; see upfirdn2d.cu's `f2d`). A warp takes U rows
// and J spans of 32 columns at a time, its lanes along the columns
// (coalesced), and issues all U * J loads before it stores any: one load
// at a time would leave the block waiting out the device memory's
// latency once per element. With U * warps >= rows and 32 * J >= cols
// the whole window is one round.
template <int U, int J, int GAP = 0, typename S, typename D>
__device__ __forceinline__ void stage_window(const S* __restrict__ src, int src_h, int src_w,
                                             int y0, int x0, D* __restrict__ dst, int rows,
                                             int cols, int live_cols, int pitch, float add,
                                             int tid, int nt) {
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    for (int r0 = warp; r0 < rows; r0 += nwarps * U) {
        for (int c0 = lane; c0 < cols; c0 += 32 * J) {
            D v[U][J];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int r = r0 + u * nwarps, y = y0 + r;
                const bool row_in = r < rows && y >= 0 && y < src_h;
#pragma unroll
                for (int j = 0; j < J; ++j) {
                    const int c = c0 + 32 * j, x = x0 + c;
                    v[u][j] = D(0);
                    if (row_in && c < live_cols && c < cols && x >= 0 && x < src_w)
                        v[u][j] = stage_load(src + (long long)y * src_w + x, add);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int r = r0 + u * nwarps;
#pragma unroll
                for (int j = 0; j < J; ++j) {
                    const int c = c0 + 32 * j;
                    if (r < rows && c < cols) dst[r * pitch + c + GAP * (c >> 5)] = v[u][j];
                }
            }
        }
    }
}

static inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

template <typename V>
struct Same { typedef V type; };

// Allow `smem` bytes of dynamic shared memory, launch, and return the
// launch's error. The arguments convert to the kernel's parameter types.
template <typename... K>
static cudaError_t launch_kernel(void (*kernel)(K...), dim3 grid, dim3 block, size_t smem,
                                 cudaStream_t stream, typename Same<K>::type... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    void* argv[] = {(void*)&args...};
    err = cudaLaunchKernel(kernel, grid, block, argv, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}
