// Kernel K2: upfirdn2d (zero-insert upsample, pad/crop, FIR, decimate) on
// [planes, H, W] images, f32 or bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas kernel `_upfirdn2d_pallas_call`
// (latentaugment_tpu/ops/upfirdn2d.py:492-576) and, called with the
// transformed parameters of its custom VJP (:598-614), its backward.
//
// What bounds it on the H100: bytes. The StyleGAN2 filters have 4 taps
// (16 multiply-adds per output in the 2-D form, 4 per output and axis
// when separable), far below the ~295 operations per byte at which the
// card turns compute-bound, so the floor is reading the input once and
// writing the output once from device memory.
//
// The simple design: one thread per output pixel, a 32x8 block of
// threads over a 32x8 tile of output columns and rows (coalesced stores),
// blockIdx.z over the [N*C] planes. The per-thread index math (window
// origin, first live tap) depends only on (oy, ox), so it is done once
// and reused for every plane the thread visits; the tap loops do no
// integer division, and they unroll over at most 4 taps per axis (all of
// StyleGAN2's filters have 4; larger ones are refused), so a thread has
// its whole window of loads in flight at once instead of one load at a
// time. The TPU kernel inserted the upsampling zeros outside the
// kernel (Mosaic could not lower the interleave) and so read and wrote a
// 4x canvas for up=2; here the zero insertion is folded into the
// indexing: a tap touches canvas row u only when (u - pad0) % up == 0, so
// the loops start at the first such tap and step by `up`, never reading
// an inserted zero. Padding and cropping are bounds tests on the source
// index, decimation is the output stride. The taps sit in shared memory
// (reversed on load for the convolution convention). Input rows a thread
// re-reads for neighbouring taps come from L1/L2; a shared-memory input
// tile with halo and 16-byte vector loads are left for a later change.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Taps per axis; the launcher refuses larger filters.
#define UPFIRDN2D_MAX_TAPS 4

struct Upfirdn2dParams {
    long long planes;  // N * C
    int in_h, in_w, out_h, out_w;
    int upx, upy, downx, downy, padx0, pady0;
    int fw, fh, separable, flip;
    float gain;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// At most UPFIRDN2D_MAX_TAPS live taps per axis, known at compile time, so
// both tap loops unroll and every load of a window is issued before the
// first multiply-add (out-of-range taps are predicated off).
template <typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 const float* __restrict__ f, Upfirdn2dParams p) {
    __shared__ float taps[UPFIRDN2D_MAX_TAPS * UPFIRDN2D_MAX_TAPS];
    const int nf = p.separable ? p.fw : p.fw * p.fh;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    // The op convolves (flip=0): correlate with the reversed taps. Reversing
    // the flat index of a row-major [fh, fw] filter flips both axes.
    for (int i = tid; i < nf; i += blockDim.x * blockDim.y)
        taps[i] = f[p.flip ? i : nf - 1 - i];
    __syncthreads();

    const int ox = blockIdx.x * blockDim.x + threadIdx.x;
    const int oy = blockIdx.y * blockDim.y + threadIdx.y;
    if (ox >= p.out_w || oy >= p.out_h) return;

    // Canvas position of the window's first tap, relative to the
    // zero-inserted input (canvas u <-> input u / up when u % up == 0).
    // The first live tap a0 makes cy + a0 a multiple of up; from there
    // each live tap (a0 + k * up) reads the next input row iy0 + k, so the
    // tap loops need no division.
    const int cy = oy * p.downy - p.pady0;
    const int cx = ox * p.downx - p.padx0;
    const int a0 = ((-cy) % p.upy + p.upy) % p.upy;
    const int b0 = ((-cx) % p.upx + p.upx) % p.upx;
    const int iy0 = (cy + a0) / p.upy;  // exact division
    const int ix0 = (cx + b0) / p.upx;
    const int nty = a0 < p.fh ? (p.fh - a0 + p.upy - 1) / p.upy : 0;  // live taps
    const int ntx = b0 < p.fw ? (p.fw - b0 + p.upx - 1) / p.upx : 0;
    const long long in_plane = (long long)p.in_h * p.in_w;
    const long long out_plane = (long long)p.out_h * p.out_w;

    for (long long plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
        const T* xp = x + plane * in_plane;
        float acc = 0.f;
#pragma unroll
        for (int ky = 0; ky < UPFIRDN2D_MAX_TAPS; ++ky) {
            const int iy = iy0 + ky;
            const bool row_ok = ky < nty && iy >= 0 && iy < p.in_h;
            const int a = a0 + ky * p.upy;
            float racc = 0.f;
#pragma unroll
            for (int kx = 0; kx < UPFIRDN2D_MAX_TAPS; ++kx) {
                const int ix = ix0 + kx;
                const int b = b0 + kx * p.upx;
                if (row_ok && kx < ntx && ix >= 0 && ix < p.in_w)
                    racc += (p.separable ? taps[b] : taps[a * p.fw + b])
                            * load_f32(xp + (long long)iy * p.in_w + ix);
            }
            if (row_ok)
                acc += p.separable ? taps[a] * racc : racc;
        }
        store(y + plane * out_plane + (long long)oy * p.out_w + ox, acc * p.gain);
    }
}

extern "C" int upfirdn2d_launch(const void* x, void* y, const void* f, int dtype,
                                long long planes, int in_h, int in_w, int out_h, int out_w,
                                int upx, int upy, int downx, int downy, int padx0, int pady0,
                                int fw, int fh, int separable, int flip, float gain,
                                void* stream) {
    if (fw < 1 || fh < 1 || fw > UPFIRDN2D_MAX_TAPS || fh > UPFIRDN2D_MAX_TAPS ||
        (separable && fw != fh) ||
        upx < 1 || upy < 1 || downx < 1 || downy < 1 || planes < 0 ||
        in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    Upfirdn2dParams p;
    p.planes = planes;
    p.in_h = in_h; p.in_w = in_w; p.out_h = out_h; p.out_w = out_w;
    p.upx = upx; p.upy = upy; p.downx = downx; p.downy = downy;
    p.padx0 = padx0; p.pady0 = pady0;
    p.fw = fw; p.fh = fh; p.separable = separable; p.flip = flip; p.gain = gain;
    if (planes == 0) return (int)cudaSuccess;

    const dim3 block(32, 8);
    // gridDim.z is at most 65535; the plane loop covers the rest.
    const dim3 grid((out_w + 31) / 32, (out_h + 7) / 8,
                    (unsigned)(planes < 65535 ? planes : 65535));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        upfirdn2d_kernel<float><<<grid, block, 0, s>>>(
            (const float*)x, (float*)y, (const float*)f, p);
    else
        upfirdn2d_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
            (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (const float*)f, p);
    return (int)cudaGetLastError();
}
