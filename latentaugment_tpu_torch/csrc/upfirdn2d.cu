// Kernel K2: upfirdn2d (zero-insert upsample, pad/crop, FIR, decimate) on
// [planes, H, W] images, f32 or bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas kernel `_upfirdn2d_pallas_call`
// (latentaugment_tpu/ops/upfirdn2d.py:492-576) and, called with the
// transformed parameters of its custom VJP (:598-614), its backward.
//
// What bounds it on the H100: bytes. The StyleGAN2 filters have 4 taps
// (4 multiply-adds per output and axis when separable), far below the
// ~20 fp32 operations per byte at which the card's FMA pipe becomes the
// limit, so the floor is reading the input once and writing the output
// once from device memory (1.078 GB, 0.32 ms, for the generator's blur
// of [32,128,257,257] bf16). What stands between a kernel and that
// floor here is instructions: scalar 2-byte global loads behind bounds
// tests, one per tap and output, run an order of magnitude above it;
// so the separable kernel stages each input once, tests bounds only
// there, and filters from shared memory in registers.
//
// Two kernels, chosen by the plan in ops/upfirdn2d.py (the launchers
// refuse a plan that does not fit them):
//
//  * `upfirdn2d_kernel_sep4<UP, DOWN, T>` for the separable 4-tap filter
//    with (up, down) = (1,1), (1,2) or (2,1): every geometry of the
//    StyleGAN2 walk and its backward. A block of 256 threads stages the
//    input tile with its halo in shared memory as f32 (lanes along
//    the rows, 8 loads in flight per thread; padding and cropping are
//    bounds tests here and nowhere else), then runs the two 1-D passes from shared
//    memory: along W a thread makes 4 outputs of one staged row from one
//    window of float2 loads; along H it makes 2 rows x 4 columns from a
//    sliding window of float4 loads, and writes 4 outputs in one store
//    where the output rows are aligned. The taps are kernel parameters
//    (constant memory; with compile-time indices each is an operand of
//    its FFMA). For up = 2 the polyphase is resolved on the host: the
//    tile starts at an even output, so an output's phase is its local
//    index modulo 2, and the wrapper hands a table of 3 taps per phase
//    (2 live taps, shifted by one where that phase starts one input
//    later). Tiles (rows x columns of outputs) and shared memory:
//    (1,1) 32x128, 37 KB; (1,2) 32x64, 52 KB; (2,1) 32x128, 14 KB;
//    smaller maps take a tile cut to their size. Blocks loop over planes
//    in z.
//  * `upfirdn2d_kernel<T>`, the generic kernel, for 2-D filters, other
//    rates and fewer taps: one thread per output pixel, at most 4 taps
//    per axis, the zero insertion folded into the indexing (a tap touches
//    canvas row u only when (u - pad0) % up == 0, so the loops start at
//    the first such tap and step by `up`), taps in shared memory.
//
// C interface for ctypes; each launcher returns the CUDA error of the
// launch (or cudaErrorInvalidValue for arguments it does not take).

#include "common.cuh"

// Taps per axis; the launchers refuse larger filters.
#define UPFIRDN2D_MAX_TAPS 4
#define UPFIRDN2D_THREADS 256
#define UPFIRDN2D_MAX_SMEM_BYTES 232448

// ----------------------------------------------------------------------------
// The separable 4-tap kernel.

struct Upfirdn2dSepParams {
    long long planes;  // N * C
    int in_h, in_w, out_h, out_w;
    int ox, oy;    // UP == 1: the low padding; UP == 2: the input index that tap 0 of
                   // the tables meets at output 0
    int toh, tow;  // output tile: toh % 2 == 0, tow % 4 == 0
    // UP == 1: 4 correlation taps per axis. UP == 2: [phase][3] tables.
    // The gain is folded into ty.
    float tx[8], ty[8];
};

// Staged rows / columns under `n` outputs.
static inline int sep4_window(int up, int down, int n) {
    return up == 1 ? (n - 1) * down + 4 : n / 2 + 2;
}

// Shared memory of the separable kernel in bytes; ops/upfirdn2d.py
// (`_sep4_smem_bytes`) computes the same.
static inline size_t sep4_smem_bytes(int up, int down, int toh, int tow) {
    const int xh = sep4_window(up, down, toh), xw = sep4_window(up, down, tow);
    return sizeof(float) * ((size_t)xh * round_up(xw, 4) + (size_t)xh * tow);
}

template <int UP, int DOWN, typename T>
__global__ void __launch_bounds__(UPFIRDN2D_THREADS)
upfirdn2d_kernel_sep4(const T* __restrict__ x, T* __restrict__ y, const Upfirdn2dSepParams p) {
    constexpr int NT = UPFIRDN2D_THREADS;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);

    const int toh = p.toh, tow = p.tow;
    const int xh = UP == 1 ? (toh - 1) * DOWN + 4 : toh / 2 + 2;
    const int xw = UP == 1 ? (tow - 1) * DOWN + 4 : tow / 2 + 2;
    const int px = (xw + 3) & ~3;
    float* s_x = smem;            // [xh][px]   input tile with halo
    float* s_h = smem + xh * px;  // [xh][tow]  filtered along W

    const int tid = threadIdx.x;
    const int ox0 = blockIdx.x * tow, oy0 = blockIdx.y * toh;
    const int ix0 = UP == 1 ? ox0 * DOWN - p.ox : ox0 / 2 + p.ox;
    const int iy0 = UP == 1 ? oy0 * DOWN - p.oy : oy0 / 2 + p.oy;
    const long long in_plane = (long long)p.in_h * p.in_w;
    const long long out_plane = (long long)p.out_h * p.out_w;
    const int nt = tow / 4;
    const bool vec = (p.out_w % 4) == 0;

    for (long long plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
        __syncthreads();  // the previous plane is done with shared memory

        // Stage the input tile; zeros outside the image.
        stage_window<4, 2>(x + plane * in_plane, p.in_h, p.in_w, iy0, ix0, s_x, xh, px, xw, px, 0.f,
                        tid, NT);
        __syncthreads();

        // Along W: 4 outputs of one staged row per thread.
        {
            constexpr int NW = UP == 1 ? 3 * DOWN + 4 : 4;  // window
            constexpr int NWL = (NW + 1) & ~1;              // loaded as float2
            constexpr int STEP = UP == 1 ? 4 * DOWN : 2;    // window start per 4 outputs
            const int dr = NT / nt, dt = NT - dr * nt;
            int r = tid / nt, t = tid - r * nt;
            while (r < xh) {
                const float* src = s_x + r * px + t * STEP;
                float w[NWL];
#pragma unroll
                for (int i = 0; i < NWL; i += 2) {
                    const float2 v = *reinterpret_cast<const float2*>(src + i);
                    w[i] = v.x;
                    w[i + 1] = v.y;
                }
                float o[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    float acc = 0.f;
                    if constexpr (UP == 1) {
#pragma unroll
                        for (int b = 0; b < 4; ++b) acc = fmaf(p.tx[b], w[c * DOWN + b], acc);
                    } else {
#pragma unroll
                        for (int k = 0; k < 3; ++k)
                            acc = fmaf(p.tx[(c % 2) * 3 + k], w[c / 2 + k], acc);
                    }
                    o[c] = acc;
                }
                *reinterpret_cast<float4*>(s_h + r * tow + t * 4) =
                    make_float4(o[0], o[1], o[2], o[3]);
                t += dt;
                r += dr;
                if (t >= nt) { t -= nt; ++r; }
            }
        }
        __syncthreads();

        // Along H: 2 output rows x 4 columns per thread.
        {
            constexpr int NWV = UP == 1 ? DOWN + 4 : 3;   // window rows
            constexpr int STEP = UP == 1 ? 2 * DOWN : 1;  // window start per 2 output rows
            T* yp = y + plane * out_plane;
            const int nrb = toh / 2;
            const int dr = NT / nt, dt = NT - dr * nt;
            int rb = tid / nt, t = tid - rb * nt;
            while (rb < nrb) {
                const float* src = s_h + (rb * STEP) * tow + t * 4;
                float4 acc[2];
                acc[0] = make_float4(0.f, 0.f, 0.f, 0.f);
                acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int k = 0; k < NWV; ++k) {
                    const float4 v = *reinterpret_cast<const float4*>(src + k * tow);
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int a = UP == 1 ? k - j * DOWN : k;
                        if (a >= 0 && a < (UP == 1 ? 4 : 3)) {
                            const float tap = UP == 1 ? p.ty[a] : p.ty[j * 3 + a];
                            acc[j].x = fmaf(tap, v.x, acc[j].x);
                            acc[j].y = fmaf(tap, v.y, acc[j].y);
                            acc[j].z = fmaf(tap, v.z, acc[j].z);
                            acc[j].w = fmaf(tap, v.w, acc[j].w);
                        }
                    }
                }
                const int ox = ox0 + t * 4;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int oy = oy0 + rb * 2 + j;
                    if (oy < p.out_h && ox < p.out_w) {
                        T* dst = yp + (long long)oy * p.out_w + ox;
                        if (vec) {  // out_w % 4 == 0: all 4 inside, aligned
                            store4(dst, acc[j]);
                        } else {
                            store(dst, acc[j].x);
                            if (ox + 1 < p.out_w) store(dst + 1, acc[j].y);
                            if (ox + 2 < p.out_w) store(dst + 2, acc[j].z);
                            if (ox + 3 < p.out_w) store(dst + 3, acc[j].w);
                        }
                    }
                }
                t += dt;
                rb += dr;
                if (t >= nt) { t -= nt; ++rb; }
            }
        }
    }
}

template <int UP, int DOWN>
static cudaError_t launch_sep4(int dtype, const void* x, void* y, const Upfirdn2dSepParams& p,
                               size_t smem, cudaStream_t s) {
    const dim3 block(UPFIRDN2D_THREADS);
    // gridDim.z is at most 65535; the plane loop covers the rest.
    const dim3 grid((p.out_w + p.tow - 1) / p.tow, (p.out_h + p.toh - 1) / p.toh,
                    (unsigned)(p.planes < 65535 ? p.planes : 65535));
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_kernel(upfirdn2d_kernel_sep4<UP, DOWN, float>, grid, block, smem, s,
                             (const float*)x, (float*)y, p);
    return launch_kernel(upfirdn2d_kernel_sep4<UP, DOWN, __nv_bfloat16>, grid, block, smem, s,
                         (const __nv_bfloat16*)x, (__nv_bfloat16*)y, p);
}

// x: [planes, in_h, in_w]; y: [planes, out_h, out_w]. tx, ty: host arrays
// of 8 floats (see Upfirdn2dSepParams). (up, down) must be (1,1), (1,2)
// or (2,1), the same on both axes.
extern "C" int upfirdn2d_sep4_launch(const void* x, void* y, int dtype, long long planes,
                                     int in_h, int in_w, int out_h, int out_w,
                                     int up, int down, int ox, int oy, int toh, int tow,
                                     int smem_bytes, const float* tx, const float* ty,
                                     void* stream) {
    const bool variant = (up == 1 && (down == 1 || down == 2)) || (up == 2 && down == 1);
    if (!variant || (dtype != 0 && dtype != 1) || planes < 0 ||
        in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || tx == nullptr || ty == nullptr ||
        toh < 2 || toh % 2 != 0 || tow < 4 || tow % 4 != 0)
        return (int)cudaErrorInvalidValue;
    const size_t need = sep4_smem_bytes(up, down, toh, tow);
    if ((size_t)smem_bytes != need || need > UPFIRDN2D_MAX_SMEM_BYTES)
        return (int)cudaErrorInvalidValue;
    if (planes == 0) return (int)cudaSuccess;

    Upfirdn2dSepParams p;
    p.planes = planes;
    p.in_h = in_h; p.in_w = in_w; p.out_h = out_h; p.out_w = out_w;
    p.ox = ox; p.oy = oy; p.toh = toh; p.tow = tow;
    for (int i = 0; i < 8; ++i) { p.tx[i] = tx[i]; p.ty[i] = ty[i]; }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (up == 2) err = launch_sep4<2, 1>(dtype, x, y, p, need, s);
    else if (down == 2) err = launch_sep4<1, 2>(dtype, x, y, p, need, s);
    else err = launch_sep4<1, 1>(dtype, x, y, p, need, s);
    return (int)err;
}

// ----------------------------------------------------------------------------
// The generic kernel.

struct Upfirdn2dParams {
    long long planes;  // N * C
    int in_h, in_w, out_h, out_w;
    int upx, upy, downx, downy, padx0, pady0;
    int fw, fh, separable, flip;
    float gain;
};

// One thread per output pixel, a 32x8 block over a 32x8 tile of outputs,
// blockIdx.z over the planes. At most UPFIRDN2D_MAX_TAPS live taps per
// axis, known at compile time, so both tap loops unroll and every load of
// a window is issued before the first multiply-add (out-of-range taps are
// predicated off).
template <typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 const float* __restrict__ f, const Upfirdn2dParams p) {
    extern __shared__ float4 smem4[];  // UPFIRDN2D_MAX_TAPS^2 floats
    float* taps = reinterpret_cast<float*>(smem4);
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
    const size_t smem = sizeof(float) * UPFIRDN2D_MAX_TAPS * UPFIRDN2D_MAX_TAPS;
    if (dtype == 0)
        return (int)launch_kernel(upfirdn2d_kernel<float>, grid, block, smem, s, (const float*)x,
                                  (float*)y, (const float*)f, p);
    return (int)launch_kernel(upfirdn2d_kernel<__nv_bfloat16>, grid, block, smem, s,
                              (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (const float*)f, p);
}
