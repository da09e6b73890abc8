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
// there, and filters from shared memory in registers. StyleGAN3-R's
// radial 12x12 down filter is the exception: 144 multiply-adds per
// output at down 2 put it over the fp32 line, so operations bound it.
//
// Four kernels, chosen by the plan in ops/upfirdn2d.py (the launchers
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
//  * `upfirdn2d_kernel_sepn<UP, DOWN, T, Tp>` for the separable filters of
//    more than 4 taps that StyleGAN3-R's decomposed layers launch: up 2
//    with 12 taps, up 4 with 24, and their backwards at down 2 and 4. The
//    same staging and two 1-D passes as `sep4`, with polyphase tables of
//    T / UP + 1 taps per phase, and stores of two elements a lane on every
//    even output width (its note below says more).
//  * `upfirdn2d_kernel_f2d<UP, DOWN, SY, SX, T>` for the 2-D 12x12 filter
//    at down 2 and at up 2: StyleGAN3-R's radial down filter on the
//    decomposed filtered_lrelu, and its backward. The same staging, a
//    register block of outputs per thread, the 144 taps (down 2) or the
//    four 2-D polyphase tables (up 2) as kernel parameters (its note
//    below says more).
//  * `upfirdn2d_kernel<MAXT, T>`, the generic kernel, for other 2-D
//    filters, other rates and other tap counts: one thread per output
//    pixel, the zero insertion folded into the indexing (a tap touches
//    canvas row u only when (u - pad0) % up == 0, so the loops start at
//    the first such tap and step by `up`), taps in shared memory. Two
//    instantiations:
//    MAXT = 4 (at most 4 taps per axis, both tap loops unrolled) and
//    MAXT = 0, whose tap count is a run-time parameter (at most
//    UPFIRDN2D_MAX_DYN_TAPS per axis; fw * fh floats of dynamic shared
//    memory, read from device memory once per block, loops over the live
//    taps only). No path on the card launches it since `f2d` took the
//    radial filter; it stays for the filters and rates that no staged
//    variant takes.
//
// C interface for ctypes; each launcher returns the CUDA error of the
// launch (or cudaErrorInvalidValue for arguments it does not take).

#include "common.cuh"

// Taps per axis of the unrolled instantiations and of the run-time one;
// the launchers refuse larger filters.
#define UPFIRDN2D_MAX_TAPS 4
#define UPFIRDN2D_MAX_DYN_TAPS 64
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
// The staged polyphase kernel for separable filters of more than 4 taps.
//
// Replaces, for StyleGAN3-R's 1-D up filters, the launches of the Pallas
// kernel `_upfirdn2d_pallas_call` (latentaugment_tpu/ops/upfirdn2d.py:492)
// that the decomposed filtered_lrelu makes: up 2 with 12 taps and up 4 with
// 24, and their backwards (down 2 / 12 taps, down 4 / 24 taps).
//
// What bounds it: bytes. The up filters write 4x or 16x the input (5.2 GB
// of bf16 for the walk's L10 at batch 16, 1.6 ms at 3.35 TB/s) and the
// backwards read as much; each output costs 7 multiply-adds along H plus
// a share of the W pass's (up), or 24 + 24 at stride 4 (down), under the
// fp32 line either way. The run-time-tap `generic` kernel spent 25-46x
// that bound on instructions: one thread per output, every tap a bounds-
// tested scalar load through L1, one 2-byte store per thread. Here a
// block stages its input tile with its halo once, as f32 in shared memory
// (bounds tests, padding and cropping only there), runs the W pass into a
// shared [staged rows x output columns] buffer and the H pass from there
// into registers, with the taps as kernel parameters (compile-time
// indices: each an operand of its FFMA). For up > 1 the polyphase is
// resolved on the host: a tile starts at an output index that is a
// multiple of UP, so an output's phase is its local index mod UP, and the
// wrapper hands UP tables of T / UP + 1 taps (`_taps.polyphase_table`),
// the gain folded into the H taps. A thread makes 8 outputs of a staged
// row along W (up) or 4 (down) from one window of float2 loads, and along
// H 8 (up), 2 or 1 (down 2, 4) rows of two adjacent columns from a sliding
// window of float2 loads, so it stores bf16x2 / float2 pairs: at least 4
// bytes a lane, a warp's lanes on consecutive pairs of one output row, on
// every even output width (every width of the R plan). The down filters
// read 4-16x what they write, and a block that stages, then filters,
// leaves the memory idle while it filters: so a block takes 8 planes of
// its tile, and where the rows start at even elements it loads the next
// plane's window into registers (element pairs, one 4- or 8-byte load a
// lane) while it filters this one. Tiles (rows x columns of outputs) and
// shared memory: up 2 64x128, 30 KB; up 4 64x128, 15 KB; down 2 32x64,
// 60 KB; down 4 16x32, 61 KB: at least three blocks an SM.

#define UPFIRDN2D_SEPN_MAX_TAPS 28  // per axis: UP * (T / UP + 1) = 28 for up 4, 24 taps

struct Upfirdn2dSepnParams {
    long long planes;  // N * C
    int in_h, in_w, out_h, out_w;
    int ox, oy;    // UP == 1: the low padding; UP > 1: the input index that entry 0 of
                   // the tables meets at output 0
    int toh, tow;  // output tile: toh % 8 == 0 (UP > 1) or % rows per item (down), tow % 8 == 0
    int pairs;     // in_w even and x aligned to 2 elements: stage element pairs, prefetched
    // UP == 1: T correlation taps per axis. UP > 1: [phase][T / UP + 1] tables.
    // The gain is folded into ty.
    float tx[UPFIRDN2D_SEPN_MAX_TAPS], ty[UPFIRDN2D_SEPN_MAX_TAPS];
};

// Staged rows / columns under `n` outputs.
static inline int sepn_window(int up, int down, int taps, int n) {
    return up == 1 ? (n - 1) * down + taps : n / up + taps / up;
}

// Row pitches of the staged tile and of the W pass's buffer, in floats:
// 2 mod 4 (an odd number of 8-byte words) and tow + 4 (an odd number of
// 16-byte words), so that the lanes of a warp, one staged row each, read
// float2 and write float4 without bank conflicts.
__host__ __device__ static inline int sepn_pitch_x(int xw) { return xw + ((6 - xw % 4) % 4); }
__host__ __device__ static inline int sepn_pitch_h(int tow) { return tow + 4; }

// Shared memory of the kernel in bytes; ops/upfirdn2d.py
// (`_sepn_smem_bytes`) computes the same.
static inline size_t sepn_smem_bytes(int up, int down, int taps, int toh, int tow) {
    const int xh = sepn_window(up, down, taps, toh), xw = sepn_window(up, down, taps, tow);
    return sizeof(float) * ((size_t)round_up(xh * sepn_pitch_x(xw), 4) +
                            (size_t)xh * sepn_pitch_h(tow));
}

// Output rows of one H-pass work item (two columns each).
static inline int sepn_rows_per_item(int up, int down) { return up > 1 ? 8 : (down == 2 ? 2 : 1); }

// Element pairs as loaded (one 8-byte f32 or 4-byte bf16 load) and as f32.
template <typename S> struct SepnPair;
template <> struct SepnPair<float> { typedef float2 type; };
template <> struct SepnPair<__nv_bfloat16> { typedef __nv_bfloat162 type; };
__device__ __forceinline__ void pair_zero(float2& v) { v = make_float2(0.f, 0.f); }
__device__ __forceinline__ void pair_zero(__nv_bfloat162& v) { v = __floats2bfloat162_rn(0.f, 0.f); }
__device__ __forceinline__ float2 pair_f32(float2 v) { return v; }
__device__ __forceinline__ float2 pair_f32(__nv_bfloat162 v) {
    return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}

// A staged window held in registers between its loads and its stores to
// shared memory, so that a block loads the next plane's window while it
// filters this one. Used when the rows start at even elements (src_w even,
// the plane aligned to 2 elements): `npairs` element pairs a row from the
// even column `xe` at or before the window's first, `rows` rows. Warp w
// holds rows w, w + 8, ... (at most RW of them), its lanes pairs lane,
// lane + 32, ... of each (at most JP): every load is one row's 32
// consecutive pairs, and the column tests are made once per lane.
template <int RW, int JP, typename S>
struct SepnWindow {
    typename SepnPair<S>::type v[RW][JP];

    __device__ __forceinline__ void load(const S* __restrict__ src, int src_h, int src_w, int y0,
                                         int xe, int rows, int npairs, int tid) {
        constexpr int NW = UPFIRDN2D_THREADS / 32;
        const int lane = tid & 31, warp = tid >> 5;
        bool col_in[JP];
#pragma unroll
        for (int j = 0; j < JP; ++j) {
            const int q = lane + 32 * j, x = xe + 2 * q;
            col_in[j] = q < npairs && x >= 0 && x < src_w;
        }
        const S* row = src + (long long)(y0 + warp) * src_w + xe + 2 * lane;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
            const int r = warp + i * NW, y = y0 + r;
            const bool row_in = r < rows && y >= 0 && y < src_h;
#pragma unroll
            for (int j = 0; j < JP; ++j) {
                pair_zero(v[i][j]);
                if (row_in && col_in[j])
                    v[i][j] = *reinterpret_cast<const typename SepnPair<S>::type*>(row + 64 * j);
            }
            row += (long long)NW * src_w;
        }
    }

    // Into dst[r][c] (row pitch `pitch`, `cols` columns) with c = 2q - shift;
    // with GAP > 0 column c lies at c + GAP * (c / 32), as stage_window's.
    template <int GAP = 0>
    __device__ __forceinline__ void store(float* __restrict__ dst, int pitch, int cols, int shift,
                                          int rows, int npairs, int tid) const {
        constexpr int NW = UPFIRDN2D_THREADS / 32;
        const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
            const int r = warp + i * NW;
            if (r >= rows) break;
            float* drow = dst + r * pitch;
#pragma unroll
            for (int j = 0; j < JP; ++j) {
                const int q = lane + 32 * j, c = 2 * q - shift;
                if (q < npairs) {
                    const float2 f = pair_f32(v[i][j]);
                    if (c >= 0) drow[c + GAP * (c >> 5)] = f.x;
                    if (c + 1 < cols) drow[c + 1 + GAP * ((c + 1) >> 5)] = f.y;
                }
            }
        }
    }
};

// Rows a warp and pair spans a lane may hold: the planned tiles stage at
// most 38 x 36 pairs (up 2), 22 x 20 (up 4), 74 x 70 (down 2) and 84 x 76
// (down 4); a larger window is staged without prefetch.
#define UPFIRDN2D_SEPN_UP_RW 5
#define UPFIRDN2D_SEPN_UP_JP 2
#define UPFIRDN2D_SEPN_DOWN_RW 11
#define UPFIRDN2D_SEPN_DOWN_JP 3
// Planes per block (gridDim.z covers the planes in this many rounds).
#define UPFIRDN2D_SEPN_PLANES_PER_BLOCK 8

template <int UP, int DOWN, int T, typename Tp>
__global__ void __launch_bounds__(UPFIRDN2D_THREADS)
upfirdn2d_kernel_sepn(const Tp* __restrict__ x, Tp* __restrict__ y, const Upfirdn2dSepnParams p) {
    constexpr int NT = UPFIRDN2D_THREADS;
    constexpr int P = T / UP;                     // UP > 1: live taps of a phase
    constexpr int E = UP == 1 ? T : P + 1;        // taps of a table row
    constexpr int OW = UP == 1 ? 4 : 8;           // W pass: outputs of one item
    constexpr int OH = UP == 1 ? (DOWN == 2 ? 2 : 1) : 8;  // H pass: rows of one item
    constexpr int WW = UP == 1 ? (OW - 1) * DOWN + T : OW / UP + P;  // window along W
    constexpr int WWL = (WW + 1) & ~1;            // loaded as float2
    constexpr int WH = UP == 1 ? (OH - 1) * DOWN + T : OH / UP + P;  // window along H
    constexpr int SW = UP == 1 ? OW * DOWN : OW / UP;  // window start per item
    constexpr int SH = UP == 1 ? OH * DOWN : OH / UP;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);

    const int toh = p.toh, tow = p.tow;
    const int xh = UP == 1 ? (toh - 1) * DOWN + T : toh / UP + P;
    const int xw = UP == 1 ? (tow - 1) * DOWN + T : tow / UP + P;
    const int px = sepn_pitch_x(xw), ph = sepn_pitch_h(tow);
    float* s_x = smem;                                // [xh][px]  input tile with halo
    float* s_h = smem + ((xh * px + 3) & ~3);         // [xh][ph]  filtered along W

    const int tid = threadIdx.x;
    const int ox0 = blockIdx.x * tow, oy0 = blockIdx.y * toh;
    const int ix0 = UP == 1 ? ox0 * DOWN - p.ox : ox0 / UP + p.ox;
    const int iy0 = UP == 1 ? oy0 * DOWN - p.oy : oy0 / UP + p.oy;
    const long long in_plane = (long long)p.in_h * p.in_w;
    const long long out_plane = (long long)p.out_h * p.out_w;
    const int nwi = xh * (tow / OW);                     // W items
    const int nc = tow / 2, nhi = (toh / OH) * nc;       // H items: per row block, in all
    const bool pairs = (p.out_w % 2) == 0;
    // The prefetched window: px columns from the even column at or before ix0.
    constexpr int RW = UP == 1 ? UPFIRDN2D_SEPN_DOWN_RW : UPFIRDN2D_SEPN_UP_RW;
    constexpr int JP = UP == 1 ? UPFIRDN2D_SEPN_DOWN_JP : UPFIRDN2D_SEPN_UP_JP;
    const int shift = pos_mod(ix0, 2), npairs = (px + shift + 1) / 2;
    const bool prefetch = p.pairs && xh <= RW * (NT / 32) && npairs <= 32 * JP;
    SepnWindow<RW, JP, Tp> win;
    if (prefetch && blockIdx.z < p.planes)
        win.load(x + blockIdx.z * in_plane, p.in_h, p.in_w, iy0, ix0 - shift, xh, npairs, tid);

    for (long long plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
        __syncthreads();  // the previous plane is done with shared memory

        // Stage the input tile; zeros outside the image. With prefetch the
        // window is in registers: store it, then load the next plane's.
        if (prefetch) {
            win.store(s_x, px, px, shift, xh, npairs, tid);
            __syncthreads();
            if (plane + gridDim.z < p.planes)
                win.load(x + (plane + gridDim.z) * in_plane, p.in_h, p.in_w, iy0, ix0 - shift,
                         xh, npairs, tid);
        } else {
            stage_window<4, 2>(x + plane * in_plane, p.in_h, p.in_w, iy0, ix0, s_x, xh, px, xw,
                               px, 0.f, tid, NT);
            __syncthreads();
        }

        // Along W: OW outputs of one staged row per item, a warp's lanes on
        // consecutive rows (the pitches keep their accesses conflict-free).
        for (int it = tid; it < nwi; it += NT) {
            const int t = it / xh, r = it - t * xh;
            const float* src = s_x + r * px + t * SW;
            float w[WWL];
#pragma unroll
            for (int i = 0; i < WWL; i += 2) {
                const float2 v = *reinterpret_cast<const float2*>(src + i);
                w[i] = v.x;
                w[i + 1] = v.y;
            }
            float o[OW];
#pragma unroll
            for (int c = 0; c < OW; ++c) {
                float acc = 0.f;
                if constexpr (UP == 1) {
#pragma unroll
                    for (int b = 0; b < T; ++b) acc = fmaf(p.tx[b], w[c * DOWN + b], acc);
                } else {
#pragma unroll
                    for (int k = 0; k < E; ++k)
                        acc = fmaf(p.tx[(c % UP) * E + k], w[c / UP + k], acc);
                }
                o[c] = acc;
            }
            float4* dst = reinterpret_cast<float4*>(s_h + r * ph + t * OW);
#pragma unroll
            for (int c = 0; c < OW; c += 4) dst[c / 4] = make_float4(o[c], o[c + 1], o[c + 2], o[c + 3]);
        }
        __syncthreads();

        // Along H: OH rows x 2 columns per item, stored in pairs.
        Tp* yp = y + plane * out_plane;
        for (int it = tid; it < nhi; it += NT) {
            const int rb = it / nc, t = it - rb * nc;
            const float* src = s_h + (rb * SH) * ph + t * 2;
            float2 acc[OH];
#pragma unroll
            for (int j = 0; j < OH; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll
            for (int k = 0; k < WH; ++k) {
                const float2 v = *reinterpret_cast<const float2*>(src + k * ph);
#pragma unroll
                for (int j = 0; j < OH; ++j) {
                    const int a = UP == 1 ? k - j * DOWN : k - j / UP;
                    if (a >= 0 && a < E) {
                        const float tap = UP == 1 ? p.ty[a] : p.ty[(j % UP) * E + a];
                        acc[j].x = fmaf(tap, v.x, acc[j].x);
                        acc[j].y = fmaf(tap, v.y, acc[j].y);
                    }
                }
            }
            const int ox = ox0 + t * 2;
            if (ox >= p.out_w) continue;
#pragma unroll
            for (int j = 0; j < OH; ++j) {
                const int oy = oy0 + rb * OH + j;
                if (oy < p.out_h) {
                    Tp* dst = yp + (long long)oy * p.out_w + ox;
                    if (pairs) {  // out_w and ox even: both inside, aligned
                        store2(dst, acc[j].x, acc[j].y);
                    } else {
                        store(dst, acc[j].x);
                        if (ox + 1 < p.out_w) store(dst + 1, acc[j].y);
                    }
                }
            }
        }
    }
}

template <int UP, int DOWN, int T>
static cudaError_t launch_sepn(int dtype, const void* x, void* y, const Upfirdn2dSepnParams& p,
                               size_t smem, cudaStream_t s) {
    const dim3 block(UPFIRDN2D_THREADS);
    // gridDim.z is at most 65535; the plane loop covers the rest.
    // A few planes per block, so that loading the next one overlaps
    // filtering this one; gridDim.z is at most 65535.
    const long long gz = (p.planes + UPFIRDN2D_SEPN_PLANES_PER_BLOCK - 1) /
                         UPFIRDN2D_SEPN_PLANES_PER_BLOCK;
    const dim3 grid((p.out_w + p.tow - 1) / p.tow, (p.out_h + p.toh - 1) / p.toh,
                    (unsigned)(gz < 65535 ? gz : 65535));
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_kernel(upfirdn2d_kernel_sepn<UP, DOWN, T, float>, grid, block, smem, s,
                             (const float*)x, (float*)y, p);
    return launch_kernel(upfirdn2d_kernel_sepn<UP, DOWN, T, __nv_bfloat16>, grid, block, smem, s,
                         (const __nv_bfloat16*)x, (__nv_bfloat16*)y, p);
}

// x: [planes, in_h, in_w]; y: [planes, out_h, out_w]. tx, ty: host arrays
// of UPFIRDN2D_SEPN_MAX_TAPS floats (see Upfirdn2dSepnParams). (up, down,
// taps) must be (2, 1, 12), (4, 1, 24), (1, 2, 12) or (1, 4, 24), the same
// on both axes.
extern "C" int upfirdn2d_sepn_launch(const void* x, void* y, int dtype, long long planes,
                                     int in_h, int in_w, int out_h, int out_w,
                                     int up, int down, int taps, int ox, int oy, int toh, int tow,
                                     int smem_bytes, const float* tx, const float* ty,
                                     void* stream) {
    const int variant = (up == 2 && down == 1 && taps == 12) ? 0
                        : (up == 4 && down == 1 && taps == 24) ? 1
                        : (up == 1 && down == 2 && taps == 12) ? 2
                        : (up == 1 && down == 4 && taps == 24) ? 3 : -1;
    if (variant < 0 || (dtype != 0 && dtype != 1) || planes < 0 ||
        in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || tx == nullptr || ty == nullptr ||
        toh < 1 || toh % sepn_rows_per_item(up, down) != 0 || tow < 8 || tow % 8 != 0)
        return (int)cudaErrorInvalidValue;
    const size_t need = sepn_smem_bytes(up, down, taps, toh, tow);
    if ((size_t)smem_bytes != need || need > UPFIRDN2D_MAX_SMEM_BYTES)
        return (int)cudaErrorInvalidValue;
    if (planes == 0) return (int)cudaSuccess;

    Upfirdn2dSepnParams p;
    p.planes = planes;
    p.in_h = in_h; p.in_w = in_w; p.out_h = out_h; p.out_w = out_w;
    p.ox = ox; p.oy = oy; p.toh = toh; p.tow = tow;
    p.pairs = in_w % 2 == 0 && ((uintptr_t)x % (2 * (dtype == 0 ? 4 : 2))) == 0;
    for (int i = 0; i < UPFIRDN2D_SEPN_MAX_TAPS; ++i) { p.tx[i] = tx[i]; p.ty[i] = ty[i]; }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (variant == 0) err = launch_sepn<2, 1, 12>(dtype, x, y, p, need, s);
    else if (variant == 1) err = launch_sepn<4, 1, 24>(dtype, x, y, p, need, s);
    else if (variant == 2) err = launch_sepn<1, 2, 12>(dtype, x, y, p, need, s);
    else err = launch_sepn<1, 4, 24>(dtype, x, y, p, need, s);
    return (int)err;
}

// ----------------------------------------------------------------------------
// The staged 2-D polyphase kernel for StyleGAN3-R's radial 12x12 filter.
//
// Replaces, for the radial down filter of StyleGAN3-R's decomposed layers
// and its backward, the run-time-tap `generic` instantiation
// (`upfirdn2d_kernel<0, T>` below) that ran them before. The JAX package
// computes this filter outside Pallas (`_auto_wants_pallas` takes only 1-D
// filters at up = down = 1, latentaugment_tpu/ops/upfirdn2d.py:120-134, so
// it goes to `_upfirdn2d_xla`); the port's counterpart is K2, the kernel
// that replaces `_upfirdn2d_pallas_call` (:492).
//
// What bounds it: operations. The forward (down 2) makes 144 multiply-adds
// per output, the backward (up 2, the filter flipped, the padding
// transposed) 36: 2.7 ms of fp32 FMA each for the walk's L10 at batch 16,
// against 1.5 ms of bf16 bytes. `generic` spent 15-30x that bound on
// instructions: one thread per output, every tap a bounds-tested scalar
// load through L1 and a tap read from shared memory. Here a block stages
// its input tile with its halo once, as f32 in shared memory (bounds tests,
// padding and cropping only there), and a thread makes a register block of
// outputs from a sliding window of float2 loads, with the taps as kernel
// parameters (compile-time indices: each the constant operand of its FFMA;
// no tap loads, no tap arithmetic).
//  * Down 2: a thread makes 4 rows x 4 columns. Each of the 18 staged rows
//    under them is loaded once (18 columns, 9 float2) and feeds every
//    output row of the block whose 12 taps meet it: 2304 FFMAs a thread
//    from 162 loads.
//  * Up 2: the tile starts at an even output row and column, so an
//    output's phase (ey, ex) is its local index mod 2, and each phase has
//    6 x 6 live taps. The host builds the four phases' 7 x 7 tables from
//    the flipped filter (`_taps.polyphase_table_2d`, the gain folded in);
//    where a phase starts one input later (an even padding), the kernel is
//    instantiated with that shift (SY, SX), so it reads only the 36 live
//    entries. A thread makes 2 x 4 quads (4 rows x 8 columns) from an input
//    window of 7-8 rows by 9-10 columns: 1152 FFMAs from 40 loads.
// A warp's lanes take consecutive column blocks of one row block, 8 (down)
// or 4 (up) staged floats apart; column c of a staged row lies at
// c + 2 * (c / 32), so that the 16 lanes of a half-warp read their float2
// from 32 different banks. The forward stores 4 elements a lane where the
// output width is a multiple of 4 (every forward width of the R plan), the
// backward bf16x2 / float2 pairs on every even width (every backward width
// of the R plan); odd widths take a scalar tail. As in `sepn`, a block
// takes 8 planes of its tile and, where the rows start at even elements,
// loads the next plane's window into registers (element pairs) while it
// filters this one. Tiles (rows x columns of outputs, at most) and shared
// memory: down 2 64x64, 80.6 KB; up 2 64x128, 11.2 KB; a smaller map takes
// a tile cut to its size, and a block's threads take the items that hold
// outputs of the map, packed densely.

#define UPFIRDN2D_F2D_TAPS 12     // per axis
#define UPFIRDN2D_F2D_PHASE 7     // entries of an up-2 phase table per axis
#define UPFIRDN2D_F2D_PARAMS 196  // up 2: [ey][ex][7][7]; down 2 uses 144
#define UPFIRDN2D_F2D_DOWN_TOH 64
#define UPFIRDN2D_F2D_DOWN_TOW 64
#define UPFIRDN2D_F2D_UP_TOH 64
#define UPFIRDN2D_F2D_UP_TOW 128

struct Upfirdn2dF2dParams {
    long long planes;  // N * C
    int in_h, in_w, out_h, out_w;
    int ox, oy;    // down 2: the low padding; up 2: the input index that table entry 0
                   // meets at output 0
    int toh, tow;  // output tile: toh % 4 == 0, tow % 4 (down) or % 8 (up) == 0
    int pairs;     // in_w even and x aligned to 2 elements: stage element pairs, prefetched
    // Down 2: [12][12] correlation taps. Up 2: [ey][ex][7][7] phase tables.
    // The gain is folded in.
    float t[UPFIRDN2D_F2D_PARAMS];
};

// Staged rows / columns under `n` outputs.
__host__ __device__ constexpr int f2d_window(int up, int n) { return up == 1 ? 2 * n + 10 : n / 2 + 6; }
// Where column c of a staged row lies.
__host__ __device__ constexpr int f2d_col(int c) { return c + 2 * (c >> 5); }
// The staged row pitch in floats: the widest tile's row with its gaps, even.
__host__ __device__ constexpr int f2d_pitch(int up) {
    return (f2d_col(f2d_window(up, up == 1 ? UPFIRDN2D_F2D_DOWN_TOW : UPFIRDN2D_F2D_UP_TOW) - 1) +
            2) & ~1;
}

// Shared memory of the kernel in bytes; ops/upfirdn2d.py
// (`_f2d_smem_bytes`) computes the same.
static inline size_t f2d_smem_bytes(int up, int toh) {
    return sizeof(float) * (size_t)f2d_window(up, toh) * f2d_pitch(up);
}

// Rows a warp and pair spans a lane may hold of the prefetched window: the
// down-2 tile stages at most 138 rows of 70 pairs; in f32 (StyleGAN3-R's
// 36x36 layers) windows of up to 88 rows of 64 pairs are prefetched, larger
// ones staged without. The up-2 tile stages at most 38 rows of 36 pairs.
#define UPFIRDN2D_F2D_DOWN_RW 18
#define UPFIRDN2D_F2D_DOWN_JP 3
#define UPFIRDN2D_F2D_DOWN_F32_RW 11
#define UPFIRDN2D_F2D_DOWN_F32_JP 2
#define UPFIRDN2D_F2D_UP_RW 5
#define UPFIRDN2D_F2D_UP_JP 2

template <int UP, int DOWN, int SY, int SX, typename Tp>
__global__ void __launch_bounds__(UPFIRDN2D_THREADS, 2)
upfirdn2d_kernel_f2d(const Tp* __restrict__ x, Tp* __restrict__ y, const Upfirdn2dF2dParams p) {
    constexpr int NT = UPFIRDN2D_THREADS;
    constexpr int T = UPFIRDN2D_F2D_TAPS;
    constexpr int E = UPFIRDN2D_F2D_PHASE;
    constexpr int IR = 4;                                           // output rows of an item
    constexpr int IC = UP == 1 ? 4 : 8;                             // output columns of an item
    constexpr int WR = UP == 1 ? 2 * IR + T - 2 : IR / 2 + 5 + SY;  // window rows
    constexpr int WC = UP == 1 ? 2 * IC + T - 2 : IC / 2 + 5 + SX;  // window columns
    constexpr int WCL = (WC + 1) & ~1;                              // loaded as float2
    constexpr int SR = UP == 1 ? 2 * IR : IR / 2;                   // window start per item
    constexpr int SC = UP == 1 ? 2 * IC : IC / 2;
    constexpr int PX = f2d_pitch(UP);
    constexpr bool F32 = sizeof(Tp) == 4;
    constexpr int RW = UP == 2 ? UPFIRDN2D_F2D_UP_RW
                               : (F32 ? UPFIRDN2D_F2D_DOWN_F32_RW : UPFIRDN2D_F2D_DOWN_RW);
    constexpr int JP = UP == 2 ? UPFIRDN2D_F2D_UP_JP
                               : (F32 ? UPFIRDN2D_F2D_DOWN_F32_JP : UPFIRDN2D_F2D_DOWN_JP);
    static_assert((UP == 1 && DOWN == 2 && SY == 0 && SX == 0) || (UP == 2 && DOWN == 1),
                  "f2d takes down 2 or up 2");
    extern __shared__ float4 smem4[];
    float* s_x = reinterpret_cast<float*>(smem4);  // [xh][PX]  input tile with halo

    const int toh = p.toh, tow = p.tow;
    const int xh = f2d_window(UP, toh), xw = f2d_window(UP, tow);
    const int tid = threadIdx.x;
    const int ox0 = blockIdx.x * tow, oy0 = blockIdx.y * toh;
    const int ix0 = UP == 1 ? ox0 * 2 - p.ox : ox0 / 2 + p.ox;
    const int iy0 = UP == 1 ? oy0 * 2 - p.oy : oy0 / 2 + p.oy;
    const long long in_plane = (long long)p.in_h * p.in_w;
    const long long out_plane = (long long)p.out_h * p.out_w;
    // Items (IR x IC outputs) that hold outputs of the map, packed densely.
    const int live_w = p.out_w - ox0 < tow ? p.out_w - ox0 : tow;
    const int live_h = p.out_h - oy0 < toh ? p.out_h - oy0 : toh;
    const int nic = (live_w + IC - 1) / IC, nitems = nic * ((live_h + IR - 1) / IR);
    const bool vec4 = UP == 1 && (p.out_w % 4) == 0;
    const bool pairs = (p.out_w % 2) == 0;
    // The prefetched window: xw columns from the even column at or before ix0.
    const int shift = pos_mod(ix0, 2), npairs = (xw + shift + 1) / 2;
    const bool prefetch = p.pairs && xh <= RW * (NT / 32) && npairs <= 32 * JP;
    SepnWindow<RW, JP, Tp> win;
    if (prefetch && blockIdx.z < p.planes)
        win.load(x + blockIdx.z * in_plane, p.in_h, p.in_w, iy0, ix0 - shift, xh, npairs, tid);

    for (long long plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
        __syncthreads();  // the previous plane is done with shared memory

        // Stage the input tile; zeros outside the image. With prefetch the
        // window is in registers: store it, then load the next plane's.
        if (prefetch) {
            win.template store<2>(s_x, PX, xw, shift, xh, npairs, tid);
            __syncthreads();
            if (plane + gridDim.z < p.planes)
                win.load(x + (plane + gridDim.z) * in_plane, p.in_h, p.in_w, iy0, ix0 - shift,
                         xh, npairs, tid);
        } else {
            stage_window<4, 2, 2>(x + plane * in_plane, p.in_h, p.in_w, iy0, ix0, s_x, xh, xw, xw,
                                  PX, 0.f, tid, NT);
            __syncthreads();
        }

        Tp* yp = y + plane * out_plane;
        for (int it = tid; it < nitems; it += NT) {
            const int rb = it / nic, cb = it - rb * nic;
            const float* src = s_x + rb * SR * PX;
            int off[WCL / 2];
#pragma unroll
            for (int k = 0; k < WCL / 2; ++k) off[k] = f2d_col(cb * SC + 2 * k);
            float acc[IR][IC];
#pragma unroll
            for (int j = 0; j < IR; ++j)
#pragma unroll
                for (int c = 0; c < IC; ++c) acc[j][c] = 0.f;
#pragma unroll
            for (int r = 0; r < WR; ++r) {
                float w[WCL];
#pragma unroll
                for (int k = 0; k < WCL / 2; ++k) {
                    const float2 v = *reinterpret_cast<const float2*>(src + r * PX + off[k]);
                    w[2 * k] = v.x;
                    w[2 * k + 1] = v.y;
                }
                if constexpr (UP == 1) {
                    // Output row j meets staged row r at tap row r - 2j.
#pragma unroll
                    for (int j = 0; j < IR; ++j) {
                        const int a = r - 2 * j;
                        if (a >= 0 && a < T) {
#pragma unroll
                            for (int b = 0; b < T; ++b) {
                                const float tap = p.t[a * T + b];
#pragma unroll
                                for (int c = 0; c < IC; ++c)
                                    acc[j][c] = fmaf(tap, w[2 * c + b], acc[j][c]);
                            }
                        }
                    }
                } else {
                    // Quad row q of phase ey meets window row r at table row
                    // r - q, live from the phase's start; so along W.
#pragma unroll
                    for (int q = 0; q < IR / 2; ++q) {
#pragma unroll
                        for (int ey = 0; ey < 2; ++ey) {
                            const int ky = r - q, sy = ey ? SY : 0;
                            if (ky >= sy && ky < sy + T / 2) {
#pragma unroll
                                for (int ex = 0; ex < 2; ++ex) {
                                    const int sx = ex ? SX : 0;
#pragma unroll
                                    for (int kx = sx; kx < sx + T / 2; ++kx) {
                                        const float tap = p.t[((ey * 2 + ex) * E + ky) * E + kx];
#pragma unroll
                                        for (int h = 0; h < IC / 2; ++h)
                                            acc[2 * q + ey][2 * h + ex] =
                                                fmaf(tap, w[h + kx], acc[2 * q + ey][2 * h + ex]);
                                    }
                                }
                            }
                        }
                    }
                }
            }
            const int ox = ox0 + cb * IC;
#pragma unroll
            for (int j = 0; j < IR; ++j) {
                const int oy = oy0 + rb * IR + j;
                if (oy >= p.out_h) break;
                Tp* dst = yp + (long long)oy * p.out_w + ox;
#pragma unroll
                for (int c = 0; c < IC; c += 4) {
                    if (ox + c >= p.out_w) break;
                    if (vec4) {  // out_w % 4 == 0: all 4 inside, aligned
                        store4(dst + c, make_float4(acc[j][c], acc[j][c + 1], acc[j][c + 2],
                                                    acc[j][c + 3]));
                    } else if (pairs) {  // out_w and ox even: a pair is inside or outside
                        store2(dst + c, acc[j][c], acc[j][c + 1]);
                        if (ox + c + 2 < p.out_w) store2(dst + c + 2, acc[j][c + 2], acc[j][c + 3]);
                    } else {
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            if (ox + c + e < p.out_w) store(dst + c + e, acc[j][c + e]);
                    }
                }
            }
        }
    }
}

template <int UP, int DOWN, int SY, int SX>
static cudaError_t launch_f2d(int dtype, const void* x, void* y, const Upfirdn2dF2dParams& p,
                              size_t smem, cudaStream_t s) {
    const dim3 block(UPFIRDN2D_THREADS);
    // A few planes per block, so that loading the next one overlaps
    // filtering this one; gridDim.z is at most 65535, the plane loop covers
    // the rest.
    const long long gz = (p.planes + UPFIRDN2D_SEPN_PLANES_PER_BLOCK - 1) /
                         UPFIRDN2D_SEPN_PLANES_PER_BLOCK;
    const dim3 grid((p.out_w + p.tow - 1) / p.tow, (p.out_h + p.toh - 1) / p.toh,
                    (unsigned)(gz < 65535 ? gz : 65535));
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_kernel(upfirdn2d_kernel_f2d<UP, DOWN, SY, SX, float>, grid, block, smem, s,
                             (const float*)x, (float*)y, p);
    return launch_kernel(upfirdn2d_kernel_f2d<UP, DOWN, SY, SX, __nv_bfloat16>, grid, block, smem,
                         s, (const __nv_bfloat16*)x, (__nv_bfloat16*)y, p);
}

// x: [planes, in_h, in_w]; y: [planes, out_h, out_w]. taps: a host array of
// UPFIRDN2D_F2D_PARAMS floats (see Upfirdn2dF2dParams). (up, down) must be
// (1, 2) or (2, 1), the same on both axes, with a 12x12 filter. shift_x /
// shift_y (up 2 only): 1 where phase 1's live taps start at table entry 1.
extern "C" int upfirdn2d_f2d_launch(const void* x, void* y, int dtype, long long planes,
                                    int in_h, int in_w, int out_h, int out_w, int up, int down,
                                    int ox, int oy, int shift_x, int shift_y, int toh, int tow,
                                    int smem_bytes, const float* taps, void* stream) {
    const bool variant = (up == 1 && down == 2) || (up == 2 && down == 1);
    const int max_h = up == 1 ? UPFIRDN2D_F2D_DOWN_TOH : UPFIRDN2D_F2D_UP_TOH;
    const int max_w = up == 1 ? UPFIRDN2D_F2D_DOWN_TOW : UPFIRDN2D_F2D_UP_TOW;
    const int ic = up == 1 ? 4 : 8;
    if (!variant || (dtype != 0 && dtype != 1) || planes < 0 ||
        in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || taps == nullptr ||
        shift_x < 0 || shift_x > 1 || shift_y < 0 || shift_y > 1 ||
        (up == 1 && (shift_x != 0 || shift_y != 0)) ||
        toh < 4 || toh % 4 != 0 || toh > max_h || tow < ic || tow % ic != 0 || tow > max_w)
        return (int)cudaErrorInvalidValue;
    const size_t need = f2d_smem_bytes(up, toh);
    if ((size_t)smem_bytes != need || need > UPFIRDN2D_MAX_SMEM_BYTES)
        return (int)cudaErrorInvalidValue;
    if (planes == 0) return (int)cudaSuccess;

    Upfirdn2dF2dParams p;
    p.planes = planes;
    p.in_h = in_h; p.in_w = in_w; p.out_h = out_h; p.out_w = out_w;
    p.ox = ox; p.oy = oy; p.toh = toh; p.tow = tow;
    p.pairs = in_w % 2 == 0 && ((uintptr_t)x % (2 * (dtype == 0 ? 4 : 2))) == 0;
    for (int i = 0; i < UPFIRDN2D_F2D_PARAMS; ++i) p.t[i] = taps[i];
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (up == 1) err = launch_f2d<1, 2, 0, 0>(dtype, x, y, p, need, s);
    else if (shift_y == 0 && shift_x == 0) err = launch_f2d<2, 1, 0, 0>(dtype, x, y, p, need, s);
    else if (shift_y == 0) err = launch_f2d<2, 1, 0, 1>(dtype, x, y, p, need, s);
    else if (shift_x == 0) err = launch_f2d<2, 1, 1, 0>(dtype, x, y, p, need, s);
    else err = launch_f2d<2, 1, 1, 1>(dtype, x, y, p, need, s);
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
// blockIdx.z over the planes. MAXT > 0: at most MAXT live taps per axis,
// known at compile time, so both tap loops unroll and every load of a
// window is issued before the first multiply-add (out-of-range taps are
// predicated off). MAXT == 0: the live taps are counted at run time and
// the loops skip rows and columns outside the image.
template <int MAXT, typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 const float* __restrict__ f, const Upfirdn2dParams p) {
    extern __shared__ float4 smem4[];  // the filter: fw (separable) or fw * fh floats
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
        if constexpr (MAXT > 0) {
#pragma unroll
            for (int ky = 0; ky < MAXT; ++ky) {
                const int iy = iy0 + ky;
                const bool row_ok = ky < nty && iy >= 0 && iy < p.in_h;
                const int a = a0 + ky * p.upy;
                float racc = 0.f;
#pragma unroll
                for (int kx = 0; kx < MAXT; ++kx) {
                    const int ix = ix0 + kx;
                    const int b = b0 + kx * p.upx;
                    if (row_ok && kx < ntx && ix >= 0 && ix < p.in_w)
                        racc += (p.separable ? taps[b] : taps[a * p.fw + b])
                                * load_f32(xp + (long long)iy * p.in_w + ix);
                }
                if (row_ok)
                    acc += p.separable ? taps[a] * racc : racc;
            }
        } else {
            // Only the taps whose input lies inside the image.
            const int ky0 = iy0 < 0 ? -iy0 : 0;
            const int ky1 = nty < p.in_h - iy0 ? nty : p.in_h - iy0;
            const int kx0 = ix0 < 0 ? -ix0 : 0;
            const int kx1 = ntx < p.in_w - ix0 ? ntx : p.in_w - ix0;
            for (int ky = ky0; ky < ky1; ++ky) {
                const int a = a0 + ky * p.upy;
                const T* row = xp + (long long)(iy0 + ky) * p.in_w + ix0;
                const float* trow = p.separable ? taps : taps + a * p.fw;
                float racc = 0.f;
                for (int kx = kx0; kx < kx1; ++kx)
                    racc += trow[b0 + kx * p.upx] * load_f32(row + kx);
                acc += p.separable ? taps[a] * racc : racc;
            }
        }
        store(y + plane * out_plane + (long long)oy * p.out_w + ox, acc * p.gain);
    }
}

// The filter's size picks the instantiation: the unrolled one when it has
// at most UPFIRDN2D_MAX_TAPS taps on both axes, else the run-time one, up
// to UPFIRDN2D_MAX_DYN_TAPS.
extern "C" int upfirdn2d_launch(const void* x, void* y, const void* f, int dtype,
                                long long planes, int in_h, int in_w, int out_h, int out_w,
                                int upx, int upy, int downx, int downy, int padx0, int pady0,
                                int fw, int fh, int separable, int flip, float gain,
                                void* stream) {
    if (fw < 1 || fh < 1 || fw > UPFIRDN2D_MAX_DYN_TAPS || fh > UPFIRDN2D_MAX_DYN_TAPS ||
        (separable && fw != fh) ||
        upx < 1 || upy < 1 || downx < 1 || downy < 1 || planes < 0 ||
        in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const bool dynamic = fw > UPFIRDN2D_MAX_TAPS || fh > UPFIRDN2D_MAX_TAPS;
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
    const size_t smem = sizeof(float) * (dynamic ? (size_t)(separable ? fw : fw * fh)
                                                 : UPFIRDN2D_MAX_TAPS * UPFIRDN2D_MAX_TAPS);
    if (dynamic) {
        if (dtype == 0)
            return (int)launch_kernel(upfirdn2d_kernel<0, float>, grid, block, smem, s,
                                      (const float*)x, (float*)y, (const float*)f, p);
        return (int)launch_kernel(upfirdn2d_kernel<0, __nv_bfloat16>, grid, block, smem, s,
                                  (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (const float*)f, p);
    }
    if (dtype == 0)
        return (int)launch_kernel(upfirdn2d_kernel<UPFIRDN2D_MAX_TAPS, float>, grid, block, smem,
                                  s, (const float*)x, (float*)y, (const float*)f, p);
    return (int)launch_kernel(upfirdn2d_kernel<UPFIRDN2D_MAX_TAPS, __nv_bfloat16>, grid, block,
                              smem, s, (const __nv_bfloat16*)x, (__nv_bfloat16*)y,
                              (const float*)f, p);
}
