// Kernel K3: filtered_lrelu, forward, backward and linearised forward, on
// [planes, H, W] images, f32 or bf16 in and out, fp32 arithmetic
// throughout.
//
// Replaces the Pallas kernel `_filtered_lrelu_fused`
// (latentaugment_tpu/ops/filtered_lrelu.py:328-431, `pl.pallas_call` at
// :410) and its custom VJP `_fused_op` (:175-212). The TPU kernel's
// backward was the decomposed form's VJP, traced JAX that differentiates
// again; here the backward is a kernel too, the same one run in its
// second mode, and the backward's derivative is its third mode.
//
// One launch computes, per plane (n, c) and per tile of outputs:
//
//   stage 1  M = FIR_f1(pad_lo(zero_insert(X, up), pad1))    on the mid grid
//   middle   forward:  M = clamp(lrelu(M, slope) * gain)    (+ 2-bit record)
//            backward, linearised forward:
//                      M = M * gain * (negative ? slope : 1), 0 where clamped
//   stage 2  Y = decimate(FIR_f2(pad_lo(M, pad2)), down)   on the output grid
//
// with separable (1-D) filters, each axis in its own pass. Forward: X is
// x + bias, f1 = fu (gain up per axis), pad1 = the user padding's low
// side, stage 2 = fd with no padding, and the mid grid is the up-rate
// canvas. Backward: X is dy, stage 1 = fd flipped with up = down and
// pad1 = taps - 1, stage 2 = fu flipped with down = up and the padding
// transformed (the wrapper computes it as K2's backward does); the middle
// multiplies by the derivative read from the forward's record. The
// backward dx = U^T M D^T dy is linear in dy; its derivative with respect
// to dy, applied to ddx, is D M U ddx: the linearised forward, the
// forward's geometry (X = ddx + the cotangent of the bias gradient) with
// the backward's middle step. Each of the two is the other's adjoint on
// the same record, so derivatives of any order alternate between them.
// Positions of the mid grid outside [0, mid_h) x [0, mid_w) are zeros;
// negative padding crops.
//
// The record: 2 bits per up-rate pixel, bit 0 = "not positive" (slope
// applies), bit 1 = "clamped" (gradient 0), four pixels of a row per
// byte (pixel x in bits 2*(x%4) of byte x/4), row pitch ceil(mid_w/4)
// bytes. It is written only when the wrapper asks (autograd needs it),
// and read by the backward and the linearised forward, any byte by any
// block. Every byte is written by exactly one block: a block owns the mid
// pixels of its own tile_out*down core, the last tile of a row and of a
// column owning through to the canvas edge. No atomics: the kernel is
// deterministic.
//
// What bounds it on the H100: fp32 multiply-adds, not device memory. At
// the walk's L10 layer ([16,256,150,150] bf16, up 4 with 24 taps, down 2
// with 12) the four 1-D passes need 21.2 G multiply-adds (0.63 ms at 67
// TFLOP/s) and the launch moves 0.81 GB (0.24 ms at 3.35 TB/s). The
// contract is fp32 arithmetic with fp32 mid values, so the FIRs stay on
// the FMA pipe (no tensor cores). A multiply-add that takes its tap and
// its operand from shared memory is bound by shared-memory loads, two
// per multiply-add, an order of magnitude above the FMA bound; so the
// tiled kernel's taps are FFMA operands and its operands sit in
// register windows, and what is left between it and the bound is
// instruction issue, the middle step, halos and staging latency.
//
// Three kernels, chosen by the plan in ops/filtered_lrelu.py (the
// launchers refuse a plan that does not fit them):
//
//  * `filtered_lrelu_kernel_tiled<UP, DOWN, MODE, T>` for the alias-free
//    generator's layers: (up, taps1, down, taps2) = (2,12,2,12),
//    (4,24,2,12) (forward and linearised forward) and, in the backward of
//    an up-4 layer, (2,12,4,24); six
//    live taps per phase in stage 1 always. Everything about the filters
//    is known at compile time, so every tap loop unrolls. The taps are
//    kernel parameters (constant memory): with compile-time indices each
//    is an operand of its FFMA, not a load. The polyphase of stage 1 is
//    resolved on the host: the mid tile starts at a multiple of 4, so a
//    mid column's phase is its local index modulo `up`, and the wrapper
//    hands a table of 7 taps per phase (6 live taps, shifted by one
//    where that phase starts one input later; 1/7 of the stage-1
//    multiply-adds are by zero). Each pass is register-blocked:
//      A   input window + bias -> s_x (f32): a warp per row, 4 rows'
//          loads in flight (one at a time leaves the block waiting out
//          the device memory's latency once per element)
//      B   stage 1 along W: a thread makes 8 mid columns of one input row
//          from a window of 8/up + 6 values read as float2; lanes run
//          down the rows (pitches chosen so that they hit 32 banks)
//      C   stage 1 along H + the middle step: a thread makes 8 rows x 4
//          columns, reading float4 columns of s_a down a sliding window
//          (8/up + 6 loads for 224 multiply-adds), packs its own record
//          byte per row (forward) or reads it (backward and linearised
//          forward: one byte per row, asked for before the FIR so that
//          its latency passes under it; the mid tile's 4-aligned origin
//          makes each read a whole byte, whichever tile wrote it), and
//          stores float4 to s_m; a tile inside the canvas
//          skips the bounds tests
//      D   stage 2 along H: 4 output rows x 4 columns from a sliding
//          window of 3*down + taps2 float4 loads
//      E   stage 2 along W: 4 outputs of one row from 3*down + taps2
//          scalar loads; lanes run down the rows of s_b, whose pitch is
//          odd, so a warp's loads hit 32 banks; the tile goes to s_o
//      F   s_o -> device memory with lanes along the columns, 4 (or 2)
//          outputs per store (a store straight from pass E, whose
//          lanes run down the rows, would touch 32 rows per warp)
//    The tile is rectangular and chosen by the plan (`_tiled_tile`) per
//    geometry. Shared memory holds s_x and s_a (s_b over them) and s_m (s_o
//    over it). On the walk's large layers (outputs x mid tile
//    with its alignment slack, bytes, blocks of 256 threads per SM):
//      L8, L9   (2,12,2,12) forward  40x32 x 96x80    57 KB  3 blocks
//      L10      (4,24,2,12) forward  40x48 x 96x112   60 KB  3 blocks
//      L11, L12 (2,12,2,12) forward  40x48 x 96x112   80 KB  2 blocks
//      L13      (2,12,2,12) forward  32x64 x 80x144   86 KB  2 blocks
//      L10      (2,12,4,24) backward 16x32 x 88x152   99 KB  2 blocks
//    (a sweep of 14 tiles per layer on the card found none better than
//    the plan's by more than a tenth; the 24-tap backward pays the most
//    halo, 88x152 mid pixels for 64x128 useful ones, and larger tiles
//    leave one block per SM).
//  * `filtered_lrelu_kernel_pointwise<READ, T>` for up = down = 1 without
//    filters or padding (toRGB): one thread per 4 pixels of a row, no
//    shared memory.
//  * `filtered_lrelu_kernel<T>`, the generic kernel, for every other
//    geometry: run-time sizes, a square tile, one output per thread and
//    pass with the taps in shared memory.
//
// C interface for ctypes; each launcher returns the CUDA error of the
// launch (or cudaErrorInvalidValue for arguments it does not take), and
// the Python wrapper raises on any non-zero code.

#include "common.cuh"

#define FLRELU_MAX_TAPS 64
#define FLRELU_MAX_SMEM_BYTES 232448  // 227 KB, the most a block can take
#define FLRELU_THREADS 256
#define FLRELU_PHASE_TAPS 7  // stage-1 taps per phase in the tiled kernel's tables

// The modes of a launch. FWD writes the record (when asked); BWD and LIN
// read it. BWD runs the transposed geometry and takes no bias; FWD and LIN
// run the forward's.
#define FLRELU_FWD 0
#define FLRELU_BWD 1
#define FLRELU_LIN 2

// The forward's middle step on one value; `bits` gets the record's pair.
__device__ __forceinline__ float middle_forward(float acc, float slope, float gain, float clamp,
                                                unsigned& bits) {
    const bool neg = !(acc > 0.f);
    float v = (neg ? acc * slope : acc) * gain;
    bits = neg ? 1u : 0u;
    if (clamp >= 0.f && fabsf(v) > clamp) {
        v = copysignf(clamp, v);
        bits |= 2u;
    }
    return v;
}

// The backward's (and the linearised forward's) middle step: the
// derivative the record's pair selects.
__device__ __forceinline__ float middle_backward(float acc, float slope, float gain,
                                                 unsigned bits) {
    return (bits & 2u) ? 0.f : acc * gain * ((bits & 1u) ? slope : 1.f);
}

// ----------------------------------------------------------------------------
// The tiled kernel.

struct FlreluTiledParams {
    long long planes;  // N * C
    int channels;      // C: the bias of plane p is bias[p % C]
    int in_h, in_w, mid_h, mid_w, out_h, out_w;
    int pad2x, pad2y;  // stage 2's low padding (0 in the forward)
    int jx, jy;        // input index that tap 0 of the tables meets at mid position 0
    int toh, tow;      // output tile
    int mh, mw;        // mid tile with its alignment slack: mh % 8 == 0, mw % 8 == 0
    int rec_pitch;     // bytes per record row: ceil(mid_w / 4)
    float slope, gain, clamp;  // clamp < 0: none
    float t1x[4 * FLRELU_PHASE_TAPS];  // stage 1 along W: [phase][tap], flip and gain folded in
    float t1y[4 * FLRELU_PHASE_TAPS];  // stage 1 along H
    float t2[24];                      // stage 2, both axes: correlation taps
};

// Pitch of the input window: even (float2 loads), and with an odd number
// of float2 per row so that a half-warp reading one column of 16 rows
// hits 16 different bank pairs.
__host__ __device__ __forceinline__ int tiled_x_pitch(int xw) {
    const int px = (xw + 1) & ~1;
    return (px / 2) % 2 == 0 ? px + 2 : px;
}

// Shared memory of the tiled kernel in bytes; ops/filtered_lrelu.py
// (`_tiled_smem_bytes`) computes the same.
static inline size_t tiled_smem_bytes(int up, int toh, int mh, int mw) {
    const int xh = mh / up + 6, xw = mw / up + 6;
    const int r0 = round_up(xh * tiled_x_pitch(xw), 4) + xh * (mw + 4), r1 = toh * (mw + 1);
    const int region = round_up(r0 > r1 ? r0 : r1, 4);
    return sizeof(float) * ((size_t)region + (size_t)mh * mw);
}

// The middle step on 4 columns of one mid row. MASKED: the tile reaches
// past the canvas, positions outside are 0. Forward: `byte` returns the
// 4 record pairs; backward and linearised forward: `byte` holds them.
template <int MODE, bool MASKED>
__device__ __forceinline__ float4 middle_row4(float4 acc, unsigned& byte, bool row_in, int mxb,
                                              int mid_w, float slope, float gain, float clamp) {
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
    float v[4];
    unsigned out = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool in = !MASKED || (row_in && mxb + i >= 0 && mxb + i < mid_w);
        if (MODE != FLRELU_FWD) {
            const float f = middle_backward(a[i], slope, gain, (byte >> (2 * i)) & 3u);
            v[i] = in ? f : 0.f;
        } else {
            unsigned bits = 0u;
            const float f = middle_forward(a[i], slope, gain, clamp, bits);
            v[i] = in ? f : 0.f;
            out |= (in ? bits : 0u) << (2 * i);
        }
    }
    if (MODE == FLRELU_FWD) byte = out;
    return make_float4(v[0], v[1], v[2], v[3]);
}

template <int UP, int DOWN, int MODE, typename T>
__global__ void __launch_bounds__(FLRELU_THREADS)
filtered_lrelu_kernel_tiled(const T* __restrict__ x, const T* __restrict__ bias,
                            T* __restrict__ y, uint8_t* __restrict__ record,
                            const FlreluTiledParams p) {
    constexpr int NP = FLRELU_PHASE_TAPS;
    constexpr int T2 = 6 * DOWN;
    constexpr int NT = FLRELU_THREADS;
    constexpr bool READ = MODE != FLRELU_FWD;  // the middle step reads the record
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);

    const int toh = p.toh, tow = p.tow, mh = p.mh, mw = p.mw;
    const int xh = mh / UP + 6, xw = mw / UP + 6, px = tiled_x_pitch(xw);
    const int pa = mw + 4;  // pa / 4 odd: 8 rows of one float4 column hit 32 banks
    const int pb = mw + 1;  // odd: 32 rows of one column hit 32 banks
    const int xs = (xh * px + 3) & ~3;
    const int r0 = xs + xh * pa, r1 = toh * pb;
    const int region = ((r0 > r1 ? r0 : r1) + 3) & ~3;
    float* s_x = smem;                // [xh][px]  input window
    float* s_a = smem + xs;           // [xh][pa]  stage 1 along W
    float* s_b = smem;                // [toh][pb] stage 2 along H (reuses s_x, s_a)
    float* s_m = smem + region;       // [mh][mw]  mid tile

    const int tid = threadIdx.x;

    // Tile origins. The mid tile starts at a multiple of 4 at or before
    // the first mid position stage 2 needs, so phases and record bytes
    // line up with local indices.
    const int ox0 = blockIdx.x * tow, oy0 = blockIdx.y * toh;
    const int mx0 = ox0 * DOWN - p.pad2x, my0 = oy0 * DOWN - p.pad2y;
    const int mxa = mx0 & ~3, mya = my0 & ~3;
    const int shx = mx0 - mxa, shy = my0 - mya;
    const int ix0 = mxa / UP + p.jx, iy0 = mya / UP + p.jy;  // exact divisions
    // A tile inside the canvas needs no bounds tests in the middle step.
    const bool interior = mxa >= 0 && mya >= 0 && mxa + mw <= p.mid_w && mya + mh <= p.mid_h;
    // The record pixels this block owns (forward).
    const int own_x0 = ox0 * DOWN, own_y0 = oy0 * DOWN;
    const int own_x1 = (blockIdx.x == gridDim.x - 1) ? p.mid_w : own_x0 + tow * DOWN;
    const int own_y1 = (blockIdx.y == gridDim.y - 1) ? p.mid_h : own_y0 + toh * DOWN;

    const long long in_plane = (long long)p.in_h * p.in_w;
    const long long rec_plane = (long long)p.mid_h * p.rec_pitch;
    const long long out_plane = (long long)p.out_h * p.out_w;
    const int ncg = mw / 4;

    for (long long plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
        __syncthreads();  // the previous plane is done with shared memory

        // Pass A: the input window, bias added inside the image only
        // (the padding is 0).
        {
            const float b = (bias != nullptr) ? load_f32(bias + plane % p.channels) : 0.f;
            stage_window<4, 1>(x + plane * in_plane, p.in_h, p.in_w, iy0, ix0, s_x, xh, xw, xw, px,
                            b, tid, NT);
        }
        __syncthreads();

        // Pass B: stage 1 along W. Local mid column c = UP * q + e meets
        // inputs q .. q + 6 of the window with the taps of phase e. Lanes
        // run down the rows.
        {
            constexpr int NIN = 8 / UP;   // inputs under 8 mid columns
            constexpr int NW = NIN + 6;   // window (even)
            const int nitems = xh * (mw / 8);
            for (int i = tid; i < nitems; i += NT) {
                const int g = i / xh, r = i - g * xh;
                const float* src = s_x + r * px + g * NIN;
                float w[NW];
#pragma unroll
                for (int k = 0; k < NW; k += 2) {
                    const float2 v = *reinterpret_cast<const float2*>(src + k);
                    w[k] = v.x;
                    w[k + 1] = v.y;
                }
                float o[8];
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    float acc = 0.f;
#pragma unroll
                    for (int k = 0; k < NP; ++k)
                        acc = fmaf(p.t1x[(c % UP) * NP + k], w[c / UP + k], acc);
                    o[c] = acc;
                }
                float4* dst = reinterpret_cast<float4*>(s_a + r * pa + g * 8);
                dst[0] = make_float4(o[0], o[1], o[2], o[3]);
                dst[1] = make_float4(o[4], o[5], o[6], o[7]);
            }
        }
        __syncthreads();

        // Pass C: stage 1 along H for 8 mid rows x 4 columns from a
        // sliding window of float4 loads down s_a, then the middle step.
        {
            constexpr int NWC = 8 / UP + 6;
            const int nrg = mh / 8;
            const int dr = NT / ncg, dg = NT - dr * ncg;
            int rg = tid / ncg, cg = tid - rg * ncg;
            uint8_t* rp = record + plane * rec_plane;
            const bool write_record = !READ && record != nullptr;
            while (rg < nrg) {
                const float* src = s_a + (rg * (8 / UP)) * pa + cg * 4;
                const int mxb = mxa + cg * 4;
                // Backward, linearised forward: this item's 8 record bytes,
                // asked for before the FIR so that their latency passes
                // under it.
                unsigned rec[8];
                if (READ) {
                    const int bx = mxb >> 2;  // mxb is a multiple of 4, maybe negative
#pragma unroll
                    for (int rr = 0; rr < 8; ++rr) {
                        const int my = mya + rg * 8 + rr;
                        rec[rr] = (my >= 0 && my < p.mid_h && bx >= 0 && bx < p.rec_pitch)
                            ? (unsigned)rp[(long long)my * p.rec_pitch + bx] : 0u;
                    }
                }
                float4 acc[8];
#pragma unroll
                for (int rr = 0; rr < 8; ++rr) acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int k = 0; k < NWC; ++k) {
                    const float4 v = *reinterpret_cast<const float4*>(src + k * pa);
#pragma unroll
                    for (int rr = 0; rr < 8; ++rr) {
                        const int kk = k - rr / UP;  // tap of phase rr % UP that meets row k
                        if (kk >= 0 && kk < NP) {
                            const float t = p.t1y[(rr % UP) * NP + kk];
                            acc[rr].x = fmaf(t, v.x, acc[rr].x);
                            acc[rr].y = fmaf(t, v.y, acc[rr].y);
                            acc[rr].z = fmaf(t, v.z, acc[rr].z);
                            acc[rr].w = fmaf(t, v.w, acc[rr].w);
                        }
                    }
                }
                const bool col_owned = mxb >= own_x0 && mxb < own_x1;
#pragma unroll
                for (int rr = 0; rr < 8; ++rr) {
                    const int lr = rg * 8 + rr;
                    const int my = mya + lr;
                    unsigned byte = READ ? rec[rr] : 0u;
                    float4 v;
                    if (interior)
                        v = middle_row4<MODE, false>(acc[rr], byte, true, mxb, p.mid_w, p.slope,
                                                    p.gain, p.clamp);
                    else
                        v = middle_row4<MODE, true>(acc[rr], byte, my >= 0 && my < p.mid_h, mxb,
                                                   p.mid_w, p.slope, p.gain, p.clamp);
                    *reinterpret_cast<float4*>(s_m + lr * mw + cg * 4) = v;
                    if (write_record && col_owned && my >= own_y0 && my < own_y1)
                        rp[(long long)my * p.rec_pitch + (mxb >> 2)] = (uint8_t)byte;
                }
                cg += dg;
                rg += dr;
                if (cg >= ncg) { cg -= ncg; ++rg; }
            }
        }
        __syncthreads();

        // Pass D: stage 2 along H, 4 output rows x 4 columns per thread
        // from a sliding window of float4 loads down s_m.
        {
            constexpr int NWD = 3 * DOWN + T2;
            const int nrog = toh / 4;
            const int dr = NT / ncg, dg = NT - dr * ncg;
            int rog = tid / ncg, cg = tid - rog * ncg;
            while (rog < nrog) {
                const float* src = s_m + (shy + rog * 4 * DOWN) * mw + cg * 4;
                float4 acc[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int k = 0; k < NWD; ++k) {
                    const float4 v = *reinterpret_cast<const float4*>(src + k * mw);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int a = k - j * DOWN;
                        if (a >= 0 && a < T2) {
                            const float t = p.t2[a];
                            acc[j].x = fmaf(t, v.x, acc[j].x);
                            acc[j].y = fmaf(t, v.y, acc[j].y);
                            acc[j].z = fmaf(t, v.z, acc[j].z);
                            acc[j].w = fmaf(t, v.w, acc[j].w);
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float* dst = s_b + (rog * 4 + j) * pb + cg * 4;
                    dst[0] = acc[j].x;
                    dst[1] = acc[j].y;
                    dst[2] = acc[j].z;
                    dst[3] = acc[j].w;
                }
                cg += dg;
                rog += dr;
                if (cg >= ncg) { cg -= ncg; ++rog; }
            }
        }
        __syncthreads();

        // Pass E: stage 2 along W, 4 outputs of one row per thread; lanes
        // run down the rows (odd pitches: 32 banks). The output tile goes
        // to shared memory (over the mid tile, which pass D is done with).
        const int po = tow + 1;
        float* s_o = s_m;  // [toh][po]
        {
            constexpr int NWE = 3 * DOWN + T2;
            const int nitems = toh * (tow / 4);
            for (int i = tid; i < nitems; i += NT) {
                const int cog = i / toh, ro = i - cog * toh;
                const float* src = s_b + ro * pb + shx + cog * 4 * DOWN;
                float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int k = 0; k < NWE; ++k) {
                    const float w = src[k];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int a = k - j * DOWN;
                        if (a >= 0 && a < T2) acc[j] = fmaf(p.t2[a], w, acc[j]);
                    }
                }
                float* dst = s_o + ro * po + cog * 4;
#pragma unroll
                for (int j = 0; j < 4; ++j) dst[j] = acc[j];
            }
        }
        __syncthreads();

        // Pass F: the output tile to device memory, lanes along the rows'
        // columns: 4 outputs per store where the rows are aligned to 4
        // elements, else 2 where to 2, else 1.
        {
            T* yp = y + plane * out_plane;
            const int nc = tow / 4;
            const int dr = NT / nc, dc = NT - dr * nc;
            int ro = tid / nc, c4 = tid - ro * nc;
            while (ro < toh) {
                const int oy = oy0 + ro, ox = ox0 + c4 * 4;
                if (oy < p.out_h && ox < p.out_w) {
                    const float* src = s_o + ro * po + c4 * 4;
                    T* dst = yp + (long long)oy * p.out_w + ox;
                    if (p.out_w % 4 == 0) {
                        store4(dst, make_float4(src[0], src[1], src[2], src[3]));
                    } else if (p.out_w % 2 == 0) {
                        store2(dst, src[0], src[1]);
                        if (ox + 2 < p.out_w) store2(dst + 2, src[2], src[3]);
                    } else {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (ox + j < p.out_w) store(dst + j, src[j]);
                    }
                }
                c4 += dc;
                ro += dr;
                if (c4 >= nc) { c4 -= nc; ++ro; }
            }
        }
    }
}

template <int UP, int DOWN, int MODE>
static cudaError_t launch_tiled(int dtype, const void* x, const void* bias, void* y,
                                void* record, const FlreluTiledParams& p, size_t smem,
                                cudaStream_t s) {
    const dim3 block(FLRELU_THREADS);
    // gridDim.z is at most 65535; the plane loop covers the rest.
    const dim3 grid((p.out_w + p.tow - 1) / p.tow, (p.out_h + p.toh - 1) / p.toh,
                    (unsigned)(p.planes < 65535 ? p.planes : 65535));
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_kernel(filtered_lrelu_kernel_tiled<UP, DOWN, MODE, float>, grid, block, smem,
                             s, (const float*)x, (const float*)bias, (float*)y,
                             (uint8_t*)record, p);
    return launch_kernel(filtered_lrelu_kernel_tiled<UP, DOWN, MODE, __nv_bfloat16>, grid, block,
                         smem, s, (const __nv_bfloat16*)x, (const __nv_bfloat16*)bias,
                         (__nv_bfloat16*)y, (uint8_t*)record, p);
}

// x: [planes, in_h, in_w]; y: [planes, out_h, out_w]; record: [planes,
// mid_h, rec_pitch] bytes (mode FLRELU_FWD: written when not null;
// FLRELU_BWD, FLRELU_LIN: read, required). bias: [channels] or null (not
// in FLRELU_BWD). t1x, t1y: host arrays of up * 7 taps, t2: host array of
// 6 * down taps (see FlreluTiledParams). (up, down, mode) must be one of
// the compiled variants and the tile must fit them.
extern "C" int filtered_lrelu_tiled_launch(
        const void* x, const void* bias, void* y, void* record, int dtype,
        long long planes, int channels,
        int in_h, int in_w, int mid_h, int mid_w, int out_h, int out_w,
        int up, int down, int mode, int pad2x, int pad2y, int jx, int jy,
        int toh, int tow, int mh, int mw, int smem_bytes,
        const float* t1x, const float* t1y, const float* t2,
        float slope, float gain, float clamp, void* stream) {
    const bool bwd = mode == FLRELU_BWD;
    const bool variant = (up == 2 && down == 2) || (up == 4 && down == 2 && !bwd) ||
                         (up == 2 && down == 4 && bwd);
    if (!variant || mode < FLRELU_FWD || mode > FLRELU_LIN || (dtype != 0 && dtype != 1) ||
        planes < 0 || channels < 1 ||
        in_h <= 0 || in_w <= 0 || mid_h <= 0 || mid_w <= 0 || out_h <= 0 || out_w <= 0 ||
        t1x == nullptr || t1y == nullptr || t2 == nullptr ||
        (mode != FLRELU_FWD && record == nullptr) || (bwd && bias != nullptr) ||
        (!bwd && (pad2x != 0 || pad2y != 0 || (tow * down) % 4 != 0)) ||
        toh < 4 || toh % 4 != 0 || tow < 4 || tow % 4 != 0 || mh % 8 != 0 || mw % 8 != 0 ||
        mh < (toh - 1) * down + 6 * down + 3 || mw < (tow - 1) * down + 6 * down + 3)
        return (int)cudaErrorInvalidValue;
    const size_t need = tiled_smem_bytes(up, toh, mh, mw);
    if ((size_t)smem_bytes != need || need > FLRELU_MAX_SMEM_BYTES)
        return (int)cudaErrorInvalidValue;
    if (planes == 0) return (int)cudaSuccess;

    FlreluTiledParams p;
    p.planes = planes; p.channels = channels;
    p.in_h = in_h; p.in_w = in_w; p.mid_h = mid_h; p.mid_w = mid_w;
    p.out_h = out_h; p.out_w = out_w;
    p.pad2x = pad2x; p.pad2y = pad2y; p.jx = jx; p.jy = jy;
    p.toh = toh; p.tow = tow; p.mh = mh; p.mw = mw;
    p.rec_pitch = (mid_w + 3) / 4;
    p.slope = slope; p.gain = gain; p.clamp = clamp;
    for (int i = 0; i < 4 * FLRELU_PHASE_TAPS; ++i) {
        p.t1x[i] = i < up * FLRELU_PHASE_TAPS ? t1x[i] : 0.f;
        p.t1y[i] = i < up * FLRELU_PHASE_TAPS ? t1y[i] : 0.f;
    }
    for (int i = 0; i < 24; ++i) p.t2[i] = i < 6 * down ? t2[i] : 0.f;

    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (up == 2 && down == 2)
        err = mode == FLRELU_FWD
            ? launch_tiled<2, 2, FLRELU_FWD>(dtype, x, bias, y, record, p, need, s)
            : mode == FLRELU_BWD
            ? launch_tiled<2, 2, FLRELU_BWD>(dtype, x, bias, y, record, p, need, s)
            : launch_tiled<2, 2, FLRELU_LIN>(dtype, x, bias, y, record, p, need, s);
    else if (up == 4)
        err = mode == FLRELU_FWD
            ? launch_tiled<4, 2, FLRELU_FWD>(dtype, x, bias, y, record, p, need, s)
            : launch_tiled<4, 2, FLRELU_LIN>(dtype, x, bias, y, record, p, need, s);
    else
        err = launch_tiled<2, 4, FLRELU_BWD>(dtype, x, bias, y, record, p, need, s);
    return (int)err;
}

// ----------------------------------------------------------------------------
// The pointwise kernel: up = down = 1, no filters, no padding.

template <bool READ, typename T>
__global__ void __launch_bounds__(FLRELU_THREADS)
filtered_lrelu_kernel_pointwise(const T* __restrict__ x, const T* __restrict__ bias,
                                T* __restrict__ y, uint8_t* __restrict__ record,
                                long long rows, int channels, int h, int w, int rec_pitch,
                                float slope, float gain, float clamp) {
    // One thread per record byte: 4 pixels of one row. READ: the backward
    // and the linearised forward, one computation here (no filters; only
    // the latter adds a bias).
    const long long total = rows * rec_pitch;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const long long row = i / rec_pitch;  // plane * h + y
        const int bx = (int)(i - row * rec_pitch);
        const float b = (bias != nullptr) ? load_f32(bias + (row / h) % channels) : 0.f;
        const T* src = x + row * w + bx * 4;
        T* dst = y + row * w + bx * 4;
        unsigned byte = READ ? (unsigned)record[i] : 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (bx * 4 + k < w) {
                const float a = load_f32(src + k) + b;
                if (READ) {
                    store(dst + k, middle_backward(a, slope, gain, (byte >> (2 * k)) & 3u));
                } else {
                    unsigned bits = 0u;
                    store(dst + k, middle_forward(a, slope, gain, clamp, bits));
                    byte |= bits << (2 * k);
                }
            }
        }
        if (!READ && record != nullptr) record[i] = (uint8_t)byte;
    }
}

// x, y: [planes, h, w]; record: [planes, h, ceil(w/4)] bytes (read, and
// required, in modes FLRELU_BWD and FLRELU_LIN); bias: not in FLRELU_BWD.
extern "C" int filtered_lrelu_pointwise_launch(
        const void* x, const void* bias, void* y, void* record, int dtype,
        long long planes, int channels, int h, int w, int mode,
        float slope, float gain, float clamp, void* stream) {
    if ((dtype != 0 && dtype != 1) || planes < 0 || channels < 1 || h <= 0 || w <= 0 ||
        mode < FLRELU_FWD || mode > FLRELU_LIN ||
        (mode != FLRELU_FWD && record == nullptr) || (mode == FLRELU_BWD && bias != nullptr))
        return (int)cudaErrorInvalidValue;
    const bool read = mode != FLRELU_FWD;
    if (planes == 0) return (int)cudaSuccess;
    const int rec_pitch = (w + 3) / 4;
    const long long rows = planes * h;
    const long long total = rows * rec_pitch;
    const long long want = (total + FLRELU_THREADS - 1) / FLRELU_THREADS;
    const dim3 grid((unsigned)(want < 132 * 32 ? want : 132 * 32)), block(FLRELU_THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (dtype == 0) {
        const float* xs = (const float*)x; const float* bs = (const float*)bias;
        err = read
            ? launch_kernel(filtered_lrelu_kernel_pointwise<true, float>, grid, block, 0, s, xs,
                            bs, (float*)y, (uint8_t*)record, rows, channels, h, w, rec_pitch,
                            slope, gain, clamp)
            : launch_kernel(filtered_lrelu_kernel_pointwise<false, float>, grid, block, 0, s, xs,
                            bs, (float*)y, (uint8_t*)record, rows, channels, h, w, rec_pitch,
                            slope, gain, clamp);
    } else {
        const __nv_bfloat16* xs = (const __nv_bfloat16*)x;
        const __nv_bfloat16* bs = (const __nv_bfloat16*)bias;
        err = read
            ? launch_kernel(filtered_lrelu_kernel_pointwise<true, __nv_bfloat16>, grid, block, 0,
                            s, xs, bs, (__nv_bfloat16*)y, (uint8_t*)record, rows, channels, h, w,
                            rec_pitch, slope, gain, clamp)
            : launch_kernel(filtered_lrelu_kernel_pointwise<false, __nv_bfloat16>, grid, block, 0,
                            s, xs, bs, (__nv_bfloat16*)y, (uint8_t*)record, rows, channels, h, w,
                            rec_pitch, slope, gain, clamp);
    }
    return (int)err;
}

// ----------------------------------------------------------------------------
// The generic kernel: any up, down and tap counts up to FLRELU_MAX_TAPS.
//
// A block of 32x8 threads owns one plane and one TO x TO output tile and
// loops over planes in z. It loads the input window (with bias) into
// shared memory in f32, runs stage 1 along W then H into the mid tile
// (polyphase: only the taps that meet a non-zero input), applies the
// middle step, then stage 2 along W and H, one output per thread and
// pass, and writes only the output tile. Shared memory, in floats: taps
// 2*64, input XT*XT and W-pass XT*MT (the stage-2 W pass reuses them),
// mid tile MT*MT, then MT*MT bytes of record pairs, with
// MT = (TO-1)*down + taps2 and XT = (MT + taps1 - 2 + up) / up. The
// forward packs the record from the pairs of the pixels the block owns;
// the backward and the linearised forward read each pixel's pair from
// the packed record.

struct FlreluParams {
    long long planes;  // N * C
    int channels;      // C: the bias of plane p is bias[p % C]
    int in_h, in_w, mid_h, mid_w, out_h, out_w;
    int up, pad1x, pad1y, t1, flip1;
    int down, pad2x, pad2y, t2, flip2;
    float gain1, gain2;       // per-axis tap scale of each stage
    int mode;                 // FLRELU_FWD: activation; BWD, LIN: derivative from the record
    float slope, gain, clamp; // clamp < 0: none
    int tile, xt, mt;         // output tile edge, input and mid tile edges
    int rec_pitch;            // bytes per record row: ceil(mid_w / 4)
};

static inline int tile_region(int xt, int mt, int to) {
    const int a = xt * xt + xt * mt, b = mt * to;
    return a > b ? a : b;
}

// Shared memory of the generic kernel in bytes; ops/filtered_lrelu.py
// (`_generic_smem_bytes`) computes the same.
static inline size_t generic_smem_bytes(int up, int t1, int down, int t2, int to) {
    const int mt = (to - 1) * down + t2;
    const int xt = (mt + t1 - 2 + up) / up;
    return sizeof(float) * (2 * FLRELU_MAX_TAPS + (size_t)tile_region(xt, mt, to)
                            + (size_t)mt * mt) + (size_t)mt * mt;
}

template <typename T>
__global__ void filtered_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                                      const float* __restrict__ f1, const float* __restrict__ f2,
                                      T* __restrict__ y, uint8_t* __restrict__ record,
                                      const FlreluParams p) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int TO = p.tile, MT = p.mt, XT = p.xt;
    const int r01 = (XT * XT + XT * MT) > (MT * TO) ? (XT * XT + XT * MT) : (MT * TO);
    float* s_f1 = smem;
    float* s_f2 = smem + FLRELU_MAX_TAPS;
    float* s_x = s_f2 + FLRELU_MAX_TAPS;  // [XT][XT]  input window
    float* s_a = s_x + XT * XT;           // [XT][MT]  stage 1 along W
    float* s_b = s_x;                     // [MT][TO]  stage 2 along W (reuses s_x, s_a)
    float* s_m = s_x + r01;               // [MT][MT]  mid tile
    uint8_t* s_bits = reinterpret_cast<uint8_t*>(s_m + MT * MT);  // [MT][MT] record pairs

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int bx = blockDim.x, by = blockDim.y;
    const int tid = ty * bx + tx;
    // Correlation taps: the op convolves (flip 0), so reverse on load.
    for (int i = tid; i < p.t1; i += bx * by)
        s_f1[i] = (f1 ? f1[p.flip1 ? i : p.t1 - 1 - i] : 1.f) * p.gain1;
    for (int i = tid; i < p.t2; i += bx * by)
        s_f2[i] = (f2 ? f2[p.flip2 ? i : p.t2 - 1 - i] : 1.f) * p.gain2;

    // Tile origins: output, mid grid (stage 2's window), input (stage 1's).
    const int ox0 = blockIdx.x * TO, oy0 = blockIdx.y * TO;
    const int mx0 = ox0 * p.down - p.pad2x, my0 = oy0 * p.down - p.pad2y;
    const int ix0 = floor_div(mx0 - p.pad1x + p.up - 1, p.up);
    const int iy0 = floor_div(my0 - p.pad1y + p.up - 1, p.up);
    // The record pixels this block owns (forward: mx0, my0 are its core's
    // origin, a multiple of 4 along W).
    const int own_w = ((blockIdx.x == gridDim.x - 1) ? p.mid_w - mx0 : TO * p.down);
    const int own_h = ((blockIdx.y == gridDim.y - 1) ? p.mid_h - my0 : TO * p.down);
    const long long in_plane = (long long)p.in_h * p.in_w;
    const long long rec_plane = (long long)p.mid_h * p.rec_pitch;
    const long long out_plane = (long long)p.out_h * p.out_w;

    for (long long plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
        __syncthreads();  // taps loaded; the previous plane is done with smem
        const T* xp = x + plane * in_plane;
        const float b = (bias != nullptr) ? load_f32(bias + plane % p.channels) : 0.f;

        // Input window, bias added inside the image only (the padding is 0).
        for (int r = ty; r < XT; r += by) {
            const int iy = iy0 + r;
            for (int c = tx; c < XT; c += bx) {
                const int ix = ix0 + c;
                float v = 0.f;
                if (iy >= 0 && iy < p.in_h && ix >= 0 && ix < p.in_w)
                    v = load_f32(xp + (long long)iy * p.in_w + ix) + b;
                s_x[r * XT + c] = v;
            }
        }
        __syncthreads();

        // Stage 1 along W: mid column m reads zero-inserted input column
        // m + a - pad1x for tap a; only taps a0, a0 + up, ... meet an input
        // column (the others meet inserted zeros).
        for (int c = tx; c < MT; c += bx) {
            const int m = mx0 + c;
            const int a0 = pos_mod(p.pad1x - m, p.up);
            const int li0 = (m + a0 - p.pad1x) / p.up - ix0;  // exact division
            for (int r = ty; r < XT; r += by) {
                const float* row = s_x + r * XT + li0;
                float acc = 0.f;
                for (int a = a0, k = 0; a < p.t1; a += p.up, ++k)
                    acc += s_f1[a] * row[k];
                s_a[r * MT + c] = acc;
            }
        }
        __syncthreads();

        // Stage 1 along H, then the middle step, on the mid tile.
        for (int r = ty; r < MT; r += by) {
            const int my = my0 + r;
            const bool row_in = my >= 0 && my < p.mid_h;
            const int a0 = pos_mod(p.pad1y - my, p.up);
            const int li0 = (my + a0 - p.pad1y) / p.up - iy0;
            for (int c = tx; c < MT; c += bx) {
                const int mx = mx0 + c;
                float v = 0.f;
                unsigned bits = 0u;
                if (row_in && mx >= 0 && mx < p.mid_w) {
                    float acc = 0.f;
                    for (int a = a0, k = li0; a < p.t1; a += p.up, ++k)
                        acc += s_f1[a] * s_a[k * MT + c];
                    if (p.mode == FLRELU_FWD) {
                        v = middle_forward(acc, p.slope, p.gain, p.clamp, bits);
                    } else {
                        const uint8_t byte = record[plane * rec_plane
                                                    + (long long)my * p.rec_pitch + (mx >> 2)];
                        v = middle_backward(acc, p.slope, p.gain, (byte >> (2 * (mx & 3))) & 3u);
                    }
                }
                s_m[r * MT + c] = v;
                s_bits[r * MT + c] = (uint8_t)bits;
            }
        }
        __syncthreads();

        // Forward: pack the pairs of the owned pixels, 4 per byte.
        if (p.mode == FLRELU_FWD && record != nullptr) {
            uint8_t* rp = record + plane * rec_plane;
            const int nb = (own_w + 3) / 4;
            for (int r = ty; r < own_h; r += by) {
                for (int c = tx; c < nb; c += bx) {
                    unsigned byte = 0u;
                    // Canvas columns and rows past the tile feed no output: 0.
                    for (int k = 0; k < 4; ++k)
                        if (c * 4 + k < own_w && c * 4 + k < MT && r < MT)
                            byte |= (unsigned)s_bits[r * MT + c * 4 + k] << (2 * k);
                    rp[(long long)(my0 + r) * p.rec_pitch + (mx0 >> 2) + c] = (uint8_t)byte;
                }
            }
        }

        // Stage 2 along W: output column c reads mid columns c*down + a.
        for (int r = ty; r < MT; r += by) {
            const float* row = s_m + r * MT;
            for (int c = tx; c < TO; c += bx) {
                float acc = 0.f;
                for (int a = 0; a < p.t2; ++a)
                    acc += s_f2[a] * row[c * p.down + a];
                s_b[r * TO + c] = acc;
            }
        }
        __syncthreads();

        // Stage 2 along H, written to the output tile.
        T* yp = y + plane * out_plane;
        for (int r = ty; r < TO; r += by) {
            const int oy = oy0 + r;
            if (oy >= p.out_h) break;
            for (int c = tx; c < TO; c += bx) {
                const int ox = ox0 + c;
                if (ox >= p.out_w) break;
                float acc = 0.f;
                for (int a = 0; a < p.t2; ++a)
                    acc += s_f2[a] * s_b[(r * p.down + a) * TO + c];
                store(yp + (long long)oy * p.out_w + ox, acc);
            }
        }
    }
}

// x: [planes, in_h, in_w]; y: [planes, out_h, out_w]; record: [planes,
// mid_h, ceil(mid_w/4)] bytes (mode FLRELU_FWD: written when not null;
// FLRELU_BWD, FLRELU_LIN: read, required). bias: [channels] or null (not
// in FLRELU_BWD). f1, f2:
// float32 device taps or null for the identity filter [1]. `tile` is the
// plan's square output tile (a multiple of 4 / down columns in the
// forward, so that a block's record bytes are its own).
extern "C" int filtered_lrelu_launch(
        const void* x, const void* bias, const float* f1, const float* f2, void* y,
        void* record, int dtype, long long planes, int channels,
        int in_h, int in_w, int mid_h, int mid_w, int out_h, int out_w,
        int up, int pad1x, int pad1y, int t1, int flip1, float gain1,
        int down, int pad2x, int pad2y, int t2, int flip2, float gain2,
        int mode, float slope, float gain, float clamp,
        int tile, int smem_bytes, void* stream) {
    const bool bwd = mode == FLRELU_BWD;
    if ((dtype != 0 && dtype != 1) || planes < 0 || channels < 1 ||
        in_h <= 0 || in_w <= 0 || mid_h <= 0 || mid_w <= 0 || out_h <= 0 || out_w <= 0 ||
        up < 1 || down < 1 || t1 < 1 || t2 < 1 ||
        t1 > FLRELU_MAX_TAPS || t2 > FLRELU_MAX_TAPS ||
        (f1 == nullptr && t1 != 1) || (f2 == nullptr && t2 != 1) ||
        mode < FLRELU_FWD || mode > FLRELU_LIN ||
        (mode != FLRELU_FWD && record == nullptr) || (bwd && bias != nullptr) ||
        (!bwd && (pad2x != 0 || pad2y != 0 || (tile * down) % 4 != 0)) || tile < 1)
        return (int)cudaErrorInvalidValue;
    const size_t need = generic_smem_bytes(up, t1, down, t2, tile);
    if ((size_t)smem_bytes != need || need > FLRELU_MAX_SMEM_BYTES)
        return (int)cudaErrorInvalidValue;
    if (planes == 0) return (int)cudaSuccess;

    FlreluParams p;
    p.planes = planes; p.channels = channels;
    p.in_h = in_h; p.in_w = in_w; p.mid_h = mid_h; p.mid_w = mid_w;
    p.out_h = out_h; p.out_w = out_w;
    p.up = up; p.pad1x = pad1x; p.pad1y = pad1y; p.t1 = t1; p.flip1 = flip1;
    p.down = down; p.pad2x = pad2x; p.pad2y = pad2y; p.t2 = t2; p.flip2 = flip2;
    p.gain1 = gain1; p.gain2 = gain2;
    p.mode = mode; p.slope = slope; p.gain = gain; p.clamp = clamp;
    p.tile = tile; p.mt = (tile - 1) * down + t2; p.xt = (p.mt + t1 - 2 + up) / up;
    p.rec_pitch = (mid_w + 3) / 4;

    const dim3 block(32, 8);
    // gridDim.z is at most 65535; the plane loop covers the rest.
    const dim3 grid((out_w + tile - 1) / tile, (out_h + tile - 1) / tile,
                    (unsigned)(planes < 65535 ? planes : 65535));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return (int)launch_kernel(filtered_lrelu_kernel<float>, grid, block, need, s,
                                  (const float*)x, (const float*)bias, f1, f2, (float*)y,
                                  (uint8_t*)record, p);
    return (int)launch_kernel(filtered_lrelu_kernel<__nv_bfloat16>, grid, block, need, s,
                              (const __nv_bfloat16*)x, (const __nv_bfloat16*)bias, f1, f2,
                              (__nv_bfloat16*)y, (uint8_t*)record, p);
}
