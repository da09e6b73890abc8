// Kernel K3: filtered_lrelu, forward and backward, on [planes, H, W]
// images, f32 or bf16 in and out, fp32 arithmetic throughout.
//
// Replaces the Pallas kernel `_filtered_lrelu_fused`
// (latentaugment_tpu/ops/filtered_lrelu.py:328-431, `pl.pallas_call` at
// :410) and its custom VJP `_fused_op` (:175-212). The TPU kernel's
// backward was the decomposed form's VJP; here the backward is a kernel
// too, the same one run in its second mode.
//
// One launch computes, per plane (n, c) and per square tile of outputs:
//
//   stage 1  M = FIR_f1(pad_lo(zero_insert(X, up), pad1))    on the mid grid
//   middle   forward:  M = clamp(lrelu(M, slope) * gain)    (+ 1-byte record)
//            backward: M = M * gain * (negative ? slope : 1), 0 where clamped
//   stage 2  Y = decimate(FIR_f2(pad_lo(M, pad2)), down)   on the output grid
//
// with separable (1-D) filters, each axis in its own pass. Forward: X is
// x + bias, f1 = fu (gain up per axis), pad1 = the user padding's low
// side, stage 2 = fd with no padding, and the mid grid is the up-rate
// canvas. Backward: X is dy, stage 1 = fd flipped with up = down and
// pad1 = taps - 1, stage 2 = fu flipped with down = up and the padding
// transformed (the wrapper computes it as K2's backward does); the middle
// multiplies by the derivative read from the forward's record: bit 0 =
// "not positive" (slope applies), bit 1 = "clamped" (gradient 0). The
// record is written only when the wrapper asks (autograd needs it), one
// byte per up-rate pixel; NVIDIA's filtered_lrelu.cu packs 2 bits, which
// is left for a later change.
//
// Positions of the mid grid outside [0, mid_h) x [0, mid_w) are zeros
// (the high-side padding of stage 1 and both sides of stage 2 are
// implicit in the grid sizes); negative padding crops.
//
// What bounds it on the H100: arithmetic on shared memory, not device
// memory. At the walk's L10 layer ([16,256,150,150] bf16, up 4 with 24
// taps, down 2 with 12) it reads 184 MB and writes 624 MB, ~0.25 ms at
// 3.35 TB/s, but does ~90 multiply-adds per output (~28 G in all), each
// reading one shared-memory operand. The decomposed form writes and reads
// its 562x562 up-rate canvas several times (2.6 GB each at bf16), and
// autograd keeps several of them per layer; this kernel keeps none: the
// canvas lives only in shared memory, and the backward needs 1 byte per
// up-rate pixel (1.3 GB at L10) instead.
//
// The simple design: a block of 32x8 threads owns one plane and one
// TO x TO output tile (TO = 32 where the shared memory allows, else 16,
// 8, ...; the launcher picks it), and loops over planes in z. It loads the
// input window (with bias) into shared memory in f32, runs stage 1 along
// W then H into the mid tile (polyphase: only the taps that meet a
// non-zero input, as K2), applies the middle step, then stage 2 along W
// and H, and writes only the output tile. Shared memory, in floats:
// taps 2*64, input XT*XT and W-pass XT*MT (the stage-2 W pass reuses
// them), mid tile MT*MT, with MT = (TO-1)*down + taps2 and
// XT = (MT + taps1 - 2 + up) / up. For the forward at the walk's layers
// that is 32-42 KB at TO = 32.
//
// C interface for ctypes; the launcher returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments it does not take),
// and the Python wrapper raises on any non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FLRELU_MAX_TAPS 64
#define FLRELU_MAX_SMEM_BYTES (64 * 1024)  // tile choice; 227 KB is the hard limit

struct FlreluParams {
    long long planes;  // N * C
    int channels;      // C: the bias of plane p is bias[p % C]
    int in_h, in_w, mid_h, mid_w, out_h, out_w;
    int up, pad1x, pad1y, t1, flip1;
    int down, pad2x, pad2y, t2, flip2;
    float gain1, gain2;       // per-axis tap scale of each stage
    int backward;             // 0: activation (forward), 1: derivative from the record
    float slope, gain, clamp; // clamp < 0: none
    int tile, xt, mt;         // output tile edge, input and mid tile edges
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Floor division and non-negative remainder for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int pos_mod(int a, int b) {
    const int r = a % b;
    return r < 0 ? r + b : r;
}

static inline int tile_region(int xt, int mt, int to) {
    const int a = xt * xt + xt * mt, b = mt * to;
    return a > b ? a : b;
}

template <typename T>
__global__ void filtered_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                                      const float* __restrict__ f1, const float* __restrict__ f2,
                                      T* __restrict__ y, uint8_t* __restrict__ record,
                                      FlreluParams p) {
    extern __shared__ float smem[];
    const int TO = p.tile, MT = p.mt, XT = p.xt;
    const int r01 = (XT * XT + XT * MT) > (MT * TO) ? (XT * XT + XT * MT) : (MT * TO);
    float* s_f1 = smem;
    float* s_f2 = smem + FLRELU_MAX_TAPS;
    float* s_x = s_f2 + FLRELU_MAX_TAPS;  // [XT][XT]  input window
    float* s_a = s_x + XT * XT;           // [XT][MT]  stage 1 along W
    float* s_b = s_x;                     // [MT][TO]  stage 2 along W (reuses s_x, s_a)
    float* s_m = s_x + r01;               // [MT][MT]  mid tile

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
    const long long in_plane = (long long)p.in_h * p.in_w;
    const long long mid_plane = (long long)p.mid_h * p.mid_w;
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
                if (row_in && mx >= 0 && mx < p.mid_w) {
                    float acc = 0.f;
                    for (int a = a0, k = li0; a < p.t1; a += p.up, ++k)
                        acc += s_f1[a] * s_a[k * MT + c];
                    const long long ri = plane * mid_plane + (long long)my * p.mid_w + mx;
                    if (!p.backward) {
                        const bool neg = !(acc > 0.f);
                        v = (neg ? acc * p.slope : acc) * p.gain;
                        bool clamped = false;
                        if (p.clamp >= 0.f && fabsf(v) > p.clamp) {
                            v = copysignf(p.clamp, v);
                            clamped = true;
                        }
                        if (record != nullptr)
                            record[ri] = (uint8_t)((neg ? 1 : 0) | (clamped ? 2 : 0));
                    } else {
                        const uint8_t bits = record[ri];
                        v = (bits & 2) ? 0.f : acc * p.gain * ((bits & 1) ? p.slope : 1.f);
                    }
                }
                s_m[r * MT + c] = v;
            }
        }
        __syncthreads();

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
// mid_h, mid_w] bytes (forward: written when not null; backward: read,
// required). bias: [channels] or null (forward only). f1, f2: float32
// taps or null for the identity filter [1].
extern "C" int filtered_lrelu_launch(
        const void* x, const void* bias, const float* f1, const float* f2, void* y,
        void* record, int dtype, long long planes, int channels,
        int in_h, int in_w, int mid_h, int mid_w, int out_h, int out_w,
        int up, int pad1x, int pad1y, int t1, int flip1, float gain1,
        int down, int pad2x, int pad2y, int t2, int flip2, float gain2,
        int backward, float slope, float gain, float clamp, void* stream) {
    if ((dtype != 0 && dtype != 1) || planes < 0 || channels < 1 ||
        in_h <= 0 || in_w <= 0 || mid_h <= 0 || mid_w <= 0 || out_h <= 0 || out_w <= 0 ||
        up < 1 || down < 1 || t1 < 1 || t2 < 1 ||
        t1 > FLRELU_MAX_TAPS || t2 > FLRELU_MAX_TAPS ||
        (f1 == nullptr && t1 != 1) || (f2 == nullptr && t2 != 1) ||
        (backward && (record == nullptr || bias != nullptr)))
        return (int)cudaErrorInvalidValue;
    if (planes == 0) return (int)cudaSuccess;

    FlreluParams p;
    p.planes = planes; p.channels = channels;
    p.in_h = in_h; p.in_w = in_w; p.mid_h = mid_h; p.mid_w = mid_w;
    p.out_h = out_h; p.out_w = out_w;
    p.up = up; p.pad1x = pad1x; p.pad1y = pad1y; p.t1 = t1; p.flip1 = flip1;
    p.down = down; p.pad2x = pad2x; p.pad2y = pad2y; p.t2 = t2; p.flip2 = flip2;
    p.gain1 = gain1; p.gain2 = gain2;
    p.backward = backward; p.slope = slope; p.gain = gain; p.clamp = clamp;

    // The largest output tile whose shared memory fits the budget.
    size_t smem = 0;
    int to = 32;
    for (; to >= 1; to /= 2) {
        const int mt = (to - 1) * down + t2;
        const int xt = (mt + t1 - 2 + up) / up;
        smem = sizeof(float) * (2 * FLRELU_MAX_TAPS + (size_t)tile_region(xt, mt, to)
                                + (size_t)mt * mt);
        if (smem <= FLRELU_MAX_SMEM_BYTES) {
            p.tile = to; p.mt = mt; p.xt = xt;
            break;
        }
    }
    if (to < 1) return (int)cudaErrorInvalidValue;

    const dim3 block(32, 8);
    // gridDim.z is at most 65535; the plane loop covers the rest.
    const dim3 grid((out_w + p.tile - 1) / p.tile, (out_h + p.tile - 1) / p.tile,
                    (unsigned)(planes < 65535 ? planes : 65535));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (dtype == 0) {
        err = cudaFuncSetAttribute(filtered_lrelu_kernel<float>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        filtered_lrelu_kernel<float><<<grid, block, smem, s>>>(
            (const float*)x, (const float*)bias, f1, f2, (float*)y, (uint8_t*)record, p);
    } else {
        err = cudaFuncSetAttribute(filtered_lrelu_kernel<__nv_bfloat16>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        filtered_lrelu_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)bias, f1, f2,
            (__nv_bfloat16*)y, (uint8_t*)record, p);
    }
    return (int)cudaGetLastError();
}
