// Montgomery multiply in the BLS12-381 base field on 52 signed 8-bit limbs
// in float32, for Hopper (sm_90a), with a group of G threads on each lane.
//
// Replaces the TPU kernel coconut_tpu/tpu/pallas_fp.py::_mul_kernel
// (launched by _mul_flat through pl.pallas_call, wrapped by pallas_fp.mul).
// Same function, limb for limb: out = a * b * 2^-416 mod p as a NORMALIZED
// limb vector (|limb| <= 132, |value| < 0.66p) for LAZY inputs (|limb| <=
// 2^17, |value| <= 1024p, limbs 50-51 zero). The pipeline:
//   1. two carry passes on each input (|limb| <= 132);
//   2. t = a * b, the 103 coefficients of the 52x52 limb product;
//   3. tlo = three passes over t[0:52] (the carry out of limb 51 drops:
//      truncation mod 2^416 is intended);
//   4. m = three passes over the low 52 coefficients of tlo * N'
//      (N' = -p^-1 mod 2^416, again truncated mod 2^416);
//   5. w = t + m * p, whose low 416 bits vanish;
//   6. three passes over w[0:52] extended by 3 limbs give the carry into
//      the high half; the high half w[52:103] extended by 1 limb takes that
//      carry in its limbs 0-2 and gets three passes.
// A carry pass is hi = round_half_even(t / 256), lo = t - 256 hi,
// t' = lo + (hi shifted up one limb), the top limb's hi dropped. Every
// value is an integer below 2^24, so every float32 operation is exact and
// any split of a sum, in any order, gives the same bits; the rounding must
// be ties-to-even (rintf), as jnp.round is in the reference. The exactness
// proof is in tpu/fp.py's import asserts and in the port's copy of them
// (gpu/fp.py). Build without fast-math.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32): per lane it reads
// 2 x 208 bytes and writes 208 bytes, and does 6,786 multiply-adds (2,704
// for a*b, 1,378 for the truncated m, 2,704 for m*p) plus ~1,000 carry-pass
// operations. At 55,296 lanes (fp12_mul at B = 1024) that is 34.5 MB
// (0.0103 ms) against 375M multiply-adds (0.0112 ms); at 3,072 lanes
// (fp2_mul) 1.9 MB (0.0006 ms) against 20.8M multiply-adds (0.0006 ms).
// The main path makes thousands of launches, most of them narrow, so what
// it pays is the latency of one lane's dependency chain, not throughput.
//
// The design: a group of G threads (G a power of two, G <= 32, so a group
// lies inside one warp) works on each lane, which cuts the chain by about G
// and puts G times more warps on the card at every width.
//   - Ownership is cyclic: thread r of a group owns the coefficients and
//     limbs k = r + G c. For a limb product every thread then does about
//     1/G of the terms (the triangle of a*b is spread evenly), in a fully
//     unrolled loop: for each v < G, a window ys[d] = y[r - v + G d] of the
//     second operand is read once into registers, and x[G u + v] of the
//     first is broadcast to the group and multiplied into acc[u + d]. The
//     y rows in shared memory carry zero padding, so window terms outside
//     the product read zeros and add nothing; x terms past limb 51 are
//     left out when the loops unroll.
//   - A carry pass is local: rintf and one fmaf per owned limb, then each
//     hi moves to the owner of limb k + 1, thread r + 1 of the group (one
//     __shfl_sync over the group's segment; thread 0 takes thread G-1's hi
//     of the previous c). The truncations of the reference are kept by
//     which k each step reads and writes.
//   - Operands come in as 16-byte loads spread over the group and are
//     parked, normalized, in shared memory; t and w stay in registers of
//     their owners; tlo, m and the result pass through shared memory. Each
//     lane's rows start at a stride that is G mod 32 floats, so the groups
//     of a warp read distinct banks; the constants p and N' are shared by
//     the block, and the groups of a warp read them as broadcasts.
// Tensor-core limb products, TMA staging and fused tower glue are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NL = 52;         // limbs per element
constexpr int THREADS = 128;   // threads per block
constexpr int SHIP_G = 8;      // threads per lane of the shipped kernel
constexpr int SHIP_MINB = 8;   // blocks an SM the shipped kernel is built for

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int G>
struct Shape {
    static_assert(G >= 4 && G <= 32 && (G & (G - 1)) == 0, "G: 4, 8, 16 or 32");
    static constexpr int LANES = THREADS / G;          // lanes per block
    static constexpr int U = cdiv(NL, G);              // steps u of x[G u + v]
    static constexpr int D = (NL + G - 2) / G + 1;     // window ys[0..D)
    static constexpr int YS = G * (D + 1);             // y row: G zeros, limbs, zeros
    static constexpr int RT = cdiv(2 * NL, G);         // c of k = r + G c < 104
    static constexpr int C52 = (NL - 1) / G + 1;       // c that reach some k < 52
    static constexpr int CE = (NL + 2) / G + 1;        // c that reach some k < 55
    static constexpr int CH0 = NL / G;                 // every k < G CH0 is < 52
    static constexpr int ROW = NL + YS;                // x row, then y row
    static constexpr int STRIDE = ROW + (G % 32 - ROW % 32 + 32) % 32;  // = G mod 32
};

// acc[c] += sum_i x[i] * y[r + G c - i] for c < C. x is a lane's row of 52
// limbs; y points at limb 0 of a zero-padded row (y[-G..YS-G)).
template <int G, int C>
__device__ __forceinline__ void mul_acc(const float* x, const float* y, int r,
                                        float (&acc)[C]) {
    using S = Shape<G>;
#pragma unroll
    for (int v = 0; v < G; ++v) {
        const float* yv = y + (r - v);
        float ys[S::D];
#pragma unroll
        for (int d = 0; d < S::D; ++d) ys[d] = yv[G * d];
#pragma unroll
        for (int u = 0; u < S::U; ++u) {
            if (G * u + v >= NL) break;
            const float xi = x[G * u + v];
#pragma unroll
            for (int d = 0; d < S::D; ++d)
                if (u + d < C) acc[u + d] = fmaf(xi, ys[d], acc[u + d]);
        }
    }
}

// One carry pass over the owned limbs k = r + G c, C0 <= c < C1. The carry
// into limb G C0 is 0 (the limbs below it are zero); carries out of the
// range land in k the caller ignores.
template <int G, int C0, int C1, int C>
__device__ __forceinline__ void carry_pass(float (&x)[C], int r) {
    const int src = (r + G - 1) & (G - 1);
    float from[C];
#pragma unroll
    for (int c = C0; c < C1; ++c) {
        const float hi = rintf(x[c] * 0.00390625f);  // exact scale by 2^-8
        x[c] = fmaf(-256.0f, hi, x[c]);
        from[c] = __shfl_sync(0xffffffffu, hi, src, G);
    }
#pragma unroll
    for (int c = C0; c < C1; ++c) {
        const float in = r != 0 ? from[c] : (c > C0 ? from[c - 1] : 0.0f);
        x[c] += in;
    }
}

template <int G, int PASSES, int C0, int C1, int C>
__device__ __forceinline__ void carry_passes(float (&x)[C], int r) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) carry_pass<G, C0, C1>(x, r);
}

// Limbs 0..51 of `row` (zero beyond) into the owned registers, and back.
template <int G, int C>
__device__ __forceinline__ void gather(const float* row, int r, float (&x)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int k = r + G * c;
        x[c] = k < NL ? row[k] : 0.0f;
    }
}

template <int G, int C>
__device__ __forceinline__ void scatter(float* row, int r, const float (&x)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int k = r + G * c;
        if (k < NL) row[k] = x[c];
    }
}

template <int G, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
fp_mul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ consts, float* __restrict__ out,
              long long n) {
    using S = Shape<G>;
    __shared__ __align__(16) float s_lanes[S::LANES * S::STRIDE];
    __shared__ float s_const[2 * S::YS];  // p, then N', as zero-padded y rows

    const int tid = threadIdx.x;
    const int r = tid & (G - 1);
    const int slot = tid / G;
    const long long lane = (long long)blockIdx.x * S::LANES + slot;
    const bool live = lane < n;
    float* xr = s_lanes + slot * S::STRIDE;  // a, then tlo, m, the result
    float* yb = xr + NL + G;                 // b, limb 0 at yb[0]
    const float* yp = s_const + G;
    const float* yn = s_const + S::YS + G;

    for (int i = tid; i < 2 * S::YS; i += THREADS) {
        const int j = i % S::YS - G;
        s_const[i] = (j >= 0 && j < NL) ? consts[(i / S::YS) * NL + j] : 0.0f;
    }
    yb[r - G] = 0.0f;
    for (int i = NL + r; i < S::YS - G; i += G) yb[i] = 0.0f;
    if (live) {
        const float4* ra = reinterpret_cast<const float4*>(a + lane * NL);
        const float4* rb = reinterpret_cast<const float4*>(b + lane * NL);
        for (int q = r; q < NL / 4; q += G) {
            reinterpret_cast<float4*>(xr)[q] = ra[q];
            reinterpret_cast<float4*>(yb)[q] = rb[q];
        }
    } else {
        for (int i = r; i < NL; i += G) xr[i] = yb[i] = 0.0f;
    }
    __syncwarp();

    // 1. two carry passes per input, in place
    {
        float x[S::C52], y[S::C52];
        gather<G>(xr, r, x);
        gather<G>(yb, r, y);
        carry_passes<G, 2, 0, S::C52>(x, r);
        carry_passes<G, 2, 0, S::C52>(y, r);
        scatter<G>(xr, r, x);
        scatter<G>(yb, r, y);
    }
    __syncthreads();  // the block's constants and every lane's rows

    // 2. t = a * b, coefficient r + G c in t[c]
    float t[S::RT];
#pragma unroll
    for (int c = 0; c < S::RT; ++c) t[c] = 0.0f;
    mul_acc<G>(xr, yb, r, t);
    __syncwarp();  // the group has read a

    // 3. tlo = t mod 2^416, normalized, into the x row
    {
        float u[S::C52];
#pragma unroll
        for (int c = 0; c < S::C52; ++c) u[c] = r + G * c < NL ? t[c] : 0.0f;
        carry_passes<G, 3, 0, S::C52>(u, r);
        scatter<G>(xr, r, u);
    }
    __syncwarp();

    // 4. m = tlo * N' mod 2^416: coefficients below 52, then 3 passes
    {
        float m[S::C52];
#pragma unroll
        for (int c = 0; c < S::C52; ++c) m[c] = 0.0f;
        mul_acc<G>(xr, yn, r, m);
        carry_passes<G, 3, 0, S::C52>(m, r);
        __syncwarp();  // the group has read tlo
        scatter<G>(xr, r, m);
    }
    __syncwarp();

    // 5. w = t + m * p, in place (|coefficient| < 2^22)
    mul_acc<G>(xr, yp, r, t);

    // 6. low half: limbs 0..51 clear to zero, the carry lands in 52..54
    float e[S::CE];
#pragma unroll
    for (int c = 0; c < S::CE; ++c) e[c] = r + G * c < NL ? t[c] : 0.0f;
    carry_passes<G, 3, 0, S::CE>(e, r);

    //    high half: w[52:104) plus that carry in its limbs 0..2
    float h[S::RT];
#pragma unroll
    for (int c = S::CH0; c < S::RT; ++c) {
        const int k = r + G * c;
        float v = k < NL ? 0.0f : t[c];
        if (c < S::CE && k >= NL && k < NL + 3) v += e[c];
        h[c] = v;
    }
    carry_passes<G, 3, S::CH0, S::RT>(h, r);
    __syncwarp();  // the group has read m
#pragma unroll
    for (int c = S::CH0; c < S::RT; ++c) {
        const int k = r + G * c;
        if (k >= NL && k < 2 * NL) xr[k - NL] = h[c];
    }
    __syncwarp();
    if (live) {
        float4* ro = reinterpret_cast<float4*>(out + lane * NL);
        for (int q = r; q < NL / 4; q += G) ro[q] = reinterpret_cast<const float4*>(xr)[q];
    }
}

template <int G, int MINB>
int launch_fp_mul(const void* a, const void* b, const void* consts, void* out,
                  long long n, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const long long blocks = (n + Shape<G>::LANES - 1) / Shape<G>::LANES;
    fp_mul_kernel<G, MINB><<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)consts, (float*)out, n);
    return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: row-major float32 [n, 52], 16-byte aligned; consts: float32
// [104] = balanced limbs of p, then of N'. Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch.
extern "C" int coconut_fp_mul(const void* a, const void* b, const void* consts,
                              void* out, long long n, void* stream) {
    return launch_fp_mul<SHIP_G, SHIP_MINB>(a, b, consts, out, n, stream);
}

// Threads that work on one lane (G) in coconut_fp_mul.
extern "C" int coconut_fp_mul_group() { return SHIP_G; }
