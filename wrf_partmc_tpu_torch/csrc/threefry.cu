// Threefry-2x32 draws for Hopper (sm_90a): K4, every bulk random draw of
// the port (wrf_partmc_tpu_torch/utils/rng.py: random_bits, uniform,
// normal, and through them randint, gumbel and categorical).
//
// Replaces no Pallas kernel: the JAX package draws with jax.random, whose
// threefry2x32 hash XLA fuses into one loop on the TPU.  The port's plain
// version (rng.draw_plain) reproduces those draws bit for bit as some 170
// elementwise torch ops on int64 words; this kernel computes the same
// function in one pass, element by element, and writes only the result.
//
// Element e of a draw hashes its counter pair (n >> 32, n & 0xFFFFFFFF)
// under the key (k0, k1): 20 rounds in five groups of four, the key
// schedule ks2 = k0 ^ k1 ^ 0x1BD11BDA injected after each group as
// ks[(i+1)%3] and ks[(i+2)%3] + i + 1, and the two output words xor-ed.
// n is e itself (flat), or for a rank's block of a global draw shaped
// (n0, ny, nx, trail...) the element's global row-major index, computed
// from (ny, nx, iy0, ix0, ny_l, nx_l, trail) as rng.Block.flat_index does:
//   t = e % trail, c = e / trail, jx = c % nx_l, c /= nx_l,
//   jy = c % ny_l, i0 = c / ny_l,
//   n = ((i0 * ny + iy0 + jy) * nx + ix0 + jx) * trail + t.
// A draw holds fewer than 2^32 elements (the wrapper refuses more); n is
// 64-bit, so a block's global index past 2^32 carries its high word.
//
// Three outputs:
//   bits     the 32 bits as int64 values (rng.random_bits; randint's
//            modulo stays in torch);
//   uniform  23 bits under exponent 0, minus 1, times span, plus lo,
//            clamped below at lo: float32 (rng.uniform);
//   normal   the uniform on (nextafter(-1, 0), 1), XLA-CPU's float32
//            erfinv (rng.erfinv_xla: Cephes log and log1p, Giles'
//            polynomials), times sqrt(2) in float32 (rng.normal).
//
// Bit-exactness with the plain version.  Every float operation is written
// with a round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __dmul_rn, ...),
// which nvcc never contracts into an FMA, and in the precision the plain
// version gives its operands: a float32 value widened to float64 is exact,
// and rng._fma's float32 fused multiply-add is a float64 product and sum
// rounded once to float32 (fma64 below), never fmaf, so the rare ties
// round as the plain version rounds them.  The square root is a float64
// root rounded to float32.  No flush to zero: the build takes no
// --use_fast_math, and the log clamps its argument to the smallest normal
// first, as the plain version does.
//
// Bound.  The kernel reads nothing and writes 4 (uniform, normal) or 8
// (bits) bytes an element: 82 MB for a [16000, 1280] float32 draw, 0.024
// ms at 3.35 TB/s.  The hash is about 75 int32 operations an element
// (add, funnel-shift rotate, xor), 1.5e9 for that draw, about 0.045 ms at
// 128 integer operations a clock on each of the H100's 132 multiprocessors:
// the kernel is bound by its integer operations, and normal adds 36-45
// float64 operations and some 30 float32-float64 conversions an element.
// A grid-stride loop of 256-thread blocks keeps every lane busy with no
// shared memory; each thread writes consecutive words with its warp, so the
// stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

// XLA-CPU's float32 log (Cephes plog), log1p (Cephes rational) and the
// erf_inv of the CHLO lowering, as rng._LOG_P, _LOG1P_NUM, _LOG1P_DEN,
// _ERFINV_LT5 and _ERFINV_GE5 round them to float32 (exact hex values).
__constant__ float kLogP[9] = {0x1.204376p-4f, -0x1.d7a37p-4f, 0x1.de4a34p-4f, -0x1.fcba9ep-4f, 0x1.23d37ep-3f, -0x1.555cap-3f, 0x1.999d58p-3f, -0x1.fffff8p-3f, 0x1.555554p-2f};
__constant__ float kLog1pNum[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f, 0x1.e798ecp+5f, 0x1.c8e75ap+5f, 0x1.40a202p+4f};
__constant__ float kLog1pDen[7] = {0x1.0p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f, 0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
__constant__ float kErfinvLt5[9] = {0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f, -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f, -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
__constant__ float kErfinvGe5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f, -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f, 0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};

constexpr float kMinNormal = 0x1.0p-126f;      // 1.17549435e-38
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;    // 0.707106781186547524
constexpr float kLogC1 = -0x1.bd0106p-13f;     // -2.12194440e-4
constexpr float kLogC2 = 0x1.63p-1f;           // 0.693359375
constexpr float kLog1pCut = 0x1.a8279ap-2f;    // sqrt(2) - 1
constexpr float kSqrt2 = 0x1.6a09e6p+0f;

enum Mode { kBits = 0, kUniform = 1, kNormal = 2 };

// A rank's block of a global draw (see the head of the file).
struct BlockIndex {
  long long ny, nx, iy0, ix0;
  uint32_t ny_l, nx_l, trail;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define WPT_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  WPT_ROUND(13) WPT_ROUND(15) WPT_ROUND(26) WPT_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  WPT_ROUND(17) WPT_ROUND(29) WPT_ROUND(16) WPT_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  WPT_ROUND(13) WPT_ROUND(15) WPT_ROUND(26) WPT_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  WPT_ROUND(17) WPT_ROUND(29) WPT_ROUND(16) WPT_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  WPT_ROUND(13) WPT_ROUND(15) WPT_ROUND(26) WPT_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef WPT_ROUND

// rng._fma: a * b + c in float64 (the float32 operands widen exactly, so
// the product is exact), rounded once to float32.
__device__ __forceinline__ float fma64(double a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// rng._bits_to_unit, then rng.uniform's f * span + lo clamped at lo.
__device__ __forceinline__ float unit_range(uint32_t bits, float lo, float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float v = __fadd_rn(__fmul_rn(f, span), lo);
  return v < lo ? lo : v;
}

// rng._xla_log for x > 0.
__device__ float xla_log(float x) {
  x = x < kMinNormal ? kMinNormal : x;
  const int bits = __float_as_int(x);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  float m = __int_as_float((bits & (int)0x807FFFFF) | 0x3F000000);   // [0.5, 1)
  const bool small = m < kSqrtHalf;
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  const double m64 = m, x3_64 = x3;
  float y = fma64(fma64(m64, kLogP[0], kLogP[1]), m64, kLogP[2]);
  const float y1 = fma64(fma64(m64, kLogP[3], kLogP[4]), m64, kLogP[5]);
  const float y2 = fma64(fma64(m64, kLogP[6], kLogP[7]), m64, kLogP[8]);
  y = fma64(fma64(y, x3_64, y1), x3_64, y2);
  y = fma64(y, x3_64, __fmul_rn(e, kLogC1));
  const float r = __fadd_rn(__fsub_rn(m, __fmul_rn(0.5f, x2)), y);
  return fma64(e, kLogC2, r);
}

// rng._xla_log1p: the rational below |a| < sqrt(2) - 1, else log(a + 1).
__device__ float xla_log1p(float a) {
  if (!(fabsf(a) < kLog1pCut)) return xla_log(__fadd_rn(a, 1.0f));
  const double a64 = a;
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    num = fma64(num, a64, kLog1pNum[i]);
    den = fma64(den, a64, kLog1pDen[i]);
  }
  const float a2 = __fmul_rn(a, a);
  return __fadd_rn(a, __fadd_rn(__fmul_rn(-0.5f, a2),
                                __fmul_rn(__fmul_rn(a, a2), __fdiv_rn(num, den))));
}

// rng.erfinv_xla: Giles' two branches on w = -log1p(-x^2), split at w = 5.
__device__ float erfinv_xla(float x) {
  const float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt5 = w < 5.0f;
  const float ww = lt5 ? __fsub_rn(w, 2.5f)
                       : __fsub_rn(__double2float_rn(__dsqrt_rn((double)w)), 3.0f);
  const double ww64 = ww;
  float p = lt5 ? kErfinvLt5[0] : kErfinvGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fma64(p, ww64, lt5 ? kErfinvLt5[i] : kErfinvGe5[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}

__device__ __forceinline__ unsigned long long global_index(uint32_t e, const BlockIndex& b) {
  const uint32_t t = e % b.trail;
  uint32_t c = e / b.trail;
  const uint32_t jx = c % b.nx_l;
  c /= b.nx_l;
  const uint32_t jy = c % b.ny_l;
  const uint32_t i0 = c / b.ny_l;
  const unsigned long long cell =
      ((unsigned long long)i0 * b.ny + b.iy0 + jy) * b.nx + b.ix0 + jx;
  return cell * b.trail + t;
}

template <int MODE, bool BLOCKED>
__global__ void __launch_bounds__(kThreads)
    threefry_draw_kernel(void* __restrict__ out, unsigned long long n, uint32_t k0, uint32_t k1,
                         float lo, float span, BlockIndex b) {
  const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
  for (unsigned long long e = (unsigned long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += stride) {
    const unsigned long long idx = BLOCKED ? global_index((uint32_t)e, b) : e;
    const uint32_t bits = threefry_bits(k0, k1, (uint32_t)(idx >> 32), (uint32_t)idx);
    if (MODE == kBits) {
      static_cast<long long*>(out)[e] = (long long)bits;
    } else if (MODE == kUniform) {
      static_cast<float*>(out)[e] = unit_range(bits, lo, span);
    } else {
      static_cast<float*>(out)[e] = __fmul_rn(kSqrt2, erfinv_xla(unit_range(bits, lo, span)));
    }
  }
}

template <int MODE>
void launch(bool blocked, int grid, cudaStream_t stream, void* out, unsigned long long n,
            uint32_t k0, uint32_t k1, float lo, float span, const BlockIndex& b) {
  if (blocked) {
    threefry_draw_kernel<MODE, true><<<grid, kThreads, 0, stream>>>(out, n, k0, k1, lo, span, b);
  } else {
    threefry_draw_kernel<MODE, false><<<grid, kThreads, 0, stream>>>(out, n, k0, k1, lo, span, b);
  }
}

}  // namespace

// out: n int64 (mode 0) or float32 (modes 1, 2) values; k0, k1: the key's
// uint32 words; blocked: 1 to hash the block's global indices (ny ... trail).
extern "C" int wpt_threefry_draw(void* out, long long n, long long k0, long long k1, int mode,
                                 float lo, float span, int blocked, long long ny, long long nx,
                                 long long iy0, long long ix0, long long ny_l, long long nx_l,
                                 long long trail, void* stream) {
  if (n < 0 || n >= (1LL << 32) || mode < kBits || mode > kNormal) return cudaErrorInvalidValue;
  if (blocked && (ny_l <= 0 || nx_l <= 0 || trail <= 0 || ny_l >= (1LL << 32) ||
                  nx_l >= (1LL << 32) || trail >= (1LL << 32)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const BlockIndex b{ny, nx, iy0, ix0, (uint32_t)ny_l, (uint32_t)nx_l, (uint32_t)trail};
  const long long want = (n + kThreads - 1) / kThreads;
  const int grid = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const auto s = (cudaStream_t)stream;
  const auto u0 = (uint32_t)k0, u1 = (uint32_t)k1;
  const auto un = (unsigned long long)n;
  if (mode == kBits) {
    launch<kBits>(blocked != 0, grid, s, out, un, u0, u1, lo, span, b);
  } else if (mode == kUniform) {
    launch<kUniform>(blocked != 0, grid, s, out, un, u0, u1, lo, span, b);
  } else {
    launch<kNormal>(blocked != 0, grid, s, out, un, u0, u1, lo, span, b);
  }
  return (int)cudaGetLastError();
}
