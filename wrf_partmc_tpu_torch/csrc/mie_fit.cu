// Bulk aerosol optics of the fitted Mie surrogate for Hopper (sm_90a): K5,
// the part of optics.bulk_optical_props(method="mie_fit") that follows the
// per-particle wet diameter and refractive index.
//
// Replaces no Pallas kernel: the JAX package computes it as XLA code,
// wrf_partmc_tpu/models/partmc/mie.py:255 fit_lookup under
// optics.py:159 per_particle_optics and the sums of optics.py:184
// bulk_optical_props.  The port's plain version (optics.mie_fit_sums_plain)
// fills a [60, N] Chebyshev design matrix, contracts it with the [60, 45]
// fit coefficients into an [N, 15, 3] projection, takes a batched
// matrix-vector product with the (n, k) basis and reduces [W, N]
// cross-sections per cell: at the CARES shape (N = 15.9 M slots, W = 4)
// some 90 GB of device traffic and a 3.8 GB and a 2.9 GB temporary.
//
// For each cell c and band b (wavelength lambda_b) it writes
//   out[0, b, c] = sum_p c_sca * num,   out[1, b, c] = sum_p c_abs * num,
//   out[2, b, c] = sum_p c_sca * g * num
// over the slots p of the cell, with x = pi d / lambda_b, (q_ext, q_sca, g)
// the fit's (log10 q_ext, log10 q_abs and g as Chebyshev_60(t(x)) x
// poly_4(n_s, k_s) series), c_sca = q_sca area, c_abs = (q_ext - q_sca)
// area, area = pi/4 d^2.  A slot of number 0 (dead) adds nothing.
//
// Design.  A block owns a cell at a time (a grid-stride loop over cells,
// one block of up to 128 threads per resident slot of the SMs), one thread
// a slot.  The fit coefficients (60 x 45 floats, rows padded to 48) are
// loaded into shared memory once per block; every thread of a warp reads
// the same word, a broadcast.  A thread reads its slot's d, n, k and
// number once (coalesced across the warp), forms the 15-term (n_s, k_s)
// basis once, and walks the 60 Chebyshev orders: at order j it contracts
// row j of the coefficients with the basis (D[j, q], 45 multiply-adds,
// shared by the bands) and advances every band's recurrence
// T_j = 2 t T_{j-1} - T_{j-2} in registers, accumulating T_j D[j, q].
// Nothing per slot goes to device memory: the 12 sums of a cell are
// reduced across the block (warp shuffles, then shared memory) and
// written once.
//
// Arithmetic.  The scalings of x, n and k and the recurrence use the _rn
// intrinsics in the order and with the reciprocals of the plain version's
// torch operations on the card (a division by a host scalar is a product
// with its float32 reciprocal there), so the t, n_s, k_s and T_j of both
// are the same floats: near t = +-1 the fit amplifies a last-ulp change of
// t some 10^4 times.  The 900-term series is summed in another order than
// the plain version's matrix products, and the cell sums in another order
// than torch.sum, so the result is not bit-equal; chip_smoke.py holds it
// at a stated tolerance.
//
// Bound.  The function reads d, n, k and the number once (16 bytes a slot)
// and writes 12 floats a cell: 0.076 ms for the CARES shape's 255 MB at
// 3.35 TB/s.  Its least arithmetic is 60 x 45 multiply-adds a live slot for
// the basis-weighted coefficients and W x (3 x 60 + 58) for the bands'
// contractions and recurrences, 3,652 at W = 4: about 1.4 ms for 12.4 M
// live slots at 33.5e12 multiply-adds a second, so the kernel is bound by
// its float32 operations.

#include <cuda_runtime.h>

namespace {

constexpr int kJ = 60;                  // Chebyshev orders in t(x)
constexpr int kM = 15;                  // (n_s, k_s) monomials of degree <= 4
constexpr int kQ = 3;                   // log10 q_ext, log10 q_abs, g
constexpr int kMQ = kM * kQ;            // a coefficient row: index m * 3 + q
constexpr int kRow4 = 12;               // a row padded to 48 floats, as float4
constexpr int kMaxBands = 4;
constexpr int kOut = kQ * kMaxBands;    // the sums of a cell
constexpr int kMaxThreads = 128;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kQuarterPi = 0.78539816339744830962f;

struct Fit {
  float lx0, inv_lx;                    // t = (log10 x - lx0) * inv_lx * 2 - 1
  float n0, inv_n;                      // n_s = (n - n0) * inv_n * 2 - 1
  float lk0, inv_lk;                    // k_s = (log10 k - lk0) * inv_lk * 2 - 1
  float inv_wl[kMaxBands];              // float32 reciprocals of the wavelengths
  int bands;
};

// clamp((v - lo) * inv * 2 - 1, -1, 1), rounded as the plain version's ops
__device__ __forceinline__ float scaled(float v, float lo, float inv) {
  const float s = __fsub_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, lo), inv), 2.0f), 1.0f);
  return fminf(fmaxf(s, -1.0f), 1.0f);
}

// x^0 .. x^4 by the repeated squaring of mie._ipow
__device__ __forceinline__ void powers(float x, float p[5]) {
  p[0] = 1.0f;
  p[1] = x;
  p[2] = __fmul_rn(x, x);
  p[3] = __fmul_rn(x, p[2]);
  p[4] = __fmul_rn(p[2], p[2]);
}

// D[j, q] = sum_m coef[j, m * 3 + q] basis[m], the fit's row j weighted by
// the slot's (n_s, k_s) monomials
__device__ __forceinline__ void row_weights(const float4* __restrict__ coef, int j,
                                            const float basis[kM], float dq[kQ]) {
  dq[0] = dq[1] = dq[2] = 0.0f;
#pragma unroll
  for (int v = 0; v < kRow4; ++v) {
    const float4 c = coef[j * kRow4 + v];
    const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * v + i;
      if (e < kMQ) dq[e % kQ] = fmaf(cs[i], basis[e / kQ], dq[e % kQ]);
    }
  }
}

// one live slot's contributions to the cell's sums
__device__ __forceinline__ void slot_sums(float d, float n, float k, float num,
                                          const float4* __restrict__ coef, const Fit& f,
                                          float acc[kOut]) {
  const float area = __fmul_rn(__fmul_rn(kQuarterPi, d), d);
  const float pd = __fmul_rn(kPi, d);
  float np_[5], kp[5], basis[kM], dq[kQ];
  powers(scaled(n, f.n0, f.inv_n), np_);
  powers(scaled(log10f(fmaxf(k, 1e-30f)), f.lk0, f.inv_lk), kp);
  // the monomials n_s^dn k_s^dk in the order of mie._nk_exponents()
  basis[0] = kp[0];
  basis[1] = kp[1];
  basis[2] = kp[2];
  basis[3] = kp[3];
  basis[4] = kp[4];
  basis[5] = np_[1];
  basis[6] = __fmul_rn(np_[1], kp[1]);
  basis[7] = __fmul_rn(np_[1], kp[2]);
  basis[8] = __fmul_rn(np_[1], kp[3]);
  basis[9] = np_[2];
  basis[10] = __fmul_rn(np_[2], kp[1]);
  basis[11] = __fmul_rn(np_[2], kp[2]);
  basis[12] = np_[3];
  basis[13] = __fmul_rn(np_[3], kp[1]);
  basis[14] = np_[4];

  // order 0 (T_0 = 1); each band's recurrence then starts from T_0 = 1 and
  // T_-1 = T_1 = t, so that its first step gives 2 t - t = t exactly
  row_weights(coef, 0, basis, dq);
  float t2[kMaxBands], tm2[kMaxBands], tm1[kMaxBands], s[kMaxBands][kQ];
#pragma unroll
  for (int b = 0; b < kMaxBands; ++b) {
    const float x = __fmul_rn(pd, f.inv_wl[b]);
    const float t = scaled(log10f(fmaxf(x, 1e-30f)), f.lx0, f.inv_lx);
    t2[b] = __fmul_rn(2.0f, t);
    tm1[b] = 1.0f;
    tm2[b] = t;
#pragma unroll
    for (int q = 0; q < kQ; ++q) s[b][q] = dq[q];
  }
  for (int j = 1; j < kJ; ++j) {
    row_weights(coef, j, basis, dq);
#pragma unroll
    for (int b = 0; b < kMaxBands; ++b) {
      const float tj = __fsub_rn(__fmul_rn(t2[b], tm1[b]), tm2[b]);
      tm2[b] = tm1[b];
      tm1[b] = tj;
#pragma unroll
      for (int q = 0; q < kQ; ++q) s[b][q] = fmaf(tj, dq[q], s[b][q]);
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxBands; ++b) {
    if (b >= f.bands) break;
    const float q_ext = powf(10.0f, s[b][0]);
    const float q_abs = powf(10.0f, s[b][1]);
    const float g = fminf(fmaxf(s[b][2], 0.0f), 1.0f);
    const float q_sca = fmaxf(__fsub_rn(q_ext, q_abs), 0.0f);
    const float c_sca = __fmul_rn(q_sca, area);
    const float c_abs = __fmul_rn(__fsub_rn(q_ext, q_sca), area);
    acc[b * kQ + 0] = fmaf(c_sca, num, acc[b * kQ + 0]);
    acc[b * kQ + 1] = fmaf(c_abs, num, acc[b * kQ + 1]);
    acc[b * kQ + 2] = fmaf(__fmul_rn(c_sca, g), num, acc[b * kQ + 2]);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
mie_fit_bulk_kernel(const float* __restrict__ diam, const float* __restrict__ n,
                    const float* __restrict__ k, const float* __restrict__ num,
                    const float* __restrict__ coef, float* __restrict__ out, long long cells,
                    int slots, Fit f) {
  __shared__ float4 s_coef[kJ * kRow4];
  __shared__ float s_red[kMaxThreads / 32][kOut];
  float* sc = reinterpret_cast<float*>(s_coef);
  for (int i = threadIdx.x; i < kJ * kRow4 * 4; i += blockDim.x) {
    const int j = i / (kRow4 * 4), e = i % (kRow4 * 4);
    sc[i] = e < kMQ ? coef[j * kMQ + e] : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (long long c = blockIdx.x; c < cells; c += gridDim.x) {
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
    const long long base = c * slots;
    for (int p = threadIdx.x; p < slots; p += blockDim.x) {
      const float w = num[base + p];
      if (w != 0.0f) slot_sums(diam[base + p], n[base + p], k[base + p], w, s_coef, f, acc);
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kOut; ++i) s_red[warp][i] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < kQ * f.bands) {
      float v = 0.0f;
      for (int w = 0; w < warps; ++w) v += s_red[w][threadIdx.x];
      const int b = threadIdx.x / kQ, q = threadIdx.x % kQ;
      out[((long long)q * f.bands + b) * cells + c] = v;
    }
    __syncthreads();
  }
}

}  // namespace

// diam, n, k, num: float32 [cells, slots] on the card; coef: float32
// [60, 45]; out: float32 [3, bands, cells].  The scalings come as the
// offsets and float32 reciprocal spans of the fit's domain, the bands as
// float32 reciprocal wavelengths; sms is the card's multiprocessor count.
extern "C" int wpt_mie_fit_bulk(const void* diam, const void* n, const void* k, const void* num,
                                const void* coef, void* out, long long cells, int slots,
                                int bands, float lx0, float inv_lx, float n0, float inv_n,
                                float lk0, float inv_lk, float inv_wl0, float inv_wl1,
                                float inv_wl2, float inv_wl3, int sms, void* stream) {
  if (cells < 0 || slots < 1 || bands < 1 || bands > kMaxBands || sms < 1)
    return cudaErrorInvalidValue;
  if (cells == 0) return cudaSuccess;
  const Fit f{lx0, inv_lx, n0, inv_n, lk0, inv_lk, {inv_wl0, inv_wl1, inv_wl2, inv_wl3}, bands};
  const int threads = slots >= kMaxThreads ? kMaxThreads : ((slots + 31) / 32) * 32;
  // resident blocks an SM holds at this block size, asked once per size (not
  // while a CUDA graph captures the launch)
  static int occupancy[kMaxThreads / 32 + 1] = {0};
  int& per_sm = occupancy[threads / 32];
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mie_fit_bulk_kernel, threads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(cells < most ? cells : most);
  mie_fit_bulk_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)diam, (const float*)n, (const float*)k, (const float*)num,
      (const float*)coef, (float*)out, cells, slots, f);
  return (int)cudaGetLastError();
}
