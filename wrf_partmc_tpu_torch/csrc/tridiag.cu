// Batched Thomas tridiagonal column solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wrf_partmc_tpu/ops/pallas_tridiag.py
// (_thomas_kernel, reached from solve_pallas).  It solves A x = b for m
// independent columns of n levels: the acoustic W'' solve of the ARW core
// (n = nz-1 interior faces, m = ny*nx) and the implicit vertical diffusion
// (n = nz, m = L*ny*nx).
//
// Layout: level-major [n, m] with the columns contiguous, one thread per
// column.  At every level the 32 threads of a warp read 32 neighbouring
// floats, so each load and store is one coalesced 128-byte transaction.
// Bound: device memory.  The floor is one read of dl, d, du, b and one write
// of x per element; this first version also writes and re-reads the
// forward-sweep scratch cp/dp (two more round trips), which is the next
// thing to move into registers or shared memory.
//
// Broadcast coefficients: each diagonal carries its own column count m_c
// (a divisor of m) and is read at column j % m_c, so [n,1,ny,nx]
// coefficients against an [n,L,ny,nx] right-hand side need no expanded
// copy.  dl[0] and du[n-1] are ignored, as in the reference.
//
// Arithmetic: products and differences use the _rn intrinsics so nvcc
// cannot contract them into FMAs; the kernel then performs exactly the
// float32 operations of the plain PyTorch recurrence (solve_scan).

#include <cuda_runtime.h>

namespace {

__global__ void thomas_kernel(const float* __restrict__ dl,
                              const float* __restrict__ d,
                              const float* __restrict__ du,
                              const float* __restrict__ b,
                              float* __restrict__ x,
                              float* __restrict__ cp,
                              float* __restrict__ dp,
                              int n, long long m, long long m_dl,
                              long long m_d, long long m_du, long long m_b) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const long long jdl = j % m_dl, jd = j % m_d, jdu = j % m_du, jb = j % m_b;
  float cprev = 0.0f, dprev = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float a = dl[k * m_dl + jdl];
    const float denom = __fsub_rn(d[k * m_d + jd], __fmul_rn(a, cprev));
    const float c = __fdiv_rn(du[k * m_du + jdu], denom);
    const float r = __fdiv_rn(__fsub_rn(b[k * m_b + jb], __fmul_rn(a, dprev)),
                              denom);
    cp[k * m + j] = c;
    dp[k * m + j] = r;
    cprev = c;
    dprev = r;
  }
  float xn = 0.0f;
  for (int k = n - 1; k >= 0; --k) {
    xn = __fsub_rn(dp[k * m + j], __fmul_rn(cp[k * m + j], xn));
    x[k * m + j] = xn;
  }
}

}  // namespace

extern "C" int wpt_thomas_solve_f32(const float* dl, const float* d,
                                    const float* du, const float* b, float* x,
                                    float* cp, float* dp, int n, long long m,
                                    long long m_dl, long long m_d,
                                    long long m_du, long long m_b,
                                    void* stream) {
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  thomas_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      dl, d, du, b, x, cp, dp, n, m, m_dl, m_d, m_du, m_b);
  return (int)cudaGetLastError();
}
