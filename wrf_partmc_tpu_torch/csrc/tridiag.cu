// Batched Thomas tridiagonal column solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wrf_partmc_tpu/ops/pallas_tridiag.py:33
// (_thomas_kernel, reached from solve_pallas).  It solves A x = b for
// independent columns of n levels: the acoustic W'' solve of the ARW core
// (n = nz-1 interior faces), the MYJ q2 and Noah soil columns, and the
// implicit vertical diffusion of every Eulerian field (n = nz).  dl[0] and
// du[n-1] are ignored, as in the reference.
//
// Bound: device memory.  The least traffic is one read of dl, d, du and b
// and one write of x per element; the 9 float32 operations per unknown are
// far below it.  Below a few thousand columns (the acoustic solve has
// 1,600, MYJ and Noah 5,184) the bytes take under a microsecond and the
// floor is the launch itself.  What the design does about both:
//
// 1. No scratch in device memory.  For n <= 32 the kernel is templated on
//    a level bucket NB (8, 16, 24, 32): both sweeps are unrolled with
//    compile-time indices guarded by k < n, so the forward sweep's cp/dp
//    live in registers, and every load of the column (dl, d, du, b at all
//    its levels) is issued before the dependent chain starts.  For n > 32
//    cp/dp go to shared memory laid out [level][thread], free of bank
//    conflicts, in a window of W levels (48 KB a block).  A column longer
//    than W is solved window by window from the top: each window re-runs
//    the forward sweep from level 0 to reach its first level, so any n is
//    taken and nothing is stored in device memory but x.
// 2. Blocks sized to the column count.  64 threads below 16,896 columns
//    (132 SMs x 128), so the acoustic [9,40,40] solve spreads over 25 SMs
//    and MYJ/Noah [.,72,72] over 81 instead of 7 and 21 with 256; 128
//    threads above, where the grid covers every SM many times over.
//    Registers, not threads, bound the occupancy there (4 x NB values a
//    thread: 160 registers at NB = 32, hence the 24-level bucket for the
//    23- and 24-level CARES columns), and a 256-thread block of the large
//    buckets would fit once per SM.  The shared-memory window uses 64.
// 3. Strided fields, several per launch.  One launch solves up to 8
//    right-hand sides that share one set of coefficients (vertical
//    diffusion's u, v, theta', moist [L,n,ny,nx], chem [L,n,ny,nx] and
//    tke).  Each field is read in its own layout with a level stride and a
//    field stride, so no transpose or contiguous copy precedes the solve;
//    x is written contiguous.  The descriptor table goes by value as a
//    kernel parameter, so nothing is allocated for it; a block belongs to
//    one field, found from the table's first-block offsets.
//
// Broadcast coefficients: each diagonal is contiguous [n, c] with its own
// column count c (a divisor of the field's column count) and is read at
// column j % c, so [n,1,ny,nx] coefficients against an [n,L,ny,nx]
// right-hand side need no expanded copy.
//
// Arithmetic: products and differences use the _rn intrinsics so nvcc
// cannot contract them into FMAs; the kernel performs exactly the float32
// operations of the plain PyTorch recurrence (solve_scan), in its order,
// and matches it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 8;

// x is contiguous [n, cols] or [L, n, cols]: level stride cols, field
// stride n * cols.
struct Field {
  const float* b;
  float* x;
  long long b_level, b_field;  // strides of b between levels, between fields
  int columns;                 // L * cols (under 2^31)
  int block0;                  // first block of this field
};

struct Launch {
  const float* coef[3];  // dl, d, du: contiguous [n, coef_cols[i]]
  int coef_cols[3];
  int cols;              // columns of one field (the trailing block)
  int n;
  int count;             // fields in use
  int window;            // levels the shared-memory window holds
  Field f[kMaxFields];
};

struct Column {
  const float* dl;
  const float* d;
  const float* du;
  const float* b;
  float* x;
  long long dl_s, d_s, du_s, b_s, x_s;  // level strides
};

// The column this thread solves, or false past the end of its field.
__device__ __forceinline__ bool locate(const Launch& p, Column& c) {
  int fi = 0;
#pragma unroll
  for (int i = 1; i < kMaxFields; ++i)
    if (i < p.count && (int)blockIdx.x >= p.f[i].block0) fi = i;
  const Field& f = p.f[fi];
  // 32-bit column arithmetic: the plan keeps a field's columns under 2^31
  const unsigned local = ((unsigned)blockIdx.x - (unsigned)f.block0) * blockDim.x + threadIdx.x;
  if (local >= (unsigned)f.columns) return false;
  const unsigned l = local / (unsigned)p.cols, j = local - l * (unsigned)p.cols;
  c.b = f.b + (long long)l * f.b_field + j;
  c.x = f.x + (long long)l * p.n * p.cols + j;
  c.b_s = f.b_level;
  c.x_s = p.cols;
  c.dl = p.coef[0] + j % (unsigned)p.coef_cols[0];
  c.d = p.coef[1] + j % (unsigned)p.coef_cols[1];
  c.du = p.coef[2] + j % (unsigned)p.coef_cols[2];
  c.dl_s = p.coef_cols[0];
  c.d_s = p.coef_cols[1];
  c.du_s = p.coef_cols[2];
  return true;
}

// n <= NB: both sweeps in registers.
template <int NB>
__global__ void __launch_bounds__(128) thomas_regs(const __grid_constant__ Launch p) {
  Column c;
  if (!locate(p, c)) return;
  const int n = p.n;
  float a[NB], dg[NB], up[NB], r[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    a[k] = dg[k] = up[k] = r[k] = 0.0f;
    if (k < n) {
      a[k] = __ldg(c.dl + k * c.dl_s);
      dg[k] = __ldg(c.d + k * c.d_s);
      up[k] = __ldg(c.du + k * c.du_s);
      r[k] = __ldg(c.b + k * c.b_s);
    }
  }
  float cprev = 0.0f, dprev = 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k < n) {
      const float denom = __fsub_rn(dg[k], __fmul_rn(a[k], cprev));
      cprev = __fdiv_rn(up[k], denom);
      dprev = __fdiv_rn(__fsub_rn(r[k], __fmul_rn(a[k], dprev)), denom);
      up[k] = cprev;
      r[k] = dprev;
    }
  }
  float xn = 0.0f;
#pragma unroll
  for (int k = NB - 1; k >= 0; --k) {
    if (k < n) {
      xn = __fsub_rn(r[k], __fmul_rn(up[k], xn));
      c.x[k * c.x_s] = xn;
    }
  }
}

// n > 32: cp/dp in shared memory [level][thread], a window of p.window
// levels at a time, from the top window down.
__global__ void __launch_bounds__(64) thomas_window(const __grid_constant__ Launch p) {
  extern __shared__ float smem[];
  Column c;
  if (!locate(p, c)) return;
  const int n = p.n, w = p.window, T = blockDim.x;
  float* scp = smem + threadIdx.x;
  float* sdp = smem + w * T + threadIdx.x;
  float xn = 0.0f;
  for (int w0 = ((n - 1) / w) * w; w0 >= 0; w0 -= w) {
    const int w1 = min(w0 + w, n);
    float cprev = 0.0f, dprev = 0.0f;
    for (int k = 0; k < w1; ++k) {
      const float a = __ldg(c.dl + k * c.dl_s);
      const float denom = __fsub_rn(__ldg(c.d + k * c.d_s), __fmul_rn(a, cprev));
      cprev = __fdiv_rn(__ldg(c.du + k * c.du_s), denom);
      dprev = __fdiv_rn(__fsub_rn(__ldg(c.b + k * c.b_s), __fmul_rn(a, dprev)), denom);
      if (k >= w0) {
        scp[(k - w0) * T] = cprev;
        sdp[(k - w0) * T] = dprev;
      }
    }
    for (int k = w1 - 1; k >= w0; --k) {
      xn = __fsub_rn(sdp[(k - w0) * T], __fmul_rn(scp[(k - w0) * T], xn));
      c.x[k * c.x_s] = xn;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// plan: n, cols, coef_cols[3], count, bucket, threads, window, blocks, then
// count rows of (b, x, b_level, b_field, columns, block0).  Bucket
// 8/16/24/32 runs the sweeps in registers, 0 the shared-memory window.
extern "C" int wpt_thomas_fields_f32(const float* dl, const float* d, const float* du,
                                     const long long* plan, void* stream) {
  Launch p = {};
  p.coef[0] = dl;
  p.coef[1] = d;
  p.coef[2] = du;
  p.n = (int)plan[0];
  p.cols = (int)plan[1];
  for (int i = 0; i < 3; ++i) p.coef_cols[i] = (int)plan[2 + i];
  p.count = (int)plan[5];
  const int bucket = (int)plan[6], threads = (int)plan[7];
  p.window = (int)plan[8];
  const long long blocks = plan[9];
  if (p.count < 1 || p.count > kMaxFields) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p.count; ++i) {
    const long long* r = plan + 10 + 6 * i;
    p.f[i] = Field{(const float*)r[0], (float*)r[1], r[2], r[3], (int)r[4], (int)r[5]};
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
  switch (bucket) {
    case 8: thomas_regs<8><<<grid, threads, 0, s>>>(p); break;
    case 16: thomas_regs<16><<<grid, threads, 0, s>>>(p); break;
    case 24: thomas_regs<24><<<grid, threads, 0, s>>>(p); break;
    case 32: thomas_regs<32><<<grid, threads, 0, s>>>(p); break;
    case 0:
      thomas_window<<<grid, threads, (size_t)2 * p.window * threads * sizeof(float), s>>>(p);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One launch of a kernel that does nothing: the floor a launch costs, for
// comparison with the solve's time.
extern "C" int wpt_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
