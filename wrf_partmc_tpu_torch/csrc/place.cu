// Particle row placement for Hopper (sm_90a): batched row scatter and gather
// over a channel-first payload [B, CH, L].
//
// Replace the Pallas TPU kernels of wrf_partmc_tpu/ops/place.py:
//   _scatter_kernel (via _scatter_rows_pallas)  out[b,:,dst[b,i]] = x[b,:,i]
//   _gather_kernel  (via _gather_rows_pallas)   out[b,:,o] = x[b,:,src[b,o]]
// The TPU kernels move rows as bf16x3 one-hot matmuls on the MXU because
// XLA gathers were slow there; on Hopper these are indexed copies, exact to
// the bit.  A dst of -1 (or out of range) drops the row and leaves its
// slots 0; a src of -1 (or out of range) writes a zero row.
//
// Bound: device memory.  The least traffic is one read of every row the
// indices select, one read of the index row and one write of the output.
// Each data-dependent access straight to device memory moves a whole
// 32-byte sector for one 4-byte float, because consecutive channels of a
// slot lie L floats apart.  Both kernels therefore build or hold one side
// of the copy in shared memory and keep the device-memory side coalesced:
//
// * Scatter.  A block owns one cell's output tile [ct, L2] (or G whole
//   cells when a cell is small), zeroes it in shared memory, reads the
//   x[b, c, i] of the rows with a valid dst (coalesced along the slot
//   axis; a warp whose 32 dst are all dropped reads nothing) and writes
//   them into the tile at dst.  The tile then goes out with coalesced
//   16-byte stores: every output byte is written once, no zero-fill pass
//   precedes the kernel and no partial sector reaches device memory.
// * Gather.  A block brings one cell's input tile [ct, L1] (contiguous in
//   the [B, CH, L] layout; G whole cells when small) into shared memory
//   with one TMA bulk copy (cp.async.bulk completing on an mbarrier) where
//   the tile is 16-byte aligned and a multiple of 16 bytes long, and with
//   coalesced loads otherwise, then writes out[c, o] = tile[c, src[o]]
//   coalesced along the output slots (four slots a thread and one 16-byte
//   store per channel where L2 is a multiple of 4): every input byte is
//   read once.
//
// What still separates them from the bound: the scatter reads a moving row
// as CH floats L1 apart, so a row that moves alone costs CH 32-byte
// sectors; the gather reads the whole input tile even where few of its
// rows are selected.
//
// The cell's index row is loaded into shared memory once and reused over
// the channel tiles.  Channel tiles keep a block under a budget of shared
// memory: 23 KB for the scatter, so that eight blocks of 256 threads share
// an SM and hide the latency of its data-dependent loads, and 46 KB for the
// gather, whose loads are bulk copies and which keeps its tiles few.  A 1-D
// grid of cell groups holds up to 2^31 - 1 groups (a 2-D grid with the cell
// on y stops at 65,535 cells).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kScatterBudget = 23 * 1024; // shared memory a block aims for
constexpr int kGatherBudget = 46 * 1024;
constexpr int kMaxSmem = 227 * 1024;      // what a block may have on sm_90

__host__ __device__ inline long long align16(long long n) { return (n + 15) & ~15LL; }

// an index in [0, n) moves a row; anything else drops it or reads zeros
__device__ inline bool valid(int i, int n) { return i >= 0 && i < n; }

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Zero n floats of a 16-byte aligned shared tile.
__device__ inline void zero_tile(float* tile, int n) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int k = threadIdx.x; k < (n >> 2); k += blockDim.x) t4[k] = z;
  for (int k = (n & ~3) + threadIdx.x; k < n; k += blockDim.x) tile[k] = 0.f;
}

// Block (cells b0 .. b0+gn-1, channels c0 .. c0+cn-1): G > 1 only when the
// tile holds every channel, so the tile [gn, cn, l2] is one contiguous run
// of the output, out[(b0*ch + c0)*l2 ...].
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ x, const int* __restrict__ dst,
                    float* __restrict__ out, long long b, int ch, int l1,
                    int l2, int G, int ct) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  int* sdst = reinterpret_cast<int*>(smem + align16(4LL * G * ct * l2));
  const long long b0 = (long long)blockIdx.x * G;
  const int gn = (int)min((long long)G, b - b0);
  const int nslot = gn * l1;
  for (int k = threadIdx.x; k < nslot; k += blockDim.x) sdst[k] = dst[b0 * l1 + k];

  for (int c0 = 0; c0 < ch; c0 += ct) {
    const int cn = min(ct, ch - c0);
    const int n = gn * cn * l2;
    zero_tile(tile, n);
    __syncthreads();
    for (int k = threadIdx.x; k < nslot; k += blockDim.x) {
      const int o = sdst[k];
      if (!valid(o, l2)) continue;
      const int g = k / l1;
      const int i = k - g * l1;
      const float* xr = x + ((b0 + g) * ch + c0) * (long long)l1 + i;
      float* tr = tile + g * cn * l2 + o;
      int c = 0;
      for (; c + 8 <= cn; c += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcs(xr + (long long)(c + u) * l1);
#pragma unroll
        for (int u = 0; u < 8; ++u) tr[(c + u) * l2] = v[u];
      }
      for (; c < cn; ++c) tr[c * l2] = __ldcs(xr + (long long)c * l1);
    }
    __syncthreads();
    float* g_out = out + (b0 * ch + c0) * (long long)l2;
    if ((reinterpret_cast<uintptr_t>(g_out) & 15) == 0) {
      const float4* t4 = reinterpret_cast<const float4*>(tile);
      float4* o4 = reinterpret_cast<float4*>(g_out);
      for (int k = threadIdx.x; k < (n >> 2); k += blockDim.x) __stcs(o4 + k, t4[k]);
      for (int k = (n & ~3) + threadIdx.x; k < n; k += blockDim.x) g_out[k] = tile[k];
    } else {
      for (int k = threadIdx.x; k < n; k += blockDim.x) g_out[k] = tile[k];
    }
    __syncthreads();
  }
}

// Block (cells b0 .. b0+gn-1, channels c0 .. c0+cn-1): the input tile
// [gn, cn, l1] is one contiguous run of x, x[(b0*ch + c0)*l1 ...].
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ src,
                   float* __restrict__ out, long long b, int ch, int l1,
                   int l2, int G, int ct) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* tile = reinterpret_cast<float*>(smem + 16);
  int* ssrc = reinterpret_cast<int*>(smem + 16 + align16(4LL * G * ct * l1));
  const long long b0 = (long long)blockIdx.x * G;
  const int gn = (int)min((long long)G, b - b0);
  const int nslot = gn * l2;
  const uint32_t bar_s = smem_addr(bar);
  // 16-byte output stores when every output row starts 16-byte aligned
  const bool vec = (l2 & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int k = threadIdx.x; k < nslot; k += blockDim.x) ssrc[k] = src[b0 * l2 + k];
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  uint32_t phase = 0;
  for (int c0 = 0; c0 < ch; c0 += ct) {
    const int cn = min(ct, ch - c0);
    const int n = gn * cn * l1;
    const float* g_in = x + (b0 * ch + c0) * (long long)l1;
    const uint32_t bytes = 4u * (uint32_t)n;
    if (bytes > 0 && (bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(g_in) & 15) == 0) {
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar_s), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(tile)), "l"(g_in), "r"(bytes), "r"(bar_s)
            : "memory");
      }
      mbar_wait(bar_s, phase);
      phase ^= 1u;
    } else {
      for (int k = threadIdx.x; k < n; k += blockDim.x) tile[k] = __ldcs(g_in + k);
      __syncthreads();
    }
    if (vec) {
      // four neighbouring slots a thread, one 16-byte store per channel
      for (int k = threadIdx.x * 4; k < nslot; k += blockDim.x * 4) {
        const int g = k / l2;
        const int o = k - g * l2;
        const int4 s = *reinterpret_cast<const int4*>(ssrc + k);
        const float* t = tile + g * cn * l1;
        float4* orow = reinterpret_cast<float4*>(out + ((b0 + g) * ch + c0) * (long long)l2 + o);
        for (int c = 0; c < cn; ++c, t += l1) {
          const float4 v = make_float4(valid(s.x, l1) ? t[s.x] : 0.0f,
                                       valid(s.y, l1) ? t[s.y] : 0.0f,
                                       valid(s.z, l1) ? t[s.z] : 0.0f,
                                       valid(s.w, l1) ? t[s.w] : 0.0f);
          __stcs(orow + (long long)c * (l2 / 4), v);
        }
      }
    } else {
      for (int k = threadIdx.x; k < nslot; k += blockDim.x) {
        const int g = k / l2;
        const int o = k - g * l2;
        const int s = ssrc[k];
        float* orow = out + ((b0 + g) * ch + c0) * (long long)l2 + o;
        if (!valid(s, l1)) {
          for (int c = 0; c < cn; ++c) __stcs(orow + (long long)c * l2, 0.0f);
        } else {
          const float* t = tile + g * cn * l1 + s;
          for (int c = 0; c < cn; ++c) __stcs(orow + (long long)c * l2, t[c * l1]);
        }
      }
    }
    __syncthreads();       // every read of the tile precedes the next copy
  }
}

// Cells per block and channels per tile: whole cells (G of them, enough to
// give the block's threads kThreads slots) when one cell's tile and index
// row fit in `budget` bytes, else one cell in ct-channel tiles of near-equal
// size.
// `row` is the bytes of one channel row of the tile, `idx` of one index row.
void plan(long long budget, long long b, int ch, long long row, long long idx, int nslot,
          int* G, int* ct) {
  const long long cell = std::max(1LL, ch * row + idx);
  if (cell <= budget) {
    const long long g = std::min(budget / cell, (long long)((kThreads + nslot - 1) / nslot));
    *G = (int)std::max(1LL, std::min(g, b));
    *ct = ch;
    return;
  }
  *G = 1;
  const long long fit = row > 0 ? std::max(1LL, (budget - idx) / row) : ch;
  const long long tiles = (ch + fit - 1) / fit;
  *ct = (int)((ch + tiles - 1) / tiles);
}

template <typename Kernel>
int launch(Kernel kernel, long long smem, long long b, int G, int nslot,
           cudaStream_t stream, const float* x, const int* idx, float* out,
           int ch, int l1, int l2, int ct) {
  if (b <= 0) return 0;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (b + G - 1) / G;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = std::min(kThreads, std::max(32, ((G * nslot + 31) / 32) * 32));
  kernel<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(x, idx, out, b, ch, l1, l2,
                                                               G, ct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wpt_scatter_rows_f32(const float* x, const int* dst, float* out,
                                    long long b, int ch, int l1, int l2,
                                    void* stream) {
  int G, ct;
  plan(kScatterBudget, b, ch, 4LL * l2, 4LL * l1, std::max(l1, 1), &G, &ct);
  const long long smem = align16(4LL * G * ct * l2) + 4LL * G * l1;
  return launch(scatter_rows_kernel, smem, b, G, l1, (cudaStream_t)stream, x, dst, out,
                ch, l1, l2, ct);
}

extern "C" int wpt_gather_rows_f32(const float* x, const int* src, float* out,
                                   long long b, int ch, int l1, int l2,
                                   void* stream) {
  int G, ct;
  plan(kGatherBudget, b, ch, 4LL * l1, 4LL * l2, std::max(l2, 1), &G, &ct);
  const long long smem = 16 + align16(4LL * G * ct * l1) + 4LL * G * l2;
  return launch(gather_rows_kernel, smem, b, G, l2, (cudaStream_t)stream, x, src, out,
                ch, l1, l2, ct);
}
