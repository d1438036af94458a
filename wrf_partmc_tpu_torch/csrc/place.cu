// Particle row placement for Hopper (sm_90a): batched row scatter and gather
// over a channel-first payload [B, CH, L].
//
// Replace the Pallas TPU kernels of wrf_partmc_tpu/ops/place.py:
//   _scatter_kernel (via _scatter_rows_pallas)  out[b,:,dst[b,i]] = x[b,:,i]
//   _gather_kernel  (via _gather_rows_pallas)   out[b,:,o] = x[b,:,src[b,o]]
// The TPU kernels move rows as bf16x3 one-hot matmuls on the MXU because
// XLA gathers were slow there; on Hopper these are plain indexed copies,
// exact to the bit.
//
// Bound: device memory, one read and one write of every moved float (plus
// the int32 index row).  Design: a 1-D grid of nblk blocks per batch row
// (cell), cell-major, so the slot blocks of one cell run together and a
// grid holds up to 2^31 - 1 blocks (a 2-D grid with the cell on y stops at
// 65,535 cells; with the cell on x the blocks of a cell run far apart and
// the scatter's partial-sector writes to its row miss L2).  Threads run
// along the slot axis, and each thread loops over the CH channels.  For the
// scatter the reads x[b,c,i] of a warp are coalesced and the writes go to
// data-dependent slots of the same cell row (a few KB, L2 resident); for
// the gather the writes are coalesced and the reads land inside one cell's
// row.  The scatter writes into an output the caller zeroed; a dst of -1 (or
// out of range) drops the row, a src of -1 (or out of range) writes zeros.

#include <cuda_runtime.h>

namespace {

__global__ void scatter_rows_kernel(const float* __restrict__ x,
                                    const int* __restrict__ dst,
                                    float* __restrict__ out, int ch, int l1,
                                    int l2, int nblk) {
  const long long bb = blockIdx.x / nblk;
  const int i = (blockIdx.x % nblk) * blockDim.x + threadIdx.x;
  if (i >= l1) return;
  const int o = dst[bb * l1 + i];
  if (o < 0 || o >= l2) return;
  const float* xr = x + bb * (long long)ch * l1 + i;
  float* orow = out + bb * (long long)ch * l2 + o;
  for (int c = 0; c < ch; ++c) orow[(long long)c * l2] = xr[(long long)c * l1];
}

__global__ void gather_rows_kernel(const float* __restrict__ x,
                                   const int* __restrict__ src,
                                   float* __restrict__ out, int ch, int l1,
                                   int l2, int nblk) {
  const long long bb = blockIdx.x / nblk;
  const int o = (blockIdx.x % nblk) * blockDim.x + threadIdx.x;
  if (o >= l2) return;
  const int s = src[bb * l2 + o];
  float* orow = out + bb * (long long)ch * l2 + o;
  if (s < 0 || s >= l1) {
    for (int c = 0; c < ch; ++c) orow[(long long)c * l2] = 0.0f;
    return;
  }
  const float* xr = x + bb * (long long)ch * l1 + s;
  for (int c = 0; c < ch; ++c) orow[(long long)c * l2] = xr[(long long)c * l1];
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int wpt_scatter_rows_f32(const float* x, const int* dst, float* out,
                                    long long b, int ch, int l1, int l2,
                                    void* stream) {
  const int nblk = (l1 + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<(unsigned)(b * nblk), kThreads, 0,
                        (cudaStream_t)stream>>>(x, dst, out, ch, l1, l2, nblk);
  return (int)cudaGetLastError();
}

extern "C" int wpt_gather_rows_f32(const float* x, const int* src, float* out,
                                   long long b, int ch, int l1, int l2,
                                   void* stream) {
  const int nblk = (l2 + kThreads - 1) / kThreads;
  gather_rows_kernel<<<(unsigned)(b * nblk), kThreads, 0,
                       (cudaStream_t)stream>>>(x, src, out, ch, l1, l2, nblk);
  return (int)cudaGetLastError();
}
