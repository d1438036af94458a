// K6: the particle transport's move draw, open-edge drop and within-cell
// class ranks for Hopper (sm_90a), in one pass over the slots.
//
// Replaces no Pallas kernel.  The JAX package computes these in XLA (its
// transport.py: sample_moves, open_boundary_drop and rebucket's ranks, the
// last as a bf16 triangular matmul on the MXU).  The port's plain version
// (ops/moves.py: draw_moves, edge_drop, move_codes, class_ranks) makes one
// full pass over the [C, P] slots for each destination level of the draw and
// one per destination class of the ranks (D = nz + 4), with int64
// temporaries: some 20 GB of device traffic a step on the em_uniform cell
// for work that needs half a gigabyte.
//
// Per slot the kernel does the plain version's float32 work: c1..c4 as the
// same chain of adds (__fadd_rn, never contracted), the face and direction by
// the same comparisons, dest = #{d : u2 >= R_cum[d]} clamped to the column,
// the same direction code and the same drop test, so its codes are bit-equal.
// The ranks and counts are integers.  A class index outside [0, n_class) is
// clamped (the plain gather refuses it).
//
// Bound: device memory.  The least traffic is one read of u, u2, num and
// w_class and one write of dcode and rank_p, 24 bytes a slot, plus each
// cell's face probabilities and R rows and the [C, D] counts.  Design: one
// warp walks one cell's P slots 32 at a time, coalesced, with the next 32
// slots' loads in flight while it works on these.  The face probabilities
// and R row of a slot's class are read through the read-only cache: every
// lane of a cell reads the same few addresses.  The ranks need the slots in
// order: __match_any_sync groups the 32 lanes by code, a lane's rank is its
// class's counter plus the peers below it, and the group's lowest lane adds
// the group's size to the counter.  The D counters of each warp live in
// shared memory sized at launch, so any nz and any P work; at P = 128 a warp
// makes 4 rounds, at 1280 it makes 40.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // cells (warps) a block
constexpr int kStay = -1;        // ops/moves.py: STAY
constexpr int kGone = -2;        // ops/moves.py: GONE
constexpr int kNone = -3;        // a lane past the cell's last slot
constexpr int kMaxSmem = 48 * 1024;

struct Slot {
  float u, u2, num;
  int cls;
};

__device__ __forceinline__ Slot load_slot(const float* __restrict__ u,
                                          const float* __restrict__ u2,
                                          const float* __restrict__ num,
                                          const int* __restrict__ w_class, long long s,
                                          bool in) {
  Slot v{0.f, 0.f, 0.f, 0};
  if (in) {
    v.u = __ldg(u + s);
    v.u2 = __ldg(u2 + s);
    v.num = __ldg(num + s);
    v.cls = __ldg(w_class + s);
  }
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
move_ranks_kernel(const float* __restrict__ u, const float* __restrict__ u2,
                  const float* __restrict__ num, const int* __restrict__ w_class,
                  const float* __restrict__ pxm, const float* __restrict__ pxp,
                  const float* __restrict__ pym, const float* __restrict__ pyp,
                  const float* __restrict__ r_cum, int* __restrict__ dcode,
                  int* __restrict__ rank_p, float* __restrict__ cnt, long long cells,
                  int n_class, int nz, int ny, int nx, int P, int iy0, int ix0, int ny_g,
                  int nx_g, int open_y, int open_x) {
  extern __shared__ int counters[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long cell = (long long)blockIdx.x * kWarps + warp;
  if (cell >= cells) return;       // the whole warp leaves together
  const int D = nz + 4;
  int* ctr = counters + warp * D;
  for (int d = lane; d < D; d += 32) ctr[d] = 0;
  __syncwarp();

  const int x = (int)(cell % nx);
  const int y = (int)((cell / nx) % ny);
  const int k = (int)(cell / ((long long)nx * ny));
  // one class's face probabilities span the cells; its R rows are
  // [ny, nx, src, dst], and this cell reads row (y, x, k)
  const long long rcol = (((long long)y * nx + x) * nz + k) * nz;
  const long long rclass = (long long)ny * nx * nz * nz;
  const unsigned below = (1u << lane) - 1u;
  const long long first = cell * P;

  Slot cur = load_slot(u, u2, num, w_class, first + lane, lane < P);
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    const bool in = p < P;
    const Slot next = load_slot(u, u2, num, w_class, first + p + 32, p + 32 < P);
    int code = kNone;
    if (in) {
      const int c = min(max(cur.cls, 0), n_class - 1);
      const long long f = c * cells + cell;
      const float c1 = __ldg(pxm + f);
      const float c2 = __fadd_rn(c1, __ldg(pxp + f));
      const float c3 = __fadd_rn(c2, __ldg(pym + f));
      const float c4 = __fadd_rn(c3, __ldg(pyp + f));
      const float v = cur.u;
      const int di = v < c1 ? -1 : (v < c2 ? 1 : 0);
      const int dj = (v >= c2 && v < c3) ? -1 : ((v >= c3 && v < c4) ? 1 : 0);
      const bool horiz = v < c4;
      const float* row = r_cum + c * rclass + rcol;
      int dest = 0;
      for (int d = 0; d < nz; ++d) dest += cur.u2 >= __ldg(row + d) ? 1 : 0;
      dest = min(max(dest, 0), nz - 1);
      bool drop = false;
      if (open_x) {
        const int gi = ix0 + x + di;
        drop = drop || (horiz && (gi < 0 || gi >= nx_g));
      }
      if (open_y) {
        const int gj = iy0 + y + dj;
        drop = drop || (horiz && (gj < 0 || gj >= ny_g));
      }
      const int hdir = di < 0 ? 0 : (di > 0 ? 1 : (dj < 0 ? 2 : 3));
      const int moved = (!horiz && dest != k) ? dest : (horiz ? nz + hdir : kStay);
      code = (cur.num > 0.f && !drop) ? moved : kGone;
    }
    // every lane reads its class's counter before the group's lowest lane
    // moves it on
    const unsigned peers = __match_any_sync(0xffffffffu, code);
    const int before = code >= 0 ? ctr[code] : 0;
    __syncwarp();
    if (code >= 0 && lane == __ffs(peers) - 1) ctr[code] = before + __popc(peers);
    __syncwarp();
    if (in) {
      dcode[first + p] = code;
      rank_p[first + p] = code >= 0 ? before + __popc(peers & below) : 0;
    }
    cur = next;
  }
  for (int d = lane; d < D; d += 32) cnt[cell * D + d] = (float)ctr[d];
}

}  // namespace

extern "C" int wpt_move_ranks(const float* u, const float* u2, const float* num,
                              const int* w_class, const float* pxm, const float* pxp,
                              const float* pym, const float* pyp, const float* r_cum,
                              int* dcode, int* rank_p, float* cnt, long long cells,
                              int n_class, int nz, int ny, int nx, int P, int iy0, int ix0,
                              int ny_g, int nx_g, int open_y, int open_x, void* stream) {
  if (cells <= 0) return 0;
  if (n_class < 1 || nz < 1 || ny < 1 || nx < 1 || P < 0 ||
      cells != (long long)nz * ny * nx)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (cells + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kWarps * (nz + 4) * sizeof(int);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  move_ranks_kernel<<<(unsigned)blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      u, u2, num, w_class, pxm, pxp, pym, pyp, r_cum, dcode, rank_p, cnt, cells, n_class,
      nz, ny, nx, P, iy0, ix0, ny_g, nx_g, open_y, open_x);
  return (int)cudaGetLastError();
}
