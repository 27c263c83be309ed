// Exact micro-triangle classification for Hopper (sm_90a).
//
// Replaces the JAX package's only TPU kernel, pallas_classify._kernel_v3
// (derive_slot_geometry + _kernel_body): per survivor slot, decode the
// flat id t*M + m, compute the micro-triangle's corners by the bird
// curve, derive its raster window, run the conservative edge test over
// the window's texels and the level-line increments on covered texels,
// add the bilinear seed at corner p0, and write the above/below counts.
//
// What bounds it on this card: fp32 arithmetic with IEEE sqrt and
// division (up to 6 sqrt and 3 divisions per edge test, three edge tests
// per texel), on data-dependent paths.  On the benchmark's slot streams
// about a quarter of the window texels are covered, and a sixth of
// those reach the edge tests; a thread that follows one slot through
// its window runs all of those paths in turn, and its warp waits for
// the slowest.  Bytes are few: slot ids, counts, and the texels under
// the slots' windows (tens of thousands per stream).
//
// What the design does about it: one thread block of B threads per
// block of B slots, in passes that each give the warps uniform work:
//   1. geometry: each thread derives its slot's corners, window, edge
//      functions and region offset; what other threads need goes to
//      shared memory;
//   2. per chunk of LIST_TEXELS window texels:
//      a. each thread tests its slot's texels against the conservative
//         mask; warp ballots compact the covered (slot, texel) pairs
//         into a shared list;
//      b. the threads take the listed pairs, 32 to a warp, and run the
//         corner tests; the pairs they leave open go, by a second
//         ballot, to a second list;
//      c. the threads run the edge tests of that list, 32 to a warp;
//      increments go to per-slot shared counters by integer atomics
//      (order-free, so the counts are exact and deterministic);
//   3. seed: each thread adds its slot's seed and writes its counts.
// Small blocks keep every warp busy in every pass and leave room for
// several blocks on each SM, whose passes interleave.  Texels are read
// from the padded plane through the L1 cache: a block's slots read a few
// hundred distinct texels, far fewer than its 64-texel tile's region.
// A slot whose window lies inside its tile's region and the plane
// (every slot of a stream built by twophase.slot_stream) reads without
// bounds checks; any other reads through the checked fetch, which gives
// 0.0 outside the region or past the plane, as the twin does.
//
// Built by omm_tpu_torch/kernels/build.py with -fmad=false, -prec-div=true,
// -prec-sqrt=true and -ftz=false: a contracted FMA or an approximate sqrt
// would change the fp32 results that decide the states.
#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace omm_exact {

constexpr int MIN_BLOCKS = 8;          // resident blocks per SM asked of ptxas
constexpr int LIST = LIST_TEXELS * B;  // (slot, texel) pairs per chunk
// per-slot fields in shared memory, one array of B each
enum { I_X0, I_Y0, I_X1, I_Y1, I_OX, I_OY, I_IN, NI };
enum { F_NX = 0, F_NY = 3, F_CC = 6, F_BX = 9, F_BY = 12, F_MX = 15,
       F_MY = 18, NF = 21 };

struct Shared {
  int gi[NI * B];
  float gf[NF * B];
  unsigned list[LIST], edge_list[LIST];
  int cnt_a[B], cnt_b[B];
  int n_list, n_edge;
};

// The block's view of the padded plane: its tile's region starts at
// (y_base, x_base); fetch(ry, rx) reads region texel (ry, rx), 0.0
// outside [0, TSA)^2 or past the plane.
struct RegionFetch {
  const float* plane;
  int Hp, Wp, TSA, y_base, x_base;
  __host__ __device__ __forceinline__ float operator()(int ry,
                                                      int rx) const {
    const int gy = y_base + ry, gx = x_base + rx;
    return ((unsigned)ry < (unsigned)TSA && (unsigned)rx < (unsigned)TSA &&
            gy < Hp && gx < Wp)
               ? plane[(size_t)gy * Wp + gx]
               : 0.f;
  }
  // the quad (c00, c01, c11, c10) at region texel (ry, rx); unchecked
  // when the caller knows the slot's window lies inside
  __device__ __forceinline__ void quad(int ry, int rx, bool inside, float& x,
                                       float& y, float& z, float& w) const {
    if (inside) {
      const float* q = plane + (size_t)(y_base + ry) * Wp + x_base + rx;
      x = __ldg(q);
      w = __ldg(q + 1);
      y = __ldg(q + Wp);
      z = __ldg(q + Wp + 1);
    } else {
      x = (*this)(ry, rx);
      y = (*this)(ry + 1, rx);
      z = (*this)(ry + 1, rx + 1);
      w = (*this)(ry, rx + 1);
    }
  }
};

// Append `v` to list[*n] for every lane whose `take` is set (all 32
// lanes of the warp must call it).
__device__ __forceinline__ void push(unsigned* list, int* n, bool take,
                                     unsigned v) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xffffffffu, take);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (take) list[base + __popc(m & ((1u << lane) - 1u))] = v;
}

__device__ __forceinline__ unsigned pair(int slot, int dx, int dy) {
  return (unsigned)(slot | (dx << 7) | (dy << 14));
}

__global__ void __launch_bounds__(B, MIN_BLOCKS)
    exact_classify_kernel(Params p, const float* __restrict__ plane,
                          const int* __restrict__ block_tile,
                          const int* __restrict__ ids,
                          const float* __restrict__ uv6,
                          const int* __restrict__ ccw, int* __restrict__ above,
                          int* __restrict__ below) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, blk = blockIdx.x;
  const int bt = block_tile[blk];
  const RegionFetch fetch{plane, p.Hp, p.Wp, p.TSA,
                          (bt / p.ntx) * TILE, (bt % p.ntx) * TILE};

  // ---- pass 1: this thread's slot, into shared memory ----
  {
    const int id = ids[blk * B + tid];
    SlotGeom g;
    int inside = -1;  // -1 empty slot, 0 checked reads, 1 unchecked reads
    if (id >= 0) {
      slot_geometry(p, id, bt, uv6, ccw, g);
      inside = g.ox >= 0 && g.oy >= 0 && g.ox + p.W + 2 <= p.TSA &&
               g.oy + p.H + 2 <= p.TSA &&
               fetch.y_base + g.oy + p.H + 2 <= p.Hp &&
               fetch.x_base + g.ox + p.W + 2 <= p.Wp;
    } else {
      g.x0 = g.y0 = g.x1 = g.y1 = g.ox = g.oy = 0;  // covers nothing
    }
    sh.gi[I_X0 * B + tid] = g.x0;
    sh.gi[I_Y0 * B + tid] = g.y0;
    sh.gi[I_X1 * B + tid] = g.x1;
    sh.gi[I_Y1 * B + tid] = g.y1;
    sh.gi[I_OX * B + tid] = g.ox;
    sh.gi[I_OY * B + tid] = g.oy;
    sh.gi[I_IN * B + tid] = inside;
    if (id >= 0) {
      for (int e = 0; e < 3; ++e) {
        sh.gf[(F_NX + e) * B + tid] = g.nx[e];
        sh.gf[(F_NY + e) * B + tid] = g.ny[e];
        sh.gf[(F_CC + e) * B + tid] = g.cc[e];
        sh.gf[(F_BX + e) * B + tid] = g.bx[e];
        sh.gf[(F_BY + e) * B + tid] = g.by[e];
        sh.gf[(F_MX + e) * B + tid] = g.mx[e];
        sh.gf[(F_MY + e) * B + tid] = g.my[e];
      }
    }
    sh.cnt_a[tid] = 0;
    sh.cnt_b[tid] = 0;
    if (tid == 0) sh.n_list = sh.n_edge = 0;
  }
  __syncthreads();

  // ---- pass 2: the window's texels, LIST_TEXELS at a time ----
  const int HW = p.H * p.W;
  int dx = 0, dy = 0;
  for (int t0 = 0; t0 < HW; t0 += LIST_TEXELS) {
    const int t1 = min(t0 + LIST_TEXELS, HW);
    // a. conservative mask of this thread's slot (a warp-uniform loop)
    float nx[3], ny[3], cc[3], bx[3], by[3];
    for (int e = 0; e < 3; ++e) {
      nx[e] = sh.gf[(F_NX + e) * B + tid];
      ny[e] = sh.gf[(F_NY + e) * B + tid];
      cc[e] = sh.gf[(F_CC + e) * B + tid];
      bx[e] = sh.gf[(F_BX + e) * B + tid];
      by[e] = sh.gf[(F_BY + e) * B + tid];
    }
    const int x0 = sh.gi[I_X0 * B + tid], y0 = sh.gi[I_Y0 * B + tid];
    const int x1 = sh.gi[I_X1 * B + tid], y1 = sh.gi[I_Y1 * B + tid];
    const bool live = sh.gi[I_IN * B + tid] >= 0;
    for (int t = t0; t < t1; ++t) {
      const bool in = live && texel_covered(nx, ny, cc, bx, by, x0 + dx,
                                            y0 + dy, x1, y1);
      push(sh.list, &sh.n_list, in, pair(tid, dx, dy));
      if (++dx == p.W) {
        dx = 0;
        ++dy;
      }
    }
    __syncthreads();
    // b. corner tests of the covered pairs; open ones to the edge list
    const int n = sh.n_list;
    for (int k0 = 0; k0 < n; k0 += B) {  // warp-uniform: push needs all lanes
      const int k = k0 + tid;
      bool open = false;
      unsigned v = 0;
      if (k < n) {
        v = sh.list[k];
        const int s = v & (B - 1), ddx = (v >> 7) & 127, ddy = v >> 14;
        float mx[3], my[3];
        for (int e = 0; e < 3; ++e) {
          mx[e] = sh.gf[(F_MX + e) * B + s];
          my[e] = sh.gf[(F_MY + e) * B + s];
        }
        float qx, qy, qz, qw;
        fetch.quad(sh.gi[I_OY * B + s] + ddy, sh.gi[I_OX * B + s] + ddx,
                   sh.gi[I_IN * B + s] > 0, qx, qy, qz, qw);
        int a = 0, b = 0;
        open = texel_corners(p, make_tri(mx, my), sh.gi[I_X0 * B + s] + ddx,
                             sh.gi[I_Y0 * B + s] + ddy, qx, qy, qz, qw, a,
                             b);
        if (a) atomicAdd(&sh.cnt_a[s], a);
        if (b) atomicAdd(&sh.cnt_b[s], b);
      }
      push(sh.edge_list, &sh.n_edge, open, v);
    }
    __syncthreads();
    // c. edge tests of the open pairs
    const int m = sh.n_edge;
    if (tid == 0) sh.n_list = 0;  // every thread has read it
    for (int k = tid; k < m; k += B) {
      const unsigned v = sh.edge_list[k];
      const int s = v & (B - 1), ddx = (v >> 7) & 127, ddy = v >> 14;
      float mx[3], my[3];
      for (int e = 0; e < 3; ++e) {
        mx[e] = sh.gf[(F_MX + e) * B + s];
        my[e] = sh.gf[(F_MY + e) * B + s];
      }
      float qx, qy, qz, qw;
      fetch.quad(sh.gi[I_OY * B + s] + ddy, sh.gi[I_OX * B + s] + ddx,
                 sh.gi[I_IN * B + s] > 0, qx, qy, qz, qw);
      int a = 0, b = 0;
      texel_edges(p, make_tri(mx, my), sh.gi[I_X0 * B + s] + ddx,
                  sh.gi[I_Y0 * B + s] + ddy, qx, qy, qz, qw, a, b);
      if (a) atomicAdd(&sh.cnt_a[s], a);
      if (b) atomicAdd(&sh.cnt_b[s], b);
    }
    __syncthreads();
    if (tid == 0) sh.n_edge = 0;  // read by all before the barrier
  }

  // ---- pass 3: this thread's seed and counts ----
  int a = 0, b = 0;
  if (sh.gi[I_IN * B + tid] >= 0) {
    a = sh.cnt_a[tid];
    b = sh.cnt_b[tid];
    slot_seed(p, sh.gi[I_X0 * B + tid], sh.gi[I_Y0 * B + tid],
              sh.gi[I_OX * B + tid], sh.gi[I_OY * B + tid],
              sh.gf[F_MX * B + tid], sh.gf[F_MY * B + tid], fetch, a, b);
  }
  above[blk * B + tid] = a;
  below[blk * B + tid] = b;
}

cudaError_t blocks_per_sm(int* n) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, exact_classify_kernel,
                                                       B, 0);
}

}  // namespace omm_exact

extern "C" int omm_exact_classify(const float* plane, int Hp, int Wp,
                                  const int* block_tile, const int* ids,
                                  int nblk, const float* uv6, const int* ccw,
                                  int subdiv, int pad, int ntx, int w, int h,
                                  int Pw, int Ph, int H, int W, float rcp_x,
                                  float rcp_y, float cutoff, int* above,
                                  int* below, void* stream) {
  using namespace omm_exact;
  Params p;
  p.subdiv = subdiv;
  p.pad = pad;
  p.ntx = ntx;
  p.w = w;
  p.h = h;
  p.Pw = Pw;
  p.Ph = Ph;
  p.H = H;
  p.W = W;
  p.TSA = TILE + (H > W ? H : W) + 2;
  p.Hp = Hp;
  p.Wp = Wp;
  p.rcp_x = rcp_x;
  p.rcp_y = rcp_y;
  p.cutoff = cutoff;
  exact_classify_kernel<<<nblk, B, 0, (cudaStream_t)stream>>>(
      p, plane, block_tile, ids, uv6, ccw, above, below);
  return (int)cudaGetLastError();
}

// The launch's shape: threads and resident blocks per SM, and shared
// memory per block (bytes); H and W do not change it.
extern "C" int omm_exact_shape(int H, int W, int* threads, int* per_sm,
                               int* smem) {
  (void)H;
  (void)W;
  *threads = omm_exact::B;
  *smem = (int)sizeof(omm_exact::Shared);
  return (int)omm_exact::blocks_per_sm(per_sm);
}

extern "C" const char* omm_exact_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
