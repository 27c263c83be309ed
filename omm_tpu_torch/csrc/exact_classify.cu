// Exact micro-triangle classification for Hopper (sm_90a).
//
// Replaces the JAX package's only TPU kernel, pallas_classify._kernel_v3
// (derive_slot_geometry + _kernel_body): per survivor slot, decode the
// flat id t*M + m, compute the micro-triangle's corners by the bird
// curve, derive its raster window, run the conservative edge test over
// the window's texels and the level-line increments on covered texels,
// add the bilinear seed at corner p0, and write the above/below counts.
//
// What bounds it on this card: per-thread fp32 arithmetic, with IEEE
// sqrt and division (up to 6 sqrt and 3 divisions per edge test, three
// edge tests per covered texel).  Texel traffic is small: one block's
// shared tile is TSA x TSA fp32, 19.6 KB at TSA = 70 for 128 slots, and
// each slot reads at most (H+2) x (W+2) texels of it.
//
// What the design does about it: one thread block per 128-slot block,
// one thread per slot.  The slot stream is sorted by texel tile, so a
// block stages its tile once into shared memory (coalesced rows, zero
// past the padded plane's edge) and its threads read their windows from
// there, not from device memory.  Each thread skips texels outside its
// conservative mask and stops a texel's edge tests at the first hit,
// which the TPU's dense lane layout could not.  The TPU's one-hot MXU
// gathers and bf16x3 split have no counterpart: shared memory serves the
// gathers directly.
//
// Built by omm_tpu_torch/kernels/build.py with -fmad=false, -prec-div=true,
// -prec-sqrt=true and -ftz=false: a contracted FMA or an approximate sqrt
// would change the fp32 results that decide the states.
#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace omm_exact {

struct SmemFetch {
  const float* tile;
  int TSA;
  __host__ __device__ __forceinline__ float operator()(int ry, int rx) const {
    return (ry >= 0 && ry < TSA && rx >= 0 && rx < TSA) ? tile[ry * TSA + rx]
                                                        : 0.f;
  }
};

__global__ void __launch_bounds__(B)
    exact_classify_kernel(Params p, const float* __restrict__ plane,
                          const int* __restrict__ block_tile,
                          const int* __restrict__ ids,
                          const float* __restrict__ uv6,
                          const int* __restrict__ ccw, int* __restrict__ above,
                          int* __restrict__ below) {
  extern __shared__ float tile[];
  const int blk = blockIdx.x;
  const int bt = block_tile[blk];
  const int y_base = (bt / p.ntx) * TILE;
  const int x_base = (bt % p.ntx) * TILE;
  const int n = p.TSA * p.TSA;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int gy = y_base + i / p.TSA;
    int gx = x_base + i % p.TSA;
    tile[i] = (gy < p.Hp && gx < p.Wp) ? plane[(size_t)gy * p.Wp + gx] : 0.f;
  }
  __syncthreads();
  const SmemFetch fetch{tile, p.TSA};
  const int s = blk * B + threadIdx.x;
  int a, b;
  classify_slot(p, ids[s], bt, uv6, ccw, fetch, a, b);
  above[s] = a;
  below[s] = b;
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
  size_t smem = (size_t)p.TSA * p.TSA * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        exact_classify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  exact_classify_kernel<<<nblk, B, smem, (cudaStream_t)stream>>>(
      p, plane, block_tile, ids, uv6, ccw, above, below);
  return (int)cudaGetLastError();
}

extern "C" const char* omm_exact_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
