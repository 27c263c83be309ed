// The capacity chain's descent for Hopper (sm_90a): kernel A, one level's
// child expansion and window test, and kernel B, the survivors' tile
// keys.
//
// Replaces an XLA program of the JAX package, not a Pallas kernel:
// twophase._sides_for (per level of _stageAB: the bird-curve decode, the
// subtriangle corners, per mip the window origin, its wrap and the
// clamped class-plane lookup, the sides combined over the mips) with
// _stageAB's child expansion and validity (flat' = flat * E + j), and the
// survivor geometry and tile keys of _stageAB's tile sort.  XLA fuses
// each into a few kernels; the port ran them as ~100 torch ops per level.
//
// What bounds it on this card: launch latency.  A level is a few
// thousand to a few hundred thousand lanes, each reading an int64
// parent, six UV floats and one class-plane byte per mip and writing
// 11 bytes: a few MB per batch, about a microsecond of memory traffic.
// The fp32 work is ~50 operations a lane.
//
// What the design does about it: one thread per child lane, and every
// step of the level (expansion, validity against the device count,
// corners, per-mip windows, side, open mask, the partial batch's active
// test) in that thread, so a level is one launch; the tile keys of every
// mip come from one launch that shares each lane's corners.  The count
// is read in the kernel, never on the host, so the launch can be
// captured into the batch's CUDA graph.
//
// Built by omm_tpu_torch/kernels/build.py with -fmad=false (a contracted
// FMA would move a window by a texel) and the exact stage's other flags.
#include <cuda_runtime.h>

#include "chain_math.cuh"

namespace omm_chain {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) descend_kernel(Descend d) {
  int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j < d.n_out) descend_lane(d, j);
}

__global__ void __launch_bounds__(THREADS) keys_kernel(Keys k) {
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < k.n) keys_lane(k, i);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace omm_chain

// Kernel A over n_out child lanes (Descend in chain_math.cuh); side may
// be null when test is 0.
extern "C" int omm_descend_sides(const int64_t* par, const int64_t* count,
                                 int64_t n_par, int64_t n_out, int64_t E,
                                 int level, int test, const uint8_t* active,
                                 int64_t act_span, const float* uv, int nm,
                                 const int64_t* cls, const int* mip_ints,
                                 int8_t* side, int64_t* node, uint8_t* valid,
                                 uint8_t* open, void* stream) {
  using namespace omm_chain;
  Descend d;
  if (!make_mips(nm, cls, mip_ints, d.mips))
    return (int)cudaErrorInvalidValue;
  d.par = par;
  d.count = count;
  d.n_par = n_par;
  d.n_out = n_out;
  d.E = E;
  d.act_span = act_span;
  d.level = level;
  d.test = test;
  d.active = active;
  d.uv = uv;
  d.side = side;
  d.node = node;
  d.valid = valid;
  d.open = open;
  if (n_out > 0)
    descend_kernel<<<blocks_for(n_out), THREADS, 0, (cudaStream_t)stream>>>(
        d);
  return (int)cudaGetLastError();
}

// Kernel B over n survivor lanes: keys (nm, n) int32.
extern "C" int omm_tile_keys(const int64_t* ids, const uint8_t* kvalid,
                             int64_t n, int subdiv, const float* uv, int nm,
                             const int* mip_ints, int32_t* keys,
                             void* stream) {
  using namespace omm_chain;
  Keys k;
  if (!make_mips(nm, nullptr, mip_ints, k.mips))
    return (int)cudaErrorInvalidValue;
  k.ids = ids;
  k.kvalid = kvalid;
  k.n = n;
  k.subdiv = subdiv;
  k.uv = uv;
  k.keys = keys;
  if (n > 0)
    keys_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}

extern "C" const char* omm_chain_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
