// Host driver of the exact stage's per-slot math (exact_math.cuh).
//
// Loops over blocks and slots the way exact_classify.cu's kernel does,
// reading each block's region straight from the padded plane.  The CPU
// tests build it with g++ (-ffp-contract=off, __host__/__device__ defined
// empty) and require its counts to equal the torch twin's bit for bit,
// which tests the kernel's arithmetic without a card.
#include "exact_math.cuh"

namespace {

struct PlaneFetch {
  const float* plane;
  int Hp, Wp, TSA, y_base, x_base;
  float operator()(int ry, int rx) const {
    if (ry < 0 || ry >= TSA || rx < 0 || rx >= TSA) return 0.f;
    int gy = y_base + ry, gx = x_base + rx;
    if (gy >= Hp || gx >= Wp) return 0.f;
    return plane[(size_t)gy * Wp + gx];
  }
};

}  // namespace

extern "C" int omm_exact_host(const float* plane, int Hp, int Wp,
                              const int* block_tile, const int* ids,
                              int nblk, const float* uv6, const int* ccw,
                              int subdiv, int pad, int ntx, int w, int h,
                              int Pw, int Ph, int H, int W, float rcp_x,
                              float rcp_y, float cutoff, int* above,
                              int* below) {
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
  for (int blk = 0; blk < nblk; ++blk) {
    int bt = block_tile[blk];
    PlaneFetch fetch{plane, Hp, Wp, p.TSA, (bt / ntx) * TILE,
                     (bt % ntx) * TILE};
    for (int i = 0; i < B; ++i) {
      int s = blk * B + i;
      classify_slot(p, ids[s], bt, uv6, ccw, fetch, above[s], below[s]);
    }
  }
  return 0;
}
