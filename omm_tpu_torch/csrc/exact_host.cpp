// Host driver of the exact stage's math (exact_math.cuh).
//
// Walks each block in the order of exact_classify.cu's kernel: the
// geometry of the block's B slots first, then the window texels in
// chunks of LIST_TEXELS x B (slot, texel) pairs: each chunk compacted to
// the list of pairs inside the conservative mask, their corner tests,
// the list of pairs those leave open, and their edge tests, increments
// going to per-slot counters; then the seeds.  Reads come from a copy of
// the block's TSA x TSA region (zero past the padded plane), which gives
// what the kernel's fetch gives.  The CPU tests build this
// file with g++ (-ffp-contract=off, __host__/__device__ defined empty)
// and require its counts to equal the torch twin's bit for bit, which
// tests the kernel's arithmetic and its decomposition without a card.
#include <vector>

#include "exact_math.cuh"

namespace {

using namespace omm_exact;

struct RegionFetch {
  const float* R;
  int TSA;
  float operator()(int ry, int rx) const {
    return (ry >= 0 && ry < TSA && rx >= 0 && rx < TSA) ? R[ry * TSA + rx]
                                                        : 0.f;
  }
};

void stage_region(const float* plane, const Params& p, int bt,
                  std::vector<float>& R) {
  int y_base = (bt / p.ntx) * TILE, x_base = (bt % p.ntx) * TILE;
  for (int r = 0; r < p.TSA; ++r)
    for (int c = 0; c < p.TSA; ++c) {
      int gy = y_base + r, gx = x_base + c;
      R[r * p.TSA + c] =
          (gy < p.Hp && gx < p.Wp) ? plane[(size_t)gy * p.Wp + gx] : 0.f;
    }
}

}  // namespace

extern "C" int omm_exact_host(const float* plane, int Hp, int Wp,
                              const int* block_tile, const int* ids,
                              int nblk, const float* uv6, const int* ccw,
                              int subdiv, int pad, int ntx, int w, int h,
                              int Pw, int Ph, int H, int W, float rcp_x,
                              float rcp_y, float cutoff, int* above,
                              int* below) {
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
  std::vector<float> R((size_t)p.TSA * p.TSA);
  std::vector<SlotGeom> g(B);
  std::vector<char> valid(B);
  std::vector<int> list, edge_list;
  int have = -1;
  for (int blk = 0; blk < nblk; ++blk) {
    int bt = block_tile[blk];
    if (bt != have) {  // staged again when the tile changes
      stage_region(plane, p, bt, R);
      have = bt;
    }
    RegionFetch fetch{R.data(), p.TSA};
    int a_cnt[B], b_cnt[B];
    for (int s = 0; s < B; ++s) {
      int id = ids[blk * B + s];
      valid[s] = id >= 0;
      a_cnt[s] = b_cnt[s] = 0;
      if (valid[s]) slot_geometry(p, id, bt, uv6, ccw, g[s]);
    }
    for (int t0 = 0; t0 < H * W; t0 += LIST_TEXELS) {
      int t1 = t0 + LIST_TEXELS < H * W ? t0 + LIST_TEXELS : H * W;
      list.clear();
      for (int t = t0; t < t1; ++t) {
        int dy = t / W, dx = t % W;
        for (int s = 0; s < B; ++s) {
          const SlotGeom& q = g[s];
          if (valid[s] && texel_covered(q.nx, q.ny, q.cc, q.bx, q.by,
                                        q.x0 + dx, q.y0 + dy, q.x1, q.y1))
            list.push_back(s | (dx << 7) | (dy << 14));
        }
      }
      edge_list.clear();
      for (int pass = 0; pass < 2; ++pass) {  // corner tests, edge tests
        for (int v : pass ? edge_list : list) {
          int s = v & (B - 1), dx = (v >> 7) & 127, dy = v >> 14;
          const SlotGeom& q = g[s];
          Tri tri = make_tri(q.mx, q.my);
          int ry = q.oy + dy, rx = q.ox + dx;
          float gx = fetch(ry, rx), gy = fetch(ry + 1, rx),
                gz = fetch(ry + 1, rx + 1), gw = fetch(ry, rx + 1);
          if (pass)
            texel_edges(p, tri, q.x0 + dx, q.y0 + dy, gx, gy, gz, gw,
                        a_cnt[s], b_cnt[s]);
          else if (texel_corners(p, tri, q.x0 + dx, q.y0 + dy, gx, gy, gz,
                                 gw, a_cnt[s], b_cnt[s]))
            edge_list.push_back(v);
        }
      }
    }
    for (int s = 0; s < B; ++s) {
      if (valid[s])
        slot_seed(p, g[s].x0, g[s].y0, g[s].ox, g[s].oy, g[s].mx[0],
                  g[s].my[0], fetch, a_cnt[s], b_cnt[s]);
      above[blk * B + s] = a_cnt[s];
      below[blk * B + s] = b_cnt[s];
    }
  }
  return 0;
}
