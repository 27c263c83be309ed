// Per-lane math of the capacity chain's descent and tile-slot assignment.
//
// Shared by the CUDA kernels (chain_descend.cu, chain_slots.cu) and their
// host build (chain_host.cpp, which walks the lanes in order; the CPU
// tests compile it with g++ and hold it against the plain torch versions
// in omm_tpu_torch/kernels/chain.py).  Every function keeps the fp32
// operation order of the JAX package's twophase._sides_for,
// _window_origin and pallas_classify.bary_cols / corner_cols (and of the
// port's bird_torch); results are bit-exact only when built without FMA
// contraction (nvcc -fmad=false; g++ -ffp-contract=off).
#pragma once

#include <math.h>
#include <stdint.h>

#include "exact_math.cuh"

namespace omm_chain {

using omm_exact::B;
using omm_exact::TILE;
using omm_exact::floor_mod;
using omm_exact::index2dbary;

constexpr int MAX_MIPS = 16;
// tile key of an invalid survivor lane (sorts after every real tile) and
// the slot of one (past every block capacity): twophase's values
constexpr int32_t INVALID_TILE = 0x7FFFFF00;
constexpr int64_t SENTINEL = 0x7FFFFF00;

// One mip's geometry; `cls` is the class plane of the level being tested
// (the descent only).
struct Mip {
  const int8_t* cls;
  int H2, W2;    // class plane size
  int w, h;      // mip size
  int pad, ntx;  // plane padding, tiles per padded row
  int Pw, Ph;    // address-mode period, 0 = aperiodic
};

struct Mips {
  int n;
  Mip m[MAX_MIPS];
};

// Mips from a wrapper's host arrays: per mip its class plane's address
// (cls null, or 0: none) and 8 ints (H2, W2, w, h, pad, ntx, Pw, Ph).
inline bool make_mips(int nm, const int64_t* cls, const int* v, Mips& out) {
  if (nm < 1 || nm > MAX_MIPS) return false;
  out.n = nm;
  for (int i = 0; i < nm; ++i) {
    const int* p = v + 8 * i;
    out.m[i] = Mip{(const int8_t*)(cls ? cls[i] : 0), p[0], p[1], p[2],
                   p[3],  p[4], p[5], p[6], p[7]};
  }
  return true;
}

__host__ __device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// bary_cols: (u, v, d) of curve index `index` at `level`; the corners are
// (u, v), (u + d, v), (u, v + d).
__host__ __device__ __forceinline__ void bary_cols(uint32_t index, int level,
                                                   float& bu, float& bv,
                                                   float& bd) {
  uint32_t iu, iv, iw;
  index2dbary(index, iu, iv, iw);
  uint32_t lm = (1u << level) - 1u;
  iu &= lm;
  iv &= lm;
  iw &= lm;
  bool upright = ((iu & 1u) ^ (iv & 1u) ^ (iw & 1u)) != 0u;
  if (!upright) {
    iu += 1u;
    iv += 1u;
  }
  float ls = ldexpf(1.f, -level);
  bd = upright ? ls : -ls;
  bu = (float)(int)iu * ls;
  bv = (float)(int)iv * ls;
}

struct Corners {
  float x[3], y[3];
};

// corner_cols: p = p0*(1-u-v) + p1*u + p2*v at the three corners.
__host__ __device__ __forceinline__ void corner_cols(const float* u6, float bu,
                                                     float bv, float bd,
                                                     Corners& c) {
  float cu[3] = {bu, bu + bd, bu};
  float cv[3] = {bv, bv, bv + bd};
  for (int k = 0; k < 3; ++k) {
    float w_ = 1.f - cu[k] - cv[k];
    c.x[k] = u6[0] * w_ + u6[2] * cu[k] + u6[4] * cv[k];
    c.y[k] = u6[1] * w_ + u6[3] * cu[k] + u6[5] * cv[k];
  }
}

// Corners of the subtriangle `index` at `level` of the item whose six UV
// floats start at u6.
__host__ __device__ __forceinline__ void sub_corners(const float* u6,
                                                     uint32_t index,
                                                     int level, Corners& c) {
  float bu, bv, bd;
  bary_cols(index, level, bu, bv, bd);
  corner_cols(u6, bu, bv, bd, c);
}

// window_origin + wrap_origin: floor(min corner * size - 0.5), wrapped
// into the canonical period where the mode has one.
__host__ __device__ __forceinline__ void window_origin(const Corners& c,
                                                       const Mip& m, int& x0,
                                                       int& y0) {
  float wf = (float)m.w, hf = (float)m.h;
  float qxm = fminf(fminf(c.x[0], c.x[1]), c.x[2]) * wf - 0.5f;
  float qym = fminf(fminf(c.y[0], c.y[1]), c.y[2]) * hf - 0.5f;
  x0 = (int)floorf(qxm);
  y0 = (int)floorf(qym);
  if (m.Pw) {
    x0 = floor_mod(x0, m.Pw);
    y0 = floor_mod(y0, m.Ph);
  }
}

// Exact-stage tile id of a (wrapped) window origin.
__host__ __device__ __forceinline__ int32_t tile_of(int x0, int y0,
                                                    const Mip& m) {
  return (int32_t)(floor_div((int64_t)y0 + m.pad, TILE) * m.ntx +
                   floor_div((int64_t)x0 + m.pad, TILE));
}

// The class plane at the window anchor (x0 - 1 + pad, y0 - 1 + pad),
// clamped per axis as XLA's gather clamps.
__host__ __device__ __forceinline__ int8_t class_at(const Mip& m, int x0,
                                                    int y0) {
  int64_t yy = (int64_t)y0 - 1 + m.pad;
  int64_t xx = (int64_t)x0 - 1 + m.pad;
  yy = yy < 0 ? 0 : (yy > m.H2 - 1 ? m.H2 - 1 : yy);
  xx = xx < 0 ? 0 : (xx > m.W2 - 1 ? m.W2 - 1 : xx);
  return m.cls[yy * m.W2 + xx];
}

// sides_for of one node (flat id t*4^level + n): the side (+1 / -1 / 0)
// combined over the mips, 0 where two mips disagree.
__host__ __device__ __forceinline__ int8_t node_side(int64_t node, int level,
                                                     const float* uv,
                                                     const Mips& mips) {
  uint32_t idx = (uint32_t)(node & ((((int64_t)1) << (2 * level)) - 1));
  int64_t t = node >> (2 * level);
  Corners c;
  sub_corners(uv + 6 * t, idx, level, c);
  int8_t side = 0;
  for (int mi = 0; mi < mips.n; ++mi) {
    int x0, y0;
    window_origin(c, mips.m[mi], x0, y0);
    int8_t s = class_at(mips.m[mi], x0, y0);
    side = mi == 0 ? s : (s == side ? side : (int8_t)0);
  }
  return side;
}

// ---- kernel A: one level of the descent ----
// Child lane j of n_out has parent lane p = j / E.  A parent lane below
// n_par expands to node par[p]*E + j % E (par null: parent p is node p),
// valid while p < min(count, n_par) (count null: every parent lane);
// lanes from n_par*E on hold node 0, invalid, as the plain version pads.
// With `test` the child's window side is written; `open` is valid &
// side == 0 (without `test`: valid), and where act_span > 0 also the
// group test: some active flag in active[node*act_span, +act_span).
struct Descend {
  const int64_t* par;
  const int64_t* count;
  int64_t n_par, n_out, E, act_span;
  int level, test;
  const uint8_t* active;
  const float* uv;
  Mips mips;
  int8_t* side;
  int64_t* node;
  uint8_t* valid;
  uint8_t* open;
};

__host__ __device__ inline void descend_lane(const Descend& d, int64_t j) {
  int64_t p = j / d.E;
  int64_t nd = 0;
  bool ok = false;
  if (p < d.n_par) {
    int64_t pv = d.par ? d.par[p] : p;
    nd = pv * d.E + (j - p * d.E);
    int64_t lim = d.n_par;
    if (d.count && *d.count < lim) lim = *d.count;
    ok = p < lim;
  }
  d.node[j] = nd;
  d.valid[j] = ok;
  bool op = ok;
  if (d.test) {
    int8_t s = node_side(nd, d.level, d.uv, d.mips);
    d.side[j] = s;
    op = op && s == 0;
  }
  if (op && d.act_span > 0) {
    const uint8_t* a = d.active + nd * d.act_span;
    bool any = false;
    for (int64_t k = 0; k < d.act_span && !any; ++k) any = a[k] != 0;
    op = any;
  }
  d.open[j] = op;
}

// ---- kernel B: survivor tile keys ----
// For survivor lane i (flat id t*4^subdiv + m) and each mip: the tile of
// its wrapped window origin, INVALID_TILE where kvalid is 0 (kvalid
// null: every lane).  keys is (mips.n, n).
struct Keys {
  const int64_t* ids;
  const uint8_t* kvalid;
  int64_t n;
  int subdiv;
  const float* uv;
  Mips mips;
  int32_t* keys;
};

__host__ __device__ inline void keys_lane(const Keys& k, int64_t i) {
  if (k.kvalid && !k.kvalid[i]) {
    for (int mi = 0; mi < k.mips.n; ++mi) k.keys[mi * k.n + i] = INVALID_TILE;
    return;
  }
  int64_t id = k.ids[i];
  int64_t t = id >> (2 * k.subdiv);
  uint32_t mm = (uint32_t)(id & ((((int64_t)1) << (2 * k.subdiv)) - 1));
  Corners c;
  sub_corners(k.uv + 6 * t, mm, k.subdiv, c);
  for (int mi = 0; mi < k.mips.n; ++mi) {
    int x0, y0;
    window_origin(c, k.mips.m[mi], x0, y0);
    k.keys[mi * k.n + i] = tile_of(x0, y0, k.mips.m[mi]);
  }
}

// ---- kernel C: tile slots from the stably sorted keys ----
// Each group of equal keys starts at a multiple of B: the slot of sorted
// position i is the group's offset, the exclusive scan of the padded
// sizes ceil(size / B) * B of the groups before it (close_inc summed up
// to i), plus its rank i - group_start(i).

// The first position of st[i]'s group in the sorted row st (binary
// search over [0, i]).
__host__ __device__ __forceinline__ int64_t group_start(const int32_t* st,
                                                        int64_t i) {
  int32_t key = st[i];
  int64_t lo = 0, hi = i;
  while (lo < hi) {
    int64_t mid = lo + (hi - lo) / 2;
    if (st[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__host__ __device__ __forceinline__ bool is_start(const int32_t* st,
                                                  int64_t i) {
  return i == 0 || st[i] != st[i - 1];
}

// The padded size of the group that closes just before position i, where
// i > 0 starts a group; else 0.
__host__ __device__ __forceinline__ int64_t close_inc(const int32_t* st,
                                                      int64_t i) {
  if (i == 0 || st[i] == st[i - 1]) return 0;
  int64_t size = i - group_start(st, i - 1);
  return (size + B - 1) / B * B;
}

// st and order are (nm, K): each mip's stably sorted keys and the lane
// each came from.  Outputs: slot (nm, K) by lane (SENTINEL on invalid
// lanes), padM (nm) the padded slot total, and per mip a slot stream of
// nblk[m] blocks at ids_off[m] / bt_off[m] of the flat ids_slot (the
// survivor id at its slot, -1 elsewhere) and block_tile (each block's
// tile, 0 for an empty block); a slot past the stream is left out.
struct Slots {
  const int32_t* st;
  const int64_t* order;
  const int64_t* ids;
  int64_t K;
  int nm;
  int64_t nblk[MAX_MIPS], ids_off[MAX_MIPS], bt_off[MAX_MIPS];
  int64_t* slot;
  int64_t* padM;
  int32_t* ids_slot;
  int32_t* block_tile;
};

// The kernel's decomposition of a row: chunks of SLOT_CHUNK sorted
// positions, SLOT_ITEMS consecutive ones to a thread.
constexpr int SLOT_THREADS = 256;
constexpr int SLOT_ITEMS = 8;
constexpr int64_t SLOT_CHUNK = SLOT_THREADS * SLOT_ITEMS;

__host__ __device__ __forceinline__ int64_t slot_chunks(int64_t K) {
  return K > 0 ? (K + SLOT_CHUNK - 1) / SLOT_CHUNK : 1;
}

// Write sorted position i of mip m, whose group offset is `off` and rank
// `rank`.
__host__ __device__ inline void write_sorted(const Slots& s, int m,
                                             int64_t i, int64_t off,
                                             int64_t rank) {
  const int32_t* st = s.st + m * s.K;
  int32_t key = st[i];
  int64_t k = s.order[m * s.K + i];
  if (key == INVALID_TILE) {
    s.slot[m * s.K + k] = SENTINEL;
    return;
  }
  int64_t q = off + rank;
  s.slot[m * s.K + k] = q;
  if (q < s.nblk[m] * B) {
    s.ids_slot[s.ids_off[m] + q] = (int32_t)s.ids[k];
    if (rank % B == 0) s.block_tile[s.bt_off[m] + q / B] = key;
  }
  // the last valid position holds the padded total
  if (i + 1 == s.K || st[i + 1] == INVALID_TILE)
    s.padM[m] = off + (rank + B) / B * B;
}

// The discovery path's slot stream from lanes already placed: lane k's
// id at slot[k] and, at a block's first slot, its tile key (keys from
// kernel B); slots outside [0, nblk * B) are left out.
struct Stream {
  const int64_t* ids;
  const int64_t* slot;
  const int32_t* keys;
  int64_t n, nblk;
  int32_t* ids_slot;
  int32_t* block_tile;
};

__host__ __device__ __forceinline__ void stream_lane(const Stream& s,
                                                     int64_t k) {
  int64_t q = s.slot[k];
  if (q < 0 || q >= s.nblk * B) return;
  s.ids_slot[q] = (int32_t)s.ids[k];
  if (q % B == 0) s.block_tile[q / B] = s.keys[k];
}

}  // namespace omm_chain
