// Per-slot math of the exact classification stage.
//
// Shared by the CUDA kernel (exact_classify.cu) and its host driver
// (exact_host.cpp, which walks a block in the kernel's order; the CPU
// tests compile it with g++ and hold it against the torch twin in
// omm_tpu_torch/kernels/exact.py).  Every function keeps
// the fp32 operation order of the JAX package's pallas_classify
// derive_slot_geometry + _kernel_body and kernels/levelline.py; results
// are bit-exact only when built without FMA contraction and with IEEE
// division and sqrt (nvcc -fmad=false -prec-div=true -prec-sqrt=true
// -ftz=false; g++ -ffp-contract=off).
//
// Branches replace the JAX code's computed-then-selected candidates where
// the outcome cannot differ: each selected value goes through the same
// operations on the same operands.
#pragma once

#include <math.h>
#include <stdint.h>

namespace omm_exact {

constexpr int TILE = 64;  // texel tile edge (host.TILE)
constexpr int B = 128;    // slots per block (host.B)

struct Params {
  int subdiv, pad, ntx;  // level, plane padding, tiles per padded row
  int w, h;              // mip size
  int Pw, Ph;            // address-mode period, 0 = aperiodic
  int H, W;              // texel window per slot
  int TSA;               // region edge: TILE + max(H + 2, W + 2)
  int Hp, Wp;            // padded plane size
  float rcp_x, rcp_y, cutoff;
};

// Python's floor modulo (C++ `%` truncates toward zero).
__host__ __device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__host__ __device__ __forceinline__ bool is_zero(float v, float e) {
  return (v < e) && (v > -e);
}

__host__ __device__ __forceinline__ float length2(float dx, float dy) {
  return sqrtf(dx * dx + dy * dy);
}

// ---- bird curve (bird.h:36-70) ----
__host__ __device__ __forceinline__ uint32_t extract_even_bits(uint32_t x) {
  x = x & 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return x;
}

__host__ __device__ __forceinline__ uint32_t prefix_eor(uint32_t x) {
  x = x ^ (x >> 1);
  x = x ^ (x >> 2);
  x = x ^ (x >> 4);
  x = x ^ (x >> 8);
  return x;
}

__host__ __device__ __forceinline__ void index2dbary(uint32_t index,
                                                     uint32_t& u, uint32_t& v,
                                                     uint32_t& w) {
  uint32_t b0 = extract_even_bits(index);
  uint32_t b1 = extract_even_bits(index >> 1);
  uint32_t fx = prefix_eor(b0);
  uint32_t fy = prefix_eor(b0 & ~b1);
  uint32_t t = fy ^ b1;
  u = (fx & ~t) | (b0 & ~t) | (~b0 & ~fx & t);
  v = fy ^ b0;
  w = (~fx & ~t) | (b0 & ~t) | (~b0 & fx & t);
}

// ---- point in triangle (geometry.h:101-114) ----
struct Tri {
  float p0x, p0y, p1x, p1y, p2x, p2y;
  float p0p2x, p0p2y, p1p0x, p1p0y, p2p1x, p2p1y;
};

__host__ __device__ __forceinline__ bool point_in_tri(const Tri& t, float px,
                                                      float py) {
  float s = t.p0p2x * (py - t.p2y) - t.p0p2y * (px - t.p2x);
  float u = t.p1p0x * (py - t.p0y) - t.p1p0y * (px - t.p0x);
  bool early_false = ((s < 0.f) != (u < 0.f)) && (s != 0.f) && (u != 0.f);
  float d = t.p2p1x * (py - t.p1y) - t.p2p1y * (px - t.p1x);
  bool ok = (d == 0.f) || ((d < 0.f) == ((s + u) <= 0.f));
  return !early_false && ok;
}

// ---- TestEdgeHyperbolaIntersection (bake_kernels_cpu.h:144-238) ----
__host__ __device__ __forceinline__ bool point_hit(float px, float py,
                                                   float q0x, float q0y,
                                                   float q1x, float q1y,
                                                   float edge_len) {
  if (!((px >= 0.f) && (px <= 1.f) && (py >= 0.f) && (py <= 1.f)))
    return false;
  float l = length2(px - q0x, py - q0y) + length2(px - q1x, py - q1y) -
            edge_len;
  return is_zero(l, 1e-5f);
}

__host__ __device__ inline bool edge_hyperbola_hit(float p0x, float p0y,
                                                   float p1x, float p1y,
                                                   float ha, float hb,
                                                   float hc, float hd) {
  bool swap = p0x > p1x;
  float q0x = swap ? p1x : p0x;
  float q0y = swap ? p1y : p0y;
  float q1x = swap ? p0x : p1x;
  float q1y = swap ? p0y : p1y;
  float edge_len = length2(q1x - q0x, q1y - q0y);
  float k_denum = q1x - q0x;
  float pax, pay, pbx = 2.f, pby = 2.f;
  if (is_zero(k_denum, 1e-6f)) {  // vertical edge
    float vx = q0x;
    float v_c0 = hd * vx + hc;
    float v_c1 = ha + hb * vx;
    if (is_zero(v_c0, 1e-6f)) return false;
    pax = vx;
    pay = -v_c1 / v_c0;
  } else {
    float k = (q1y - q0y) / k_denum;
    float m = q1y - q1x * k;
    float c0 = hd * k;
    float c1 = hc * k + hd * m + hb;
    float c2 = ha + hc * m;
    if (is_zero(c0, 1e-6f)) {  // straight line
      if (is_zero(c1, 1e-6f)) return false;
      pax = -c2 / c1;
      pay = k * pax + m;
    } else {  // hyperbola
      float inner = c1 * c1 - (4.f * c0) * c2;
      if (!(inner > 0.f)) return false;
      float root = sqrtf(inner);
      pax = 0.5f * (-c1 + root) / c0;
      pbx = 0.5f * (-c1 - root) / c0;
      pay = k * pax + m;
      pby = k * pbx + m;
    }
  }
  return point_hit(pax, pay, q0x, q0y, q1x, q1y, edge_len) ||
         point_hit(pbx, pby, q0x, q0y, q1x, q1y, edge_len);
}

// ---- one texel of the level-line kernel (bake_kernels_cpu.h:241-399) ----
// gx..gw: the 2x2 quad at c00, c01, c11, c10.  Adds 0..2 to each count,
// in two parts: the corner tests decide most texels; the rest (the
// return value is true) run the edge tests.

// The corner-in-triangle extremum search and the flat-quad test.
__host__ __device__ inline bool level_line_corners(
    const Tri& tri, int px, int py, float gx, float gy, float gz, float gw,
    float inv_x, float inv_y, float cutoff, int& above, int& below) {
  float pixelf_x = (float)px + 0.5f;
  float pixelf_y = (float)py + 0.5f;
  float invpix_x = pixelf_x * inv_x;
  float invpix_y = pixelf_y * inv_y;
  bool op0 = cutoff < gx, op1 = cutoff < gy, op2 = cutoff < gz,
       op3 = cutoff < gw;
  bool in0 = point_in_tri(tri, invpix_x, invpix_y);
  bool in1 = point_in_tri(tri, invpix_x, invpix_y + inv_y);
  bool in2 = point_in_tri(tri, invpix_x + inv_x, invpix_y + inv_y);
  bool in3 = point_in_tri(tri, invpix_x + inv_x, invpix_y);
  bool is_op = (in0 && op0) || (in1 && op1) || (in2 && op2) || (in3 && op3);
  bool is_tr =
      (in0 && !op0) || (in1 && !op1) || (in2 && !op2) || (in3 && !op3);
  above += is_op;
  below += is_tr;
  if (is_op && is_tr) return false;  // extremum found: level lines add nothing

  float b = gw - gx;
  float c = gy - gx;
  float d = gx + gz - gy - gw;
  if (is_zero(b, 1e-6f) && is_zero(c, 1e-6f) && is_zero(d, 1e-6f)) {
    if (cutoff < gx)
      above += 1;
    else
      below += 1;
    return false;
  }
  return true;
}

// The level-line edge tests of a texel the corner tests left open:
// adds 1 to both counts at the first edge the level line crosses.
__host__ __device__ inline void level_line_edges(
    const Tri& tri, int px, int py, float gx, float gy, float gz, float gw,
    float sizef_x, float sizef_y, float cutoff, int& above, int& below) {
  float pixelf_x = (float)px + 0.5f;
  float pixelf_y = (float)py + 0.5f;
  float a = gx;
  float b = gw - gx;
  float c = gy - gx;
  float d = gx + gz - gy - gw;
  float ha = a - cutoff;
  float cx[3] = {tri.p0x, tri.p1x, tri.p2x};
  float cy[3] = {tri.p0y, tri.p1y, tri.p2y};
  for (int e = 0; e < 3; ++e) {
    int n = e == 2 ? 0 : e + 1;
    float p0x = sizef_x * cx[e] - pixelf_x;
    float p0y = sizef_y * cy[e] - pixelf_y;
    float p1x = sizef_x * cx[n] - pixelf_x;
    float p1y = sizef_y * cy[n] - pixelf_y;
    if (edge_hyperbola_hit(p0x, p0y, p1x, p1y, ha, b, c, d)) {
      above += 1;
      below += 1;
      return;
    }
  }
}

// ---- one survivor slot, in three steps ----
// The kernel runs them as three passes over a block of B slots: the
// geometry of every slot, then every (slot, texel) pair of the H x W
// window (the conservative mask; the corner tests of the covered pairs;
// the edge tests of the pairs the corner tests leave open), then every
// slot's seed.  Each step keeps the fp32
// operation order of the JAX package's derive_slot_geometry and
// _kernel_body.

constexpr int LIST_TEXELS = 8;  // window texels per compaction chunk

struct SlotGeom {
  int x0, y0, x1, y1;  // raster window [x0, x1) x [y0, y1), texels
  int ox, oy;          // window origin in the block's TSA x TSA region
  float nx[3], ny[3], cc[3], bx[3], by[3];  // conservative edge functions
  float mx[3], my[3];  // micro-triangle corners, UV
};

// Geometry of the slot holding flat survivor id t*M + m (id >= 0) in a
// block of tile bt: bird-curve corners, raster window, region offset
// and the edge functions of the CCW-normalised raster triangle.
__host__ __device__ inline void slot_geometry(const Params& p, int id, int bt,
                                              const float* uv6,
                                              const int* ccw, SlotGeom& g) {
  int t = id >> (2 * p.subdiv);
  uint32_t mm = (uint32_t)id & ((1u << (2 * p.subdiv)) - 1u);

  // bary_cols: corner (u, v), (u+d, v), (u, v+d)
  uint32_t iu, iv, iw;
  index2dbary(mm, iu, iv, iw);
  uint32_t lm = (1u << p.subdiv) - 1u;
  iu &= lm;
  iv &= lm;
  iw &= lm;
  bool upright = ((iu & 1u) ^ (iv & 1u) ^ (iw & 1u)) != 0u;
  if (!upright) {
    iu += 1u;
    iv += 1u;
  }
  float ls = ldexpf(1.f, -p.subdiv);
  float bd = upright ? ls : -ls;
  float bu = (float)(int)iu * ls;
  float bv = (float)(int)iv * ls;

  // corner_cols: p = p0*(1-u-v) + p1*u + p2*v
  const float* u6 = uv6 + 6 * t;
  float cu[3] = {bu, bu + bd, bu};
  float cv[3] = {bv, bv, bv + bd};
  for (int k = 0; k < 3; ++k) {
    float w_ = 1.f - cu[k] - cv[k];
    g.mx[k] = u6[0] * w_ + u6[2] * cu[k] + u6[4] * cv[k];
    g.my[k] = u6[1] * w_ + u6[3] * cu[k] + u6[5] * cv[k];
  }

  // derive_slot_geometry
  float wf = (float)p.w, hf = (float)p.h;
  float qx[3], qy[3];
  for (int k = 0; k < 3; ++k) {
    qx[k] = g.mx[k] * wf - 0.5f;
    qy[k] = g.my[k] * hf - 0.5f;
  }
  g.x0 = (int)floorf(fminf(fminf(qx[0], qx[1]), qx[2]));
  g.y0 = (int)floorf(fminf(fminf(qy[0], qy[1]), qy[2]));
  g.x1 = (int)ceilf(fmaxf(fmaxf(qx[0], qx[1]), qx[2]));
  g.y1 = (int)ceilf(fmaxf(fmaxf(qy[0], qy[1]), qy[2]));
  bool flip = ccw[t] == 0;
  float qnx[3], qny[3];
  for (int k = 0; k < 3; ++k) {
    int s = flip ? 2 - k : k;
    qnx[k] = qx[s];
    qny[k] = qy[s];
  }
  int btx = bt % p.ntx, bty = bt / p.ntx;
  int x0m = p.Pw ? floor_mod(g.x0, p.Pw) : g.x0;
  int y0m = p.Ph ? floor_mod(g.y0, p.Ph) : g.y0;
  g.ox = x0m + p.pad - btx * TILE;
  g.oy = y0m + p.pad - bty * TILE;

  for (int e = 0; e < 3; ++e) {
    int n = e == 2 ? 0 : e + 1;
    g.nx[e] = qny[n] - qny[e];
    g.ny[e] = qnx[e] - qnx[n];
    g.cc[e] = -(g.nx[e] * qnx[e] + g.ny[e] * qny[e]);
    g.bx[e] = g.nx[e] > 0.f ? 0.f : g.nx[e];
    g.by[e] = g.ny[e] > 0.f ? 0.f : g.ny[e];
  }
}

// The conservative mask at texel (px, py) of a window [.., x1) x [.., y1).
__host__ __device__ __forceinline__ bool texel_covered(
    const float nx[3], const float ny[3], const float cc[3],
    const float bx[3], const float by[3], int px, int py, int x1, int y1) {
  bool in = (px < x1) && (py < y1);
  float sxf = (float)px, syf = (float)py;
  for (int e = 0; e < 3 && in; ++e) {
    float ev = (nx[e] * sxf + ny[e] * syf) + cc[e];
    in = (ev + bx[e] + by[e]) < 0.f;
  }
  return in;
}

// The point-in-triangle form of corners (mx, my).
__host__ __device__ __forceinline__ Tri make_tri(const float mx[3],
                                                 const float my[3]) {
  Tri tri;
  tri.p0x = mx[0];
  tri.p0y = my[0];
  tri.p1x = mx[1];
  tri.p1y = my[1];
  tri.p2x = mx[2];
  tri.p2y = my[2];
  tri.p0p2x = tri.p0x - tri.p2x;
  tri.p0p2y = tri.p0y - tri.p2y;
  tri.p1p0x = tri.p1x - tri.p0x;
  tri.p1p0y = tri.p1y - tri.p0y;
  tri.p2p1x = tri.p2x - tri.p1x;
  tri.p2p1y = tri.p2y - tri.p1y;
  return tri;
}

// Level-line increments of one covered texel (px, py) whose 2x2 quad
// is gx..gw, in its two parts: texel_corners adds the corner tests'
// increments and returns true when texel_edges must run.
__host__ __device__ __forceinline__ bool texel_corners(
    const Params& p, const Tri& tri, int px, int py, float gx, float gy,
    float gz, float gw, int& above, int& below) {
  return level_line_corners(tri, px, py, gx, gy, gz, gw, p.rcp_x, p.rcp_y,
                            p.cutoff, above, below);
}

__host__ __device__ __forceinline__ void texel_edges(
    const Params& p, const Tri& tri, int px, int py, float gx, float gy,
    float gz, float gw, int& above, int& below) {
  level_line_edges(tri, px, py, gx, gy, gz, gw, (float)p.w, (float)p.h,
                   p.cutoff, above, below);
}

// Bilinear seed at corner p0 = (mx0, my0) of a slot whose window starts
// at texel (x0, y0), region offset (ox, oy): adds 1 to above or below.
// fetch(ry, rx): the block's region at (ry, rx), 0 outside [0, TSA)^2
// and past the padded plane.
template <class Fetch>
__host__ __device__ inline void slot_seed(const Params& p, int x0, int y0,
                                          int ox, int oy, float mx0,
                                          float my0, const Fetch& fetch,
                                          int& above, int& below) {
  float wf = (float)p.w, hf = (float)p.h;
  float p0px = mx0 * wf - 0.5f;
  float p0py = my0 * hf - 0.5f;
  int sx = (int)floorf(p0px);
  int sy = (int)floorf(p0py);
  int We = p.W + 2, Ke = (p.H + 2) * We;
  int soff = (sy - y0) * We + (sx - x0);
  float sv[4];
  int shifts[4] = {0, We, 1, We + 1};
  for (int i = 0; i < 4; ++i) {
    int k = soff + shifts[i];
    sv[i] = (k >= 0 && k < Ke) ? fetch(oy + k / We, ox + k % We) : 0.f;
  }
  float wxf = p0px - floorf(p0px);
  float wyf = p0py - floorf(p0py);
  float ac = sv[0] * (1.f - wxf) + sv[2] * wxf;
  float bdv = sv[1] * (1.f - wxf) + sv[3] * wxf;
  float seed = ac * (1.f - wyf) + bdv * wyf;
  if (p.cutoff < seed)
    above += 1;
  else
    below += 1;
}

}  // namespace omm_exact
