// Host build of the capacity chain's kernels (chain_math.cuh).
//
// The same C entries as chain_descend.cu and chain_slots.cu, without the
// stream: kernels A, B and the slot stream walk their lanes in order
// through the kernels' per-lane functions; kernel C walks each row in the
// kernel's chunks, the offset of a position being the sums of the chunks
// before its own plus the closing sizes up to it in its chunk, and its
// group start the last start in the chunk, or the binary search for the
// group the chunk opens in.  The CPU tests build this file with g++
// (-ffp-contract=off, __host__/__device__ defined empty) and require its
// outputs to equal the plain torch versions' bit for bit, which tests the
// kernels' arithmetic and decomposition without a card.
#include <vector>

#include "chain_math.cuh"

using namespace omm_chain;

extern "C" int omm_descend_sides_host(
    const int64_t* par, const int64_t* count, int64_t n_par, int64_t n_out,
    int64_t E, int level, int test, const uint8_t* active, int64_t act_span,
    const float* uv, int nm, const int64_t* cls, const int* mip_ints,
    int8_t* side, int64_t* node, uint8_t* valid, uint8_t* open) {
  Descend d;
  if (!make_mips(nm, cls, mip_ints, d.mips)) return 1;
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
  for (int64_t j = 0; j < n_out; ++j) descend_lane(d, j);
  return 0;
}

extern "C" int omm_tile_keys_host(const int64_t* ids, const uint8_t* kvalid,
                                  int64_t n, int subdiv, const float* uv,
                                  int nm, const int* mip_ints,
                                  int32_t* keys) {
  Keys k;
  if (!make_mips(nm, nullptr, mip_ints, k.mips)) return 1;
  k.ids = ids;
  k.kvalid = kvalid;
  k.n = n;
  k.subdiv = subdiv;
  k.uv = uv;
  k.keys = keys;
  for (int64_t i = 0; i < n; ++i) keys_lane(k, i);
  return 0;
}

extern "C" int omm_tile_slots_host(const int32_t* st, const int64_t* order,
                                   const int64_t* ids, int64_t K, int nm,
                                   const int64_t* nblk, int64_t* slot,
                                   int64_t* padM, int32_t* ids_slot,
                                   int32_t* block_tile) {
  if (nm < 1 || nm > MAX_MIPS) return 1;
  Slots s;
  s.st = st;
  s.order = order;
  s.ids = ids;
  s.K = K;
  s.nm = nm;
  int64_t ids_total = 0, bt_total = 0;
  for (int m = 0; m < nm; ++m) {
    s.nblk[m] = nblk[m];
    s.ids_off[m] = ids_total;
    s.bt_off[m] = bt_total;
    ids_total += nblk[m] * B;
    bt_total += nblk[m];
  }
  s.slot = slot;
  s.padM = padM;
  s.ids_slot = ids_slot;
  s.block_tile = block_tile;
  for (int64_t q = 0; q < ids_total; ++q) ids_slot[q] = -1;
  for (int64_t q = 0; q < bt_total; ++q) block_tile[q] = 0;
  const int64_t nchunks = slot_chunks(K);
  std::vector<int64_t> bsum(nchunks);
  for (int m = 0; m < nm; ++m) {
    const int32_t* row = st + m * K;
    for (int64_t c = 0; c < nchunks; ++c) {
      bsum[c] = 0;
      for (int64_t i = c * SLOT_CHUNK; i < K && i < (c + 1) * SLOT_CHUNK; ++i)
        bsum[c] += close_inc(row, i);
    }
    if (K == 0 || row[0] == INVALID_TILE) padM[m] = 0;
    int64_t pre = 0;
    for (int64_t c = 0; c < nchunks; ++c) {
      const int64_t base = c * SLOT_CHUNK;
      int64_t off = pre, start = -1;
      for (int64_t i = base; i < K && i < base + SLOT_CHUNK; ++i) {
        off += close_inc(row, i);
        int64_t cand = is_start(row, i) ? i
                       : i == base      ? group_start(row, i)
                                        : -1;
        if (cand > start) start = cand;
        write_sorted(s, m, i, off, i - start);
      }
      pre += bsum[c];
    }
  }
  return 0;
}

extern "C" int omm_slot_stream_host(const int64_t* ids, const int64_t* slot,
                                    const int32_t* keys, int64_t n,
                                    int64_t nblk, int32_t* ids_slot,
                                    int32_t* block_tile) {
  for (int64_t q = 0; q < nblk * B; ++q) ids_slot[q] = -1;
  for (int64_t q = 0; q < nblk; ++q) block_tile[q] = 0;
  Stream s{ids, slot, keys, n, nblk, ids_slot, block_tile};
  for (int64_t k = 0; k < n; ++k) stream_lane(s, k);
  return 0;
}
