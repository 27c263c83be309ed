// Tile-slot assignment of the capacity chain for Hopper (sm_90a): kernel
// C, from each mip's stably sorted tile keys to every survivor's slot,
// the padded slot total and the exact stage's slot stream.
//
// Replaces an XLA program of the JAX package, not a Pallas kernel: the
// group padding and slot assignment after _stageAB's tile sort (the
// is-start flags, the cummax of group starts, the padded-size cumsum,
// the slot scatter and the padded total), the slot-stream scatter of
// _stageC_mip and its block tiles.  The sort itself stays a sort
// (torch.sort, as the JAX package leaves it to jax.lax.sort).
//
// What bounds it on this card: launch latency, then the scan across the
// row.  A row is K_cap sorted keys (~200k on the benchmark's batches);
// the work is a few integer operations and ~40 bytes a position.  The
// port's torch version took its cummax scan as the largest kernel of the
// batch (2.8 ms per bench bake on the H100).
//
// What the design does about it: no cummax.  A position's rank is its
// distance from its group's first position, which a block finds by a
// max-scan of the group starts in its chunk, seeded by one binary search
// for the group the chunk opens in; a group's offset is the exclusive
// sum of the padded sizes of the groups before it, each added at the
// position that closes it (a binary search for that group's start, at
// group starts only).  Two launches per call, every mip in each: the
// first sums each chunk's closing sizes (and fills the slot streams with
// -1 / 0), the second adds the sums of the chunks before its own and
// scans within the chunk (CUB's block scan), then writes the slot, the
// stream entries and, at the last valid position, the padded total.
#include <cuda_runtime.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "chain_math.cuh"

namespace omm_chain {

struct SumMax {
  long long sum, mx;
};

struct SumMaxOp {
  __device__ __forceinline__ SumMax operator()(const SumMax& a,
                                               const SumMax& b) const {
    SumMax r;
    r.sum = a.sum + b.sum;
    r.mx = a.mx > b.mx ? a.mx : b.mx;
    return r;
  }
};

typedef cub::BlockReduce<long long, SLOT_THREADS> Reduce;
typedef cub::BlockScan<SumMax, SLOT_THREADS> Scan;

// Pass 1: bsum[m][c] = the closing sizes in chunk c of row m; and the
// fill of every slot stream.
__global__ void __launch_bounds__(SLOT_THREADS)
    slots_sum_kernel(Slots s, int64_t* bsum, int64_t nchunks,
                     int64_t ids_total, int64_t bt_total) {
  const int m = blockIdx.y;
  const int32_t* st = s.st + m * s.K;
  const int64_t base = (int64_t)blockIdx.x * SLOT_CHUNK;
  long long acc = 0;
  for (int j = 0; j < SLOT_ITEMS; ++j) {
    int64_t i = base + (int64_t)j * SLOT_THREADS + threadIdx.x;
    if (i < s.K) acc += close_inc(st, i);
  }
  __shared__ typename Reduce::TempStorage tmp;
  long long tot = Reduce(tmp).Sum(acc);
  if (threadIdx.x == 0) bsum[m * nchunks + blockIdx.x] = tot;
  int64_t g = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * SLOT_THREADS +
              threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * gridDim.y * SLOT_THREADS;
  for (int64_t q = g; q < ids_total; q += stride) s.ids_slot[q] = -1;
  for (int64_t q = g; q < bt_total; q += stride) s.block_tile[q] = 0;
}

// Pass 2: offsets and ranks of the chunk's positions, and their writes.
__global__ void __launch_bounds__(SLOT_THREADS)
    slots_write_kernel(Slots s, const int64_t* bsum, int64_t nchunks) {
  const int m = blockIdx.y;
  const int32_t* st = s.st + m * s.K;
  const int64_t base = (int64_t)blockIdx.x * SLOT_CHUNK;
  __shared__ union {
    typename Reduce::TempStorage r;
    typename Scan::TempStorage s;
  } tmp;
  __shared__ long long pre_sh;
  long long acc = 0;
  for (int64_t c = threadIdx.x; c < blockIdx.x; c += SLOT_THREADS)
    acc += bsum[m * nchunks + c];
  long long pre = Reduce(tmp.r).Sum(acc);
  if (threadIdx.x == 0) pre_sh = pre;
  __syncthreads();
  pre = pre_sh;

  long long inc[SLOT_ITEMS], cand[SLOT_ITEMS];
  SumMax loc = {0, -1};
  const int64_t i0 = base + (int64_t)threadIdx.x * SLOT_ITEMS;
  for (int j = 0; j < SLOT_ITEMS; ++j) {
    int64_t i = i0 + j;
    inc[j] = 0;
    cand[j] = -1;
    if (i < s.K) {
      inc[j] = close_inc(st, i);
      if (is_start(st, i))
        cand[j] = i;
      else if (i == base)  // the chunk opens inside a group
        cand[j] = group_start(st, i);
    }
    loc.sum += inc[j];
    loc.mx = cand[j] > loc.mx ? cand[j] : loc.mx;
  }
  SumMax excl;
  SumMax init = {0, -1};
  Scan(tmp.s).ExclusiveScan(loc, excl, init, SumMaxOp());
  long long off = pre + excl.sum, start = excl.mx;
  for (int j = 0; j < SLOT_ITEMS; ++j) {
    int64_t i = i0 + j;
    if (i >= s.K) break;
    off += inc[j];
    if (cand[j] > start) start = cand[j];
    write_sorted(s, m, i, off, i - start);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      (s.K == 0 || st[0] == INVALID_TILE))
    s.padM[m] = 0;
}

__global__ void __launch_bounds__(SLOT_THREADS)
    stream_fill_kernel(int32_t* ids_slot, int32_t* block_tile, int64_t nblk) {
  int64_t g = (int64_t)blockIdx.x * SLOT_THREADS + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * SLOT_THREADS;
  for (int64_t q = g; q < nblk * B; q += stride) ids_slot[q] = -1;
  for (int64_t q = g; q < nblk; q += stride) block_tile[q] = 0;
}

__global__ void __launch_bounds__(SLOT_THREADS) stream_kernel(Stream s) {
  int64_t k = (int64_t)blockIdx.x * SLOT_THREADS + threadIdx.x;
  if (k < s.n) stream_lane(s, k);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + SLOT_THREADS - 1) / SLOT_THREADS);
}

}  // namespace omm_chain

// Chunks of a row of K positions: the wrapper's bsum scratch holds nm of
// these counts of int64.
extern "C" int64_t omm_tile_slots_chunks(int64_t K) {
  return omm_chain::slot_chunks(K);
}

// Kernel C (Slots in chain_math.cuh): nblk is a host array of nm block
// capacities (0: no stream for that mip); the streams lie end to end in
// ids_slot and block_tile.
extern "C" int omm_tile_slots(const int32_t* st, const int64_t* order,
                              const int64_t* ids, int64_t K, int nm,
                              const int64_t* nblk, int64_t* slot,
                              int64_t* padM, int32_t* ids_slot,
                              int32_t* block_tile, int64_t* bsum,
                              void* stream) {
  using namespace omm_chain;
  if (nm < 1 || nm > MAX_MIPS) return (int)cudaErrorInvalidValue;
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
  const int64_t nchunks = slot_chunks(K);
  const dim3 grid((unsigned)nchunks, (unsigned)nm);
  cudaStream_t cs = (cudaStream_t)stream;
  slots_sum_kernel<<<grid, SLOT_THREADS, 0, cs>>>(s, bsum, nchunks,
                                                 ids_total, bt_total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  slots_write_kernel<<<grid, SLOT_THREADS, 0, cs>>>(s, bsum, nchunks);
  return (int)cudaGetLastError();
}

// The discovery path's slot stream of nblk blocks from n placed lanes
// (Stream in chain_math.cuh).
extern "C" int omm_slot_stream(const int64_t* ids, const int64_t* slot,
                               const int32_t* keys, int64_t n, int64_t nblk,
                               int32_t* ids_slot, int32_t* block_tile,
                               void* stream) {
  using namespace omm_chain;
  cudaStream_t cs = (cudaStream_t)stream;
  if (nblk > 0) {
    stream_fill_kernel<<<blocks_for(nblk * B), SLOT_THREADS, 0, cs>>>(
        ids_slot, block_tile, nblk);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  Stream s{ids, slot, keys, n, nblk, ids_slot, block_tile};
  if (n > 0) stream_kernel<<<blocks_for(n), SLOT_THREADS, 0, cs>>>(s);
  return (int)cudaGetLastError();
}
