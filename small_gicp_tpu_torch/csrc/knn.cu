// Standalone exact neighbour searches (K9-K12), hand-written for Hopper
// (sm_90a). They replace the Pallas kernels of
// small_gicp_tpu/ops/knn_pallas.py:
//
//   nn1_split_kernel<false|true>  `_nn1_kernel_vpu` / `_nn1_kernel`
//                                 (nearest_neighbor_pallas, "vpu" / "mxu")
//   knn_split_kernel<KMAX>        `_make_knn_kernel`        (knn_pallas)
//   knn_warp_split_kernel<QW>     `_make_knn_kernel_T`      (knn_pallas_T)
//   knn_pruned_walk_kernel<KMAX, TEAM>
//                                 `_make_knn_listed_kernel` (knn_pallas_pruned)
//
// nn1_kernel and knn_kernel are the first forms of K9 and K10, one thread
// per query over every row, knn_warp_kernel_v1 the first form of K11 and
// knn_pruned_kernel_v1 that of K12; they stay as yardsticks (entries
// sgt_nn1_v1, sgt_knn_v1, sgt_knn_warp_v1, sgt_knn_pruned_v1) and are on no
// path.
//
// Shared contract. Targets are [M,4] float32 rows (x y z w) of which the
// first *tnum are valid (a device int32 read in place; sentinel rows beyond
// it never enter a distance); queries are rows of 3 or 4 floats at a stride
// given in floats. Distances are in difference form, ((dx·dx + dy·dy) +
// dz·dz) with every operation rounded on its own, the order of the plain
// PyTorch versions, so kernel and plain version choose the same rows bit
// for bit. Results ascend by (d², row index): ties go to the lower index.
// A candidate needs d² < 3e38 (kBig); slots for which no valid row is left
// (k > *tnum) hold d² = kBig and index 0. The JAX kernels return sentinel
// rows with d² > 1e16 there; both mean "no neighbour" to every caller, and
// comparisons hold to slots with d² < 1e16.
//
// What bounds them: the pair loop, Q·M pairs at 9 float32 operations
// (operations; the bytes are 16·(Q+M) in and 8·k·Q out). Every kernel
// streams the target through shared memory in 16-byte rows, so the inner
// loop is one broadcast load, the distance and one compare.
//
// K9 (1-NN). Both clouds are centred on `centre` (the mean of the finite
// target rows, computed by the wrapper), as the Pallas wrapper centres
// them: the difference-form instance returns d² of the centred
// coordinates; the score-form instance ranks by |t|² − 2 q·t of the centred
// coordinates (|q|² is constant per query) and returns the winner's d²
// recomputed from the uncentred inputs.
//
// K10 (kNN, k ≤ 64): a sorted top-k list per query (KMAX ∈ {16, 32, 64}
// sizes it and the bound's sample list, k at run time; up to kRegList slots
// in registers, longer lists in local memory). An insertion taken by one lane stalls its warp, and a cloud in
// scan or voxel order approaches a query gradually, so a cold list would
// insert at most rows. Each query therefore first takes the kth smallest d²
// over a strided sample of rows as a bound B ≥ its true kth distance, and
// the scan only considers rows with d² ≤ B: the result is unchanged, the
// insertions drop to about the rows inside the bound.
//
// The split design of K9 and K10. A block owns R · kSplitThreads queries,
// R of them per thread (kNn1Rows for K9, kKnnRows for K10), so that one
// staged row feeds R independent distance chains. The second grid dimension
// cuts the valid target rows into gridDim.y chunks (split_chunk: equal
// multiples of kSplitTile, read from the device row count, so trailing
// chunks may be empty); the wrapper chooses gridDim.y from the query blocks
// and the card's SM count so that a launch fills the card at every query
// count. A chunk streams through a two-stage cp.async ring of kSplitTile
// rows: tile t + 1 lands while tile t is scanned. Within a chunk, rows come
// in index order. With one chunk the block writes its results; with more,
// every chunk's winners are merged inside the same launch:
//   K9: each thread posts its winner as a 64-bit key, the rank's bits made
//       orderable (the score can be negative) in the high word and the row
//       in the low one, by atomicMax of its complement into a per-query
//       word that is 0 between launches: the smallest key wins, ties to the
//       lower row, whatever the blocks' order. The last block of the query
//       block (a ticket) decodes the winner, recomputes the score form's d²
//       from the uncentred rows, writes, and sets the words and the ticket
//       back to 0.
//   K10: each non-empty chunk's sorted list goes to a workspace [S, k, Q];
//       the last block of the query block merges the lists in chunk order.
//       Chunks cover disjoint, ascending row ranges, so inserting after
//       every entry of equal d² keeps (d², row) order. K10's bound is taken
//       over every kSampleStep-th row of the chunk (fewer where that would
//       exceed about kChunkSample rows), which bounds that chunk's own list;
//       a chunk of at most kSplitTile rows starts cold. Any chunk's bound,
//       and any chunk's full list's kth, bounds the query's kth over the
//       whole target, so the chunks of a query trade their bounds through a
//       per-query word after every tile, and each keeps only rows within
//       the smallest: a row of the final list is never cut.
//
// K11 (kNN, a warp per few queries): the other work mapping of the same
// search, for few queries. A warp holds QW queries in registers and its
// lanes stride the rows of each staged tile: lane l takes the rows whose
// index is l mod 32, in index order, and computes QW distances a row. Each
// lane keeps a private sorted list per query in shared memory (k × 32
// entries a query, one bank per lane), and the lists are merged by k rounds
// of a warp-wide arg-min on (d², index) through shuffles. A block holds up
// to kWarpMaxWarps warps, as many as kWarpListBytes of lists allow; QW is
// kWarpQueries up to k = 16 and halves at k = 32 and above. The first form
// (knn_warp_kernel_v1: one query a warp, four warps a block, the whole
// target staged synchronously, cold lists, no split) re-read the target
// for every 4 queries, inserted most rows of a scan-ordered cloud and left
// the card idle at a few queries. This one splits as K10 does: gridDim.y
// chunks of the valid rows (split_chunk; the wrapper plans them from the
// query blocks and the SM count), each streamed through a two-stage
// cp.async ring of kWarpStage rows (a lane takes kWarpStage / 32 rows of
// a stage, QW distances each, between two barriers; kScanBatch rows a lane
// are loaded before their distances, and only a batch holding a candidate
// takes the branch that inserts); each query of a chunk
// first takes a bound B ≥ its kth d² over the chunk from a strided sample
// of the chunk's rows (every kWarpSampleStep-th, streamed through the ring
// before the scan) — sample s goes to lane s mod 32, each lane
// keeps its smallest d² (its two smallest above k = 32) in registers, and B
// is the k-th smallest of the lanes' values (the ⌈k/2⌉-th of their second
// smallest), a value with k distinct rows at or below it — and a lane then
// keeps only rows with d² ≤ B. Each lane list keeps a fill count, so an
// insertion shifts only over its real entries. With more than one
// chunk every chunk's list (popped in (d², index) order) goes to a
// workspace [S, k, Q], and the last block of the query block (a ticket)
// merges them: the lists laid end to end, lane l takes entries l, l + 32,
// … into its lane list in (d², index) order, and k pops give the query's
// list. The merge's loads go out kMergeBatch at a time.
// Bit-identical to K10: every row of the global top-k is among its chunk's
// k first within B, among its lane's k first, and the merges keep (d²,
// index) order. What bounds it is K10's: all Q·M pairs (operations).
// Its time follows the warps an SM holds (the lists' shared memory sets
// them) and the insertions; tools/warp_kernel_sweep.py chose 96 KB of lists
// a block over 64 KB, 4 queries a warp over 8 and 1,024-row stages over 512
// and 2,048.
//
// K12 (pruned kNN): work ∝ local density, on the box walk that K3, K4 and
// K5 share (common.cuh's walk_sorted). The target comes sorted by Morton
// code (valid rows first) into rows (x y z | original index), with the
// bounding box of every kTile sorted rows and the sorted codes (a KdTree
// keeps all three); the queries come sorted by the same code (qperm, their
// codes qkey). TEAM threads serve one query, kKnnThreads / TEAM
// consecutive sorted queries a block. Each thread finds its query's
// insertion position among the sorted codes by binary search, and the
// query's reach is the kth smallest d² over the `window` sorted rows
// around it — or, where more rows than that share its code (a dense 1 m
// cell of a raw scan), over `window` rows spread evenly across them, since
// a window at one end of the run may lie a cell's width away: any k
// distinct rows bound the true kth distance from above.
// The block's anchor box is the one holding its median query's insertion
// position; cull passes of kCullPass boxes go outwards from it against the
// block's bound R (the largest reach, tightened after every pass), and the
// live tiles stream through the two-stage cp.async ring, a kept box
// re-checked against R as it tightens. Member t of a team takes the rows
// t, t + TEAM, … of a staged tile into its own list seeded with the reach;
// a warp skips a tile beyond each of its queries' kth. At the end the team
// merges its lists in k rounds of a shuffle arg-min (team_list_pop). The
// gap² between boxes never exceeds the d² of a pair inside them, and the
// lists are in (d², original index) order whatever the order of the tiles,
// so K12 equals K10 on every input. The wrapper picks TEAM from the query
// count and the SM count (pruned_plan). What bounds it: the pairs the walk
// cannot avoid on the data (operations, ~9 a pair).
//
// The first form (knn_pruned_kernel_v1, entry sgt_knn_pruned_v1, on no
// path) gave each thread a query, 64 a block, scanned the five tiles around
// the block's anchor for a first bound and then tested every other tile's
// box one after another, each staged synchronously.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using sgt::kBig;

constexpr int kKnnThreads = 64;    // queries per block (K9, K10 v1, K12)
constexpr int kKnnTile = 512;      // target rows staged at once (v1)
constexpr int kSampleRows = 2048;  // rows of K10 v1's bound sample
constexpr int kSplitThreads = 64;  // threads per block (K9, K10)
constexpr int kNn1Rows = 4;        // queries per thread (K9)
constexpr int kKnnRows = 1;        // queries per thread (K10)
constexpr int kSplitTile = 256;    // rows per ring stage; chunks are multiples
constexpr int kSampleStep = 8;     // K10's bound samples every 8th row of a
constexpr int kChunkSample = 2048;  // chunk, or a larger step above this many
constexpr int kRegList = 16;       // K10's lists up to this long live in registers
constexpr int kWarpTile = 256;     // target rows staged at once (K11 v1)
// K11: queries a warp holds (up to k = 16; half that up to k = 32, a
// quarter above), warps a block at most, bytes of lane lists a block at
// most, rows a ring stage (tools/warp_kernel_sweep.py).
constexpr int kWarpQueries = 4;
constexpr int kWarpMaxWarps = 8;
constexpr int kWarpListBytes = 98304;
constexpr int kWarpStage = 1024;   // K11's rows a ring stage
constexpr int kMergeBatch = 8;     // K11's merge loads a lane issues at once
constexpr int kWarpSampleStep = 4;  // K11's bound samples every 4th row of a chunk
constexpr int kScanBatch = 8;      // K11's rows a lane loads before their distances
static_assert(kScanBatch < 32, "K11's candidate bits of one query fit a word");
static_assert(kWarpStage % kSplitTile == 0, "K11's stage is whole ring tiles");
constexpr int kTile = sgt::kBoxRows;  // sorted rows per box (K12)
constexpr int kSeedTiles = 5;      // tiles around the anchor K12's first form scans first
using sgt::kNoIndex;
static_assert(kKnnThreads == sgt::kPrunedThreads, "K12 blocks use common.cuh's helpers");

__device__ __forceinline__ void load_query(const float* __restrict__ qry,
                                           int qstride, int row, float& x,
                                           float& y, float& z) {
  const float* q = qry + (size_t)row * qstride;
  x = q[0];
  y = q[1];
  z = q[2];
}

// ------------------------------------------------------------- K9 v1 ----

template <bool SCORE>
__global__ void __launch_bounds__(kKnnThreads)
nn1_kernel(const float* __restrict__ tgt, const int* __restrict__ tnum, int mcap,
           const float* __restrict__ qry, int qstride, int nq,
           const float* __restrict__ centre, float* __restrict__ out_d,
           int* __restrict__ out_i) {
  __shared__ float4 tile[kKnnTile];
  const int i = blockIdx.x * kKnnThreads + threadIdx.x;
  const int m = min(*tnum, mcap);
  const bool active = i < nq;
  const float4* t4 = reinterpret_cast<const float4*>(tgt);
  const float cx = centre[0], cy = centre[1], cz = centre[2];

  float ux = 0.f, uy = 0.f, uz = 0.f;
  if (active) load_query(qry, qstride, i, ux, uy, uz);
  const float qx = __fsub_rn(ux, cx);
  const float qy = __fsub_rn(uy, cy);
  const float qz = __fsub_rn(uz, cz);

  float best = kBig;
  int best_i = 0;
  for (int base = 0; base < m; base += kKnnTile) {
    const int cnt = min(kKnnTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kKnnThreads) {
      float4 p = t4[base + j];
      p.x = __fsub_rn(p.x, cx);
      p.y = __fsub_rn(p.y, cy);
      p.z = __fsub_rn(p.z, cz);
      if (SCORE)
        p.w = __fadd_rn(__fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y)),
                        __fmul_rn(p.z, p.z));
      tile[j] = p;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      float v;
      if (SCORE) {
        const float dot = __fadd_rn(
            __fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
        v = __fsub_rn(p.w, __fmul_rn(2.f, dot));
      } else {
        float dx, dy, dz;
        v = sgt::sq_dist(qx, qy, qz, p.x, p.y, p.z, dx, dy, dz);
      }
      if (v < best) {  // strict: the first index keeps a tie
        best = v;
        best_i = base + j;
      }
    }
  }
  if (!active) return;
  if (SCORE) {
    // The score only ranks; the distance comes from the uncentred rows.
    if (best < kBig) {
      const float4 p = t4[best_i];
      float dx, dy, dz;
      best = sgt::sq_dist(ux, uy, uz, p.x, p.y, p.z, dx, dy, dz);
    }
  }
  out_d[i] = best;
  out_i[i] = best_i;
}

// ------------------------------------------------------------ K10 v1 ----

// K10's list lives in local memory (L1), indexed at run time: its sampled
// bound is loose, so a query inserts some fifty times, and an insertion
// sort that stops where the new entry belongs costs its shift distance,
// while common.cuh's register list costs every insertion a pass over all
// KMAX slots, taken by the whole warp. On 108,043 × 108,043 points, k = 20,
// the search takes 17.9 ms this way against 50.1 ms with the register list
// (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, 700 W). K3, K4 and K12
// bound their lists tightly, insert rarely and keep them in registers.
template <int KMAX>
__global__ void __launch_bounds__(kKnnThreads)
knn_kernel(const float* __restrict__ tgt, const int* __restrict__ tnum, int mcap,
           const float* __restrict__ qry, int qstride, int nq, int k,
           float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[kKnnTile];
  const int i = blockIdx.x * kKnnThreads + threadIdx.x;
  const int m = min(*tnum, mcap);
  const bool active = i < nq;
  const float4* t4 = reinterpret_cast<const float4*>(tgt);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  float bound = kBig;
  if (active) {
    load_query(qry, qstride, i, qx, qy, qz);
    const int step = max(1, m / kSampleRows);
    bound = sgt::kth_bound<KMAX>(t4, 0, m, step, k, qx, qy, qz);
  }

  float bd[KMAX];
  int bi[KMAX];
  for (int s = 0; s < k; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }
  float kth = kBig;  // bd[k-1], the distance a candidate has to beat

  for (int base = 0; base < m; base += kKnnTile) {
    const int cnt = min(kKnnTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kKnnThreads) tile[j] = t4[base + j];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      float dx, dy, dz;
      const float d2 = sgt::sq_dist(qx, qy, qz, p.x, p.y, p.z, dx, dy, dz);
      if (d2 < kth && d2 <= bound) {
        // Rows arrive in index order, so inserting after equal entries
        // keeps ties at the lower index.
        int s = k - 1;
        while (s > 0 && bd[s - 1] > d2) {
          bd[s] = bd[s - 1];
          bi[s] = bi[s - 1];
          --s;
        }
        bd[s] = d2;
        bi[s] = base + j;
        kth = bd[k - 1];
      }
    }
  }
  if (!active) return;
  for (int s = 0; s < k; ++s) {
    out_d[(size_t)i * k + s] = bd[s];
    out_i[(size_t)i * k + s] = bi[s];  // 0 in a slot no row has filled
  }
}

// --------------------------------------------------- K9, K10: split ----

// Start the copy of rows [base, base + cnt) into dst: 16-byte cp.async
// copies; thread tid copies rows tid, tid + kSplitThreads, ….
__device__ __forceinline__ void stage_rows(float4* dst, const float4* t4, int base,
                                           int cnt) {
  for (int j = threadIdx.x; j < cnt; j += kSplitThreads)
    __pipeline_memcpy_async(dst + j, t4 + base + j, sizeof(float4));
}

// Rows per chunk when the m valid rows are cut into gridDim.y chunks of at
// least `least` rows (a multiple of kSplitTile): a multiple of kSplitTile;
// trailing chunks may be empty.
__device__ __forceinline__ int split_chunk(int m, int least) {
  return max(least, ((m + (int)gridDim.y - 1) / (int)gridDim.y + kSplitTile - 1) /
                        kSplitTile * kSplitTile);
}

// Called by every thread after it posted its chunk's results: true in the
// block of query block blockIdx.x that finished last among its chunks.
__device__ __forceinline__ bool last_chunk(unsigned* tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  return last;
}

// K9's result for query q: the winner (v, row) of the ranks; the score
// form's d² recomputed from the uncentred query (u) and row.
template <bool SCORE>
__device__ __forceinline__ void put_nn1(const float4* __restrict__ t4, float ux,
                                        float uy, float uz, float v, int row,
                                        float* __restrict__ out_d,
                                        int* __restrict__ out_i, int q) {
  if (SCORE && v < kBig) {
    const float4 p = t4[row];
    float dx, dy, dz;
    v = sgt::sq_dist(ux, uy, uz, p.x, p.y, p.z, dx, dy, dz);
  }
  out_d[q] = v;
  out_i[q] = row;
}

// keys [nq] and tickets [query blocks]: 0 between launches.
template <bool SCORE>
__global__ void __launch_bounds__(kSplitThreads)
nn1_split_kernel(const float* __restrict__ tgt, const int* __restrict__ tnum, int mcap,
                 const float* __restrict__ qry, int qstride, int nq,
                 const float* __restrict__ centre,
                 unsigned long long* __restrict__ keys, unsigned* __restrict__ tickets,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int R = kNn1Rows;
  __shared__ __align__(16) float4 tile[2][kSplitTile];
  const int q0 = blockIdx.x * R * kSplitThreads + threadIdx.x;  // + r·kSplitThreads
  const int m = min(*tnum, mcap);
  const int chunk = split_chunk(m, kSplitTile);
  const int lo = blockIdx.y * chunk;
  const int cnt = max(0, min(m - lo, chunk));
  const float4* t4 = reinterpret_cast<const float4*>(tgt);
  const float cx = centre[0], cy = centre[1], cz = centre[2];

  float ux[R], uy[R], uz[R], qx[R], qy[R], qz[R], best[R];
  int best_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ux[r] = uy[r] = uz[r] = 0.f;
    if (q0 + r * kSplitThreads < nq)
      load_query(qry, qstride, q0 + r * kSplitThreads, ux[r], uy[r], uz[r]);
    qx[r] = __fsub_rn(ux[r], cx);
    qy[r] = __fsub_rn(uy[r], cy);
    qz[r] = __fsub_rn(uz[r], cz);
    best[r] = kBig;
    best_i[r] = 0;
  }

  // Tile t goes to ring slot t & 1, one commit group per tile.
  const int ntiles = (cnt + kSplitTile - 1) / kSplitTile;
  if (ntiles > 0) stage_rows(tile[0], t4, lo, min(kSplitTile, cnt));
  __pipeline_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int base = lo + t * kSplitTile;
    const int rows = min(kSplitTile, cnt - t * kSplitTile);
    if (t + 1 < ntiles)
      stage_rows(tile[(t + 1) & 1], t4, base + kSplitTile,
                 min(kSplitTile, cnt - (t + 1) * kSplitTile));
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of tile t landed
    float4* tl = tile[t & 1];
    // Centre the rows this thread copied; the score form's |t|² goes to w.
    for (int j = threadIdx.x; j < rows; j += kSplitThreads) {
      float4 p = tl[j];
      p.x = __fsub_rn(p.x, cx);
      p.y = __fsub_rn(p.y, cy);
      p.z = __fsub_rn(p.z, cz);
      if (SCORE)
        p.w = __fadd_rn(__fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y)),
                        __fmul_rn(p.z, p.z));
      tl[j] = p;
    }
    __syncthreads();  // every thread's rows are in place
#pragma unroll 2
    for (int j = 0; j < rows; ++j) {
      const float4 p = tl[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v;
        if (SCORE) {
          const float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(qx[r], p.x), __fmul_rn(qy[r], p.y)),
              __fmul_rn(qz[r], p.z));
          v = __fsub_rn(p.w, __fmul_rn(2.f, dot));
        } else {
          float dx, dy, dz;
          v = sgt::sq_dist(qx[r], qy[r], qz[r], p.x, p.y, p.z, dx, dy, dz);
        }
        if (v < best[r]) {  // strict: the first row keeps a tie
          best[r] = v;
          best_i[r] = base + j;
        }
      }
    }
    __syncthreads();  // slot t & 1 is read; tile t + 2 may land there
  }

  if (gridDim.y == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (q0 + r * kSplitThreads < nq)
        put_nn1<SCORE>(t4, ux[r], uy[r], uz[r], best[r], best_i[r], out_d, out_i,
                       q0 + r * kSplitThreads);
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * kSplitThreads;
    if (q < nq && best[r] < kBig) {
      // -0 + 0 = +0: equal ranks get equal keys.
      const unsigned long long key =
          ((unsigned long long)sgt::orderable(__fadd_rn(best[r], 0.f)) << 32) |
          (unsigned)best_i[r];
      atomicMax(keys + q, ~key);
    }
  }
  if (!last_chunk(tickets)) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * kSplitThreads;
    if (q >= nq) continue;
    const unsigned long long key = ~__ldcg(keys + q);
    keys[q] = 0ull;
    const bool found = key != ~0ull;  // some chunk posted a winner
    put_nn1<SCORE>(t4, ux[r], uy[r], uz[r],
                   found ? sgt::from_orderable((unsigned)(key >> 32)) : kBig,
                   found ? (int)(key & 0xffffffffu) : 0, out_d, out_i, q);
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// K10's sorted list (d, p) of length k ≤ KMAX. Up to kRegList slots it is
// kept in registers: every access is unrolled over the slots with constant
// indices, and an insertion costs a pass over all of them. Longer lists
// live in local memory, indexed at run time, where an insertion shifts only
// the entries behind it.
template <int KMAX>
constexpr bool kInRegisters = KMAX <= kRegList;

template <int KMAX>
__device__ __forceinline__ float list_kth(const float (&d)[KMAX], int k) {
  if (kInRegisters<KMAX>) return sgt::topk_slot<KMAX>(d, k - 1);
  return d[k - 1];
}

// Insert (d2, row) after every entry ≤ d2; the caller has checked
// d2 < the list's kth.
template <int KMAX>
__device__ __forceinline__ void list_insert(float (&d)[KMAX], int (&p)[KMAX], int k,
                                            float d2, int row) {
  if (kInRegisters<KMAX>) {
#pragma unroll
    for (int s = KMAX - 1; s > 0; --s) {
      if (s < k) {
        if (d[s - 1] > d2) {
          d[s] = d[s - 1];
          p[s] = p[s - 1];
        } else if (d[s] > d2) {
          d[s] = d2;
          p[s] = row;
        }
      }
    }
    if (d[0] > d2) {
      d[0] = d2;
      p[0] = row;
    }
    return;
  }
  int s = k - 1;
  while (s > 0 && d[s - 1] > d2) {
    d[s] = d[s - 1];
    p[s] = p[s - 1];
    --s;
  }
  d[s] = d2;
  p[s] = row;
}

// A bound B of query q's kth d² over the whole target, shared by its
// chunks: words[q] holds ~bits(B) (d² ≥ 0, so the bits order as the values),
// 0 for none; atomicMax keeps the smallest B.
__device__ __forceinline__ void share_bound(unsigned* words, int q, float& b) {
  const unsigned w = __ldcg(words + q);
  if (w != 0u && __uint_as_float(~w) < b) b = __uint_as_float(~w);
  else if (b < kBig && (w == 0u || b < __uint_as_float(~w)))
    atomicMax(words + q, ~__float_as_uint(b));
}

// ws_d / ws_i [gridDim.y, k, nq], bounds [nq] (used when gridDim.y > 1),
// tickets [query blocks]; bounds and tickets are 0 between launches.
template <int KMAX>
__global__ void __launch_bounds__(kSplitThreads)
knn_split_kernel(const float* __restrict__ tgt, const int* __restrict__ tnum, int mcap,
                 const float* __restrict__ qry, int qstride, int nq, int k, int least,
                 float* __restrict__ ws_d, int* __restrict__ ws_i,
                 unsigned* __restrict__ bounds, unsigned* __restrict__ tickets,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int R = kKnnRows;
  __shared__ __align__(16) float4 tile[2][kSplitTile];
  const int q0 = blockIdx.x * R * kSplitThreads + threadIdx.x;  // + r·kSplitThreads
  const int m = min(*tnum, mcap);
  const int chunk = split_chunk(m, least);
  const int lo = blockIdx.y * chunk;
  const int cnt = max(0, min(m - lo, chunk));
  const bool shared = gridDim.y > 1;
  const float4* t4 = reinterpret_cast<const float4*>(tgt);

  // Query r's list (bd[r], bi[r]). bnd[r] is a bound of its kth d² over
  // the whole target: its own chunk's sampled bound, its own list's kth once
  // full, and with more than one chunk the other chunks' (bounds). Every
  // row of the final list has d² ≤ bnd[r], and a row of this chunk that
  // belongs to it is among the chunk's k first; so a row enters the list
  // only if d² < lim[r] = min(the list's kth, the float above bnd[r]).
  float qx[R], qy[R], qz[R], bnd[R], lim[R];
  float bd[R][KMAX];
  int bi[R][KMAX];
  const float inf = __int_as_float(0x7f800000);
  const int step = max(kSampleStep, (cnt + kChunkSample - 1) / kChunkSample);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * kSplitThreads;
    qx[r] = qy[r] = qz[r] = 0.f;
    bnd[r] = kBig;
    if (q < nq) {
      load_query(qry, qstride, q, qx[r], qy[r], qz[r]);
      if (cnt > kSplitTile)
        bnd[r] = sgt::kth_bound<KMAX>(t4, lo, lo + cnt, step, k, qx[r], qy[r], qz[r]);
      if (shared && cnt > 0) share_bound(bounds, q, bnd[r]);
    }
    lim[r] = fminf(kBig, nextafterf(bnd[r], inf));
    sgt::topk_fill<KMAX>(bd[r], kBig);
    sgt::topk_fill<KMAX>(bi[r], 0);
  }

  const int ntiles = (cnt + kSplitTile - 1) / kSplitTile;
  if (ntiles > 0) stage_rows(tile[0], t4, lo, min(kSplitTile, cnt));
  __pipeline_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int base = lo + t * kSplitTile;
    const int rows = min(kSplitTile, cnt - t * kSplitTile);
    if (t + 1 < ntiles)
      stage_rows(tile[(t + 1) & 1], t4, base + kSplitTile,
                 min(kSplitTile, cnt - (t + 1) * kSplitTile));
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float4* tl = tile[t & 1];
    for (int j = 0; j < rows; ++j) {
      const float4 p = tl[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dx, dy, dz;
        const float d2 = sgt::sq_dist(qx[r], qy[r], qz[r], p.x, p.y, p.z, dx, dy, dz);
        if (d2 < lim[r]) {
          // Rows arrive in index order: after equal entries keeps ties low.
          list_insert<KMAX>(bd[r], bi[r], k, d2, base + j);
          lim[r] = fminf(list_kth<KMAX>(bd[r], k), nextafterf(bnd[r], inf));
        }
      }
    }
    if (shared) {  // trade bounds with the query's other chunks
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q = q0 + r * kSplitThreads;
        if (q >= nq) continue;
        bnd[r] = fminf(bnd[r], list_kth<KMAX>(bd[r], k));
        share_bound(bounds, q, bnd[r]);
        lim[r] = fminf(list_kth<KMAX>(bd[r], k), nextafterf(bnd[r], inf));
      }
    }
    __syncthreads();
  }

  if (gridDim.y > 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = q0 + r * kSplitThreads;
      if (q >= nq || cnt == 0) continue;  // the merge skips empty chunks
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        if (s >= k) break;
        const size_t at = ((size_t)blockIdx.y * k + s) * nq + q;
        ws_d[at] = bd[r][s];
        ws_i[at] = bi[r][s];
      }
    }
    if (!last_chunk(tickets)) return;
    // Merge the chunks' lists in chunk order: rows ascend from chunk to
    // chunk, so an entry that only ties the kth loses to it.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = q0 + r * kSplitThreads;
      if (q >= nq) continue;
      sgt::topk_fill<KMAX>(bd[r], kBig);
      sgt::topk_fill<KMAX>(bi[r], 0);
      bounds[q] = 0u;
      float kth = kBig;
      for (int c = 0; c * chunk < m; ++c) {
        for (int s = 0; s < k; ++s) {
          const size_t at = ((size_t)c * k + s) * nq + q;
          const float d2 = __ldcg(ws_d + at);
          if (!(d2 < kth)) break;  // the chunk's list ascends
          list_insert<KMAX>(bd[r], bi[r], k, d2, __ldcg(ws_i + at));
          kth = list_kth<KMAX>(bd[r], k);
        }
      }
    }
    if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * kSplitThreads;
    if (q >= nq) continue;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s >= k) break;
      out_d[(size_t)q * k + s] = bd[r][s];
      out_i[(size_t)q * k + s] = bi[r][s];  // 0 in a slot no row has filled
    }
  }
}

// --------------------------------------------------------------- K11 ----

__global__ void __launch_bounds__(128)
knn_warp_kernel_v1(const float* __restrict__ tgt, const int* __restrict__ tnum,
                int mcap, const float* __restrict__ qry, int qstride, int nq, int k,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  // tile [kWarpTile] float4 | per warp: d [k][32] float, idx [k][32] int
  extern __shared__ float4 smem[];
  float4* tile = smem;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ld = reinterpret_cast<float*>(smem + kWarpTile) + (size_t)warp * k * 64;
  int* li = reinterpret_cast<int*>(ld + (size_t)k * 32);
  const int i = blockIdx.x * warps + warp;  // this warp's query
  const int m = min(*tnum, mcap);
  const bool active = i < nq;
  const float4* t4 = reinterpret_cast<const float4*>(tgt);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) load_query(qry, qstride, i, qx, qy, qz);
  sgt::lane_list_clear(ld, li, lane, k);
  float kth = kBig;  // this lane's d[k-1]

  for (int base = 0; base < m; base += kWarpTile) {
    const int cnt = min(kWarpTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) tile[j] = t4[base + j];
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < cnt; j += 32) {
      const float4 p = tile[j];
      float dx, dy, dz;
      const float d2 = sgt::sq_dist(qx, qy, qz, p.x, p.y, p.z, dx, dy, dz);
      // A lane sees its rows in index order, so ties keep the lower row.
      if (d2 < kth) sgt::lane_list_insert(ld, li, lane, k, d2, base + j, kth);
    }
  }
  if (!active) return;  // uniform over the warp

  // Merge: k rounds of the smallest head over the lanes.
  int head = 0;
  for (int r = 0; r < k; ++r) {
    float bd;
    int bi;
    sgt::lane_lists_pop(ld, li, lane, k, head, bd, bi);
    if (lane == 0) {
      out_d[(size_t)i * k + r] = bd;
      out_i[(size_t)i * k + r] = bd < kBig ? bi : 0;
    }
  }
}


// Queries a warp of K11 holds for k neighbours, and warps a block.
__host__ __device__ __forceinline__ int warp_queries(int k) {
  const int qw = k <= 16 ? kWarpQueries : k <= 32 ? kWarpQueries / 2 : kWarpQueries / 4;
  return qw < 1 ? 1 : qw;
}

__host__ __device__ __forceinline__ int warp_block_warps(int k) {
  const int w = kWarpListBytes / (warp_queries(k) * k * 32 * 8);
  return w < 1 ? 1 : w > kWarpMaxWarps ? kWarpMaxWarps : w;
}

// Stream the rows lo + r · step, r < count, through K11's two-stage ring
// of kWarpStage rows: body(tile, first r of the stage, rows) runs once a
// stage has landed, while the next one is copied. Called by all threads.
template <class Body>
__device__ __forceinline__ void stream_rows(float4* ring, const float4* t4, int lo,
                                            int count, int step, Body&& body) {
  auto stage = [&](int t) {
    float4* dst = ring + (t & 1) * kWarpStage;
    const int first = t * kWarpStage, rows = min(kWarpStage, count - first);
    for (int j = threadIdx.x; j < rows; j += blockDim.x)
      __pipeline_memcpy_async(dst + j, t4 + lo + (size_t)(first + j) * step,
                              sizeof(float4));
  };
  const int nstages = (count + kWarpStage - 1) / kWarpStage;
  if (nstages > 0) stage(0);
  __pipeline_commit();
  for (int t = 0; t < nstages; ++t) {
    if (t + 1 < nstages) stage(t + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    body(ring + (t & 1) * kWarpStage, t * kWarpStage,
         min(kWarpStage, count - t * kWarpStage));
    __syncthreads();  // the stage is read; stage t + 2 may land there
  }
}

// Pop the k entries of a warp's lane lists in (d², index) order: lane 0
// writes entry s to d[s · stride], i[s · stride] (index 0 for an empty
// slot where `clean`, else kNoIndex as it is).
__device__ __forceinline__ void pop_list(const float* ld, const int* li, int lane, int k,
                                         float* __restrict__ d, int* __restrict__ i,
                                         size_t stride, bool clean) {
  int head = 0;
  for (int s = 0; s < k; ++s) {
    float bd;
    int bi;
    sgt::lane_lists_pop(ld, li, lane, k, head, bd, bi);
    if (lane == 0) {
      d[s * stride] = bd;
      i[s * stride] = clean && !(bd < kBig) ? 0 : bi;
    }
  }
}

// ws_d / ws_i [gridDim.y, k, nq] (used when gridDim.y > 1), tickets [query
// blocks], 0 between launches. Dynamic shared memory: the ring of two
// kWarpStage-row stages, then per warp QW lists of k × 32 (d², index)
// entries.
template <int QW>
__global__ void __launch_bounds__(kWarpMaxWarps * 32)
knn_warp_split_kernel(const float* __restrict__ tgt, const int* __restrict__ tnum,
                      int mcap, const float* __restrict__ qry, int qstride, int nq, int k,
                      float* __restrict__ ws_d, int* __restrict__ ws_i,
                      unsigned* __restrict__ tickets, float* __restrict__ out_d,
                      int* __restrict__ out_i) {
  using Mask = typename std::conditional<(QW * kScanBatch > 32), unsigned long long,
                                         unsigned>::type;
  extern __shared__ float4 smem[];
  float4* ring = smem;  // [2][kWarpStage]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* lists = reinterpret_cast<float*>(smem + 2 * kWarpStage) +
                 (size_t)warp * QW * k * 64;  // query r: d at r·k·64, index beside
  const int q0 = (blockIdx.x * (blockDim.x >> 5) + warp) * QW;  // the warp's first query
  const int m = min(*tnum, mcap);
  const int chunk = split_chunk(m, kSplitTile);
  const int lo = blockIdx.y * chunk;
  const int cnt = max(0, min(m - lo, chunk));
  const bool busy = q0 < nq;  // the same over the warp
  const float4* t4 = reinterpret_cast<const float4*>(tgt);
  const float inf = __int_as_float(0x7f800000);
  auto ld = [&](int r) { return lists + (size_t)r * k * 64; };
  auto li = [&](int r) { return reinterpret_cast<int*>(lists + (size_t)r * k * 64 + k * 32); };

  float qx[QW], qy[QW], qz[QW], lim[QW], bnd[QW];
  int n[QW];  // entries in lane list r
#pragma unroll
  for (int r = 0; r < QW; ++r) {
    qx[r] = qy[r] = qz[r] = 0.f;
    if (q0 + r < nq) load_query(qry, qstride, q0 + r, qx[r], qy[r], qz[r]);
    sgt::lane_list_clear(ld(r), li(r), lane, k);
    bnd[r] = kBig;
    n[r] = 0;
  }
  // The chunk's bound B: every kWarpSampleStep-th row of the chunk,
  // streamed through the ring, sample s taken by lane s mod 32. Each lane
  // keeps the t smallest d² of its samples (t = 1 up to k = 32, 2 above) in
  // registers; B is the ⌈k/t⌉-th smallest of the lanes' t-th values: the
  // lanes at or below it hold at least k distinct rows within it, so B
  // bounds the query's kth d² over the chunk.
  if (cnt > kSplitTile) {
    float v1[QW], v2[QW];  // the lane's smallest and second smallest
#pragma unroll
    for (int r = 0; r < QW; ++r) v1[r] = v2[r] = kBig;
    stream_rows(ring, t4, lo, (cnt + kWarpSampleStep - 1) / kWarpSampleStep,
                kWarpSampleStep, [&](const float4* tl, int, int rows) {
                  if (!busy) return;
#pragma unroll 4
                  for (int j = lane; j < rows; j += 32) {
                    const float4 p = tl[j];
#pragma unroll
                    for (int r = 0; r < QW; ++r) {
                      float dx, dy, dz;
                      const float d2 =
                          sgt::sq_dist(qx[r], qy[r], qz[r], p.x, p.y, p.z, dx, dy, dz);
                      v2[r] = fminf(v2[r], fmaxf(v1[r], d2));
                      v1[r] = fminf(v1[r], d2);
                    }
                  }
                });
    const bool two = k > 32;
    if (busy) {
#pragma unroll
      for (int r = 0; r < QW; ++r)
        bnd[r] = sgt::warp_mth_smallest(two ? v2[r] : v1[r], two ? (k + 1) / 2 : k);
    }
  }
  // A row enters lane list r if d² < lim[r] = min(the list's kth once
  // full, the float above B).
  float bnd_up[QW];
#pragma unroll
  for (int r = 0; r < QW; ++r) {
    bnd_up[r] = nextafterf(bnd[r], inf);
    lim[r] = fminf(kBig, bnd_up[r]);
  }

  // The scan: kScanBatch rows a lane at a time, all their loads first, then
  // the distances, the candidates (d² < lim) as bits r · kScanBatch + u;
  // only a batch with a candidate takes the branch that inserts them, query
  // by query in row order (a lane sees its rows in index order, so ties keep
  // the lower row), each tested again against its tightened limit.
  stream_rows(ring, t4, lo, cnt, 1, [&](const float4* tl, int first, int rows) {
    if (!busy) return;
    const int base = lo + first;
    for (int j0 = lane; j0 < rows; j0 += 32 * kScanBatch) {
      float4 p[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) p[u] = tl[min(j0 + 32 * u, rows - 1)];
      Mask bits = 0;
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
#pragma unroll
        for (int r = 0; r < QW; ++r) {
          float dx, dy, dz;
          const float d2 =
              sgt::sq_dist(qx[r], qy[r], qz[r], p[u].x, p[u].y, p[u].z, dx, dy, dz);
          if (d2 < lim[r] && j0 + 32 * u < rows) bits |= Mask(1) << (r * kScanBatch + u);
        }
      }
      if (!bits) continue;
#pragma unroll
      for (int r = 0; r < QW; ++r) {
        unsigned b = (unsigned)(bits >> (r * kScanBatch)) & ((1u << kScanBatch) - 1u);
        while (b) {
          const int j = j0 + 32 * (__ffs(b) - 1);
          b &= b - 1u;
          const float4 pj = tl[j];
          float dx, dy, dz;
          const float d2 = sgt::sq_dist(qx[r], qy[r], qz[r], pj.x, pj.y, pj.z, dx, dy, dz);
          if (d2 < lim[r]) {
            sgt::lane_list_push(ld(r), li(r), lane, k, n[r], d2, base + j);
            if (n[r] == k) lim[r] = fminf(ld(r)[(k - 1) * 32 + lane], bnd_up[r]);
          }
        }
      }
    }
  });

  if (gridDim.y == 1) {
#pragma unroll
    for (int r = 0; r < QW; ++r)
      if (q0 + r < nq)
        pop_list(ld(r), li(r), lane, k, out_d + (size_t)(q0 + r) * k,
                 out_i + (size_t)(q0 + r) * k, 1, true);
    return;
  }
  if (cnt > 0) {  // the merge skips empty chunks
#pragma unroll
    for (int r = 0; r < QW; ++r)
      if (q0 + r < nq) {
        const size_t at = (size_t)blockIdx.y * k * nq + q0 + r;
        pop_list(ld(r), li(r), lane, k, ws_d + at, ws_i + at, nq, false);
      }
  }
  if (!last_chunk(tickets)) return;
  // Merge the chunks' lists: lane l takes entries l, l + 32, … of the
  // non-empty chunks' lists laid end to end (entry f: chunk f / k, slot
  // f % k), kMergeBatch at a time, into its list in (d², index) order.
  const int entries = (m + chunk - 1) / chunk * k;
#pragma unroll
  for (int r = 0; r < QW; ++r) {
    const int q = q0 + r;
    if (q >= nq) continue;  // the same over the warp
    sgt::lane_list_clear(ld(r), li(r), lane, k);
    float kth = kBig;
    int kth0 = kNoIndex, fill = 0;
    for (int f0 = lane; f0 < entries; f0 += 32 * kMergeBatch) {
      float d2[kMergeBatch];
      int row[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const int f = f0 + 32 * u;
        d2[u] = kBig;
        row[u] = kNoIndex;
        if (f < entries) {
          const size_t at = (size_t)f * nq + q;  // (chunk · k + slot) · nq + q
          d2[u] = __ldcg(ws_d + at);
          row[u] = __ldcg(ws_i + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (sgt::lex_before(d2[u], row[u], kth, kth0)) {
          sgt::lane_list_push_lex(ld(r), li(r), lane, k, fill, d2[u], row[u]);
          if (fill == k) {
            kth = ld(r)[(k - 1) * 32 + lane];
            kth0 = li(r)[(k - 1) * 32 + lane];
          }
        }
    }
    pop_list(ld(r), li(r), lane, k, out_d + (size_t)q * k, out_i + (size_t)q * k, 1, true);
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// --------------------------------------------------------------- K12 ----

// The first form. qpos [nq]: sorted position → insertion position in the
// sorted target.
template <int KMAX>
__global__ void __launch_bounds__(kKnnThreads)
knn_pruned_kernel_v1(const float* __restrict__ tsorted, const int* __restrict__ tnum,
                  int mcap, const float* __restrict__ tbox,
                  const float* __restrict__ qry, int qstride, int nq,
                  const int* __restrict__ qperm, const int* __restrict__ qpos, int k,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  __shared__ float sw[kKnnThreads / 32];
  const int i = blockIdx.x * kKnnThreads + threadIdx.x;  // sorted position
  const int m = min(*tnum, mcap);
  const bool active = i < nq;
  const float4* t4 = reinterpret_cast<const float4*>(tsorted);
  const int ntiles = (m + kTile - 1) / kTile;  // tiles that hold a valid row

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int row = 0;
  if (active) {
    row = qperm[i];
    load_query(qry, qstride, row, qx, qy, qz);
  }
  float lo[3], hi[3];  // the block's query box
  sgt::block_box(active, qx, qy, qz, sw, lo, hi);

  float bd[KMAX];
  unsigned bi[KMAX];
  sgt::topk_fill<KMAX>(bd, kBig);
  sgt::topk_fill<KMAX>(bi, (unsigned)kNoIndex);
  float kth = kBig;
  unsigned kth0 = (unsigned)kNoIndex;

  // Seed: the tiles around the median query's position in the sorted target.
  int seed_lo = 0, seed_hi = -1;
  if (ntiles > 0) {
    const int mid = min(blockIdx.x * kKnnThreads + kKnnThreads / 2, nq - 1);
    const int anchor = min(max(qpos[mid], 0), m - 1) / kTile;
    seed_lo = max(0, anchor - kSeedTiles / 2);
    seed_hi = min(ntiles - 1, anchor + kSeedTiles / 2);
    for (int t = seed_lo; t <= seed_hi; ++t)
      sgt::scan_tile<KMAX, false>(t4, tbox, m, t, tile, active, qx, qy, qz, k, kBig,
                                  bd, bi, kth, kth0);
  }
  float bound = sgt::block_max(active ? kth : 0.f, sw);

  // Completion: every other tile whose box is within the bound.
  for (int t = 0; t < ntiles; ++t) {
    if (t >= seed_lo && t <= seed_hi) continue;
    const float gap2 =
        sgt::box_gap2(tbox + (size_t)t * 8, lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]);
    if (gap2 > bound) continue;  // the same for every thread of the block
    sgt::scan_tile<KMAX, false>(t4, tbox, m, t, tile, active, qx, qy, qz, k, kBig, bd,
                                bi, kth, kth0);
    bound = sgt::block_max(active ? kth : 0.f, sw);
  }
  if (active) sgt::store_list<KMAX>(bd, bi, k, out_d, out_i, (size_t)row);
}

// The first position of the m sorted keys whose key is not below v.
__device__ __forceinline__ int code_position(const long long* __restrict__ keys, int m,
                                           long long v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// tkey [mcap]: the sorted Morton codes of the target rows; qperm [nq]:
// sorted position → query row; qkey [nq]: the queries' sorted codes.
template <int KMAX, int TEAM>
__global__ void __launch_bounds__(kKnnThreads)
knn_pruned_walk_kernel(const float* __restrict__ tsorted, const int* __restrict__ tnum,
                       int mcap, const float* __restrict__ tbox,
                       const long long* __restrict__ tkey, const float* __restrict__ qry,
                       int qstride, int nq, const long long* __restrict__ qperm,
                       const int* __restrict__ qkey, int k, int window,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kQueries = kKnnThreads / TEAM;
  const int i = blockIdx.x * kQueries + threadIdx.x / TEAM;  // sorted position
  const int m = min(*tnum, mcap);
  const bool active = i < nq;
  const float4* t4 = reinterpret_cast<const float4*>(tsorted);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int row = 0, wlo = 0, whi = 0, wstep = 1;
  if (active) {
    row = (int)qperm[i];
    load_query(qry, qstride, row, qx, qy, qz);
    // The query's reach: over the `window` sorted rows around its insertion
    // position, or, where more rows than that share its code, over `window`
    // rows spread evenly across them.
    const int pos = code_position(tkey, m, qkey[i]);
    const int end = code_position(tkey, m, (long long)qkey[i] + 1);
    if (end - pos <= window) {
      wlo = max(0, min(pos - window / 2, m - window));
      whi = min(m, wlo + window);
    } else {
      wlo = pos;
      whi = end;
      wstep = (end - pos + window - 1) / window;
    }
  }
  // The anchor: the box of the median query's insertion position.
  const int mid = min(blockIdx.x * kQueries + kQueries / 2, nq - 1);
  const int own = m > 0 ? min(code_position(tkey, m, qkey[mid]), m - 1) / kTile : 0;

  float bd[KMAX];
  unsigned bi[KMAX];
  sgt::topk_fill<KMAX>(bi, (unsigned)kNoIndex);
  float kth;
  unsigned kth0 = (unsigned)kNoIndex;
  sgt::walk_sorted<KMAX, TEAM>(t4, m, tbox, k, wlo, whi, wstep, own, active, qx, qy, qz,
                               bd, bi, kth, kth0);
  sgt::unseed<KMAX>(bd, bi);
  // Merge the team's lists; member 0 writes slot r of the query's row.
  int head = 0;
  const bool writer = active && threadIdx.x % TEAM == 0;
  for (int r = 0; r < k; ++r) {
    float wd;
    int wi;
    sgt::team_list_pop<KMAX, TEAM>(bd, bi, k, head, wd, wi);
    if (writer) {
      out_d[(size_t)row * k + r] = wd;
      out_i[(size_t)row * k + r] = wd < kBig ? wi : 0;
    }
  }
}

inline bool bad_search(int mcap, int qstride, int nq) {
  return mcap < 0 || nq <= 0 || (qstride != 3 && qstride != 4);
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch. tgt [mcap,4] f32,
// tnum device int32, qry nq rows of qstride floats, out_d / out_i [nq] or
// [nq,k].

// K9. centre: 3 device floats; variant 0 = difference form, 1 = score form.
// The valid target rows are cut into nsplit chunks (split_chunk); keys [nq]
// and tickets [query blocks] are 0 between launches and left so.
int sgt_nn1(const float* tgt, const int* tnum, int mcap, const float* qry,
            int qstride, int nq, const float* centre, int variant, int nsplit,
            unsigned long long* keys, unsigned* tickets, float* out_d, int* out_i,
            void* stream) {
  if (bad_search(mcap, qstride, nq) || nsplit < 1 || nsplit > 65535 || variant < 0 ||
      variant > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kNn1Rows * kSplitThreads - 1) / (kNn1Rows * kSplitThreads),
                  nsplit);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    nn1_split_kernel<false><<<grid, kSplitThreads, 0, s>>>(
        tgt, tnum, mcap, qry, qstride, nq, centre, keys, tickets, out_d, out_i);
  else
    nn1_split_kernel<true><<<grid, kSplitThreads, 0, s>>>(
        tgt, tnum, mcap, qry, qstride, nq, centre, keys, tickets, out_d, out_i);
  return (int)cudaGetLastError();
}

// K10. Chunks as for K9, of at least `least` rows (a positive multiple of
// kSplitTile); ws_d / ws_i hold nsplit · k · nq entries when nsplit > 1;
// bounds [nq] and tickets are 0 between launches and left so.
int sgt_knn(const float* tgt, const int* tnum, int mcap, const float* qry,
            int qstride, int nq, int k, int nsplit, int least, float* ws_d, int* ws_i,
            unsigned* bounds, unsigned* tickets, float* out_d, int* out_i,
            void* stream) {
  if (bad_search(mcap, qstride, nq) || nsplit < 1 || nsplit > 65535 || k < 1 ||
      k > 64 || least < kSplitTile || least % kSplitTile != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kKnnRows * kSplitThreads - 1) / (kKnnRows * kSplitThreads),
                  nsplit);
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_split_kernel<16><<<grid, kSplitThreads, 0, s>>>(
        tgt, tnum, mcap, qry, qstride, nq, k, least, ws_d, ws_i, bounds, tickets, out_d,
        out_i);
  else if (k <= 32)
    knn_split_kernel<32><<<grid, kSplitThreads, 0, s>>>(
        tgt, tnum, mcap, qry, qstride, nq, k, least, ws_d, ws_i, bounds, tickets, out_d,
        out_i);
  else
    knn_split_kernel<64><<<grid, kSplitThreads, 0, s>>>(
        tgt, tnum, mcap, qry, qstride, nq, k, least, ws_d, ws_i, bounds, tickets, out_d,
        out_i);
  return (int)cudaGetLastError();
}

// The split geometry that the wrapper's plan and plain account repeat:
// out[0..4] = queries per K9 block, per K10 block, rows per ring stage
// (chunks are multiples of it), K10's least sample step and most sampled
// rows per chunk.
int sgt_knn_split_geometry(int* out) {
  out[0] = kNn1Rows * kSplitThreads;
  out[1] = kKnnRows * kSplitThreads;
  out[2] = kSplitTile;
  out[3] = kSampleStep;
  out[4] = kChunkSample;
  return 0;
}

// K9 v1, the yardstick: one thread per query over every row.
int sgt_nn1_v1(const float* tgt, const int* tnum, int mcap, const float* qry,
               int qstride, int nq, const float* centre, int variant, float* out_d,
               int* out_i, void* stream) {
  if (bad_search(mcap, qstride, nq) || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (nq + kKnnThreads - 1) / kKnnThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    nn1_kernel<false><<<blocks, kKnnThreads, 0, s>>>(tgt, tnum, mcap, qry, qstride,
                                                     nq, centre, out_d, out_i);
  else
    nn1_kernel<true><<<blocks, kKnnThreads, 0, s>>>(tgt, tnum, mcap, qry, qstride,
                                                    nq, centre, out_d, out_i);
  return (int)cudaGetLastError();
}

// K10 v1, the yardstick.
int sgt_knn_v1(const float* tgt, const int* tnum, int mcap, const float* qry,
               int qstride, int nq, int k, float* out_d, int* out_i, void* stream) {
  if (bad_search(mcap, qstride, nq) || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const int blocks = (nq + kKnnThreads - 1) / kKnnThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_kernel<16><<<blocks, kKnnThreads, 0, s>>>(tgt, tnum, mcap, qry, qstride, nq,
                                                  k, out_d, out_i);
  else if (k <= 32)
    knn_kernel<32><<<blocks, kKnnThreads, 0, s>>>(tgt, tnum, mcap, qry, qstride, nq,
                                                  k, out_d, out_i);
  else
    knn_kernel<64><<<blocks, kKnnThreads, 0, s>>>(tgt, tnum, mcap, qry, qstride, nq,
                                                  k, out_d, out_i);
  return (int)cudaGetLastError();
}

// K11. Chunks as for K9 (nsplit, split_chunk); ws_d / ws_i hold nsplit ·
// k · nq entries when nsplit > 1; tickets are 0 between launches and left
// so. A block holds warp_block_warps(k) warps of warp_queries(k) queries.
int sgt_knn_warp(const float* tgt, const int* tnum, int mcap, const float* qry,
                 int qstride, int nq, int k, int nsplit, float* ws_d, int* ws_i,
                 unsigned* tickets, float* out_d, int* out_i, void* stream) {
  if (bad_search(mcap, qstride, nq) || nsplit < 1 || nsplit > 65535 || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const int qw = warp_queries(k), warps = warp_block_warps(k);
  const int per_block = qw * warps;
  const dim3 grid((nq + per_block - 1) / per_block, nsplit);
  const size_t shared = 2 * kWarpStage * sizeof(float4) + (size_t)warps * qw * k * 32 * 8;
  cudaStream_t s = (cudaStream_t)stream;
#define SGT_KNN_WARP(QW)                                                             \
  case QW:                                                                           \
    cudaFuncSetAttribute(knn_warp_split_kernel<QW>,                                  \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared); \
    knn_warp_split_kernel<QW><<<grid, warps * 32, shared, s>>>(                      \
        tgt, tnum, mcap, qry, qstride, nq, k, ws_d, ws_i, tickets, out_d, out_i);    \
    break;
  switch (qw) {
    SGT_KNN_WARP(1)
    SGT_KNN_WARP(2)
    SGT_KNN_WARP(4)
    SGT_KNN_WARP(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SGT_KNN_WARP
  return (int)cudaGetLastError();
}

// K11's block shape and sample, which the wrapper's plan and plain
// account repeat: out[0..3] = kWarpQueries, kWarpMaxWarps, kWarpListBytes,
// kWarpSampleStep.
int sgt_knn_warp_geometry(int* out) {
  out[0] = kWarpQueries;
  out[1] = kWarpMaxWarps;
  out[2] = kWarpListBytes;
  out[3] = kWarpSampleStep;
  return 0;
}

// K11's first form: four queries (warps) per block up to k = 32, two
// above, so the lists stay within 32 KB of shared memory.
int sgt_knn_warp_v1(const float* tgt, const int* tnum, int mcap, const float* qry,
                    int qstride, int nq, int k, float* out_d, int* out_i,
                    void* stream) {
  if (bad_search(mcap, qstride, nq) || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const int warps = k <= 32 ? 4 : 2;
  const int blocks = (nq + warps - 1) / warps;
  const size_t shared = kWarpTile * sizeof(float4) + (size_t)warps * k * 32 * 8;
  knn_warp_kernel_v1<<<blocks, warps * 32, shared, (cudaStream_t)stream>>>(
      tgt, tnum, mcap, qry, qstride, nq, k, out_d, out_i);
  return (int)cudaGetLastError();
}

// K12. tsorted [mcap,4]: Morton-sorted rows x y z | original index (int32
// bits), valid rows first; tbox [ceil(mcap / 256), 8]: lo 3, 0, hi 3, 0 of
// every 256 sorted rows; tkey [mcap] int64: the sorted codes; qperm [nq]
// int64: sorted position → query row; qkey [nq] int32: the queries' sorted
// codes; window: sorted rows a query takes its reach from (≥ k); team:
// threads a query (2, 4 or 8: one thread a query lost to two at every
// shape tools/pruned_walk_sweep.py measured).
int sgt_knn_pruned(const float* tsorted, const int* tnum, int mcap, const float* tbox,
                   const long long* tkey, const float* qry, int qstride, int nq,
                   const long long* qperm, const int* qkey, int k, int window, int team,
                   float* out_d, int* out_i, void* stream) {
  if (bad_search(mcap, qstride, nq) || k < 1 || k > 64 || window < k)
    return (int)cudaErrorInvalidValue;
  const int kmax = k <= 16 ? 16 : k <= 32 ? 32 : 64;
  cudaStream_t s = (cudaStream_t)stream;
#define SGT_PRUNED(KM, T)                                                          \
  if (kmax == KM && team == T) {                                                  \
    knn_pruned_walk_kernel<KM, T>                                                 \
        <<<(nq + kKnnThreads / T - 1) / (kKnnThreads / T), kKnnThreads, 0, s>>>(  \
            tsorted, tnum, mcap, tbox, tkey, qry, qstride, nq, qperm, qkey, k,    \
            window, out_d, out_i);                                                \
    return (int)cudaGetLastError();                                               \
  }
  SGT_PRUNED(16, 2) SGT_PRUNED(16, 4) SGT_PRUNED(16, 8)
  SGT_PRUNED(32, 2) SGT_PRUNED(32, 4) SGT_PRUNED(32, 8)
  SGT_PRUNED(64, 2) SGT_PRUNED(64, 4) SGT_PRUNED(64, 8)
#undef SGT_PRUNED
  return (int)cudaErrorInvalidValue;  // a team K12 has no instance for
}

// K12's first form: qpos [nq] int32, sorted position → insertion position
// in the sorted target; qperm [nq] int32; no codes.
int sgt_knn_pruned_v1(const float* tsorted, const int* tnum, int mcap,
                      const float* tbox, const float* qry, int qstride, int nq,
                      const int* qperm, const int* qpos, int k, float* out_d,
                      int* out_i, void* stream) {
  if (bad_search(mcap, qstride, nq) || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const int blocks = (nq + kKnnThreads - 1) / kKnnThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_pruned_kernel_v1<16><<<blocks, kKnnThreads, 0, s>>>(
        tsorted, tnum, mcap, tbox, qry, qstride, nq, qperm, qpos, k, out_d, out_i);
  else if (k <= 32)
    knn_pruned_kernel_v1<32><<<blocks, kKnnThreads, 0, s>>>(
        tsorted, tnum, mcap, tbox, qry, qstride, nq, qperm, qpos, k, out_d, out_i);
  else
    knn_pruned_kernel_v1<64><<<blocks, kKnnThreads, 0, s>>>(
        tsorted, tnum, mcap, tbox, qry, qstride, nq, qperm, qpos, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
