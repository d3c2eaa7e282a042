// Standalone exact neighbour searches (K9-K12), hand-written for Hopper
// (sm_90a). They replace the Pallas kernels of
// small_gicp_tpu/ops/knn_pallas.py:
//
//   nn1_kernel<false|true>   `_nn1_kernel_vpu` / `_nn1_kernel`
//                            (nearest_neighbor_pallas, "vpu" / "mxu")
//   knn_kernel<KMAX>         `_make_knn_kernel`        (knn_pallas)
//   knn_warp_kernel          `_make_knn_kernel_T`      (knn_pallas_T)
//   knn_pruned_kernel<KMAX>  `_make_knn_listed_kernel` (knn_pallas_pruned)
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
// K9 (1-NN): one thread per query, strict < over rows in index order.
// Both clouds are centred on `centre` (the mean of the finite target rows,
// computed by the wrapper), as the Pallas wrapper centres them: the
// difference-form instance returns d² of the centred coordinates; the
// score-form instance ranks by |t|² − 2 q·t of the centred coordinates
// (|q|² is constant per query) and returns the winner's d² recomputed from
// the uncentred inputs.
//
// K10 (kNN, one thread per query): a sorted top-k list per thread, in
// local memory (KMAX ∈ {16, 32, 64} sizes it and the bound's sample list,
// k at run time). An insertion taken by one
// lane stalls its warp, and a cloud in scan or voxel order approaches a
// query gradually, so a cold list would insert at most rows. Each query
// therefore first takes the kth smallest d² over a strided sample of about
// kSampleRows valid rows as a bound B ≥ its true kth distance, and the scan
// only considers rows with d² ≤ B: the result is unchanged, the insertions
// drop to about the rows inside the bound.
//
// K11 (kNN, one warp per query): the other work mapping of the same
// search, for few queries. Lanes stride the target rows, each lane keeps a
// private sorted list in shared memory (k × 32 entries per warp, one bank
// per lane), and the lists are merged by k rounds of a warp-wide arg-min on
// (d², index) through shuffles. Bit-identical to K10: each lane keeps its k
// first rows in (d², index) order, every row of the global top-k is among
// its lane's, and the merge emits them in that order.
//
// K12 (pruned kNN): work ∝ local density. The wrapper sorts the target by
// Morton code (valid rows first) into rows (x y z | original index), builds
// the bounding box of every kTile sorted rows, sorts the queries by the
// same code and finds each query's insertion position in the sorted
// target. One launch: a block owns kKnnThreads consecutive sorted queries,
// scans the five tiles around its median query's position, reduces its kth
// distance bound R = max over its queries, then walks the remaining tiles
// and branches past every tile whose box lies farther than R from the
// block's query box; R tightens after every scanned tile. Within a scanned
// tile a warp skips the rows if the tile's box lies farther from each of its
// queries than that query's own kth distance. A row that can still enter a
// query's list has d² ≤ that query's kth ≤ R, and the gap² between the
// boxes (same operation order, no fused multiply-add) is ≤ d², so no such
// row is skipped. Tiles are visited out of index order, so
// insertion is lexicographic on (d², original index): K12 equals K10 on
// every input.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using sgt::kBig;

constexpr int kKnnThreads = 64;    // queries per block (K9, K10, K12)
constexpr int kKnnTile = 512;      // target rows staged at once (K9, K10)
constexpr int kSampleRows = 2048;  // rows of K10's bound sample
constexpr int kWarpTile = 256;     // target rows staged at once (K11)
constexpr int kTile = sgt::kBoxRows;  // sorted rows per box (K12)
constexpr int kSeedTiles = 5;      // tiles around the anchor scanned first
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

// ---------------------------------------------------------------- K9 ----

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

// --------------------------------------------------------------- K10 ----

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

// --------------------------------------------------------------- K11 ----

__global__ void __launch_bounds__(128)
knn_warp_kernel(const float* __restrict__ tgt, const int* __restrict__ tnum,
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

// --------------------------------------------------------------- K12 ----

template <int KMAX>
__global__ void __launch_bounds__(kKnnThreads)
knn_pruned_kernel(const float* __restrict__ tsorted, const int* __restrict__ tnum,
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

inline bool bad_search(int mcap, int qstride, int nq) {
  return mcap < 0 || nq <= 0 || (qstride != 3 && qstride != 4);
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch. tgt [mcap,4] f32,
// tnum device int32, qry nq rows of qstride floats, out_d / out_i [nq] or
// [nq,k].

// K9. centre: 3 device floats; variant 0 = difference form, 1 = score form.
int sgt_nn1(const float* tgt, const int* tnum, int mcap, const float* qry,
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

// K10.
int sgt_knn(const float* tgt, const int* tnum, int mcap, const float* qry,
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

// K11. Four queries (warps) per block up to k = 32, two above, so the
// lists stay within 32 KB of shared memory.
int sgt_knn_warp(const float* tgt, const int* tnum, int mcap, const float* qry,
                 int qstride, int nq, int k, float* out_d, int* out_i,
                 void* stream) {
  if (bad_search(mcap, qstride, nq) || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const int warps = k <= 32 ? 4 : 2;
  const int blocks = (nq + warps - 1) / warps;
  const size_t shared = kWarpTile * sizeof(float4) + (size_t)warps * k * 32 * 8;
  knn_warp_kernel<<<blocks, warps * 32, shared, (cudaStream_t)stream>>>(
      tgt, tnum, mcap, qry, qstride, nq, k, out_d, out_i);
  return (int)cudaGetLastError();
}

// K12. tsorted [mcap,4]: Morton-sorted rows x y z | original index (int32
// bits), valid rows first; tbox [ceil(mcap / 256), 8]: lo 3, 0, hi 3, 0 of
// every 256 sorted rows; qperm [nq]: sorted position → query row; qpos
// [nq]: sorted position → insertion position in the sorted target.
int sgt_knn_pruned(const float* tsorted, const int* tnum, int mcap,
                   const float* tbox, const float* qry, int qstride, int nq,
                   const int* qperm, const int* qpos, int k, float* out_d,
                   int* out_i, void* stream) {
  if (bad_search(mcap, qstride, nq) || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const int blocks = (nq + kKnnThreads - 1) / kKnnThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_pruned_kernel<16><<<blocks, kKnnThreads, 0, s>>>(
        tsorted, tnum, mcap, tbox, qry, qstride, nq, qperm, qpos, k, out_d, out_i);
  else if (k <= 32)
    knn_pruned_kernel<32><<<blocks, kKnnThreads, 0, s>>>(
        tsorted, tnum, mcap, tbox, qry, qstride, nq, qperm, qpos, k, out_d, out_i);
  else
    knn_pruned_kernel<64><<<blocks, kKnnThreads, 0, s>>>(
        tsorted, tnum, mcap, tbox, qry, qstride, nq, qperm, qpos, k, out_d, out_i);
  return (int)cudaGetLastError();
}

// Tiles around the anchor that K12 scans first, which the wrapper's plain
// version repeats (rows per box and queries per block: sgt_box_geometry).
int sgt_knn_seed_tiles() { return kSeedTiles; }

}  // extern "C"
