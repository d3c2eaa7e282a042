// Exact self-kNN for the covariance stage, hand-written for Hopper (sm_90a):
// K3 and K5 return neighbour moments, K4 the neighbours themselves. They
// replace the three Pallas kernels of small_gicp_tpu/ops/cov_fused_pallas.py
// (knn_moments_pallas):
//
//   knn_moments_kernel<KMAX>       `_make_moments_kernel_T`   (layout "t")
//   knn_topk_idx_kernel<KMAX>      `_make_topk_idx_kernel_T`  (layout "ti")
//   knn_moments_warp_walk_kernel   `_make_moments_kernel`     (layout "q")
//
// K3 and K5: for every valid row q, the k nearest valid rows p (self
// included) by exact difference-form d², and the query-centred moments of
// d = p − q over those neighbours:
//   out[q] = [Σd 3 | Σddᵀ upper 6 (xx xy xz yy yz zz) | count | d_k | 0 ×5]
// where count is the number of slots with d² < 1e16 and d_k the kth d².
// Rows at or beyond num_points get zeros. Ties keep the lower row index.
//
// K3 and K4 walk the same boxes. What bounds them: the pairs a pruned search
// cannot avoid on the data (operations, ~9 a pair), a few per cent of N² at
// scan scale and fewer as the cloud grows; K3's moments add k·9 operations a
// row. The wrapper sorts the cloud by Morton code into rows (x y z |
// original index) and boxes every 256 sorted rows (the prologue it shares
// with K12; a KdTree over the cloud keeps it). A block owns consecutive
// sorted rows as its queries. Each query first takes the kth smallest d²
// over the `window` sorted rows around it — Morton neighbours are spatial
// neighbours, and the kth best of any k rows bounds the true kth distance
// from above, in float32 too: it is the d² of a real row in the kernel's own
// rounding. The block reduces R = the largest bound over its queries, culls
// the boxes in passes of kCullPass, in parallel, four a thread
// (common.cuh's cull_boxes: a box whose gap² to the block's query box
// exceeds R goes), and streams the live tiles through a two-stage cp.async
// ring, re-checking each kept gap² against R, which tightens after every
// pass. Passes start at the block's own box and work outwards, so that R is
// tight before the far boxes are culled. Within a scanned tile a warp skips
// the rows if the tile's box is beyond each of its queries' own bounds, and
// each list is seeded with its query's bound, so that a row costs one
// (d², index) compare. The gap² between boxes never exceeds the d² of a pair
// inside them (common.cuh), so no neighbour is skipped; the lists are in
// (d², original index) order, so the visit order is free.
//
// K4 (map scale: clouds of hundreds of thousands of rows) returns, for
// every valid row, the original indices and d² of its k nearest valid rows,
// ascending by (d², original index); the wrapper gathers the winners and
// forms the moments in torch. One thread a query, 64 queries a block.
// Instances KMAX ∈ {16, 32, 64} as K10: 32 keeps k = 20 out of local
// memory. The first form (kept as a yardstick) tested the boxes one after
// another.
//
// K3 (scan scale) forms the moments in the kernel. A scan fills the card
// with too few blocks of 64 queries (a 21k-row cloud gives 335), so kTeam
// threads serve one query: a block holds 64 / kTeam queries, whose box is
// tighter, and a team member scans every kTeam-th row of a staged tile into
// its own seeded list. At the end the team merges its lists, k rounds of a
// shuffle arg-min on (d², original index), and sums the winners' offsets
// d = p − q (p gathered from the cloud in original order) in slot order
// with the first form's arithmetic; the lists are the first form's, so the
// moment rows equal its rows bit for bit. The row goes to the query's
// original row; padding rows get zeros. The first form (kept as the
// yardstick knn_moments_kernel_v1) gave each thread a query, 64 a block,
// and scanned every valid row in original order through a 512-row shared
// tile, bounded by the kth d² over the ±32 rows around it in row order.
//
// K5 (layout "q", the other work mapping of K3): a team of kWarpTeam lanes
// a query, 64 / kWarpTeam queries a block, over the same walk as K3 — the
// Morton window bound, the parallel cull passes from the block's own box
// outwards, the two-stage ring — as the Pallas kernel walks its live-tile
// lists over the sorted cloud. The team's lanes deal each staged tile's
// rows (member t takes rows t, t + kWarpTeam, …, kWarpBatch of them loaded
// before their distances), each into its own sorted list in shared memory
// (common.cuh's lane lists, k × 32 entries a warp, in (d², original row)
// order since tiles come out of row order) seeded with the query's window
// bound and kept with a fill count, so that an insertion shifts only over
// real entries; the team also deals the window's rows to take that bound.
// k rounds of a team-wide arg-min merge the lists, and every lane of the
// team sums the winners' offsets in slot order with K3's add_offset, so
// the rows equal K3's bit for bit. What bounds it is K3's: the pairs the
// walk cannot avoid (operations). Teams of 8 lanes (8 queries a block) beat
// 16 and 32 (tools/warp_kernel_sweep.py). The first form (knn_moments_warp_kernel_v1, entry
// sgt_knn_moments_warp_v1, on no path) gave a warp to each query over every
// valid row in row order, staged synchronously, with cold lists: a dense
// scan where the Pallas kernel walks live tiles.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using sgt::kBig;

constexpr int kMomThreads = 64;
constexpr int kMomTile = 512;
constexpr int kWindow = 32;
constexpr int kWarpTile = 256;  // rows staged at once (K5's first form)
constexpr float kValidSq = 1e16f;

// Add one neighbour's offset d = p − q to the moment row o.
__device__ __forceinline__ void add_offset(float (&o)[16], float dx, float dy,
                                           float dz) {
  o[0] += dx;
  o[1] += dy;
  o[2] += dz;
  o[3] += dx * dx;
  o[4] += dx * dy;
  o[5] += dx * dz;
  o[6] += dy * dy;
  o[7] += dy * dz;
  o[8] += dz * dz;
  o[9] += 1.f;
}

__device__ __forceinline__ void store_row(float* __restrict__ out, int i,
                                          const float (&o)[16]) {
  float4* row = reinterpret_cast<float4*>(out + (size_t)i * 16);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    row[c] = make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
}

// ---------------------------------------------------- K3's first form ----

// pts [N,4] in original order. Kept as the yardstick of knn_moments_kernel
// (entry sgt_knn_moments_v1); on no path.

template <int KMAX>
__global__ void __launch_bounds__(kMomThreads)
knn_moments_kernel_v1(const float* __restrict__ pts, const int* __restrict__ num,
                      int n, int k, float* __restrict__ out) {
  __shared__ float4 tile[kMomTile];
  const int i = blockIdx.x * kMomThreads + threadIdx.x;
  const int m = *num;
  const bool active = i < n && i < m;
  const bool block_active = blockIdx.x * kMomThreads < min(n, m);
  const float4* p4 = reinterpret_cast<const float4*>(pts);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  float bound = kBig;
  if (active) {
    const float4 q = p4[i];
    qx = q.x;
    qy = q.y;
    qz = q.z;
    const int lo = max(0, min(i - kWindow, m - (2 * kWindow + 1)));
    const int hi = min(m, lo + 2 * kWindow + 1);
    bound = sgt::kth_bound<KMAX>(p4, lo, hi, 1, k, qx, qy, qz);
  }

  // (d², dx, dy, dz) of the k nearest rows so far; empty slots hold offsets 0.0f.
  float bd[KMAX];
  unsigned bx[KMAX], by[KMAX], bz[KMAX];
  sgt::topk_fill<KMAX>(bd, kBig);
  sgt::topk_fill<KMAX>(bx, 0u);
  sgt::topk_fill<KMAX>(by, 0u);
  sgt::topk_fill<KMAX>(bz, 0u);
  float kth = kBig;

  for (int base = 0; block_active && base < m; base += kMomTile) {
    const int cnt = min(kMomTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kMomThreads) tile[j] = p4[base + j];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      float dx, dy, dz;
      const float d2 = sgt::sq_dist(p.x, p.y, p.z, qx, qy, qz, dx, dy, dz);
      if (d2 < kth && d2 <= bound) {
        sgt::topk_insert3<KMAX>(bd, bx, by, bz, k, d2, __float_as_uint(dx),
                                __float_as_uint(dy), __float_as_uint(dz));
        kth = sgt::topk_slot<KMAX>(bd, k - 1);
      }
    }
  }

  if (i >= n) return;
  float o[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) o[c] = 0.f;
  if (active) {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < k && bd[s] < kValidSq)
        add_offset(o, __uint_as_float(bx[s]), __uint_as_float(by[s]),
                   __uint_as_float(bz[s]));
    }
    o[10] = kth;
  }
  store_row(out, i, o);
}

// ---------------------------------------------------------------- K4 ----

// tsorted [n,4]: Morton-sorted rows x y z | original index, the first *num
// valid; tbox [ceil(n / 256), 8]; out_d / out_i [n,k] in original row order.
// The first form: one box after another, each staged synchronously,
// R tightened after every scanned tile. Kept as the yardstick of the kernel
// below (entry sgt_knn_topk_idx_v1); on no path.
template <int KMAX>
__global__ void __launch_bounds__(sgt::kPrunedThreads)
knn_topk_idx_kernel_v1(const float* __restrict__ tsorted, const int* __restrict__ num,
                       int n, const float* __restrict__ tbox, int k, int window,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[sgt::kBoxRows];
  __shared__ float sw[sgt::kPrunedThreads / 32];
  const int i = blockIdx.x * sgt::kPrunedThreads + threadIdx.x;  // sorted position
  const int m = min(*num, n);
  const bool active = i < m;
  const float4* t4 = reinterpret_cast<const float4*>(tsorted);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int row = 0;
  if (i < n) {
    const float4 q = t4[i];
    qx = q.x;
    qy = q.y;
    qz = q.z;
    row = __float_as_int(q.w);
  }

  float bd[KMAX];
  unsigned bi[KMAX];
  sgt::topk_fill<KMAX>(bd, kBig);
  sgt::topk_fill<KMAX>(bi, (unsigned)sgt::kNoIndex);
  float kth = kBig;
  unsigned kth0 = (unsigned)sgt::kNoIndex;

  // A block of padding rows only (the same for all its threads) has nothing
  // to search; its rows get empty lists.
  if (blockIdx.x * sgt::kPrunedThreads < m) {
    // The query's bound: the kth smallest d² over its Morton window.
    float reach = kBig;
    if (active) {
      const int lo = max(0, min(i - window / 2, m - window));
      reach = sgt::kth_bound<KMAX>(t4, lo, min(m, lo + window), 1, k, qx, qy, qz);
    }
    float lo[3], hi[3];  // the block's query box
    sgt::block_box(active, qx, qy, qz, sw, lo, hi);
    float bound = sgt::block_max(active ? reach : 0.f, sw);

    const int ntiles = (m + sgt::kBoxRows - 1) / sgt::kBoxRows;
    for (int t = 0; t < ntiles; ++t) {
      const float gap2 = sgt::box_gap2(tbox + (size_t)t * 8, lo[0], lo[1], lo[2],
                                       hi[0], hi[1], hi[2]);
      if (gap2 > bound) continue;  // the same for every thread of the block
      sgt::scan_tile<KMAX, true>(t4, tbox, m, t, tile, active, qx, qy, qz, k, reach,
                                 bd, bi, kth, kth0);
      bound = sgt::block_max(active ? fminf(kth, reach) : 0.f, sw);
    }
  }
  if (i < n) sgt::store_list<KMAX>(bd, bi, k, out_d, out_i, (size_t)row);
}

// kWalkMinBlocks: the blocks an SM should hold of K4's KMAX = 16 instance,
// which caps its registers (K3's keeps the compiler's choice: a cap of 8 or
// 16 blocks moved it by ≤ 2 %, tools/scan_walk_sweep.py). kTeam: the
// threads that serve one of K3's queries. The walk itself (common.cuh's
// walk_sorted / walk_passes) starts at the box of the block's first query.
constexpr int kWalkMinBlocks = 16;
constexpr int kTeam = 4;
constexpr int kWarpTeam = 8;   // lanes that serve one of K5's queries
constexpr int kWarpBatch = 8;  // rows a lane of K5 loads before their distances
static_assert(kTeam >= 1 && kTeam <= 32 && 32 % kTeam == 0 && kWarpTeam >= 1 &&
                  kWarpTeam <= 32 && 32 % kWarpTeam == 0,
              "a team is a power of two of a warp's lanes");
static_assert(sgt::kBoxRows % (kWarpTeam * kWarpBatch) == 0,
              "K5's batches cover a full tile");

// The window of sorted rows that the query at sorted position i of a
// cloud of m valid rows takes its reach from, and the anchor box of a
// block of `queries` queries: the box of its first query.
__device__ __forceinline__ int window_start(int i, int m, int window) {
  return max(0, min(i - window / 2, m - window));
}

__device__ __forceinline__ int first_box(int queries) {
  return blockIdx.x * queries / sgt::kBoxRows;
}

template <int KMAX>
__global__ void __launch_bounds__(sgt::kPrunedThreads, KMAX == 16 ? kWalkMinBlocks : 1)
knn_topk_idx_kernel(const float* __restrict__ tsorted, const int* __restrict__ num,
                    int n, const float* __restrict__ tbox, int k, int window,
                    float* __restrict__ out_d, int* __restrict__ out_i) {
  const int i = blockIdx.x * sgt::kPrunedThreads + threadIdx.x;  // sorted position
  const int m = min(*num, n);
  const bool active = i < m;
  const float4* t4 = reinterpret_cast<const float4*>(tsorted);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int row = 0;
  if (i < n) {
    const float4 q = t4[i];
    qx = q.x;
    qy = q.y;
    qz = q.z;
    row = __float_as_int(q.w);
  }

  float bd[KMAX];
  unsigned bi[KMAX];
  sgt::topk_fill<KMAX>(bd, kBig);
  sgt::topk_fill<KMAX>(bi, (unsigned)sgt::kNoIndex);
  float kth = kBig;
  unsigned kth0 = (unsigned)sgt::kNoIndex;
  // A block of padding rows only (the same for all its threads) has nothing
  // to search; its rows get empty lists.
  if (blockIdx.x * sgt::kPrunedThreads < m)
    sgt::walk_sorted<KMAX, 1>(t4, m, tbox, k, window_start(i, m, window),
                              min(m, window_start(i, m, window) + window), 1,
                              first_box(sgt::kPrunedThreads), active, qx, qy, qz, bd,
                              bi, kth, kth0);
  sgt::unseed<KMAX>(bd, bi);
  if (i < n) sgt::store_list<KMAX>(bd, bi, k, out_d, out_i, (size_t)row);
}

// ---------------------------------------------------------------- K3 ----

// pts [n,4] in original order; tsorted [n,4] and tbox [ceil(n / 256), 8]
// its Morton sort and boxes (as K4's); out [n,16] in original row order.
template <int KMAX>
__global__ void __launch_bounds__(sgt::kPrunedThreads)
knn_moments_kernel(const float* __restrict__ pts, const float* __restrict__ tsorted,
                   const int* __restrict__ num, int n, const float* __restrict__ tbox,
                   int k, int window, float* __restrict__ out) {
  constexpr int kQueries = sgt::kPrunedThreads / kTeam;
  const int i = blockIdx.x * kQueries + threadIdx.x / kTeam;  // sorted position
  const int m = min(*num, n);
  const bool active = i < m;
  const float4* t4 = reinterpret_cast<const float4*>(tsorted);
  const float4* p4 = reinterpret_cast<const float4*>(pts);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int row = 0;
  if (i < n) {
    const float4 q = t4[i];
    qx = q.x;
    qy = q.y;
    qz = q.z;
    row = __float_as_int(q.w);
  }

  float o[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) o[c] = 0.f;
  // A block of padding rows only writes zero rows.
  if (blockIdx.x * kQueries < m) {
    float bd[KMAX];
    unsigned bi[KMAX];
    sgt::topk_fill<KMAX>(bi, (unsigned)sgt::kNoIndex);
    float kth;
    unsigned kth0 = (unsigned)sgt::kNoIndex;
    sgt::walk_sorted<KMAX, kTeam>(t4, m, tbox, k, window_start(i, m, window),
                                  min(m, window_start(i, m, window) + window), 1,
                                  first_box(kQueries), active, qx, qy, qz, bd, bi, kth,
                                  kth0);
    sgt::unseed<KMAX>(bd, bi);
    // Merge the team's lists: round r takes the smallest head in (d²,
    // original index) order — slot r of the query's list — and its member
    // advances; the winner's offset goes into the sums in slot order. Row
    // indices are unique within a team (each row went to one member), and
    // every thread of the warp runs the k rounds.
    int head = 0;
    float d_k = kBig;
    for (int r = 0; r < k; ++r) {
      float wd;
      int wi;
      sgt::team_list_pop<KMAX, kTeam>(bd, bi, k, head, wd, wi);
      d_k = wd;
      if (active && wd < kValidSq) {
        const float4 p = p4[wi];
        float dx, dy, dz;
        sgt::sq_dist(p.x, p.y, p.z, qx, qy, qz, dx, dy, dz);
        add_offset(o, dx, dy, dz);
      }
    }
    if (active) o[10] = d_k;
  }
  if (i < n && threadIdx.x % kTeam == 0) store_row(out, row, o);
}

// ---------------------------------------------------------------- K5 ----

__global__ void __launch_bounds__(128)
knn_moments_warp_kernel_v1(const float* __restrict__ pts, const int* __restrict__ num,
                        int n, int k, float* __restrict__ out) {
  // tile [kWarpTile] float4 | per warp: d [k][32] float, row [k][32] int
  extern __shared__ float4 smem[];
  float4* tile = smem;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ld = reinterpret_cast<float*>(smem + kWarpTile) + (size_t)warp * k * 64;
  int* li = reinterpret_cast<int*>(ld + (size_t)k * 32);
  const int i = blockIdx.x * warps + warp;  // this warp's query row
  const int m = min(*num, n);
  const bool active = i < m;
  const bool block_active = blockIdx.x * warps < m;  // uniform
  const float4* p4 = reinterpret_cast<const float4*>(pts);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float4 q = p4[i];
    qx = q.x;
    qy = q.y;
    qz = q.z;
  }
  sgt::lane_list_clear(ld, li, lane, k);
  float kth = kBig;  // this lane's d[k-1]

  for (int base = 0; block_active && base < m; base += kWarpTile) {
    const int cnt = min(kWarpTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) tile[j] = p4[base + j];
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < cnt; j += 32) {
      const float4 p = tile[j];
      float dx, dy, dz;
      const float d2 = sgt::sq_dist(p.x, p.y, p.z, qx, qy, qz, dx, dy, dz);
      // A lane sees its rows in index order, so ties keep the lower row.
      if (d2 < kth) sgt::lane_list_insert(ld, li, lane, k, d2, base + j, kth);
    }
  }
  if (i >= n) return;  // uniform over the warp

  // Merge, and sum the winners' offsets in slot order (every lane alike).
  float o[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) o[c] = 0.f;
  if (active) {
    int head = 0;
    float d_k = kBig;
    for (int r = 0; r < k; ++r) {
      int bi;
      sgt::lane_lists_pop(ld, li, lane, k, head, d_k, bi);
      if (d_k < kValidSq) {
        const float4 p = p4[bi];
        float dx, dy, dz;
        sgt::sq_dist(p.x, p.y, p.z, qx, qy, qz, dx, dy, dz);
        add_offset(o, dx, dy, dz);
      }
    }
    o[10] = d_k;
  }
  if (lane == 0) store_row(out, i, o);
}


// pts [n,4] in original order; tsorted / tbox as K3's; out [n,16] in
// original row order. Dynamic shared memory: per warp the lane lists, d
// [k][32] float then row [k][32] int.
template <int TEAM>
__global__ void __launch_bounds__(sgt::kPrunedThreads)
knn_moments_warp_walk_kernel(const float* __restrict__ pts,
                             const float* __restrict__ tsorted,
                             const int* __restrict__ num, int n,
                             const float* __restrict__ tbox, int k, int window,
                             float* __restrict__ out) {
  extern __shared__ float lane_lists[];
  constexpr int kQueries = sgt::kPrunedThreads / TEAM;
  const int lane = threadIdx.x & 31, member = lane % TEAM;
  float* ld = lane_lists + (threadIdx.x >> 5) * k * 64;
  int* li = reinterpret_cast<int*>(ld + k * 32);
  const int i = blockIdx.x * kQueries + threadIdx.x / TEAM;  // sorted position
  const int m = min(*num, n);
  const bool active = i < m;
  const float4* t4 = reinterpret_cast<const float4*>(tsorted);
  const float4* p4 = reinterpret_cast<const float4*>(pts);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int row = 0;
  if (i < n) {
    const float4 q = t4[i];
    qx = q.x;
    qy = q.y;
    qz = q.z;
    row = __float_as_int(q.w);
  }

  float o[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) o[c] = 0.f;
  // A block of padding rows only writes zero rows.
  if (blockIdx.x * kQueries < m) {
    // The query's bound: the kth smallest d² over its Morton window, whose
    // rows the team deals into cold lists (the sorted position as the
    // index), then k pops.
    sgt::lane_list_clear(ld, li, lane, k);
    float kth = kBig;
    int n = 0;  // entries in the lane's list
    if (active) {
      const int lo = window_start(i, m, window);
      const int hi = min(m, lo + window);
      for (int j = lo + member; j < hi; j += TEAM) {
        const float4 p = t4[j];
        float dx, dy, dz;
        const float d2 = sgt::sq_dist(p.x, p.y, p.z, qx, qy, qz, dx, dy, dz);
        if (d2 < kth) {
          sgt::lane_list_push(ld, li, lane, k, n, d2, j);
          if (n == k) kth = ld[(k - 1) * 32 + lane];
        }
      }
    }
    float reach = kBig;
    int head = 0;
    for (int r = 0; r < k; ++r) {
      int bi;
      sgt::lane_lists_pop<TEAM>(ld, li, lane, k, head, reach, bi);
    }
    if (!active) reach = kBig;
    // Seed every slot with (reach', kNoIndex): one (d², row) compare against
    // the list's end also tests d² ≤ reach and d² < kBig.
    kth = fminf(reach, nextafterf(kBig, 0.f));
    int kth0 = sgt::kNoIndex;
    n = 0;
    for (int s = 0; s < k; ++s) {
      ld[s * 32 + lane] = kth;
      li[s * 32 + lane] = sgt::kNoIndex;
    }
    sgt::walk_passes<TEAM>(
        t4, m, tbox, first_box(kQueries), active, qx, qy, qz, reach,
        [&](const float4* tile, int cnt, int tt) {
          // The warp skips the tile if its box lies beyond each lane's kth.
          const bool wanted =
              active &&
              !(sgt::box_gap2(tbox + (size_t)tt * 8, qx, qy, qz, qx, qy, qz) > kth);
          if (!__any_sync(0xffffffffu, wanted) || !wanted) return;
          // kWarpBatch rows a lane at a time: the loads first, then the
          // distances; only a batch with a candidate inserts, each row
          // tested again against the list's end.
          for (int j0 = member; j0 < cnt; j0 += TEAM * kWarpBatch) {
            float4 p[kWarpBatch];
            float d2[kWarpBatch];
#pragma unroll
            for (int u = 0; u < kWarpBatch; ++u) p[u] = tile[min(j0 + TEAM * u, cnt - 1)];
            bool any = false;
#pragma unroll
            for (int u = 0; u < kWarpBatch; ++u) {
              float dx, dy, dz;
              d2[u] = sgt::sq_dist(qx, qy, qz, p[u].x, p[u].y, p[u].z, dx, dy, dz);
              any |= j0 + TEAM * u < cnt &&
                     sgt::lex_before(d2[u], __float_as_int(p[u].w), kth, kth0);
            }
            if (!any) continue;
#pragma unroll
            for (int u = 0; u < kWarpBatch; ++u) {
              const int idx = __float_as_int(p[u].w);  // original row index
              if (j0 + TEAM * u < cnt && sgt::lex_before(d2[u], idx, kth, kth0)) {
                sgt::lane_list_push_lex(ld, li, lane, k, n, d2[u], idx);
                if (n == k) {
                  kth = ld[(k - 1) * 32 + lane];
                  kth0 = li[(k - 1) * 32 + lane];
                }
              }
            }
          }
        },
        [&] { return kth; });
    // Empty slots back to (kBig, kNoIndex); then merge, and sum the winners'
    // offsets in slot order (every lane of the team alike).
    for (int s = 0; s < k; ++s)
      if (li[s * 32 + lane] == sgt::kNoIndex) ld[s * 32 + lane] = kBig;
    head = 0;
    float d_k = kBig;
    for (int r = 0; r < k; ++r) {
      int wi;
      sgt::lane_lists_pop<TEAM>(ld, li, lane, k, head, d_k, wi);
      if (active && d_k < kValidSq) {
        const float4 p = p4[wi];
        float dx, dy, dz;
        sgt::sq_dist(p.x, p.y, p.z, qx, qy, qz, dx, dy, dz);
        add_offset(o, dx, dy, dz);
      }
    }
    if (active) o[10] = d_k;
  }
  if (i < n && member == 0) store_row(out, row, o);
}

}  // namespace

extern "C" {

// K3. pts [n,4] f32 (x y z w) in original order, tsorted [n,4] and tbox
// [ceil(n / 256), 8] from the wrapper's sort, num: device int32 count of
// valid rows, window: sorted rows a query takes its bound from (≥ k),
// out [n,16]. Returns cudaGetLastError() after the launch.
int sgt_knn_moments(const float* pts, const float* tsorted, const int* num, int n,
                    const float* tbox, int k, int window, float* out, void* stream) {
  if (k < 1 || k > 64 || n <= 0 || window < k) return (int)cudaErrorInvalidValue;
  constexpr int kQueries = sgt::kPrunedThreads / kTeam;
  const int blocks = (n + kQueries - 1) / kQueries;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_moments_kernel<16><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        pts, tsorted, num, n, tbox, k, window, out);
  else if (k <= 32)
    knn_moments_kernel<32><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        pts, tsorted, num, n, tbox, k, window, out);
  else
    knn_moments_kernel<64><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        pts, tsorted, num, n, tbox, k, window, out);
  return (int)cudaGetLastError();
}

// K3's first form: pts [N,4], num, out [N,16]; no sort.
int sgt_knn_moments_v1(const float* pts, const int* num, int n, int k, float* out,
                       void* stream) {
  if (k < 1 || k > 64 || n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kMomThreads - 1) / kMomThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_moments_kernel_v1<16><<<blocks, kMomThreads, 0, s>>>(pts, num, n, k, out);
  else
    knn_moments_kernel_v1<64><<<blocks, kMomThreads, 0, s>>>(pts, num, n, k, out);
  return (int)cudaGetLastError();
}

// K3's and K5's team sizes, which the wrapper's plain accounts repeat:
// out[0..1] = threads a query of K3, lanes a query of K5.
int sgt_knn_moments_geometry(int* out) {
  out[0] = kTeam;
  out[1] = kWarpTeam;
  return 0;
}

// K4. tsorted [n,4] and tbox [ceil(n / 256), 8] from the wrapper's sort,
// num: device int32 count of valid rows, window: sorted rows a query takes
// its bound from (≥ k), out_d / out_i [n,k].
int sgt_knn_topk_idx(const float* tsorted, const int* num, int n, const float* tbox,
                     int k, int window, float* out_d, int* out_i, void* stream) {
  if (k < 1 || k > 64 || n <= 0 || window < k) return (int)cudaErrorInvalidValue;
  const int blocks = (n + sgt::kPrunedThreads - 1) / sgt::kPrunedThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_topk_idx_kernel<16><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        tsorted, num, n, tbox, k, window, out_d, out_i);
  else if (k <= 32)
    knn_topk_idx_kernel<32><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        tsorted, num, n, tbox, k, window, out_d, out_i);
  else
    knn_topk_idx_kernel<64><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        tsorted, num, n, tbox, k, window, out_d, out_i);
  return (int)cudaGetLastError();
}

// K4's first form, the same arguments.
int sgt_knn_topk_idx_v1(const float* tsorted, const int* num, int n, const float* tbox,
                        int k, int window, float* out_d, int* out_i, void* stream) {
  if (k < 1 || k > 64 || n <= 0 || window < k) return (int)cudaErrorInvalidValue;
  const int blocks = (n + sgt::kPrunedThreads - 1) / sgt::kPrunedThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_topk_idx_kernel_v1<16><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        tsorted, num, n, tbox, k, window, out_d, out_i);
  else if (k <= 32)
    knn_topk_idx_kernel_v1<32><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        tsorted, num, n, tbox, k, window, out_d, out_i);
  else
    knn_topk_idx_kernel_v1<64><<<blocks, sgt::kPrunedThreads, 0, s>>>(
        tsorted, num, n, tbox, k, window, out_d, out_i);
  return (int)cudaGetLastError();
}

// K5. Arguments as K3's; a block of kPrunedThreads threads serves
// kPrunedThreads / kWarpTeam queries.
int sgt_knn_moments_warp(const float* pts, const float* tsorted, const int* num, int n,
                         const float* tbox, int k, int window, float* out,
                         void* stream) {
  if (k < 1 || k > 64 || n <= 0 || window < k) return (int)cudaErrorInvalidValue;
  constexpr int kQueries = sgt::kPrunedThreads / kWarpTeam;
  const int blocks = (n + kQueries - 1) / kQueries;
  const size_t shared = (size_t)(sgt::kPrunedThreads / 32) * k * 32 * 8;
  knn_moments_warp_walk_kernel<kWarpTeam>
      <<<blocks, sgt::kPrunedThreads, shared, (cudaStream_t)stream>>>(
          pts, tsorted, num, n, tbox, k, window, out);
  return (int)cudaGetLastError();
}

// K5's first form. Arguments as K3's first form's. Four queries (warps) per
// block up to k = 32, two above, so the lists stay within 32 KB of shared
// memory.
int sgt_knn_moments_warp_v1(const float* pts, const int* num, int n, int k, float* out,
                            void* stream) {
  if (k < 1 || k > 64 || n <= 0) return (int)cudaErrorInvalidValue;
  const int warps = k <= 32 ? 4 : 2;
  const int blocks = (n + warps - 1) / warps;
  const size_t shared = kWarpTile * sizeof(float4) + (size_t)warps * k * 32 * 8;
  knn_moments_warp_kernel_v1<<<blocks, warps * 32, shared, (cudaStream_t)stream>>>(
      pts, num, n, k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
