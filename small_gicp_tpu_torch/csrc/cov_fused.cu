// Exact self-kNN for the covariance stage, hand-written for Hopper (sm_90a):
// K3 and K5 return neighbour moments, K4 the neighbours themselves. They
// replace the three Pallas kernels of small_gicp_tpu/ops/cov_fused_pallas.py
// (knn_moments_pallas):
//
//   knn_moments_kernel<KMAX>       `_make_moments_kernel_T`   (layout "t")
//   knn_topk_idx_kernel<KMAX>      `_make_topk_idx_kernel_T`  (layout "ti")
//   knn_moments_warp_kernel        `_make_moments_kernel`     (layout "q")
//
// K3 and K5: for every valid row q, the k nearest valid rows p (self
// included) by exact difference-form d², and the query-centred moments of
// d = p − q over those neighbours:
//   out[q] = [Σd 3 | Σddᵀ upper 6 (xx xy xz yy yz zz) | count | d_k | 0 ×5]
// where count is the number of slots with d² < 1e16 and d_k the kth d².
// Rows at or beyond num_points get zeros. Ties keep the lower row index.
//
// K3 (scan scale). What bounds it: the search, N² pairs at ~9 f32
// operations each (operations; the moments are k·9 operations per row). One
// thread owns one query and keeps a sorted top-k list of (d², dx, dy, dz) in
// registers (common.cuh's list, shared with the search kernels); the block
// streams the cloud through shared memory in 16-byte rows, so the inner loop
// is one broadcast load, the distance and one compare. Ties keep the lower
// row index (strict < against the kth, insertion after equal entries, rows
// visited in ascending order), which is the order a stable sort of
// (d², index) gives.
//
// An insertion shifts four register arrays and, taken by one lane,
// stalls its whole warp; scanning from a cold list inserts hundreds of
// times per query. So each query first takes the kth smallest d² among
// the 2·kWindow+1 rows around it in row order (voxel-key order, so
// these are spatial neighbours) as a bound B ≥ its true kth distance,
// and the scan only considers rows with d² ≤ B. Every true neighbour
// has d² ≤ B, so the result is unchanged; the insertions drop to about
// the number of rows inside the bound.
//
// Blocks whose rows are all padding skip the scan.
//
// The list length is a template bound KMAX ∈ {16, 64} with k ≤ KMAX
// chosen at run time: KMAX = 16 keeps k = 10 (the main path) in
// registers; KMAX = 64 serves 16 < k ≤ 64 and spills to local memory.
//
// K4 (map scale: clouds of hundreds of thousands of rows, where N² pairs
// cost seconds). It returns, for every valid row, the original indices and
// d² of its k nearest valid rows, ascending by (d², original index); the
// wrapper gathers the winners and forms the moments in torch. What bounds
// it: the pairs a pruned search cannot avoid on the data (operations), a few
// per cent of N² and fewer as the cloud grows. The wrapper sorts the cloud by
// Morton code into rows (x y z | original index) and boxes every 256 sorted
// rows (the prologue it shares with K12). A block owns 64 consecutive sorted
// rows as its queries. Each query first takes the kth smallest d² over the
// `window` sorted rows around it — Morton neighbours are spatial neighbours,
// and the kth best of any k rows bounds the true kth distance from above, in
// float32 too: it is the d² of a real row in the kernel's own rounding. The
// block reduces R = the largest bound over its queries, walks the tiles in
// order and branches past every tile whose box lies farther than R from the
// block's box; within a scanned tile a warp skips the rows if the tile's box
// is beyond each of its queries' own bounds, and a row enters a list only
// with d² ≤ its query's bound. The gap² between boxes never exceeds the d²
// of a pair inside them (common.cuh), so no neighbour is skipped. The walk
// is in passes (the first form, kept as a yardstick, tested the boxes one
// after another): a pass culls kCullPass boxes in parallel against the
// current R, four a thread (common.cuh's cull_boxes), and streams the live
// ones through a two-stage cp.async ring, re-checking each kept gap²
// against R, which tightens after every pass. Passes start at the block's
// own box and work outwards, so that R is tight before the far boxes are
// culled. The self-search needs one sort and no insertion positions, and
// its bound is there before the first tile: that is what K12, which seeds
// from five tiles, does not have. Instances KMAX ∈ {16, 32, 64}
// as K10: 32 keeps k = 20 out of local memory.
//
// K5 (the other work mapping of K3, as K11 is to K10): one warp per query.
// Lanes stride the rows, each lane keeps a private sorted list of (d², row)
// in shared memory, k rounds of a shuffle arg-min on (d², row) merge them
// (common.cuh), and the warp gathers the k winners' rows and sums their
// offsets in slot order, in K3's operation order. It picks the neighbours K3
// picks. It fills the card where queries are few; at scan sizes it pays
// 32 lanes' insertions for every query.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using sgt::kBig;

constexpr int kMomThreads = 64;
constexpr int kMomTile = 512;
constexpr int kWindow = 32;
constexpr int kWarpTile = 256;  // rows staged at once (K5)
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

// ---------------------------------------------------------------- K3 ----

template <int KMAX>
__global__ void __launch_bounds__(kMomThreads)
knn_moments_kernel(const float* __restrict__ pts, const int* __restrict__ num,
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

// The walk in cull passes (the launch of sgt_knn_topk_idx). Passes of
// kCullPass boxes start at the block's own box and work outwards (kOutward;
// else in ascending order). A pass culls its boxes in parallel against the
// current R (cull_boxes, gap² kept beside each index) and streams the live
// tiles through the two-stage cp.async ring; a live tile whose gap² exceeds
// R, which has tightened since the cull, is not staged. R tightens after
// each pass. A list's empty slots start at (min(reach, the float below
// kBig), kNoIndex), so that one (d², index) compare against its end also
// tests d² ≤ reach and d² < kBig; before the store they go back to (kBig,
// kNoIndex). The lists are in (d², original index) order whatever the order
// of the tiles, so they equal the first form's. kWalkMinBlocks: the blocks
// an SM should hold of the KMAX = 16 instance, which caps its registers.
constexpr int kOutward = 1;
constexpr int kWalkMinBlocks = 16;
constexpr int kWalkWarps = sgt::kPrunedThreads / 32;

// Offer the cnt staged rows of sorted tile t to the block's seeded lists,
// in (d², original index) order; a warp skips the tile if its box lies
// beyond each of its queries' kth.
template <int KMAX>
__device__ __forceinline__ void offer_seeded(const float4* tile, int cnt,
                                             const float* __restrict__ tbox, int t,
                                             bool active, float qx, float qy, float qz,
                                             int k, float (&d)[KMAX], unsigned (&p0)[KMAX],
                                             float& kth, unsigned& kth0) {
  const bool wanted =
      active && !(sgt::box_gap2(tbox + (size_t)t * 8, qx, qy, qz, qx, qy, qz) > kth);
  if (!__any_sync(0xffffffffu, wanted) || !wanted) return;
  for (int j = 0; j < cnt; ++j) {
    const float4 p = tile[j];
    float dx, dy, dz;
    const float d2 = sgt::sq_dist(qx, qy, qz, p.x, p.y, p.z, dx, dy, dz);
    const int idx = __float_as_int(p.w);  // original row index
    if (sgt::lex_before(d2, idx, kth, (int)kth0)) {
      sgt::topk_insert_lex<KMAX>(d, p0, k, d2, idx);
      kth = sgt::topk_slot<KMAX>(d, k - 1);
      kth0 = sgt::topk_slot<KMAX>(p0, k - 1);
    }
  }
}

// The ring, the pass's list and its gaps: at least 16 blocks on an SM.
static_assert(2 * sgt::kBoxRows * 16 + sgt::kCullPass * 9 + 64 <= 232448 / 16,
              "K4's shared memory keeps fewer than 16 blocks on an SM");

template <int KMAX>
__global__ void __launch_bounds__(sgt::kPrunedThreads, KMAX == 16 ? kWalkMinBlocks : 1)
knn_topk_idx_kernel(const float* __restrict__ tsorted, const int* __restrict__ num,
                    int n, const float* __restrict__ tbox, int k, int window,
                    float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ __align__(16) float4 tile[2][sgt::kBoxRows];
  __shared__ int live[sgt::kCullPass];
  __shared__ float live_gap[sgt::kCullPass];
  __shared__ int counts[sgt::kCullWords];
  __shared__ float sw[kWalkWarps];
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
    kth = fminf(reach, nextafterf(kBig, 0.f));
    sgt::topk_fill<KMAX>(bd, kth);
    float lo[3], hi[3];  // the block's query box
    sgt::block_box(active, qx, qy, qz, sw, lo, hi);
    float bound = sgt::block_max(active ? reach : 0.f, sw);

    const int ntiles = (m + sgt::kBoxRows - 1) / sgt::kBoxRows;
    constexpr int P = sgt::kCullPass;
    // The first pass: P boxes around the block's own (or the first P).
    const int own = blockIdx.x * sgt::kPrunedThreads / sgt::kBoxRows;
    int below = kOutward ? max(0, min(own - P / 2, ntiles - P)) : 0;
    int above = min(ntiles, below + P);
    int first = below, end = above;
    bool up = true;
    for (;;) {
      const int nlive = sgt::cull_boxes(tbox, first, end, lo, hi, bound, live,
                                        live_gap, counts);
      // Live tile j goes to ring slot `slot`, one commit group per tile; the
      // next one is the first after it whose gap² is still within R.
      int j = 0;
      while (j < nlive && live_gap[j] > bound) ++j;
      if (j < nlive) sgt::stage_tile(tile[0], t4, live[j], m);
      __pipeline_commit();
      int slot = 0;
      while (j < nlive) {
        int next = j + 1;
        while (next < nlive && live_gap[next] > bound) ++next;
        if (next < nlive) sgt::stage_tile(tile[slot ^ 1], t4, live[next], m);
        __pipeline_commit();
        __pipeline_wait_prior(1);  // this thread's copies of tile j landed
        __syncthreads();           // and every other thread's
        const int tt = live[j];
        offer_seeded<KMAX>(tile[slot], min(sgt::kBoxRows, m - tt * sgt::kBoxRows), tbox,
                           tt, active, qx, qy, qz, k, bd, bi, kth, kth0);
        __syncthreads();  // the slot is read; tile `next + 1` may land there
        j = next;
        slot ^= 1;
      }
      bound = sgt::block_max(active ? kth : 0.f, sw);  // kth ≤ reach
      // The next pass: the adjacent P boxes above and below in turn.
      if (above < ntiles && (up || below == 0)) {
        first = above;
        end = above = min(ntiles, above + P);
      } else if (below > 0) {
        end = below;
        first = below = max(0, below - P);
      } else {
        break;
      }
      up = !up;
    }
  }
#pragma unroll
  for (int s = 0; s < KMAX; ++s)
    if (bi[s] == (unsigned)sgt::kNoIndex) bd[s] = kBig;
  if (i < n) sgt::store_list<KMAX>(bd, bi, k, out_d, out_i, (size_t)row);
}

// ---------------------------------------------------------------- K5 ----

__global__ void __launch_bounds__(128)
knn_moments_warp_kernel(const float* __restrict__ pts, const int* __restrict__ num,
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

}  // namespace

extern "C" {

// pts [N,4] f32 (x y z w), num: device int32 count of valid rows,
// out [N,16] f32. Returns cudaGetLastError() after the launch.
int sgt_knn_moments(const float* pts, const int* num, int n, int k, float* out,
                    void* stream) {
  if (k < 1 || k > 64 || n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kMomThreads - 1) / kMomThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    knn_moments_kernel<16><<<blocks, kMomThreads, 0, s>>>(pts, num, n, k, out);
  else
    knn_moments_kernel<64><<<blocks, kMomThreads, 0, s>>>(pts, num, n, k, out);
  return (int)cudaGetLastError();
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

// K5. Arguments as K3's. Four queries (warps) per block up to k = 32, two
// above, so the lists stay within 32 KB of shared memory.
int sgt_knn_moments_warp(const float* pts, const int* num, int n, int k, float* out,
                         void* stream) {
  if (k < 1 || k > 64 || n <= 0) return (int)cudaErrorInvalidValue;
  const int warps = k <= 32 ? 4 : 2;
  const int blocks = (n + warps - 1) / warps;
  const size_t shared = kWarpTile * sizeof(float4) + (size_t)warps * k * 32 * 8;
  knn_moments_warp_kernel<<<blocks, warps * 32, shared, (cudaStream_t)stream>>>(
      pts, num, n, k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
