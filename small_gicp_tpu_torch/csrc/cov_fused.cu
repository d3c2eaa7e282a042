// Exact self-kNN covariance moments (K3), hand-written for Hopper (sm_90a).
//
// Replaces small_gicp_tpu/ops/cov_fused_pallas.py `_make_moments_kernel_T`
// (knn_moments_pallas, layout "t"): for every valid row q, the k nearest
// valid rows p (self included) by exact difference-form d², and the
// query-centred moments of d = p − q over those neighbours:
//   out[q] = [Σd 3 | Σddᵀ upper 6 (xx xy xz yy yz zz) | count | d_k | 0 ×5]
// where count is the number of slots with d² < 1e16 and d_k the kth d².
// Rows at or beyond num_points get zeros.
//
// What bounds it: the search, N² pairs at ~9 f32 operations each
// (operations; the moments are k·9 operations per row). One thread owns
// one query and keeps a sorted top-k list of (d², dx, dy, dz) in
// registers (sgt::TopK of common.cuh, shared with the search kernels);
// the block streams the cloud through shared memory in 16-byte rows, so
// the inner loop is one broadcast load, the distance and one compare. Ties keep the lower row index (strict < against the
// kth, insertion after equal entries, rows visited in ascending order),
// which is the order a stable sort of (d², index) gives.
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

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using sgt::kBig;

constexpr int kMomThreads = 64;
constexpr int kMomTile = 512;
constexpr int kWindow = 32;
constexpr float kValidSq = 1e16f;

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

  // (d², dx, dy, dz) of the k nearest rows so far.
  sgt::TopK<KMAX, 3> best;
  best.clear(0u);  // offsets 0.0f

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
      if (d2 < best.kth && d2 <= bound) {
        best.insert(k, d2, __float_as_uint(dx), __float_as_uint(dy),
                    __float_as_uint(dz));
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
      if (s < k && best.d[s] < kValidSq) {
        const float bx = __uint_as_float(best.p0[s]);
        const float by = __uint_as_float(best.p1[s]);
        const float bz = __uint_as_float(best.p2[s]);
        o[0] += bx;
        o[1] += by;
        o[2] += bz;
        o[3] += bx * bx;
        o[4] += bx * by;
        o[5] += bx * bz;
        o[6] += by * by;
        o[7] += by * bz;
        o[8] += bz * bz;
        o[9] += 1.f;
      }
    }
    o[10] = best.kth;
  }
  float4* row = reinterpret_cast<float4*>(out + (size_t)i * 16);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    row[c] = make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
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

}  // extern "C"
