// The fleet round's two kernels, hand-written for Hopper (sm_90a): the
// box-pruned fused correspondence search + linearize over B lanes (K7) and
// the lanes' LM trial errors (K8). Each finishes its float64 sums over a
// lane's blocks inside its one launch.
//
// K7 replaces small_gicp_tpu/ops/gicp_fused_pallas.py:1312
// `gicp_linearize_fleet` (its XLA-side live-tile lists `_fleet_live_lists`
// at :1260, then `_fused_kernel_listed` + `_fused_finalize` per lane): lane b
// linearizes pair uids[b] at its pose, with K1's outputs — per-lane sums
// [H 36 | b 6 | e | inliers] and frozen rows corr = [μ 3 | W 9 | mask | d² |
// 0 0] in the clouds' row order.
//
// What bounds K7: the pairs that box pruning cannot avoid on the data
// (operations, ~9 a pair), over 30 lanes of ≈21k × 21k rows ≈ 1.4e10 pairs
// brute force. The prologue (gicp_fleet_prepare) Morton-sorts every pair's
// target into compact rows (x y z | original row), boxes every 256 sorted
// rows, and orders each source by Morton code (a permutation: the tables
// stay in the clouds' order). A block owns 64 consecutive sorted source rows
// of one lane, transforms them at the lane's pose (read from the [B,4,4]
// poses as they are) and reduces the box of the valid ones. Its 64 threads
// then test the pair's boxes in parallel, each box tid, tid + 64, …, against
// the block's box (gap² > max_d2 culls; a NaN gap keeps the tile) and
// compact the live tile indices into a shared list, in ascending order, by
// ballot and popc. The live tiles stream through a two-stage ring in shared
// memory: tile k + 1 is copied while tile k is scanned. The copies are
// cp.async 16-byte copies (one tile is at most 4 KB and contiguous: 4 copies
// a thread, no barrier object to set up), committed a group per tile and
// waited for with wait_prior(1). Within a staged tile a warp skips the rows
// if the tile's box lies farther from each of its points than that point's
// best d² so far, or than max_d2. Candidates need d² ≤ max_d2 and win in
// (d², original row) order, so the winner on every row that K1 accepts is
// K1's bit for bit; the gap² between boxes never exceeds the d² of a pair
// inside them (common.cuh), so no acceptable row is culled. K1's finalize
// follows and writes corr through the source order. A row without an
// accepted correspondence (rejected, padding, empty target) holds zeros and
// d² = 3e38, as K6's do: its nearest row may lie in a culled tile.
//
// K8 replaces :1438 `gicp_error_multi_fleet` (`_trials_kernel` per lane):
// Σ ½ rᵀWr·mask, re-weighted by w(√e) at each pose, for up to 100 poses per
// lane over the lane's frozen corr rows. What bounds it: bytes, 80 a valid
// source row (the corr row and the source xyz) per lane. Blocks of 512 rows
// of a lane read the poses once from the [B,K1,4,4] poses; each thread
// loads its four rows (a block's rows r·128 + tid) before it uses any, so
// their loads are in flight together, then sums them for 16 poses at a time
// in registers: a block reduces each pose once.
//
// The cross-block sum of both: every block writes its float32 partials,
// fences, and takes a ticket of its lane (atomicAdd); the lane's last block
// sums the lane's partials in block order in float64, writes them, and sets
// the ticket back to 0 for the next launch. No float atomics: the result
// does not depend on the blocks' order, and a lane's work depends on
// nothing of another lane's. Blocks of an inactive lane write zero corr
// rows (and block 0 zero sums) and return. The brute-force lane kernel that
// K7 replaced is gicp_fused.cu's, which K1 keeps.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "gicp_common.cuh"

namespace {

using namespace sgt;

constexpr int kMaxTiles = 256;  // 65,536 target rows a pair / kBoxRows
static_assert(kMaxTiles <= kCullPass, "one cull pass covers a pair's boxes");
constexpr int kTrialThreads = 128;
constexpr int kTrialRowsPerThread = 4;
constexpr int kTrialBlockRows = kTrialThreads * kTrialRowsPerThread;
constexpr int kPoseChunk = 16;
constexpr int kMaxPoses = 100;
constexpr int kMaxLanes = 65535;  // gridDim.y
constexpr int kWarps = kLinThreads / 32;

static_assert(kLinThreads == kPrunedThreads, "block_max reduces a linearize block");

__device__ __forceinline__ int lane_pair(const int* uids, int u) {
  return min(max(uids[blockIdx.y], 0), u - 1);
}

// Called by every thread of a block after it wrote its partials: true in
// the block of lane blockIdx.y that finished last.
__device__ __forceinline__ bool last_block_of_lane(unsigned* tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// In the lane's last block: out[o] = Σ over the lane's blocks, in block
// order, of partials [gridDim.x, width] in float64; the ticket back to 0.
__device__ __forceinline__ void lane_sum(const float* partials, int width,
                                         double* out, unsigned* tickets) {
  for (int o = threadIdx.x; o < width; o += blockDim.x) {
    double s = 0.0;
    for (unsigned k = 0; k < gridDim.x; ++k)
      s += (double)__ldcg(partials + (size_t)k * width + o);
    out[o] = s;
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0u;
}

// ttab [U,M,16], qtab [U,N,16] in the clouds' order (K1's tables); tsorted
// [U,M,4] Morton-sorted target rows x y z | original row; tbox [U,ceil(M /
// 256),8]; sperm [U,N] sorted position → source row; tnum, qnum [U]; uids,
// active [B]; poses [B,4,4]; corr [B,N,16]; partials [B,gridDim.x,44];
// tickets [B], zero between launches; sums [B,44] float64.
template <int FACTOR, int ROBUST>
__global__ void __launch_bounds__(kLinThreads)
gicp_linearize_fleet_kernel(const float* __restrict__ ttab,
                            const float* __restrict__ tsorted,
                            const float* __restrict__ tbox,
                            const int* __restrict__ tnum,
                            const float* __restrict__ qtab,
                            const int* __restrict__ sperm,
                            const int* __restrict__ qnum, int u, int mcap, int n,
                            const int* __restrict__ uids,
                            const bool* __restrict__ active_lanes,
                            const float* __restrict__ poses, float max_d2,
                            float robust_c, float* __restrict__ corr,
                            float* __restrict__ partials,
                            unsigned* __restrict__ tickets,
                            double* __restrict__ sums) {
  __shared__ __align__(16) float4 tile[2][kBoxRows];
  __shared__ int live[kMaxTiles];
  __shared__ int counts[kCullWords];
  __shared__ float sw[kWarps];
  __shared__ float red[kWarps][kLinRed];

  const size_t lane = blockIdx.y;
  const int i = blockIdx.x * kLinThreads + threadIdx.x;  // sorted position
  corr += lane * n * 16;
  sums += lane * kLinOut;
  if (!active_lanes[lane]) {
    if (i < n) {
      float4* out = reinterpret_cast<float4*>(corr + (size_t)i * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (blockIdx.x == 0 && threadIdx.x < kLinOut) sums[threadIdx.x] = 0.0;
    return;
  }
  const int pair = lane_pair(uids, u);
  const size_t ntiles_cap = (mcap + kBoxRows - 1) / kBoxRows;
  ttab += (size_t)pair * mcap * 16;
  tsorted += (size_t)pair * mcap * 4;
  tbox += (size_t)pair * ntiles_cap * 8;
  qtab += (size_t)pair * n * 16;
  sperm += (size_t)pair * n;
  float* lane_partials = partials + lane * gridDim.x * kLinOut;
  const int m = min(tnum[pair], mcap);
  const int nv = min(n, qnum[pair]);
  const bool active = i < nv;
  const bool block_active = blockIdx.x * kLinThreads < nv;  // uniform
  const int row = i < n ? sperm[i] : 0;
  const float* qrow = i < n ? qtab + (size_t)row * 16 : nullptr;

  // R row-major and t from the lane's 4×4 pose.
  const float* P = poses + lane * 16;
  float r[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = P[(k / 3) * 4 + k % 3];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = P[k * 4 + 3];

  float px = 0.f, py = 0.f, pz = 0.f;
  if (qrow) {
    const float4 p4 = *reinterpret_cast<const float4*>(qrow);
    px = p4.x;
    py = p4.y;
    pz = p4.z;
  }
  const float qx = affine_row(r + 0, t[0], px, py, pz);
  const float qy = affine_row(r + 3, t[1], px, py, pz);
  const float qz = affine_row(r + 6, t[2], px, py, pz);

  float best_d = kBig;
  int best = kNoIndex;
  if (block_active) {
    float lo[3], hi[3];  // the box of the block's transformed valid points
    block_box(active, qx, qy, qz, sw, lo, hi);

    // Cull the pair's boxes (at most kMaxTiles: one pass) into the ascending
    // list `live`.
    const int ntiles = (m + kBoxRows - 1) / kBoxRows;
    const int nlive =
        cull_boxes(tbox, 0, ntiles, lo, hi, max_d2, live, nullptr, counts);

    // Live tile k goes to ring slot k & 1, one commit group per tile.
    const float4* t4 = reinterpret_cast<const float4*>(tsorted);
    if (nlive > 0) stage_tile(tile[0], t4, live[0], m);
    __pipeline_commit();
    for (int k = 0; k < nlive; ++k) {
      if (k + 1 < nlive) stage_tile(tile[(k + 1) & 1], t4, live[k + 1], m);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of tile k landed
      __syncthreads();           // and every other thread's
      const int tt = live[k];
      nearest_in_tile(tile[k & 1], min(kBoxRows, m - tt * kBoxRows), tbox, tt, active,
                      qx, qy, qz, max_d2, best_d, best);
      __syncthreads();  // slot k & 1 is read; tile k + 2 may land there
    }
  }

  linearize_finalize<FACTOR, ROBUST, true>(
      ttab, qrow, active, best == kNoIndex ? -1 : best, best_d, r, qx, qy, qz, px, py,
      pz, max_d2, robust_c, i < n ? corr + (size_t)row * 16 : nullptr,
      lane_partials + (size_t)blockIdx.x * kLinOut, red);
  if (last_block_of_lane(tickets)) lane_sum(lane_partials, kLinOut, sums, tickets);
}

// corr [B,N,16] from K7 (the mask in column 12 holds validity); qtab
// [U,N,16] (source xyz in columns 0-2) of pair uids[b]; poses [B,K1,4,4];
// partials [B,gridDim.x,K1]; tickets [B], zero between launches; errs
// [B,K1] float64.
template <int ROBUST>
__global__ void __launch_bounds__(kTrialThreads)
gicp_error_multi_fleet_kernel(const float* __restrict__ corr,
                              const float* __restrict__ qtab, int u,
                              const int* __restrict__ uids, int n,
                              const float* __restrict__ poses, int k1,
                              float robust_c, float* __restrict__ partials,
                              unsigned* __restrict__ tickets,
                              double* __restrict__ errs) {
  __shared__ float ps[kMaxPoses * 12];  // R row-major 9 | t 3 per pose
  __shared__ float red[kTrialThreads / 32][kMaxPoses];
  const size_t lane = blockIdx.y;
  corr += lane * n * 16;
  qtab += (size_t)lane_pair(uids, u) * n * 16;
  poses += lane * k1 * 16;
  float* lane_partials = partials + lane * gridDim.x * k1;
  for (int j = threadIdx.x; j < 12 * k1; j += kTrialThreads) {
    const int k = j / 12, c = j % 12;
    ps[j] = poses[k * 16 + (c < 9 ? (c / 3) * 4 + c % 3 : (c - 9) * 4 + 3)];
  }
  __syncthreads();

  const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // This thread's rows, all loaded before any is used: i0 + r·kTrialThreads.
  const int i0 = blockIdx.x * kTrialBlockRows + threadIdx.x;
  float4 a[kTrialRowsPerThread], b[kTrialRowsPerThread], c[kTrialRowsPerThread],
      p[kTrialRowsPerThread];
  bool live[kTrialRowsPerThread];
#pragma unroll
  for (int r = 0; r < kTrialRowsPerThread; ++r) {
    const int i = i0 + r * kTrialThreads;
    live[r] = i < n;
    if (live[r]) {
      const float4* c4 = reinterpret_cast<const float4*>(corr + (size_t)i * 16);
      a[r] = c4[0];
      b[r] = c4[1];
      c[r] = c4[2];
      live[r] = c4[3].x > 0.5f;  // mask = 0: rejected, padding, idle lane
      p[r] = *reinterpret_cast<const float4*>(qtab + (size_t)i * 16);
    }
  }
  for (int k0 = 0; k0 < k1; k0 += kPoseChunk) {
    float acc[kPoseChunk];
#pragma unroll
    for (int j = 0; j < kPoseChunk; ++j) acc[j] = 0.f;
#pragma unroll
    for (int r = 0; r < kTrialRowsPerThread; ++r) {
      if (!live[r]) continue;
      const float px = p[r].x, py = p[r].y, pz = p[r].z;
#pragma unroll
      for (int j = 0; j < kPoseChunk; ++j) {
        if (k0 + j < k1) {
          const float* P = ps + 12 * (k0 + j);
          const float rx = a[r].x - (P[0] * px + P[1] * py + P[2] * pz + P[9]);
          const float ry = a[r].y - (P[3] * px + P[4] * py + P[5] * pz + P[10]);
          const float rz = a[r].z - (P[6] * px + P[7] * py + P[8] * pz + P[11]);
          const float wr0 = a[r].w * rx + b[r].x * ry + b[r].y * rz;
          const float wr1 = b[r].z * rx + b[r].w * ry + c[r].x * rz;
          const float wr2 = c[r].y * rx + c[r].z * ry + c[r].w * rz;
          float e = 0.5f * (rx * wr0 + ry * wr1 + rz * wr2);
          if (ROBUST != kNone) e = robust_weight<ROBUST>(e, robust_c) * e;
          acc[j] += e;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPoseChunk; ++j) {
      if (k0 + j < k1) {
        const float s = warp_sum(acc[j]);
        if (lid == 0) red[warp][k0 + j] = s;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < k1; k += kTrialThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kTrialThreads / 32; ++w) s += red[w][k];
    lane_partials[(size_t)blockIdx.x * k1 + k] = s;
  }
  if (last_block_of_lane(tickets)) lane_sum(lane_partials, k1, errs + lane * k1, tickets);
}

template <int F, int RB>
void launch_linearize(dim3 grid, cudaStream_t stream, const float* ttab,
                      const float* tsorted, const float* tbox, const int* tnum,
                      const float* qtab, const int* sperm, const int* qnum, int u,
                      int mcap, int n, const int* uids, const bool* active,
                      const float* poses, float max_d2, float robust_c, float* corr,
                      float* partials, unsigned* tickets, double* sums) {
  gicp_linearize_fleet_kernel<F, RB><<<grid, kLinThreads, 0, stream>>>(
      ttab, tsorted, tbox, tnum, qtab, sperm, qnum, u, mcap, n, uids, active, poses,
      max_d2, robust_c, corr, partials, tickets, sums);
}

using LinearizeLaunch = void (*)(dim3, cudaStream_t, const float*, const float*,
                                 const float*, const int*, const float*, const int*,
                                 const int*, int, int, int, const int*, const bool*,
                                 const float*, float, float, float*, float*, unsigned*,
                                 double*);

const LinearizeLaunch kLinearize[3][3] = {
    {launch_linearize<kGicp, kNone>, launch_linearize<kGicp, kHuber>,
     launch_linearize<kGicp, kCauchy>},
    {launch_linearize<kPlaneIcp, kNone>, launch_linearize<kPlaneIcp, kHuber>,
     launch_linearize<kPlaneIcp, kCauchy>},
    {launch_linearize<kIcp, kNone>, launch_linearize<kIcp, kHuber>,
     launch_linearize<kIcp, kCauchy>},
};

}  // namespace

extern "C" {

int sgt_fleet_trial_block_rows() { return kTrialBlockRows; }

// Each launch entry returns cudaGetLastError() after its launch (0 on
// success).

// K7: b lanes over u pairs of mcap target and n source rows each (mcap ≤
// 65,536); partials [b, ceil(n / 64), 44] float32 scratch; sums [b, 44].
int sgt_fleet_linearize(const float* ttab, const float* tsorted, const float* tbox,
                        const int* tnum, const float* qtab, const int* sperm,
                        const int* qnum, int u, int mcap, int n, const int* uids,
                        const bool* active, int b, const float* poses, float max_d2,
                        float robust_c, int factor, int robust, float* corr,
                        float* partials, unsigned* tickets, double* sums,
                        void* stream) {
  if (factor < 0 || factor > 2 || robust < 0 || robust > 2 || n <= 0 || u < 1 ||
      mcap < 0 || mcap > kMaxTiles * kBoxRows || b < 1 || b > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kLinThreads - 1) / kLinThreads, b);
  kLinearize[factor][robust](grid, (cudaStream_t)stream, ttab, tsorted, tbox, tnum, qtab,
                             sperm, qnum, u, mcap, n, uids, active, poses, max_d2,
                             robust_c, corr, partials, tickets, sums);
  return (int)cudaGetLastError();
}

// K8: b lanes, k1 ≤ 100 poses each; partials [b, ceil(n / 512), k1] float32
// scratch; errs [b, k1].
int sgt_fleet_error_multi(const float* corr, const float* qtab, int u, const int* uids,
                          int b, int n, const float* poses, int k1, float robust_c,
                          int robust, float* partials, unsigned* tickets, double* errs,
                          void* stream) {
  if (k1 < 1 || k1 > kMaxPoses || robust < 0 || robust > 2 || n <= 0 || u < 1 ||
      b < 1 || b > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTrialBlockRows - 1) / kTrialBlockRows, b);
  cudaStream_t s = (cudaStream_t)stream;
  if (robust == kHuber)
    gicp_error_multi_fleet_kernel<kHuber><<<grid, kTrialThreads, 0, s>>>(
        corr, qtab, u, uids, n, poses, k1, robust_c, partials, tickets, errs);
  else if (robust == kCauchy)
    gicp_error_multi_fleet_kernel<kCauchy><<<grid, kTrialThreads, 0, s>>>(
        corr, qtab, u, uids, n, poses, k1, robust_c, partials, tickets, errs);
  else
    gicp_error_multi_fleet_kernel<kNone><<<grid, kTrialThreads, 0, s>>>(
        corr, qtab, u, uids, n, poses, k1, robust_c, partials, tickets, errs);
  return (int)cudaGetLastError();
}

}  // extern "C"
