// Fused GICP correspondence search + linearize (K1) and the LM trial
// errors (K2), hand-written for Hopper (sm_90a).
//
// K1's first forms (the box walks of gicp_listed.cu replaced them on every
// path; kept as yardsticks and for the brute-force lane entries) replace
// small_gicp_tpu/ops/gicp_fused_pallas.py `_fused_kernel_listed` +
// `_fused_finalize` (the finalize is in gicp_common.cuh; the `mxu_dist`
// branch is the SCORE instance below): exact 1-NN of T·p over the valid
// target rows, then the per-point weight W (GICP (C_t + R C_s Rᵀ)⁻¹
// by adjugate with the |det| < 1e-30 guard, plane-ICP diag(n∘n), ICP I),
// the rejector mask d² ≤ max_d2, the optional Huber/Cauchy weight w(√e),
// J = [R·skew(p) | −R], the per-block sums [H | b | e | inliers] and the
// frozen correspondence rows corr = [μ 3 | W 9 | mask | d² | 0 | 0].
//
// What bounds it: the brute-force search, N·M pairs at ~9 f32 operations
// each (operations, not bytes: the target tile is read from shared memory
// by every thread of the block). The design keeps the inner loop to one
// 16-byte shared-memory broadcast load, the distance and a compare; the
// winner's payload is gathered once from device memory after the loop
// (the TPU kernel carried it through a one-hot matmul); blocks whose rows
// are all padding skip the search. One thread owns one source point, so
// the ~150-scalar finalize stays in registers; only the 21 unique entries
// of H are formed. Block sums go through warp
// shuffles into a [blocks, 44] buffer that the caller sums in float64, so
// results are deterministic (no float atomics).
//
// K2's first form (the LM step kernel of gicp_step.cu replaced it on every
// path; kept as the yardstick `_gicp_error_multi_v1` and for the lane
// entry): `_trials_kernel` (gicp_error_multi_pallas), Σ ½ rᵀWr·mask,
// re-weighted by w(√e) at each pose, for up to 100 poses over the frozen
// corr rows. It reads each correspondence row once (bytes-bound: 80 bytes
// per point) and loops over the poses held in shared memory.
//
// The lane entries run the same two kernels with a lane grid dimension
// (blockIdx.y = lane b) over U stacked pairs: a block reads uids[b] from
// device memory and offsets the table pointers to its pair in place, and
// blocks of an inactive lane write zero corr rows and zero partials and
// return. They are the brute-force forms of the fleet kernels K7 and K8,
// which gicp_fleet.cu holds (box-pruned, sums finished in the launch);
// chip_smoke.py times K7 and K8 against them. The single-pair entries
// launch the same kernels with one lane and no lane tables.

#include <cuda_runtime.h>

#include "gicp_common.cuh"

namespace {

using namespace sgt;

constexpr int kTrialThreads = 128;
constexpr int kMaxPoses = 100;

// Lane b's pair: uids[b] clamped into [0, u), or pair 0 without uids.
__device__ __forceinline__ int lane_pair(const int* uids, int u) {
  return uids ? min(max(uids[blockIdx.y], 0), u - 1) : 0;
}

// ttab [U,M,16]: x y z 0 | payload 9 (C_t row-major, or the normal) | 0 0 0
// qtab [U,N,16]: x y z 0 | C_s 9 row-major | 0 0 0
// tnum, qnum [U]: valid rows of each pair
// uids [B] lane → pair and active [B] (both may be null: every lane reads
// pair 0 and is active); poses [B,12]: R row-major 9 | t 3
// corr [B,N,16], partials [B, gridDim.x, 44]
// SCORE: rank the targets by ‖t‖² − 2 t·q with ‖t‖² read from ttab column 13
// (uncentred, as the Pallas kernel's mxu_dist branch forms it; ‖q‖² is the
// same for every target of one query) and take the winner's exact d²
// afterwards, on CUDA cores (gicp_listed.cu says why).
template <int FACTOR, int ROBUST, bool SCORE>
__global__ void __launch_bounds__(kLinThreads)
gicp_linearize_kernel(const float* __restrict__ ttab, const int* __restrict__ tnum,
                      const float* __restrict__ qtab, const int* __restrict__ qnum,
                      int u, int m_rows, const int* __restrict__ uids,
                      const bool* __restrict__ active_lanes, int n,
                      const float* __restrict__ poses, float max_d2,
                      float robust_c, float* __restrict__ corr,
                      float* __restrict__ partials) {
  __shared__ float4 tile[kLinTile];
  __shared__ float red[kLinThreads / 32][kLinRed];

  const int i = blockIdx.x * kLinThreads + threadIdx.x;
  const size_t fl = blockIdx.y;  // fleet lane
  corr += fl * n * 16;
  partials += (fl * gridDim.x + blockIdx.x) * kLinOut;
  if (active_lanes && !active_lanes[fl]) {
    if (i < n) {
      float4* out = reinterpret_cast<float4*>(corr + (size_t)i * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (threadIdx.x < kLinOut) partials[threadIdx.x] = 0.f;
    return;
  }
  const int pair = lane_pair(uids, u);
  ttab += (size_t)pair * m_rows * 16;
  qtab += (size_t)pair * n * 16;
  const float* pose = poses + fl * 12;
  const int m = tnum[pair];
  const int nv = min(n, qnum[pair]);
  const bool active = i < nv;
  const bool block_active = blockIdx.x * kLinThreads < nv;  // uniform

  float r[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];

  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    const float4 p4 = reinterpret_cast<const float4*>(qtab)[(size_t)i * 4];
    px = p4.x;
    py = p4.y;
    pz = p4.z;
  }
  const float qx = sgt::affine_row(r + 0, t[0], px, py, pz);
  const float qy = sgt::affine_row(r + 3, t[1], px, py, pz);
  const float qz = sgt::affine_row(r + 6, t[2], px, py, pz);

  // Exact 1-NN; ascending scan with strict < keeps the lower index on ties.
  float best_d = kBig;
  int best = -1;
  for (int base = 0; block_active && base < m; base += kLinTile) {
    const int cnt = min(kLinTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kLinThreads) {
      float4 tp = reinterpret_cast<const float4*>(ttab)[(size_t)(base + j) * 4];
      if (SCORE) tp.w = ttab[(size_t)(base + j) * 16 + 13];
      tile[j] = tp;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float4 tp = tile[j];
        float d2;
        if (SCORE) {
          const float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(qx, tp.x), __fmul_rn(qy, tp.y)), __fmul_rn(qz, tp.z));
          d2 = __fsub_rn(tp.w, __fmul_rn(2.f, dot));
        } else {
          float dx, dy, dz;
          d2 = sgt::sq_dist(qx, qy, qz, tp.x, tp.y, tp.z, dx, dy, dz);
        }
        if (d2 < best_d) {
          best_d = d2;
          best = base + j;
        }
      }
    }
  }

  if (SCORE && best >= 0) {
    // The score only ranks; the rejector and corr take the winner's exact d².
    const float* row = ttab + (size_t)best * 16;
    float dx, dy, dz;
    best_d = sgt::sq_dist(qx, qy, qz, row[0], row[1], row[2], dx, dy, dz);
  }
  linearize_finalize<FACTOR, ROBUST, false>(
      ttab, i < n ? qtab + (size_t)i * 16 : nullptr, active, best, best_d, r, qx, qy,
      qz, px, py, pz, max_d2, robust_c, i < n ? corr + (size_t)i * 16 : nullptr,
      partials, red);
}

// corr [B,N,16] from K1/K7; src [U,N,src_row] source xyz (K2: the points,
// src_row 4; K8: the pair tables qtab, src_row 16), lane b reading pair
// uids[b] (pair 0 without uids); qnum: valid source rows, or null when the
// corr mask alone decides (it already holds validity); poses [B,K1,12]
// (R 9 | t 3); partials [B, gridDim.x, K1].
template <int ROBUST>
__global__ void __launch_bounds__(kTrialThreads)
gicp_error_multi_kernel(const float* __restrict__ corr, const float* __restrict__ src,
                        int src_row, int u, const int* __restrict__ uids,
                        const int* __restrict__ qnum, int n,
                        const float* __restrict__ poses, int k1, float robust_c,
                        float* __restrict__ partials) {
  __shared__ float ps[kMaxPoses * 12];
  __shared__ float red[kTrialThreads / 32][kMaxPoses];
  const size_t fl = blockIdx.y;  // fleet lane
  corr += fl * n * 16;
  src += (size_t)lane_pair(uids, u) * n * src_row;
  poses += fl * k1 * 12;
  partials += (fl * gridDim.x + blockIdx.x) * k1;
  for (int j = threadIdx.x; j < 12 * k1; j += kTrialThreads) ps[j] = poses[j];
  __syncthreads();

  const int i = blockIdx.x * kTrialThreads + threadIdx.x;
  bool active = i < n && (qnum == nullptr || i < *qnum);
  float c[16];
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    const float4* c4 = reinterpret_cast<const float4*>(corr + (size_t)i * 16);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 x = c4[k];
      c[4 * k + 0] = x.x;
      c[4 * k + 1] = x.y;
      c[4 * k + 2] = x.z;
      c[4 * k + 3] = x.w;
    }
    const float4 p4 = *reinterpret_cast<const float4*>(src + (size_t)i * src_row);
    px = p4.x;
    py = p4.y;
    pz = p4.z;
    active = c[12] > 0.5f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < k1; ++k) {
    float e = 0.f;
    if (active) {
      const float* P = ps + 12 * k;
      const float rx = c[0] - (P[0] * px + P[1] * py + P[2] * pz + P[9]);
      const float ry = c[1] - (P[3] * px + P[4] * py + P[5] * pz + P[10]);
      const float rz = c[2] - (P[6] * px + P[7] * py + P[8] * pz + P[11]);
      const float wr0 = c[3] * rx + c[4] * ry + c[5] * rz;
      const float wr1 = c[6] * rx + c[7] * ry + c[8] * rz;
      const float wr2 = c[9] * rx + c[10] * ry + c[11] * rz;
      e = 0.5f * (rx * wr0 + ry * wr1 + rz * wr2);
      if (ROBUST != kNone) e = robust_weight<ROBUST>(e, robust_c) * e;
    }
    const float s = sgt::warp_sum(e);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < k1; k += kTrialThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kTrialThreads / 32; ++wi) s += red[wi][k];
    partials[k] = s;
  }
}

template <int F, int RB, bool SCORE>
void launch_linearize(dim3 grid, cudaStream_t stream, const float* ttab,
                      const int* tnum, const float* qtab, const int* qnum, int u,
                      int m_rows, const int* uids, const bool* active, int n,
                      const float* poses, float max_d2, float robust_c, float* corr,
                      float* partials) {
  gicp_linearize_kernel<F, RB, SCORE><<<grid, kLinThreads, 0, stream>>>(
      ttab, tnum, qtab, qnum, u, m_rows, uids, active, n, poses, max_d2, robust_c,
      corr, partials);
}

using LinearizeLaunch = void (*)(dim3, cudaStream_t, const float*, const int*,
                                 const float*, const int*, int, int, const int*,
                                 const bool*, int, const float*, float, float, float*,
                                 float*);

#define SGT_LINEARIZE_ROW(F, S)                                          \
  {launch_linearize<F, kNone, S>, launch_linearize<F, kHuber, S>,        \
   launch_linearize<F, kCauchy, S>}
// [score form][factor][robust]
const LinearizeLaunch kLinearize[2][3][3] = {
    {SGT_LINEARIZE_ROW(kGicp, false), SGT_LINEARIZE_ROW(kPlaneIcp, false),
     SGT_LINEARIZE_ROW(kIcp, false)},
    {SGT_LINEARIZE_ROW(kGicp, true), SGT_LINEARIZE_ROW(kPlaneIcp, true),
     SGT_LINEARIZE_ROW(kIcp, true)},
};
#undef SGT_LINEARIZE_ROW

constexpr int kMaxLanes = 65535;  // gridDim.y

int linearize(const float* ttab, const int* tnum, const float* qtab, const int* qnum,
              int u, int m_rows, const int* uids, const bool* active, int b, int n,
              const float* poses, float max_d2, float robust_c, int factor,
              int robust, bool score, float* corr, float* partials, void* stream) {
  if (factor < 0 || factor > 2 || robust < 0 || robust > 2 || n <= 0 || u < 1 ||
      m_rows < 0 || b < 1 || b > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kLinThreads - 1) / kLinThreads, b);
  kLinearize[score][factor][robust](grid, (cudaStream_t)stream, ttab, tnum, qtab, qnum, u,
                             m_rows, uids, active, n, poses, max_d2, robust_c, corr,
                             partials);
  return (int)cudaGetLastError();
}

int error_multi(const float* corr, const float* src, int src_row, int u,
                const int* uids, const int* qnum, int b, int n, const float* poses,
                int k1, float robust_c, int robust, float* partials, void* stream) {
  if (k1 < 1 || k1 > kMaxPoses || robust < 0 || robust > 2 || n <= 0 || u < 1 ||
      b < 1 || b > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTrialThreads - 1) / kTrialThreads, b);
  cudaStream_t s = (cudaStream_t)stream;
  if (robust == kHuber)
    gicp_error_multi_kernel<kHuber><<<grid, kTrialThreads, 0, s>>>(
        corr, src, src_row, u, uids, qnum, n, poses, k1, robust_c, partials);
  else if (robust == kCauchy)
    gicp_error_multi_kernel<kCauchy><<<grid, kTrialThreads, 0, s>>>(
        corr, src, src_row, u, uids, qnum, n, poses, k1, robust_c, partials);
  else
    gicp_error_multi_kernel<kNone><<<grid, kTrialThreads, 0, s>>>(
        corr, src, src_row, u, uids, qnum, n, poses, k1, robust_c, partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sgt_linearize_block_rows() { return kLinThreads; }
int sgt_trials_block_rows() { return kTrialThreads; }

// Each launch entry returns cudaGetLastError() after its launch (0 on
// success).

// K1: one pair, one pose; partials [blocks, 44].
int sgt_gicp_linearize(const float* ttab, const int* tnum, const float* qtab,
                       const int* qnum, int n, const float* pose, float max_d2,
                       float robust_c, int factor, int robust, float* corr,
                       float* partials, void* stream) {
  return linearize(ttab, tnum, qtab, qnum, 1, 0, nullptr, nullptr, 1, n, pose,
                   max_d2, robust_c, factor, robust, false, corr, partials, stream);
}

// The first form of K1's score form: the same arguments; ttab column 13
// holds ‖t‖².
int sgt_gicp_linearize_score(const float* ttab, const int* tnum, const float* qtab,
                             const int* qnum, int n, const float* pose, float max_d2,
                             float robust_c, int factor, int robust, float* corr,
                             float* partials, void* stream) {
  return linearize(ttab, tnum, qtab, qnum, 1, 0, nullptr, nullptr, 1, n, pose,
                   max_d2, robust_c, factor, robust, true, corr, partials, stream);
}

// K1 over b lanes of u pairs of m_rows target and n source rows each (the
// brute-force form of K7); partials [b, blocks, 44].
int sgt_gicp_linearize_fleet(const float* ttab, const int* tnum, const float* qtab,
                             const int* qnum, int u, int m_rows, const int* uids,
                             const bool* active, int b, int n, const float* poses,
                             float max_d2, float robust_c, int factor, int robust,
                             float* corr, float* partials, void* stream) {
  return linearize(ttab, tnum, qtab, qnum, u, m_rows, uids, active, b, n, poses,
                   max_d2, robust_c, factor, robust, false, corr, partials, stream);
}

// K2: one pair; src [N,4]; partials [blocks, k1].
int sgt_gicp_error_multi(const float* corr, const float* src, const int* qnum, int n,
                         const float* poses, int k1, float robust_c, int robust,
                         float* partials, void* stream) {
  return error_multi(corr, src, 4, 1, nullptr, qnum, 1, n, poses, k1, robust_c,
                     robust, partials, stream);
}

// K2 over b lanes (the form of K8 that leaves the sums to the caller);
// source xyz from qtab [u,N,16] of pair uids[b]; partials [b, blocks, k1].
int sgt_gicp_error_multi_fleet(const float* corr, const float* qtab, int u,
                               const int* uids, int b, int n, const float* poses,
                               int k1, float robust_c, int robust, float* partials,
                               void* stream) {
  return error_multi(corr, qtab, 16, u, uids, nullptr, b, n, poses, k1, robust_c,
                     robust, partials, stream);
}

}  // extern "C"
