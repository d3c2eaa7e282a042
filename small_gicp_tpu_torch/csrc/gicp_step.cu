// The LM step of the registration loop (K2 redesigned), hand-written for
// Hopper (sm_90a): the λ-trial solves, se3_exp, the trial errors and the
// accept in one launch.
//
// It replaces small_gicp_tpu/ops/gicp_fused_pallas.py `_trials_kernel`
// (:1033, pallas_call at :1153) together with the XLA ops around it in
// small_gicp_tpu/models/registration.py:474-536: `_solve` over the λ_j, the
// vmapped `se3_exp`, the einsum T·exp(δ_j) and the accept. One launch per
// LM iteration reads K1's float64 sums [H 36 | b 6 | e | inliers] in place
// and the frozen correspondence rows, and leaves the loop's state in a
// device record (layout below) whose pose K1 reads in place next.
//
//   * Trials: for j < K, (H + λ·f^j·I + dof)·δ_j = −b by a 6×6 Cholesky in
//     the solve type S (float, or double for solve_dtype "float64"; H
//     arrives un-truncated then), the pivot clamped at 1e-30, in the scalar
//     order of the plain version (ops/lm_step.py, the JAX package's
//     `_cholesky_solve6`) with every operation rounded on its own (no fused
//     multiply-add), so kernel and plain version solve bit for bit. λ·f^j
//     takes f^j from a table the wrapper fills by repeated multiplication in
//     float64 (no powf). δ_j is cast to float32 and T·se3_exp(δ_j) formed with
//     utils/lie.py's branches (θ < 1e-5 and θ < 1e-2 Taylor switches,
//     1 − cosθ as 2·sin²(θ/2)).
//   * Errors: Σ ½ rᵀWr·mask at the current pose and the K trial poses in one
//     pass over the rows, re-weighted by w(√e) at each pose, as K2 and K8
//     compute them: the current pose's error and the trials' come from the
//     same arithmetic, so the accept test compares like with like. Block
//     sums are float32; the last block to take a ticket sums them in
//     float64 in a fixed order (segments of consecutive blocks, loaded
//     together, then the segments in order) and sets the ticket back to 0
//     (no float atomics, no memset launch: deterministic).
//   * Accept, in that last block: the first j with err_j ≤ e0 gives T, e,
//     δ, λ ← λ_j / f; if every trial is rejected, λ ← λ·f^K and the loop
//     stops; converged = accepted and ‖δ_rot‖ ≤ rot_eps and ‖δ_t‖ ≤
//     trans_eps (registration.py:229-245 of the port, to the letter). GN: one
//     solve at gn_lambda, the error at the current pose, T·exp(δ) applied
//     even on the converging iteration.
//   * Errors only (gicp_error_multi on the card): given poses, [K1] float64
//     errors, the sums finished in the launch.
//
// What bounds it: bytes, 80 a source row (the corr row and the source
// xyz), ≈1.7 MB at the scan pair's 21.8k rows (0.5 µs at 3.35 TB/s), and
// below that the launch itself; the K solves are a few hundred dependent
// operations of one thread each. The design: one launch in place of the
// ≈230 small launches of the eager loop, no host round trip for the trial
// poses or the accept; each thread issues the loads of its two rows
// before the solves, so the rows are in flight while threads j < K of
// every block solve trial j into shared memory (PERF.md §6 records block 0
// alone solving and handing the poses over: it was slower).

#include <cuda_runtime.h>

#include "gicp_common.cuh"

namespace {

using namespace sgt;

constexpr int kStepThreads = 128;
constexpr int kStepBlockRows = 256;  // tools/step_sweep.py
constexpr int kStepRowsPerThread = kStepBlockRows / kStepThreads;
static_assert(kStepBlockRows % kStepThreads == 0, "whole rows a thread");
constexpr int kPoseChunk = 16;
constexpr int kMaxPoses = 100;  // the current pose and at most 99 trials
constexpr int kMaxTrials = kMaxPoses - 1;

enum Mode { kErrors = 0, kLm = 1, kGn = 2 };

// The state record of a float32 align, byte offsets (ops/lm_step.py's
// LmState repeats them).
constexpr int kRecT = 0;            // float [4,4] row-major: the pose
constexpr int kRecH = 64;           // float [6,6]: H + dof in the solve type
constexpr int kRecB = 208;          // float [6]
constexpr int kRecDelta = 232;      // float [6]: the step taken (0 if none)
constexpr int kRecLam = 256;        // float λ
constexpr int kRecInliers = 260;    // int
constexpr int kRecE = 264;          // double: the error after the step
constexpr int kRecIter = 272;       // int: index of the last executed iteration
constexpr int kRecCount = 276;      // int: iterations executed
constexpr int kRecJ = 280;          // int: the accepted trial, -1 if none
constexpr int kRecConverged = 284;  // bool
constexpr int kRecAccepted = 285;   // bool
constexpr int kRecStop = 286;       // bool
constexpr int kRecErrs = 288;       // double [trials + 1]: e0, then each trial's
// then float [trials, 18] at kRecErrs + 8·(trials + 1): δ_j 6 | R_j 9 | t_j 3.
constexpr int kTrialRow = 18;

// The parameters (double): lambda_factor, gn_lambda, rot_eps, trans_eps, the
// DoF diagonal [6], then f^0 … f^K.
constexpr int kParFactor = 0, kParGn = 1, kParRot = 2, kParTrans = 3, kParDof = 4,
              kParPow = 10;

// Rounded on their own, never fused.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// (H + damping·I + dof)·δ = −b by Cholesky, in the scalar order of
// `_cholesky_solve6`; H, b from K1's float64 sums, cast to S first.
template <typename S>
__device__ void solve_trial(const double* __restrict__ sums,
                            const double* __restrict__ params, S damping,
                            float (&delta)[6]) {
  const S eps = (S)1e-30;
  S L[6][6];
  S rhs[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    S s = add_rn(add_rn((S)sums[j * 7], (S)params[kParDof + j]), damping);
#pragma unroll
    for (int kk = 0; kk < j; ++kk) s = sub_rn(s, mul_rn(L[j][kk], L[j][kk]));
    const S d = sqrt_rn(s < eps ? eps : s);
    L[j][j] = d;
    const S inv = div_rn((S)1, d);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      S t = (S)sums[i * 6 + j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) t = sub_rn(t, mul_rn(L[i][kk], L[j][kk]));
      L[i][j] = mul_rn(t, inv);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    S s = -(S)sums[36 + i];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) s = sub_rn(s, mul_rn(L[i][kk], rhs[kk]));
    rhs[i] = div_rn(s, L[i][i]);
  }
  S x[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    S s = rhs[i];
#pragma unroll
    for (int kk = i + 1; kk < 6; ++kk) s = sub_rn(s, mul_rn(L[kk][i], x[kk]));
    x[i] = div_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = (float)x[i];
}

// P = T·se3_exp(δ) as R 9 | t 3, T given as R 9 | t 3 (utils/lie.py).
__device__ void trial_pose(const float (&T)[12], const float (&d)[6], float (&P)[12]) {
  const float wx = d[0], wy = d[1], wz = d[2];
  const float theta_sq = add_rn(add_rn(mul_rn(wx, wx), mul_rn(wy, wy)), mul_rn(wz, wz));
  const float theta = sqrt_rn(theta_sq < 0.f ? 0.f : theta_sq);
  const bool small = theta < 1e-5f;
  const float safe = small ? 1.f : theta;
  const float sin_half = sinf(mul_rn(0.5f, safe));
  const float a_exact = div_rn(sinf(safe), safe);
  const float b_exact = div_rn(mul_rn(mul_rn(2.f, sin_half), sin_half), mul_rn(safe, safe));
  const float a_taylor =
      sub_rn(1.f, mul_rn(div_rn(theta_sq, 6.f), sub_rn(1.f, div_rn(theta_sq, 20.f))));
  const float b_taylor =
      sub_rn(0.5f, mul_rn(div_rn(theta_sq, 24.f), sub_rn(1.f, div_rn(theta_sq, 30.f))));
  const float a = small ? a_taylor : a_exact;
  const float b = small ? b_taylor : b_exact;
  const bool small_c = theta < 1e-2f;
  const float sc = small_c ? 1.f : theta;
  const float c_exact = div_rn(sub_rn(sc, sinf(sc)), mul_rn(mul_rn(sc, sc), sc));
  const float c_taylor = mul_rn((float)(1.0 / 6.0),
                             sub_rn(1.f, mul_rn(div_rn(theta_sq, 20.f), sub_rn(1.f, div_rn(theta_sq, 42.f)))));
  const float c = small_c ? c_taylor : c_exact;
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float w2 =
          add_rn(add_rn(mul_rn(W[i][0], W[0][k]), mul_rn(W[i][1], W[1][k])), mul_rn(W[i][2], W[2][k]));
      const float eye = i == k ? 1.f : 0.f;
      R[i][k] = add_rn(add_rn(eye, mul_rn(a, W[i][k])), mul_rn(b, w2));
      V[i][k] = add_rn(add_rn(eye, mul_rn(b, W[i][k])), mul_rn(c, w2));
    }
  }
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = add_rn(add_rn(mul_rn(V[i][0], d[3]), mul_rn(V[i][1], d[4])), mul_rn(V[i][2], d[5]));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      P[3 * i + k] = add_rn(add_rn(mul_rn(T[3 * i], R[0][k]), mul_rn(T[3 * i + 1], R[1][k])),
                         mul_rn(T[3 * i + 2], R[2][k]));
    P[9 + i] = add_rn(add_rn(add_rn(mul_rn(T[3 * i], t[0]), mul_rn(T[3 * i + 1], t[1])),
                       mul_rn(T[3 * i + 2], t[2])),
                   T[9 + i]);
  }
}

// R 9 | t 3 of a row-major [4,4] pose.
__device__ __forceinline__ float pose12(const float* T, int c) {
  return T[c < 9 ? (c / 3) * 4 + c % 3 : (c - 9) * 4 + 3];
}

template <typename S>
__device__ __forceinline__ S damping_of(int mode, const unsigned char* rec,
                                        const double* params, int j) {
  if (mode == kGn) return (S)params[kParGn];
  const float lam_j =
      mul_rn(*reinterpret_cast<const float*>(rec + kRecLam), (float)params[kParPow + j]);
  return (S)lam_j;
}

// One trial j: its δ_j into sdelta and T·exp(δ_j) into pose slot 1 + j.
template <typename S, int MODE>
__device__ void solve_into(const double* sums, const double* params,
                           const unsigned char* rec, int j, float* ps, float* sdelta) {
  float d[6], T[12], P[12];
  solve_trial<S>(sums, params, damping_of<S>(MODE, rec, params, j), d);
  const float* Tr = reinterpret_cast<const float*>(rec + kRecT);
#pragma unroll
  for (int c = 0; c < 12; ++c) T[c] = pose12(Tr, c);
  trial_pose(T, d, P);
#pragma unroll
  for (int c = 0; c < 12; ++c) ps[12 * (1 + j) + c] = P[c];
#pragma unroll
  for (int c = 0; c < 6; ++c) sdelta[6 * j + c] = d[c];
}

// corr [N,16] (mask in column 12), src [N,4] source xyz, qnum: valid rows;
// the k1 poses in ps (R 9 | t 3). Writes this block's float32 sums at each
// pose to partials [gridDim.x, k1]; rows were loaded by the caller.
template <int ROBUST>
__device__ void block_errors(const float4 (&a)[kStepRowsPerThread],
                             const float4 (&b)[kStepRowsPerThread],
                             const float4 (&c)[kStepRowsPerThread],
                             const float4 (&p)[kStepRowsPerThread],
                             const bool (&live)[kStepRowsPerThread], const float* ps,
                             int k1, float robust_c, float (*red)[kMaxPoses],
                             float* __restrict__ partials) {
  const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < k1; k0 += kPoseChunk) {
    float acc[kPoseChunk];
#pragma unroll
    for (int j = 0; j < kPoseChunk; ++j) acc[j] = 0.f;
#pragma unroll
    for (int r = 0; r < kStepRowsPerThread; ++r) {
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
  for (int k = threadIdx.x; k < k1; k += kStepThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kStepThreads / 32; ++w) s += red[w][k];
    partials[(size_t)blockIdx.x * k1 + k] = s;
  }
}

// In the last block: serr[k] = Σ over the blocks of partials [gridDim.x, k1]
// in float64, in a fixed order: thread (k, s) sums segment s of the blocks
// (consecutive, its loads in flight together), then thread k adds pose k's
// segments in order. Called by every thread of the block.
__device__ void block_sums(const float* __restrict__ partials, int k1, double* serr) {
  __shared__ double seg[kStepThreads];
  const int segs = max(1, kStepThreads / k1);
  const int len = ((int)gridDim.x + segs - 1) / segs;
  for (int t = threadIdx.x; t < k1 * segs; t += kStepThreads) {
    const int k = t / segs, b0 = (t % segs) * len;
    const int b1 = min((int)gridDim.x, b0 + len);
    double s = 0.0;
#pragma unroll 4
    for (int blk = b0; blk < b1; ++blk) s += (double)__ldcg(partials + (size_t)blk * k1 + k);
    seg[t] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < k1; k += kStepThreads) {
    double s = 0.0;
    for (int i = 0; i < segs; ++i) s += seg[k * segs + i];
    serr[k] = s;
  }
}

// MODE kLm / kGn: sums [44] float64 from K1; poses_in unused; trials = K (GN:
// 1); k1 = K + 1 (GN: 1); rec the state record; ticket the block ticket, 0
// between launches. MODE kErrors: poses_in [k1,4,4]; errs_out [k1] float64.
template <typename S, int MODE, int ROBUST>
__global__ void __launch_bounds__(kStepThreads)
gicp_step_kernel(const double* __restrict__ sums, const float* __restrict__ corr,
                 const float* __restrict__ src, const int* __restrict__ qnum, int n,
                 const float* __restrict__ poses_in, int k1, int trials,
                 const double* __restrict__ params, float robust_c,
                 unsigned char* __restrict__ rec, float* __restrict__ partials,
                 unsigned* __restrict__ ticket, double* __restrict__ errs_out) {
  __shared__ float ps[kMaxPoses * 12];  // R row-major 9 | t 3 per pose
  __shared__ float sdelta[kMaxTrials * 6];
  __shared__ float red[kStepThreads / 32][kMaxPoses];
  __shared__ double serr[kMaxPoses];

  // This thread's rows, loaded before anything else: i0 + r·kStepThreads.
  const int nv = min(n, *qnum);
  const int i0 = blockIdx.x * kStepBlockRows + threadIdx.x;
  float4 a[kStepRowsPerThread], b[kStepRowsPerThread], c[kStepRowsPerThread],
      p[kStepRowsPerThread];
  bool live[kStepRowsPerThread];
#pragma unroll
  for (int r = 0; r < kStepRowsPerThread; ++r) {
    const int i = i0 + r * kStepThreads;
    live[r] = i < nv;
    if (live[r]) {
      const float4* c4 = reinterpret_cast<const float4*>(corr + (size_t)i * 16);
      a[r] = c4[0];
      b[r] = c4[1];
      c[r] = c4[2];
      live[r] = c4[3].x > 0.5f;  // mask = 0: rejected or padding
      p[r] = *reinterpret_cast<const float4*>(src + (size_t)i * 4);
    }
  }

  if (MODE == kErrors) {
    for (int j = threadIdx.x; j < 12 * k1; j += kStepThreads)
      ps[j] = pose12(poses_in + 16 * (j / 12), j % 12);
  } else {
    const float* Tr = reinterpret_cast<const float*>(rec + kRecT);
    if (threadIdx.x < 12) ps[threadIdx.x] = pose12(Tr, threadIdx.x);
    if (threadIdx.x < trials) solve_into<S, MODE>(sums, params, rec, threadIdx.x, ps, sdelta);
  }
  __syncthreads();

  block_errors<ROBUST>(a, b, c, p, live, ps, k1, robust_c, red, partials);

  if (!last_arrival(ticket, gridDim.x)) return;
  block_sums(partials, k1, serr);
  if (threadIdx.x == 0) *ticket = 0u;
  __syncthreads();
  if (MODE == kErrors) {
    for (int k = threadIdx.x; k < k1; k += kStepThreads) errs_out[k] = serr[k];
    return;
  }

  // The last block writes the record: errors, trials, H and b, then the
  // accept (thread 0).
  double* rerrs = reinterpret_cast<double*>(rec + kRecErrs);
  for (int k = threadIdx.x; k < k1; k += kStepThreads) rerrs[k] = serr[k];
  float* rtrials = reinterpret_cast<float*>(rec + kRecErrs + 8 * (trials + 1));
  for (int j = threadIdx.x; j < trials * kTrialRow; j += kStepThreads) {
    const int t = j / kTrialRow, col = j % kTrialRow;
    rtrials[j] = col < 6 ? sdelta[6 * t + col] : ps[12 * (1 + t) + col - 6];
  }
  float* rH = reinterpret_cast<float*>(rec + kRecH);
  float* rb = reinterpret_cast<float*>(rec + kRecB);
  for (int k = threadIdx.x; k < 42; k += kStepThreads) {
    if (k < 36) {
      const S dof = k % 7 == 0 ? (S)params[kParDof + k / 7] : (S)0;
      rH[k] = (float)add_rn((S)sums[k], dof);
    } else {
      rb[k - 36] = (float)(S)sums[k];
    }
  }
  if (threadIdx.x != 0) return;

  float* rT = reinterpret_cast<float*>(rec + kRecT);
  float* rdelta = reinterpret_cast<float*>(rec + kRecDelta);
  float* rlam = reinterpret_cast<float*>(rec + kRecLam);
  int jj = 0;
  bool accepted = true;
  double e = serr[0];
  if (MODE == kLm) {
    jj = -1;
    for (int j = 0; j < trials; ++j) {
      if (serr[1 + j] <= serr[0]) {
        jj = j;
        break;
      }
    }
    accepted = jj >= 0;
    const float factor = (float)params[kParFactor];
    if (accepted) {
      e = serr[1 + jj];
      *rlam = div_rn(mul_rn(*rlam, (float)params[kParPow + jj]), factor);
    } else {
      *rlam = mul_rn(*rlam, (float)params[kParPow + trials]);
    }
  }
  float d[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) d[k] = accepted ? sdelta[6 * jj + k] : 0.f;
  if (accepted) {
#pragma unroll
    for (int k = 0; k < 12; ++k)
      rT[k < 9 ? (k / 3) * 4 + k % 3 : (k - 9) * 4 + 3] = ps[12 * (1 + jj) + k];
  }
  const float dr = sqrt_rn(add_rn(add_rn(mul_rn(d[0], d[0]), mul_rn(d[1], d[1])), mul_rn(d[2], d[2])));
  const float dt = sqrt_rn(add_rn(add_rn(mul_rn(d[3], d[3]), mul_rn(d[4], d[4])), mul_rn(d[5], d[5])));
  const bool converged =
      accepted && dr <= (float)params[kParRot] && dt <= (float)params[kParTrans];
#pragma unroll
  for (int k = 0; k < 6; ++k) rdelta[k] = d[k];
  *reinterpret_cast<int*>(rec + kRecInliers) = (int)sums[43];
  *reinterpret_cast<double*>(rec + kRecE) = e;
  int* count = reinterpret_cast<int*>(rec + kRecCount);
  *reinterpret_cast<int*>(rec + kRecIter) = *count;
  *count += 1;
  *reinterpret_cast<int*>(rec + kRecJ) = MODE == kLm ? jj : 0;
  rec[kRecConverged] = converged;
  rec[kRecAccepted] = accepted;
  rec[kRecStop] = converged || !accepted;
}

template <typename S, int MODE, int ROBUST>
void launch(int blocks, cudaStream_t s, const double* sums, const float* corr,
            const float* src, const int* qnum, int n, const float* poses, int k1,
            int trials, const double* params, float robust_c, unsigned char* rec,
            float* partials, unsigned* ticket, double* errs) {
  gicp_step_kernel<S, MODE, ROBUST><<<blocks, kStepThreads, 0, s>>>(
      sums, corr, src, qnum, n, poses, k1, trials, params, robust_c, rec, partials,
      ticket, errs);
}

using Launch = void (*)(int, cudaStream_t, const double*, const float*, const float*,
                        const int*, int, const float*, int, int, const double*, float,
                        unsigned char*, float*, unsigned*, double*);

// [solve type float / double][LM / GN][robust]
const Launch kStep[2][2][3] = {
    {{launch<float, kLm, kNone>, launch<float, kLm, kHuber>, launch<float, kLm, kCauchy>},
     {launch<float, kGn, kNone>, launch<float, kGn, kHuber>, launch<float, kGn, kCauchy>}},
    {{launch<double, kLm, kNone>, launch<double, kLm, kHuber>,
      launch<double, kLm, kCauchy>},
     {launch<double, kGn, kNone>, launch<double, kGn, kHuber>,
      launch<double, kGn, kCauchy>}},
};
const Launch kErrorsOnly[3] = {launch<float, kErrors, kNone>,
                               launch<float, kErrors, kHuber>,
                               launch<float, kErrors, kCauchy>};

int blocks_for(int n) { return n <= 0 ? 1 : (n + kStepBlockRows - 1) / kStepBlockRows; }

}  // namespace

extern "C" {

// The constants the wrapper repeats: rows a block, the most poses, the
// record's offsets, the trial row's width and the power table's start.
int sgt_step_geometry(int* out) {
  const int v[] = {kStepBlockRows, kMaxPoses,    kRecT,       kRecH,    kRecB,
                   kRecDelta,      kRecLam,      kRecInliers, kRecE,    kRecIter,
                   kRecCount,      kRecJ,        kRecConverged, kRecAccepted,
                   kRecStop,       kRecErrs,     kTrialRow,   kParPow};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  return 0;
}

// Each launch entry returns cudaGetLastError() after its launch (0 on
// success).

// One LM (mode 1, trials = K, 0 ≤ K ≤ 99) or GN (mode 2, trials = 1) step:
// sums [44] float64 from K1, corr [n,16], src [n,4], the record and params
// as above; partials [ceil(n / kStepBlockRows), trials + 1] float scratch;
// ticket [1], zero between launches.
int sgt_gicp_step(const double* sums, const float* corr, const float* src,
                  const int* qnum, int n, int mode, int trials, int solve64,
                  const double* params, float robust_c, int robust, void* rec,
                  float* partials, unsigned* ticket, void* stream) {
  if ((mode != kLm && mode != kGn) || trials < 0 || trials > kMaxTrials ||
      (mode == kGn && trials != 1) || robust < 0 || robust > 2 || n < 0)
    return (int)cudaErrorInvalidValue;
  const int k1 = mode == kLm ? trials + 1 : 1;
  kStep[solve64 ? 1 : 0][mode == kLm ? 0 : 1][robust](
      blocks_for(n), (cudaStream_t)stream, sums, corr, src, qnum, n, nullptr, k1,
      trials, params, robust_c, (unsigned char*)rec, partials, ticket, nullptr);
  return (int)cudaGetLastError();
}

// The errors alone (gicp_error_multi): poses [k1,4,4], k1 ≤ 100; errs [k1]
// float64; partials [ceil(n / kStepBlockRows), k1]; ticket [1], zero between
// launches.
int sgt_gicp_step_errors(const float* corr, const float* src, const int* qnum, int n,
                         const float* poses, int k1, float robust_c, int robust,
                         float* partials, unsigned* ticket, double* errs, void* stream) {
  if (k1 < 1 || k1 > kMaxPoses || robust < 0 || robust > 2 || n < 0)
    return (int)cudaErrorInvalidValue;
  kErrorsOnly[robust](blocks_for(n), (cudaStream_t)stream, nullptr, corr, src, qnum, n,
                      poses, k1, 0, nullptr, robust_c, nullptr, partials, ticket, errs);
  return (int)cudaGetLastError();
}

}  // extern "C"
