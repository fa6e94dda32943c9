// Dense pair passes of the DFSPH main path as hand-written CUDA kernels
// for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes; see ops/_build.py and ops/pair.py).
//
// Layout (the dense grid of geometry/dense_grid.py): channel-major
// [D, cap, C] float32 arrays, cell axis last and contiguous; slot (r, c)
// holds cell c's rank-r particle and ranks fill from 0, so cell c holds
// exactly count[c] live slots (rows 0 .. count[c]-1).
//
// Replaces (salva_tpu/ops):
//   k_pass   <- pallas_pair.py k_pass_pallas / _build_k_kernel, as run by
//               pallas_pair2.py k_pass_pallas3 (v1 lo slice + the
//               _pallas_hi.py hi_complement)
//   t_pass   <- pallas_pair.py t_pass_pallas / _build_t_kernel, via
//               t_pass_pallas3 (+ hi_complement)
//   hoist_ff <- pallas_pair.py hoist_ff_pallas / _build_hoist_kernel, via
//               hoist_ff_pallas3 (+ hi_complement)
// The TPU kernels split each pass into an ungated 8-row slice plus a
// gated complement over 8-row slot groups, because the TPU computes in
// (8, 128) tiles. Here one thread owns one output slot and walks the
// true occupancy of each neighbour cell (count[n]), so the slot-group
// split, its gating flags and the air-tile skip all disappear: a dead
// slot (r >= count[c]) writes zeros and does no pair work.
//
// What bounds these kernels on the H100: not HBM bandwidth. Each live
// slot visits 3^dim neighbour cells and every particle in them
// (~27 x 8 pairs in a resting 3D fluid); the neighbour positions are
// gathered through L1/L2 with a dependent count[n] load before each cell,
// so the latency of those gathers and the special-function throughput
// of sqrtf / rsqrtf per pair (SFU: 1/8 of the FP32 rate) set the time.
// The design keeps loads coalesced (c on threadIdx.x: neighbouring lanes
// read neighbouring cells of the same row), keeps the accumulators in
// registers, and writes each output once. Staging the neighbour window
// in shared memory and warp-per-cell scheduling are later work.
//
// Determinism: each thread accumulates only its own slot, in a fixed
// order (stencil offsets, then rank); there are no atomics, so results
// are bitwise identical from run to run.
//
// Pair math: the fused cubic spline of salva_tpu (dense_common.w_dwr,
// pallas_pair._grad_scale_fn / _w_scale_fn): W and dW/dr / r from r^2
// with one sqrtf and one rsqrtf.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

struct Cubic {
  float inv_h2;     // 1 / h^2
  float w_norm;     // cubic normalizer (8 / (pi h^3) in 3D)
  float dwr_scale;  // w_norm / h^2
  float h2;         // h^2: pair-count radius
};

__device__ __forceinline__ float cubic_dwr(float r2, const Cubic& k) {
  const float q2 = r2 * k.inv_h2;
  const float q = sqrtf(q2);
  const float one_q = 1.0f - q;
  const float rq = rsqrtf(fmaxf(q2, 1.0e-12f));
  const float far_d = -6.0f * one_q * one_q * rq;
  const float near_d = 18.0f * q - 12.0f;
  const bool cut = (q > 1.0f) || (q <= 1.0e-5f);
  return k.dwr_scale * (cut ? 0.0f : (q <= 0.5f ? near_d : far_d));
}

__device__ __forceinline__ float cubic_w(float r2, const Cubic& k) {
  const float q2 = r2 * k.inv_h2;
  const float q = sqrtf(q2);
  const float near_w = 1.0f + (q2 * q - q2) * 6.0f;
  const float one_q = 1.0f - q;
  const float far_w = one_q * one_q * one_q * 2.0f;
  return k.w_norm * (q <= 0.5f ? near_w : (q <= 1.0f ? far_w : 0.0f));
}

// Flat-index delta of stencil offset o (row-major, dx outermost), the
// order of dense_grid.neighbor_offsets.
template <int DIM>
__device__ __forceinline__ int flat_shift(int o, int ny, int nz) {
  if (DIM == 3) {
    const int dx = o / 9 - 1, dy = (o / 3) % 3 - 1, dz = o % 3 - 1;
    return (dx * ny + dy) * nz + dz;
  }
  const int dx = o / 3 - 1, dy = o % 3 - 1;
  return dx * ny + dy;
}

template <int DIM>
struct Stencil {
  static constexpr int kOffsets = DIM == 3 ? 27 : 9;
};

// K_i = sum_j (m k)_j (p_i - p_j) dW/dr / r over the 3^dim stencil.
// Replaces salva_tpu/ops/pallas_pair.py k_pass_pallas (+ the hi
// complement of pallas_pair2.k_pass_pallas3); bound and design: see the
// file note.
template <int DIM>
__global__ void k_pass_kernel(const float* __restrict__ P,
                              const float* __restrict__ M,
                              const float* __restrict__ K,
                              const int* __restrict__ count,
                              float* __restrict__ out, int cap, int C,
                              int ny, int nz, Cubic k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const size_t plane = (size_t)cap * C;
  const size_t slot = (size_t)r * C + c;
  float acc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[d] = 0.0f;
  if (r < min(count[c], cap)) {
    float pi[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) pi[d] = P[d * plane + slot];
    for (int o = 0; o < Stencil<DIM>::kOffsets; ++o) {
      const int n = c + flat_shift<DIM>(o, ny, nz);
      if (n < 0 || n >= C) continue;  // outside the grid: an empty cell
      const int cnt = min(count[n], cap);
      for (int j = 0; j < cnt; ++j) {
        const size_t js = (size_t)j * C + n;
        float dp[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) dp[d] = pi[d] - P[d * plane + js];
        float r2 = dp[0] * dp[0];
#pragma unroll
        for (int d = 1; d < DIM; ++d) r2 = r2 + dp[d] * dp[d];
        const float coeff = (M[js] * K[js]) * cubic_dwr(r2, k);
#pragma unroll
        for (int d = 0; d < DIM; ++d) acc[d] += dp[d] * coeff;
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) out[d * plane + slot] = acc[d];
}

// T_i = sum_j m_j (Q_j . (p_i - p_j)) dW/dr / r over the 3^dim stencil.
// Replaces pallas_pair.py t_pass_pallas (+ the hi complement of
// t_pass_pallas3); bound and design: see the file note.
template <int DIM>
__global__ void t_pass_kernel(const float* __restrict__ P,
                              const float* __restrict__ M,
                              const float* __restrict__ Q,
                              const int* __restrict__ count,
                              float* __restrict__ out, int cap, int C,
                              int ny, int nz, Cubic k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const size_t plane = (size_t)cap * C;
  const size_t slot = (size_t)r * C + c;
  float acc = 0.0f;
  if (r < min(count[c], cap)) {
    float pi[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) pi[d] = P[d * plane + slot];
    for (int o = 0; o < Stencil<DIM>::kOffsets; ++o) {
      const int n = c + flat_shift<DIM>(o, ny, nz);
      if (n < 0 || n >= C) continue;
      const int cnt = min(count[n], cap);
      for (int j = 0; j < cnt; ++j) {
        const size_t js = (size_t)j * C + n;
        float dp[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) dp[d] = pi[d] - P[d * plane + js];
        float r2 = dp[0] * dp[0];
        float t = Q[js] * dp[0];
#pragma unroll
        for (int d = 1; d < DIM; ++d) {
          r2 = r2 + dp[d] * dp[d];
          t = t + Q[d * plane + js] * dp[d];
        }
        acc += t * cubic_dwr(r2, k) * M[js];
      }
    }
  }
  out[slot] = acc;
}

// Fluid-fluid hoist: rho = sum m_j W, Gf = sum m_j grad, sq = sum
// |m_j grad|^2, s2 = sum m_j |grad|^2 (when need_s2), and the pair count
// (r^2 <= h^2 and m_j != 0). Replaces pallas_pair.py hoist_ff_pallas (+
// the hi complement of hoist_ff_pallas3); bound and design: see the file
// note.
template <int DIM>
__global__ void hoist_ff_kernel(const float* __restrict__ P,
                                const float* __restrict__ M,
                                const int* __restrict__ count,
                                float* __restrict__ rho_out,
                                float* __restrict__ gf_out,
                                float* __restrict__ sq_out,
                                float* __restrict__ s2_out,
                                int* __restrict__ cnt_out, int cap, int C,
                                int ny, int nz, int need_s2, Cubic k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const size_t plane = (size_t)cap * C;
  const size_t slot = (size_t)r * C + c;
  float rho = 0.0f, sq = 0.0f, s2 = 0.0f;
  float gf[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) gf[d] = 0.0f;
  int cnt_pairs = 0;
  if (r < min(count[c], cap)) {
    float pi[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) pi[d] = P[d * plane + slot];
    for (int o = 0; o < Stencil<DIM>::kOffsets; ++o) {
      const int n = c + flat_shift<DIM>(o, ny, nz);
      if (n < 0 || n >= C) continue;
      const int cnt = min(count[n], cap);
      for (int j = 0; j < cnt; ++j) {
        const size_t js = (size_t)j * C + n;
        float dp[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) dp[d] = pi[d] - P[d * plane + js];
        float r2 = dp[0] * dp[0];
#pragma unroll
        for (int d = 1; d < DIM; ++d) r2 = r2 + dp[d] * dp[d];
        const float mj = M[js];
        const float dwr = cubic_dwr(r2, k);
        rho += mj * cubic_w(r2, k);
        float gsq = 0.0f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const float g = dp[d] * dwr;
          gf[d] += g * mj;
          gsq = gsq + g * g;
        }
        sq += gsq * mj * mj;
        if (need_s2) s2 += gsq * mj;
        cnt_pairs += (r2 <= k.h2 && mj != 0.0f) ? 1 : 0;
      }
    }
  }
  rho_out[slot] = rho;
#pragma unroll
  for (int d = 0; d < DIM; ++d) gf_out[d * plane + slot] = gf[d];
  sq_out[slot] = sq;
  s2_out[slot] = s2;
  cnt_out[slot] = cnt_pairs;
}

constexpr int kThreads = 128;

dim3 grid_for(int cap, int C) {
  return dim3((unsigned)((C + kThreads - 1) / kThreads), (unsigned)cap);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = success) so that the Python wrapper can raise on a refused launch.

int salva_k_pass(const float* P, const float* M, const float* K,
                 const int* count, float* out, int dim, int cap, int C,
                 int ny, int nz, float inv_h2, float w_norm,
                 float dwr_scale, float h2, void* stream) {
  if (cap <= 0 || C <= 0) return (int)cudaSuccess;
  const Cubic k{inv_h2, w_norm, dwr_scale, h2};
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) {
    k_pass_kernel<3><<<grid_for(cap, C), kThreads, 0, s>>>(
        P, M, K, count, out, cap, C, ny, nz, k);
  } else if (dim == 2) {
    k_pass_kernel<2><<<grid_for(cap, C), kThreads, 0, s>>>(
        P, M, K, count, out, cap, C, ny, nz, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int salva_t_pass(const float* P, const float* M, const float* Q,
                 const int* count, float* out, int dim, int cap, int C,
                 int ny, int nz, float inv_h2, float w_norm,
                 float dwr_scale, float h2, void* stream) {
  if (cap <= 0 || C <= 0) return (int)cudaSuccess;
  const Cubic k{inv_h2, w_norm, dwr_scale, h2};
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) {
    t_pass_kernel<3><<<grid_for(cap, C), kThreads, 0, s>>>(
        P, M, Q, count, out, cap, C, ny, nz, k);
  } else if (dim == 2) {
    t_pass_kernel<2><<<grid_for(cap, C), kThreads, 0, s>>>(
        P, M, Q, count, out, cap, C, ny, nz, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int salva_hoist_ff(const float* P, const float* M, const int* count,
                   float* rho, float* gf, float* sq, float* s2, int* cnt,
                   int dim, int cap, int C, int ny, int nz, int need_s2,
                   float inv_h2, float w_norm, float dwr_scale, float h2,
                   void* stream) {
  if (cap <= 0 || C <= 0) return (int)cudaSuccess;
  const Cubic k{inv_h2, w_norm, dwr_scale, h2};
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) {
    hoist_ff_kernel<3><<<grid_for(cap, C), kThreads, 0, s>>>(
        P, M, count, rho, gf, sq, s2, cnt, cap, C, ny, nz, need_s2, k);
  } else if (dim == 2) {
    hoist_ff_kernel<2><<<grid_for(cap, C), kThreads, 0, s>>>(
        P, M, count, rho, gf, sq, s2, cnt, cap, C, ny, nz, need_s2, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
