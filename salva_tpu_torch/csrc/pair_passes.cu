// Dense pair passes of the DFSPH and IISPH solvers as hand-written CUDA
// kernels for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; see ops/_build.py and ops/pair.py).
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
//   hoist_fb <- pallas_pair.py hoist_fb_pallas / _build_fb_hoist_kernel,
//               as run by pallas_pair2.py hoist_fb_pallas3 (and the XLA
//               twins of solver/dense_common.py: _hoist_fb_sparse and the
//               roll fold of DenseCtx._hoist); see hoist_fb_kernel
//   k_pass_v2 <- pallas_pair2.py k_pass_pallas2 / _build_k2_kernel (the
//               slot-group-predicated formulation); see k_pass_v2_kernel
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

// Fluid-boundary hoist: per live fluid slot i, over the boundary
// particles j of its 3^dim neighbour cells within h:
//   rho = sum Volb_j W,  Gb = sum Volb_j grad,  sq = sum |grad|^2 Volb_j^2,
//   s2 = sum |grad|^2 Volb_j (when need_s2),  Sb = sum Volb_j (vb_j . grad),
//   cnt = the number of such pairs.
// Replaces pallas_pair.py hoist_fb_pallas (as hoist_fb_pallas3 runs it on
// 8-row slices of the fluid grid). The TPU needed three forms of this
// hoist: the Pallas kernel over full-grid boundary arrays, a sparse XLA
// fold over the fluid columns next to a boundary (through a top_k table),
// and a roll fold over the boundary arrays rematerialized onto the full
// grid. One kernel covers all three: the boundary grid is either the
// full grid (cell_to_col == nullptr: column = cell) or the compact
// occupied-cell table (cell_to_col = cell_to_active, whose void column
// is empty), and the fluid columns to visit are either all of them
// (cols == nullptr) or the sparse hoist's adjacency table (so a table
// that overflows drops exactly the columns the reference drops; entries
// outside [0, C) are unused). A thread walks each neighbour cell's true
// boundary count, so an empty cell costs one count load and the
// sparse/dense distinction of the TPU disappears.
//
// Outputs are zero-filled by the caller; a thread writes only its own
// live slot of a listed column. What bounds it on the H100: at the 97k
// dam-break state the output planes (8 channels x cap x C x 4 B, ~17 MB
// at cap 16 and a 32,768-cell window) are the only sizeable traffic,
// ~5 us at 3.35 TB/s; the inputs it must read (live slots next to the
// floor) add well under 1 MB, and the pair work (~6 x 10^5 candidate
// pairs) is far below the float32 rate. Like the other passes it runs
// far above that bound, latency-bound on the dependent count and
// position loads.
template <int DIM>
__global__ void hoist_fb_kernel(const float* __restrict__ P,
                                const int* __restrict__ count,
                                const int* __restrict__ cols, int n_cols,
                                const float* __restrict__ Pb,
                                const float* __restrict__ Volb,
                                const float* __restrict__ Vb,
                                const int* __restrict__ count_b,
                                const int* __restrict__ cell_to_col,
                                float* __restrict__ rho_out,
                                float* __restrict__ gb_out,
                                float* __restrict__ sq_out,
                                float* __restrict__ s2_out,
                                float* __restrict__ sb_out,
                                int* __restrict__ cnt_out, int cap, int C,
                                int cap_b, int Cb, int ny, int nz,
                                int need_s2, Cubic k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (t >= n_cols) return;
  const int c = cols ? cols[t] : t;
  if (c < 0 || c >= C) return;          // unused table entry
  if (r >= min(count[c], cap)) return;  // dead slot: stays zero
  const size_t plane = (size_t)cap * C;
  const size_t plane_b = (size_t)cap_b * Cb;
  const size_t slot = (size_t)r * C + c;
  float pi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) pi[d] = P[d * plane + slot];
  float rho = 0.0f, sq = 0.0f, s2 = 0.0f, sb = 0.0f;
  float gb[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) gb[d] = 0.0f;
  int cnt_pairs = 0;
  for (int o = 0; o < Stencil<DIM>::kOffsets; ++o) {
    const int n = c + flat_shift<DIM>(o, ny, nz);
    if (n < 0 || n >= C) continue;  // outside the grid: an empty cell
    const int b = cell_to_col ? cell_to_col[n] : n;
    if (b < 0 || b >= Cb) continue;
    const int cnt = min(count_b[b], cap_b);
    for (int j = 0; j < cnt; ++j) {
      const size_t js = (size_t)j * Cb + b;
      float dp[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) dp[d] = pi[d] - Pb[d * plane_b + js];
      float r2 = dp[0] * dp[0];
#pragma unroll
      for (int d = 1; d < DIM; ++d) r2 = r2 + dp[d] * dp[d];
      if (r2 > k.h2) continue;  // outside the support: every term is 0
      const float vj = Volb[js];
      const float dwr = cubic_dwr(r2, k);
      rho += vj * cubic_w(r2, k);
      float gsq = 0.0f, vdotg = 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float g = dp[d] * dwr;
        gb[d] += g * vj;
        gsq = gsq + g * g;
        vdotg = vdotg + Vb[d * plane_b + js] * g * vj;
      }
      sq += gsq * vj * vj;
      if (need_s2) s2 += gsq * vj;
      sb += vdotg;
      ++cnt_pairs;
    }
  }
  rho_out[slot] = rho;
#pragma unroll
  for (int d = 0; d < DIM; ++d) gb_out[d * plane + slot] = gb[d];
  sq_out[slot] = sq;
  s2_out[slot] = s2;
  sb_out[slot] = sb;
  cnt_out[slot] = cnt_pairs;
}

// K_i = sum_j (m k)_j (p_i - p_j) dW/dr / r, as k_pass_kernel, in the
// slot-group formulation of pallas_pair2.py k_pass_pallas2 (v2): slots are
// taken in groups of 8 ranks, and group g of cell c is live iff the cell
// holds more than 8 g particles. An (own group, stencil shift, j group)
// block is computed only when both groups are live; the dead slots inside
// a live group contribute exactly zero (they hold the far sentinel
// position and zero mass), so the gating is pure work elision, as on the
// TPU. The TPU predicated [8, 8, 128] blocks with pl.when; here one warp
// owns one (cell, own group): lane = 4 i + jl puts the group's 8 i-slots
// on 8 lanes each and lets 4 j-lanes split every live j group (slots
// jl and jl + 4 of it). Every branch on liveness is warp-uniform (it
// depends on counts only), so the warp never diverges on it; the 4 partial
// sums of each i-slot are combined by a fixed butterfly of shuffles (the
// same order in every run, no atomics), and j-lane 0 writes the slot.
// Dead own groups write zeros. What bounds it is what bounds k_pass (the
// file note): the work is the same pairs, now including the dead slots of
// live groups.
template <int DIM>
__global__ void k_pass_v2_kernel(const float* __restrict__ P,
                                 const float* __restrict__ M,
                                 const float* __restrict__ K,
                                 const int* __restrict__ count,
                                 float* __restrict__ out, int cap, int C,
                                 int ny, int nz, Cubic k) {
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int groups = (cap + 7) >> 3;
  if (item >= (long long)groups * C) return;  // warp-uniform
  const int g = (int)(item / C);
  const int c = (int)(item % C);
  const int r = 8 * g + (lane >> 2);  // this lane's own slot
  const int jl = lane & 3;
  const bool has_i = r < cap;
  const size_t plane = (size_t)cap * C;
  float acc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[d] = 0.0f;
  if (min(count[c], cap) > 8 * g) {  // live own group (warp-uniform)
    float pi[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      pi[d] = has_i ? P[d * plane + (size_t)r * C + c] : 0.0f;
    }
    for (int o = 0; o < Stencil<DIM>::kOffsets; ++o) {
      const int n = c + flat_shift<DIM>(o, ny, nz);
      if (n < 0 || n >= C) continue;  // outside the grid: an empty cell
      const int cnt = min(count[n], cap);
      for (int gj = 0; 8 * gj < cnt; ++gj) {  // live j groups
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 8 * gj + jl + 4 * half;
          if (!has_i || j >= cap) continue;
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
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    float v = acc[d];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    acc[d] = v;
  }
  if (jl == 0 && has_i) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) out[d * plane + (size_t)r * C + c] = acc[d];
  }
}

constexpr int kThreads = 128;

dim3 grid_for(int cap, int C) {
  return dim3((unsigned)((C + kThreads - 1) / kThreads), (unsigned)cap);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = success) so that the Python wrapper can raise on a refused launch,
// or kNotLaunched when the grid is empty and there is nothing to launch
// (the outputs are then complete as the wrapper allocated them).
static const int kNotLaunched = -1;

int salva_k_pass(const float* P, const float* M, const float* K,
                 const int* count, float* out, int dim, int cap, int C,
                 int ny, int nz, float inv_h2, float w_norm,
                 float dwr_scale, float h2, void* stream) {
  if (cap <= 0 || C <= 0) return kNotLaunched;
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
  if (cap <= 0 || C <= 0) return kNotLaunched;
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
  if (cap <= 0 || C <= 0) return kNotLaunched;
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

int salva_k_pass_v2(const float* P, const float* M, const float* K,
                    const int* count, float* out, int dim, int cap, int C,
                    int ny, int nz, float inv_h2, float w_norm,
                    float dwr_scale, float h2, void* stream) {
  if (cap <= 0 || C <= 0) return kNotLaunched;
  const Cubic k{inv_h2, w_norm, dwr_scale, h2};
  cudaStream_t s = (cudaStream_t)stream;
  const long long warps = (long long)((cap + 7) / 8) * C;
  const int per_block = kThreads / 32;
  const dim3 grid((unsigned)((warps + per_block - 1) / per_block));
  if (dim == 3) {
    k_pass_v2_kernel<3><<<grid, kThreads, 0, s>>>(P, M, K, count, out, cap,
                                                   C, ny, nz, k);
  } else if (dim == 2) {
    k_pass_v2_kernel<2><<<grid, kThreads, 0, s>>>(P, M, K, count, out, cap,
                                                   C, ny, nz, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// `cols` may be null (visit all C columns; n_cols = C) and `cell_to_col`
// may be null (the boundary grid is the full grid, Cb = C). The outputs
// must be zero-filled: only listed live slots are written.
int salva_hoist_fb(const float* P, const int* count, const int* cols,
                   int n_cols, const float* Pb, const float* Volb,
                   const float* Vb, const int* count_b,
                   const int* cell_to_col, float* rho, float* gb, float* sq,
                   float* s2, float* sb, int* cnt, int dim, int cap, int C,
                   int cap_b, int Cb, int ny, int nz, int need_s2,
                   float inv_h2, float w_norm, float dwr_scale, float h2,
                   void* stream) {
  if (cap <= 0 || C <= 0 || n_cols <= 0 || cap_b <= 0 || Cb <= 0) {
    return kNotLaunched;
  }
  const Cubic k{inv_h2, w_norm, dwr_scale, h2};
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) {
    hoist_fb_kernel<3><<<grid_for(cap, n_cols), kThreads, 0, s>>>(
        P, count, cols, n_cols, Pb, Volb, Vb, count_b, cell_to_col, rho, gb,
        sq, s2, sb, cnt, cap, C, cap_b, Cb, ny, nz, need_s2, k);
  } else if (dim == 2) {
    hoist_fb_kernel<2><<<grid_for(cap, n_cols), kThreads, 0, s>>>(
        P, count, cols, n_cols, Pb, Volb, Vb, count_b, cell_to_col, rho, gb,
        sq, s2, sb, cnt, cap, C, cap_b, Cb, ny, nz, need_s2, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
