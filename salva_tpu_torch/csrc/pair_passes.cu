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
//               _pallas_hi.py hi_complement); tile_pass_kernel<KPass>
//   t_pass   <- pallas_pair.py t_pass_pallas / _build_t_kernel, via
//               t_pass_pallas3 (+ hi_complement); tile_pass_kernel<TPass>
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
// (8, 128) tiles. Here every kernel walks the true occupancy of each
// neighbour cell (count[n]), so the slot-group split and its gating flags
// disappear: a dead slot (r >= count[c]) writes zeros and does no pair
// work.
//
// The hoists (one thread per output slot). What bounds them on the H100:
// not HBM bandwidth. Each live slot visits 3^dim neighbour cells and every
// particle in them (~27 x 8 pairs in a resting 3D fluid); the neighbour
// positions are gathered through L1/L2 with a dependent count[n] load
// before each cell, so the latency of those gathers and the
// special-function throughput of sqrtf / rsqrtf per pair (SFU: 1/8 of the
// FP32 rate) set the time. The design keeps loads coalesced (c on
// threadIdx.x: neighbouring lanes read neighbouring cells of the same
// row), keeps the accumulators in registers, and writes each output once.
//
// k_pass and t_pass (tile_pass_kernel), the passes every solver iteration
// runs. What bounds them is the same pair work, and three costs of the
// thread-per-slot design: (1) a (cap, C) grid of threads for ~1/5 live
// slots, whose lanes loop over different counts; (2) every candidate
// pair's neighbour data fetched again from L1/L2 by each of up to 27 x 8
// consumer slots, behind a dependent count load; (3) the full spline
// (one sqrtf, one rsqrtf, both branches) for every candidate pair,
// although only ~15% of them lie within h. The design:
//  - Tiles: a block owns `tile` consecutive cells of the flat index. With
//    the cell axis z innermost, their 3^dim neighbour cells are 3^(dim-1)
//    runs of tile + 2 consecutive cells (one per stencil row, Rows::shift
//    plus -1 .. tile): whatever the tile's place in the grid, a run is
//    exactly the cells flat_shift gives, cells outside [0, C) empty. A
//    stencil that crosses the end of a z row therefore reads what the
//    thread-per-slot kernels and the plain versions read; with the ghost
//    ring of dense_grid (a one-cell empty layer at every face) no live
//    cell's stencil crosses one, so nothing checks for it.
//  - Shared memory: the block stages the live slots of those runs once
//    (k_pass: (p_j, (m k)_j) as one float4, premultiplied; t_pass:
//    (p_j, m_j) and Q_j), so each neighbour cell's data crosses L2 once
//    per tile instead of once per consumer slot. Each row is packed cell
//    after cell (offsets from a scan of the counts), so a cell's three
//    neighbours in a row are one run of slots. A tile of only air cells
//    stages nothing and writes its zeros. A thread issues the loads of
//    kBatch slots before it stores the first, so staging waits about one
//    global latency per kBatch slots a thread; several blocks are resident
//    on an SM, so one block's staging also overlaps another's pair work.
//    A TMA box would need a row stride that is a multiple of 16 bytes,
//    which C * 4 is not in general.
//  - Every row at once, not a ring: a ring of three row buffers filled by
//    4-byte cp.async copies two rows ahead of the warps, rows taken in
//    turn, was built and was slower on an H100 (PERF.md): a lane's queue
//    then ends at every row, so the warp runs the spline for its busiest
//    lane of each (item, row) instead of each item; a block waits at a
//    barrier per row; and a warp holds all its items' sums at once.
//  - Lanes on live work: a warp per live (cell, 8-slot group) item of the
//    tile, lane = 4 il + jl as in k_pass_v2_kernel: i-slot 8 g + il, and
//    j-lane jl takes entries jl, jl + 4, ... of each row's run. Every
//    branch on liveness and counts is warp-uniform (counts come from
//    shared memory); the 4 partial sums of an i-slot meet in a fixed
//    butterfly of shuffles.
//  - The spline only within h: a lane first runs over its candidate pairs
//    computing r^2 only, and queues (in shared memory) those with
//    q2 = r^2 * inv_h2 <= 1, q2 exactly as cubic_dwr computes it; it
//    then adds the queued pairs in the order it found them, all lanes of
//    the warp together, so the warp runs the spline about once per pair
//    within h instead of once per candidate. The skip is exact: for
//    q2 > 1, sqrtf (correctly rounded, monotone) gives q >= 1, so
//    cubic_dwr returns +-0 (the cut branch, or the far branch with
//    1 - q = 0), the pair term is +-0, and adding +-0 leaves a sum that
//    started at +0 bitwise unchanged (a float sum is -0 only when both
//    addends are -0). The skipped loop therefore returns bitwise the
//    unskipped loop's sums; on an H100 both passes of the skipped and the
//    unskipped loop were bitwise equal at the 97k dam break's state.
//  - Every output slot of a tile is written once, from a shared-memory
//    tile, in runs of consecutive cells; dead slots get zeros.
// What bounds them as built, at the 97k dam break: not HBM. Most of each
// pass is the pair loops (every candidate still costs a shared load and
// its distance, a chain of dependent instructions), the rest each block's
// counts, staging and writes, whose latency the 2-4 blocks resident on an
// SM hide only in part (PERF.md).
//
// Determinism: each output slot is summed by its own thread (hoists) or
// its own four lanes (k_pass, t_pass, k_pass_v2) in a fixed order
// (stencil offsets or rows, then rank); there are no atomics, so results
// are bitwise identical from run to run.
//
// Pair math: the fused cubic spline of salva_tpu (dense_common.w_dwr,
// pallas_pair._grad_scale_fn / _w_scale_fn): W and dW/dr / r from r^2
// with one sqrtf and one rsqrtf.

#include <cuda_runtime.h>

#include <stddef.h>

#include <algorithm>

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

// K_i = sum_j (m k)_j (p_i - p_j) dW/dr / r, as salva_k_pass, in the
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
// Dead own groups write zeros. What bounds it is what bounds the hoists
// (the file note): the same pairs, read through L1/L2 behind dependent
// count loads, the full spline for every candidate, and the dead slots of
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

// ---- k_pass and t_pass: tiles of cells, neighbour rows in shared memory --
// (design and bound: the file note)

// Entries of each lane's queue of within-h pairs: at least kQueue, and at
// least what one stencil row can add (queue_len).
constexpr int kQueue = 16;
// The most dynamic shared memory a block can opt in to on Hopper.
constexpr int kMaxSmem = 232448;
// Devices whose opt-in above the default 48 KB a process remembers.
constexpr int kDevices = 64;
// Slots a thread stages at once: the loads of all of them are in flight
// before the first store.
constexpr int kBatch = 2;

__device__ __forceinline__ float word(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// What k_pass stages per neighbour slot, and adds per pair: one float4
// (p_j, (m k)_j), (m k)_j = M[js] * K[js] premultiplied as the pair term
// takes it. A block: 8 warps and at most 56 KB of shared memory, 4 blocks
// resident on an H100 SM (228 KB, 1 KB of it reserved per block); the
// fastest of the sizes measured at the 97k dam break (PERF.md).
template <int DIM>
struct KPass {
  static constexpr int kWords = 1;  // float4 words of a staged slot
  static constexpr int kOut = DIM;  // output channels
  static constexpr int kThreads = 256;
  static constexpr int kSmemBudget = 56 * 1024;
  static constexpr int kRaw = DIM + 2;  // words read per slot: p_j, m_j, k_j
  __device__ static void fetch(float (&v)[kRaw], const float* P,
                               const float* M, const float* X, size_t plane,
                               size_t js) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) v[d] = P[d * plane + js];
    v[DIM] = M[js];
    v[DIM + 1] = X[js];
  }
  __device__ static void pack(float4* s, const float (&v)[kRaw]) {
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < DIM; ++d) w[d] = v[d];
    w[DIM] = v[DIM] * v[DIM + 1];
    s[0] = make_float4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void add(float (&acc)[kOut], const float (&dp)[DIM],
                             float r2, const float4* s, const Cubic& k) {
    const float coeff = word(s[0], DIM) * cubic_dwr(r2, k);
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc[d] += dp[d] * coeff;
  }
};

// t_pass: (p_j, m_j) and Q_j, two float4 words. Its slots are twice
// k_pass's, so a block takes 16 warps and up to 100 KB (2 per SM) to reach
// tiles as long.
template <int DIM>
struct TPass {
  static constexpr int kWords = 2;
  static constexpr int kOut = 1;
  static constexpr int kThreads = 512;
  static constexpr int kSmemBudget = 100 * 1024;
  static constexpr int kRaw = 2 * DIM + 1;  // p_j, m_j, Q_j
  __device__ static void fetch(float (&v)[kRaw], const float* P,
                               const float* M, const float* X, size_t plane,
                               size_t js) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      v[d] = P[d * plane + js];
      v[DIM + 1 + d] = X[d * plane + js];
    }
    v[DIM] = M[js];
  }
  __device__ static void pack(float4* s, const float (&v)[kRaw]) {
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      w[d] = v[d];
      q[d] = v[DIM + 1 + d];
    }
    w[DIM] = v[DIM];
    s[0] = make_float4(w[0], w[1], w[2], w[3]);
    s[1] = make_float4(q[0], q[1], q[2], q[3]);
  }
  __device__ static void add(float (&acc)[kOut], const float (&dp)[DIM],
                             float r2, const float4* s, const Cubic& k) {
    float t = word(s[1], 0) * dp[0];
#pragma unroll
    for (int d = 1; d < DIM; ++d) t = t + word(s[1], d) * dp[d];
    acc[0] += t * cubic_dwr(r2, k) * word(s[0], DIM);
  }
};

// Stencil rows: the 3^(dim-1) offsets (dx, dy) in 3D, dx in 2D, in the
// order of flat_shift; a row's three offsets add dz (3D) or dy (2D) in
// {-1, 0, 1} to its flat shift.
template <int DIM>
struct Rows {
  static constexpr int kRows = Stencil<DIM>::kOffsets / 3;
  static constexpr int kOwn = kRows / 2;  // the row of the cell itself
  __device__ static int shift(int row, int ny, int nz) {
    if (DIM == 3) return ((row / 3 - 1) * ny + (row % 3 - 1)) * nz;
    return (row - 1) * ny;
  }
};

// Queue entries a lane needs: one stencil row (three cells) adds at most
// ceil(3 cap / 4) pairs to it.
__host__ __device__ inline int queue_len(int cap) {
  return (3 * cap + 3) / 4 > kQueue ? (3 * cap + 3) / 4 : kQueue;
}

// Bytes of shared memory a block of `tile` cells takes, in the order
// tile_pass_kernel lays them out: the staged slots, the output tile, the
// lanes' queues, the staged cells' counts and offsets, each row's largest
// count, the item list (then its length).
template <int DIM, class Pass>
size_t tile_bytes(int tile, int cap) {
  const size_t rows = Rows<DIM>::kRows, width = tile + 2;
  const int items = tile * ((cap + 7) / 8);
  return rows * width * cap * Pass::kWords * sizeof(float4) +
         (size_t)Pass::kOut * cap * tile * sizeof(float) +
         (size_t)Pass::kThreads * queue_len(cap) * sizeof(unsigned short) +
         (rows * width + rows * (width + 1) + rows) * sizeof(int) +
         (size_t)(std::max(32, items) + 1) * sizeof(int);
}

struct TileShape {
  int tile;    // consecutive cells a block owns
  int smem;    // bytes of dynamic shared memory a block takes
  int blocks;  // blocks launched
};

// The tile: the most cells, up to 32 (cell, 8-slot group) items (longer
// tiles measured slower, PERF.md), whose block fits the pass's
// kSmemBudget bytes.
template <int DIM, class Pass>
TileShape tile_shape(int cap, int C) {
  int tile = std::max(1, 32 / ((cap + 7) / 8));
  while (tile > 1 && tile_bytes<DIM, Pass>(tile, cap) > Pass::kSmemBudget) {
    --tile;
  }
  const size_t bytes = tile_bytes<DIM, Pass>(tile, cap);
  return {tile, bytes > (size_t)kMaxSmem ? -1 : (int)bytes,
          (C + tile - 1) / tile};
}

// k_pass (Pass = KPass) and t_pass (TPass) over tiles of `tile`
// consecutive cells; see the file note. Every output slot of the block's
// cells is written (zero for dead slots and air cells).
template <int DIM, class Pass>
__global__ void __launch_bounds__(Pass::kThreads)
    tile_pass_kernel(const float* __restrict__ P, const float* __restrict__ M,
                     const float* __restrict__ X,
                     const int* __restrict__ count, float* __restrict__ out,
                     int cap, int C, int ny, int nz, int tile, Cubic k) {
  using R = Rows<DIM>;
  constexpr int kW = Pass::kWords;
  constexpr int kWarps = Pass::kThreads / 32;
  extern __shared__ float4 smem[];
  const int width = tile + 2;          // staged cells of a row
  const int row_slots = width * cap;   // slots a staged row holds
  const int n_staged = R::kRows * width;
  const int n_out = Pass::kOut * cap * tile;  // output tile entries
  const int n_items_max = tile * ((cap + 7) >> 3);
  const int list = max(32, n_items_max);
  const int qlen = queue_len(cap);
  float4* slots = smem;  // [kRows][row_slots][kW], each row packed
  float* out_t = reinterpret_cast<float*>(slots + (size_t)n_staged * cap * kW);
  unsigned short* queues =  // [kWarps][qlen][32]
      reinterpret_cast<unsigned short*>(out_t + n_out);
  int* cnt = reinterpret_cast<int*>(queues + Pass::kThreads * qlen);
  int* off = cnt + n_staged;                  // [kRows][width + 1]
  int* most = off + R::kRows * (width + 1);   // [kRows]
  int* items = most + R::kRows;               // [list], n_items
  const int c0 = blockIdx.x * tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = (size_t)cap * C;

  // Staged cell m of row `row` is flat cell c0 + shift(row) - 1 + m;
  // cells outside the grid are empty, as in flat_shift's kernels.
  bool own_live = false;
  for (int e = threadIdx.x; e < n_staged; e += Pass::kThreads) {
    const int row = e / width, m = e - row * width;
    const int n = c0 + R::shift(row, ny, nz) - 1 + m;
    cnt[e] = (n >= 0 && n < C) ? min(count[n], cap) : 0;
    own_live |= row == R::kOwn && m >= 1 && m <= tile && cnt[e] > 0;
  }
  if (!__syncthreads_or(own_live)) {  // block-uniform: an all-air tile
    for (int line = warp; line < Pass::kOut * cap; line += kWarps) {
      for (int lc = lane; lc < tile && c0 + lc < C; lc += 32) {
        out[(size_t)line * C + c0 + lc] = 0.0f;
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < n_out; e += Pass::kThreads) out_t[e] = 0.0f;
  // Each row's slots are packed cell after cell: off[row][m] = the slots
  // of staged cells 0 .. m-1, and most[row] = its largest count (a warp's
  // scan per row).
  for (int row = warp; row < R::kRows; row += kWarps) {
    int* o = off + row * (width + 1);
    int carry = 0, mx = 0;
    for (int m0 = 0; m0 < width; m0 += 32) {
      const int m = m0 + lane;
      const int c = m < width ? cnt[row * width + m] : 0;
      int incl = c;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, s);
        if (lane >= s) incl += y;
      }
      if (m < width) o[m + 1] = carry + incl;
      carry += __shfl_sync(0xffffffffu, incl, 31);
      mx = max(mx, c);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    }
    if (lane == 0) {
      o[0] = 0;
      most[row] = mx;
    }
  }
  // The live items: (cell lc, group g) with more than 8 g particles, in
  // order (item = g * tile + lc). The last warp lists them: it scans the
  // fewest rows.
  if (warp == kWarps - 1) {
    int found = 0;
    for (int b0 = 0; b0 < n_items_max; b0 += 32) {
      const int it = b0 + lane;
      bool live = false;
      if (it < n_items_max) {
        const int g = it / tile;
        live = cnt[R::kOwn * width + it - g * tile + 1] > 8 * g;
      }
      const unsigned b = __ballot_sync(0xffffffffu, live);
      if (live) items[found + __popc(b & ((1u << lane) - 1u))] = it;
      found += __popc(b);
    }
    if (lane == 0) items[list] = found;
  }
  __syncthreads();
  const int n_items = items[list];
  // Stage the live slots of every staged cell, ranks above the row's
  // largest count left out. Element x of row `row` is (rank x / width,
  // staged cell x % width): consecutive threads read consecutive cells of
  // one rank plane, and a thread takes elements threadIdx.x, + kThreads,
  // ... through the rows in order, issuing the loads of kBatch of them
  // before it stores the first (one global latency per batch, not per
  // slot).
  int row = 0, x = threadIdx.x;
  auto settle = [&]() {  // carry x into the row that holds it
    while (row < R::kRows && x >= most[row] * width) {
      x -= most[row] * width;
      ++row;
    }
  };
  settle();
  while (row < R::kRows) {
    float raw[kBatch][Pass::kRaw];
    int dst[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      dst[b] = -1;
      if (row < R::kRows) {
        const int rank = x / width, m = x - rank * width;
        if (rank < cnt[row * width + m]) {
          dst[b] = row * row_slots + off[row * (width + 1) + m] + rank;
          Pass::fetch(raw[b], P, M, X, plane,
                      (size_t)rank * C + c0 + R::shift(row, ny, nz) - 1 + m);
        }
        x += Pass::kThreads;
        settle();
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (dst[b] >= 0) Pass::pack(slots + (size_t)dst[b] * kW, raw[b]);
    }
  }
  __syncthreads();
  // A warp per live item: lane = 4 il + jl, i-slot r = 8 g + il; in each
  // stencil row, cell lc's three neighbours are staged cells lc .. lc + 2,
  // one packed run of slots, and j-lane jl takes its entries jl, jl + 4, ...
  const int il = lane >> 2, jl = lane & 3;
  unsigned short* q = queues + warp * qlen * 32 + lane;
  for (int w = warp; w < n_items; w += kWarps) {
    const int item = items[w];
    const int g = item / tile, lc = item - g * tile;
    const int r = 8 * g + il;
    const bool live_i = r < cnt[R::kOwn * width + lc + 1];
    float pi[DIM];
    {
      const int own = R::kOwn * row_slots +
                      off[R::kOwn * (width + 1) + lc + 1] + r;
      const float4 a = live_i ? slots[(size_t)own * kW]
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int d = 0; d < DIM; ++d) pi[d] = word(a, d);
    }
    float acc[Pass::kOut];
#pragma unroll
    for (int d = 0; d < Pass::kOut; ++d) acc[d] = 0.0f;
    int len = 0;
    // r^2 of the pair (i, staged slot idx), and p_i - p_j.
    auto dist2 = [&](int idx, float (&dp)[DIM]) {
      const float4 a = slots[(size_t)idx * kW];
#pragma unroll
      for (int d = 0; d < DIM; ++d) dp[d] = pi[d] - word(a, d);
      float r2 = dp[0] * dp[0];
#pragma unroll
      for (int d = 1; d < DIM; ++d) r2 = r2 + dp[d] * dp[d];
      return r2;
    };
    // Queue the pair if q2, exactly as cubic_dwr computes it, is at most 1:
    // beyond, the pair term is +-0 (file note), so skipping the pair
    // changes no sum.
    auto queue = [&](int idx, float r2) {
      if (r2 * k.inv_h2 <= 1.0f) q[len++ * 32] = (unsigned short)idx;
    };
    // Add the queued pairs, in the order they were found, two at a time
    // (their splines overlap; the sums take them in order).
    auto flush = [&]() {
      int e = 0;
      for (; e + 1 < len; e += 2) {
        const int i0 = q[e * 32], i1 = q[(e + 1) * 32];
        float dp0[DIM], dp1[DIM];
        const float r20 = dist2(i0, dp0), r21 = dist2(i1, dp1);
        Pass::add(acc, dp0, r20, slots + (size_t)i0 * kW, k);
        Pass::add(acc, dp1, r21, slots + (size_t)i1 * kW, k);
      }
      if (e < len) {
        const int i0 = q[e * 32];
        float dp0[DIM];
        const float r20 = dist2(i0, dp0);
        Pass::add(acc, dp0, r20, slots + (size_t)i0 * kW, k);
      }
      len = 0;
    };
    for (int row = 0; row < R::kRows; ++row) {
      const int* o = off + row * (width + 1) + lc;
      const int begin = row * row_slots + o[0];
      const int n_run = o[3] - o[0];  // warp-uniform
      // A lane queues at most ceil(n_run / 4) <= qlen pairs of this row.
      if (__any_sync(0xffffffffu, len + ((n_run + 3) >> 2) > qlen)) flush();
      const int end = begin + (live_i ? n_run : 0);
      int idx = begin + jl;
      for (; idx + 4 < end; idx += 8) {
        // Both distances before either queue store (the compiler cannot
        // tell the queue from the staged slots), so the loads overlap.
        float dp[DIM];
        const float r2a = dist2(idx, dp), r2b = dist2(idx + 4, dp);
        queue(idx, r2a);
        queue(idx + 4, r2b);
      }
      if (idx < end) {
        float dp[DIM];
        queue(idx, dist2(idx, dp));
      }
    }
    flush();
    // The 4 j-lane partial sums of each i-slot, in a fixed order.
#pragma unroll
    for (int d = 0; d < Pass::kOut; ++d) {
      float v = acc[d];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      acc[d] = v;
    }
    if (jl == 0 && live_i) {
#pragma unroll
      for (int d = 0; d < Pass::kOut; ++d) {
        out_t[(d * cap + r) * tile + lc] = acc[d];
      }
    }
  }
  __syncthreads();
  // Every slot of the tile's cells: a warp per (channel, rank) line of
  // `tile` consecutive cells (the output is [kOut][cap][C], so line
  // d * cap + r starts at line * C).
  for (int line = warp; line < Pass::kOut * cap; line += kWarps) {
    for (int lc = lane; lc < tile && c0 + lc < C; lc += 32) {
      out[(size_t)line * C + c0 + lc] = out_t[line * tile + lc];
    }
  }
}

// The tiling of a [cap, C] grid, with the kernel allowed the shared memory
// it takes (the opt-in above 48 KB is made once per device for the
// largest size asked so far); cudaErrorInvalidValue when no block fits
// (cap too large).
template <int DIM, class Pass>
cudaError_t tile_setup(int cap, int C, TileShape* t) {
  static int granted[kDevices] = {};
  *t = tile_shape<DIM, Pass>(cap, C);
  if (t->smem < 0) return cudaErrorInvalidValue;
  if (t->smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && t->smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(tile_pass_kernel<DIM, Pass>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             t->smem);
  if (err == cudaSuccess && dev < kDevices) granted[dev] = t->smem;
  return err;
}

template <int DIM, class Pass>
int launch_tile_pass(const float* P, const float* M, const float* X,
                     const int* count, float* out, int cap, int C, int ny,
                     int nz, const Cubic& k, cudaStream_t s) {
  TileShape t;
  const cudaError_t err = tile_setup<DIM, Pass>(cap, C, &t);
  if (err != cudaSuccess) return (int)err;
  tile_pass_kernel<DIM, Pass><<<t.blocks, Pass::kThreads, t.smem, s>>>(
      P, M, X, count, out, cap, C, ny, nz, t.tile, k);
  return (int)cudaGetLastError();
}

template <int DIM, class Pass>
int query_tile_pass(int cap, int C, int* shape) {
  TileShape t;
  cudaError_t err = tile_setup<DIM, Pass>(cap, C, &t);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_pass_kernel<DIM, Pass>, Pass::kThreads, t.smem);
  }
  shape[0] = t.tile;
  shape[1] = t.smem;
  shape[2] = t.blocks;
  shape[3] = per_sm;
  return (int)err;
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
    return launch_tile_pass<3, KPass<3>>(P, M, K, count, out, cap, C, ny, nz,
                                         k, s);
  }
  if (dim == 2) {
    return launch_tile_pass<2, KPass<2>>(P, M, K, count, out, cap, C, ny, nz,
                                         k, s);
  }
  return (int)cudaErrorInvalidValue;
}

int salva_t_pass(const float* P, const float* M, const float* Q,
                 const int* count, float* out, int dim, int cap, int C,
                 int ny, int nz, float inv_h2, float w_norm,
                 float dwr_scale, float h2, void* stream) {
  if (cap <= 0 || C <= 0) return kNotLaunched;
  const Cubic k{inv_h2, w_norm, dwr_scale, h2};
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) {
    return launch_tile_pass<3, TPass<3>>(P, M, Q, count, out, cap, C, ny, nz,
                                         k, s);
  }
  if (dim == 2) {
    return launch_tile_pass<2, TPass<2>>(P, M, Q, count, out, cap, C, ny, nz,
                                         k, s);
  }
  return (int)cudaErrorInvalidValue;
}

// How salva_k_pass (t_pass == 0) or salva_t_pass tiles a [cap, C] grid:
// shape[0..3] = cells a block owns, bytes of shared memory a block takes,
// blocks launched, blocks resident on one SM of the current device.
// Returns a CUDA error code (0 = success).
int salva_pass_tiling(int t_pass, int dim, int cap, int C, int* shape) {
  if (cap <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dim == 3) {
    return t_pass ? query_tile_pass<3, TPass<3>>(cap, C, shape)
                  : query_tile_pass<3, KPass<3>>(cap, C, shape);
  }
  if (dim == 2) {
    return t_pass ? query_tile_pass<2, TPass<2>>(cap, C, shape)
                  : query_tile_pass<2, KPass<2>>(cap, C, shape);
  }
  return (int)cudaErrorInvalidValue;
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
