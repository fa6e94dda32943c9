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
//               hoist_ff_pallas3 (+ hi_complement); tile_pass_kernel<HoistFF>
//   hoist_fb <- pallas_pair.py hoist_fb_pallas / _build_fb_hoist_kernel,
//               as run by pallas_pair2.py hoist_fb_pallas3 (and the XLA
//               twins of solver/dense_common.py: _hoist_fb_sparse and the
//               roll fold of DenseCtx._hoist); see hoist_fb_warps
//   k_pass_v2 <- pallas_pair2.py k_pass_pallas2 / _build_k2_kernel (the
//               slot-group-predicated formulation); the k_pass body, see
//               salva_k_pass_v2
// and, replacing no TPU kernel (the JAX package runs it as plain jnp):
//   visc_ff  <- the fluid-fluid term of the dense artificial viscosity
//               (solver/forces_dense.py); tile_pass_kernel<ViscFF>, see
//               ViscFF
// The TPU kernels split each pass into an ungated 8-row slice plus a
// gated complement over 8-row slot groups, because the TPU computes in
// (8, 128) tiles. Here every kernel walks the true occupancy of each
// neighbour cell (count[n]), so the slot-group split and its gating flags
// disappear: a dead slot (r >= count[c]) does no pair work.
//
// k_pass, t_pass and the fluid-fluid hoist (tile_pass_kernel): k_pass and
// t_pass run every solver iteration, hoist_ff once a substep. What bounds
// them on the H100 is not HBM but the pair work: each live slot visits
// 3^dim neighbour cells and every particle in them (~27 x 8 candidates in
// a resting 3D fluid). A thread-per-slot design (the first port of all
// three) pays three costs: (1) a (cap, C) grid of threads for ~1/5 live
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
//    (p_j, m_j) and Q_j; hoist_ff: (p_j, m_j), the mass as it is), so
//    each neighbour cell's data crosses L2 once per tile instead of once
//    per consumer slot. Each row is packed cell after cell (offsets from
//    a scan of the counts), so a cell's three neighbours in a row are one
//    run of slots. A tile of only air cells
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
//    tile, lane = 4 il + jl: i-slot 8 g + il, and
//    j-lane jl takes entries jl, jl + 4, ... of each row's run. Every
//    branch on liveness and counts is warp-uniform (counts come from
//    shared memory); the 4 partial sums of an i-slot meet in a fixed
//    butterfly of shuffles.
//  - The spline only within h: a lane first runs over its candidate pairs
//    computing r^2 only, and queues (in shared memory) those with
//    q2 = r^2 * inv_h2 <= 1, q2 exactly as cubic_dwr computes it (the
//    cubic's rule; the other SPH kernels queue on their own, see "Pair
//    math" below); it
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
//  - hoist_ff (Pass = HoistFF) adds, per queued pair, m_j W to rho, m_j g
//    to Gf, |g|^2 m_j^2 to sq and (when need_s2, a template flag) |g|^2
//    m_j to s2, g = (p_i - p_j) dW/dr / r, with W and dW/dr / r from one
//    sqrtf (cubic_w_dwr, of which cubic_dwr is the dW/dr / r half). The
//    skip is exact for every channel: for q2 > 1, q = sqrtf(q2) >= 1, so
//    W is w_norm * 0 (q > 1; or q == 1 and (1 - q)^3 = 0) and dW/dr / r
//    is +-0 as above; then every term (m_j W, m_j g, |g|^2 m_j^2,
//    |g|^2 m_j) is +-0, with or without fused multiply-adds, and each
//    sum stays bitwise as it was. Its pair count is not taken from the
//    queue: its rule, r^2 <= h^2 and m_j != 0, is the plain version's,
//    and the dam-break lattice holds pairs at exactly r = h, where
//    r^2 <= h^2 and r^2 * inv_h2 <= 1 can round apart. So every candidate
//    of the distance phase adds (r^2 <= h^2 && m_j != 0) to an integer
//    count, from the r^2 it has just computed and the m_j in the same
//    staged float4; the four j-lanes' counts meet in integer shuffles,
//    exact in any order. On an H100 the skipped loop was bitwise equal to
//    the unskipped one for every channel at the 97k state (PERF.md).
//  - Every output slot of a tile is written once, from a shared-memory
//    tile, in runs of consecutive cells; dead slots get zeros. hoist_ff's
//    output tile holds DIM + 3 float channels and the count (as its bits)
//    a slot; the wrapper hands one packed [DIM + 4, cap, C] allocation
//    and returns views of it.
// What bounds them as built, at the 97k dam break: not HBM. Most of each
// pass is the pair loops (every candidate still costs a shared load and
// its distance, a chain of dependent instructions), the rest each block's
// counts, staging and writes, whose latency the 2-4 blocks resident on an
// SM hide only in part (PERF.md).
//
// The fluid-boundary hoist (hoist_fb_warps), once a substep. The boundary
// is a thin layer: at the 97k dam break ~6 x 10^5 candidate pairs, a few
// thousand fluid columns next to it, while the output planes (DIM + 5
// channels x cap x C x 4 B, ~17 MB at cap 16 and 32,768 cells) are the
// only sizeable traffic (~5 us at 3.35 TB/s). What cost the first,
// thread-per-slot design was not its pair work but its call: six zero
// fills and a launch (seven launches, on a step that is host-bound), and
// in the kernel a thread per (listed column, rank) over the whole cap,
// walking the 3^dim offsets through two dependent loads each
// (cell_to_col[n], then count_b[b]) before a serial loop over the
// candidates. The design:
//  - Items: a warp owns one (listed column, 8-slot group) item, lane =
//    4 il + jl as in the tiled passes (i-slot 8 g + il; j-lane jl takes
//    boundary slots jl, jl + 4, ... of each neighbour cell). An unused
//    table entry (outside [0, C)) or a dead group exits at once
//    (warp-uniform), doing no pair work.
//  - Neighbour cells: lane o < 3^dim loads cell o's boundary column and
//    count, all lanes at once; a ballot lists the cells with boundary
//    particles, and shuffles hand each its column and count, so no
//    thread walks a chain of dependent loads per offset.
//  - Pairs: the distance phase queues, per lane in shared memory, the
//    pairs within h on the function's own rule, r^2 <= h^2 (exact here:
//    the plain version masks every term and the count on it); the
//    spline and the sums then run on the queue only. Boundary data (p,
//    volume, velocity) is read through L1: the layer is thin, and each
//    boundary slot is read by the 8 i-lanes of a warp at once.
//  - Outputs: the wrapper takes one packed [DIM + 5, cap, C] allocation
//    and zero-fills it once (one launch; the count plane is an int32
//    view), and the kernel writes the live slots of listed columns only:
//    two launches a call. The kernel cannot write the zeros of unlisted
//    columns itself: the sparse table lists columns, and knowing which
//    columns it leaves out would take an inverse map, itself a launch.
//    The fill writes the bytes the bound counts for every output anyway
//    (PERF.md has its device time beside the kernel's).
// One kernel covers the TPU's three forms of this hoist: the Pallas
// kernel over full-grid boundary arrays, a sparse XLA fold over the fluid
// columns next to a boundary (through a top_k table), and a roll fold
// over the boundary arrays rematerialized onto the full grid. The
// boundary grid is either the full grid (cell_to_col == nullptr: column
// = cell) or the compact occupied-cell table (cell_to_col =
// cell_to_active, whose void column is empty); the fluid columns to
// visit are either all of them (cols == nullptr) or the sparse hoist's
// adjacency table, so a table that overflows drops exactly the columns
// the reference drops.
//
// Determinism: each output slot is summed by its own four lanes in a
// fixed order (stencil rows or offsets, then rank); there are no
// atomics, so results are bitwise identical from run to run.
//
// Pair math: the SPH kernel of each role is a template parameter (Kern:
// cubic, poly6, spiky, viscosity; ops/pair.py passes kernel_gradient for
// dW/dr / r and kernel_density for W by name). The cubic spline is the
// fused one of salva_tpu (dense_common.w_dwr, pallas_pair._grad_scale_fn
// / _w_scale_fn): W and dW/dr / r from r^2 with one sqrtf and one rsqrtf.
// The other three are those of salva_tpu/kernels/sph.py as
// _grad_scale_fn / _w_scale_fn evaluate them: r = sqrtf(r^2), W = w(r),
// dW/dr / r = dw(r) / r as an IEEE division (no fast math:
// ops/_build.py) and 0 for r <= EPSILON; each w / dw cuts on r <= h
// itself, and the viscosity kernel guards its divisions by r and r^2
// with r > 0, as written there. Their normalizers and constants are
// folded in float64 on the host (ops/pair.py _pair_params), as the
// cubic's are. The tiled passes queue a pair for the spline on its
// kernel's own rule (Sph<K>::queue): the cubic's q2 = r^2 / h^2 <= 1, the
// others' r^2 <= queue_r2, a bound the host sets just above h^2 so that
// every pair with sqrtf(r^2) <= h is queued (on the lattice's r = h pairs
// q2 <= 1 and sqrtf(r^2) <= h round apart). A queued pair outside the
// support adds exactly +-0, as a skipped one would: each branch returns
// 0 there, so W = 0 and dW/dr / r = 0 / r = +0.

#include <cuda_runtime.h>

#include <stddef.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

namespace {

// The constants of every kernel, filled by the host in this order
// (ops/pair.py _pair_params).
struct Params {
  float inv_h2;     // 1 / h^2
  float w_norm;     // cubic normalizer (8 / (pi h^3) in 3D)
  float dwr_scale;  // w_norm / h^2
  float h2;         // h^2: pair-count radius; poly6's and viscosity's h^2
  float h;          // h: the support r <= h of the non-cubic kernels
  float queue_r2;   // every pair with sqrtf(r^2) <= h has r^2 <= queue_r2
  float poly6_n;    // poly6 normalizer
  float spiky_n;    // spiky normalizer
  float visc_n;     // Mueller viscosity normalizer
  float two_h;      // 2 h
  float two_hhh;    // 2 h^3
};
constexpr int kParams = sizeof(Params) / sizeof(float);

// salva_tpu's EPSILON (float32 machine epsilon): a pair closer than this
// has a zero gradient (kernel.rs:19-26).
constexpr float kEpsilon = 1.1920928955078125e-07f;

// W and dW/dr / r of the pair at r^2, from one sqrtf of q2.
__device__ __forceinline__ void cubic_w_dwr(float r2, const Params& k,
                                            float& w, float& dwr) {
  const float q2 = r2 * k.inv_h2;
  const float q = sqrtf(q2);
  const float one_q = 1.0f - q;
  const float rq = rsqrtf(fmaxf(q2, 1.0e-12f));
  const float far_d = -6.0f * one_q * one_q * rq;
  const float near_d = 18.0f * q - 12.0f;
  const bool cut = (q > 1.0f) || (q <= 1.0e-5f);
  dwr = k.dwr_scale * (cut ? 0.0f : (q <= 0.5f ? near_d : far_d));
  const float near_w = 1.0f + (q2 * q - q2) * 6.0f;
  const float far_w = one_q * one_q * one_q * 2.0f;
  w = k.w_norm * (q <= 0.5f ? near_w : (q <= 1.0f ? far_w : 0.0f));
}

__device__ __forceinline__ float cubic_dwr(float r2, const Params& k) {
  float w, dwr;
  cubic_w_dwr(r2, k, w, dwr);  // w is dead code here
  return dwr;
}

// The SPH kernels by id (ops/pair.py _KERNEL_IDS).
enum Kern { kCubic = 0, kPoly6 = 1, kSpiky = 2, kVisc = 3 };

template <int K>
struct Sph;

template <>
struct Sph<kCubic> {
  __device__ static float w(float r2, const Params& k) {
    float w, dwr;
    cubic_w_dwr(r2, k, w, dwr);
    return w;
  }
  __device__ static float dwr(float r2, const Params& k) {
    return cubic_dwr(r2, k);
  }
  // q2 exactly as cubic_w_dwr computes it: beyond 1 both are +-0.
  __device__ static bool queue(float r2, const Params& k) {
    return r2 * k.inv_h2 <= 1.0f;
  }
};

// dW/dr / r of the non-cubic kernel S: dw(r) / r, 0 for r <= EPSILON.
template <class S>
__device__ __forceinline__ float dw_over_r(float r2, const Params& k) {
  const float r = sqrtf(r2);
  return r > kEpsilon ? S::dw(r, k) / r : 0.0f;
}

// What the three non-cubic kernels share: dW/dr / r and the queue rule.
template <class S>
struct NonCubic {
  __device__ static float dwr(float r2, const Params& k) {
    return dw_over_r<S>(r2, k);
  }
  __device__ static bool queue(float r2, const Params& k) {
    return r2 <= k.queue_r2;
  }
};

// Poly6 (poly6_kernel.rs:12-40).
template <>
struct Sph<kPoly6> : NonCubic<Sph<kPoly6>> {
  __device__ static float w(float r2, const Params& k) {
    const float r = sqrtf(r2);
    const float a = k.h2 - r * r;
    return r <= k.h ? k.poly6_n * a * a * a : 0.0f;
  }
  __device__ static float dw(float r, const Params& k) {
    const float a = k.h2 - r * r;
    return r <= k.h ? k.poly6_n * a * a * r * -6.0f : 0.0f;
  }
};

// Spiky (spiky_kernel.rs:12-40).
template <>
struct Sph<kSpiky> : NonCubic<Sph<kSpiky>> {
  __device__ static float w(float r2, const Params& k) {
    const float r = sqrtf(r2);
    const float h_r = k.h - r;
    return r <= k.h ? k.spiky_n * h_r * h_r * h_r : 0.0f;
  }
  __device__ static float dw(float r, const Params& k) {
    const float h_r = k.h - r;
    return r <= k.h ? -k.spiky_n * h_r * h_r * 3.0f : 0.0f;
  }
};

// Mueller viscosity (viscosity_kernel.rs:12-51): zero at r = 0 and beyond
// h; its divisions by r and r^2 are taken for r > 0 only.
template <>
struct Sph<kVisc> : NonCubic<Sph<kVisc>> {
  __device__ static float w(float r2, const Params& k) {
    const float r = sqrtf(r2);
    if (!(r > 0.0f && r <= k.h)) return 0.0f;
    const float rr_hh = r * r / k.h2;
    return k.visc_n *
           (rr_hh * (1.0f - r / k.two_h) + k.h / (2.0f * r) - 1.0f);
  }
  __device__ static float dw(float r, const Params& k) {
    if (!(r > 0.0f && r <= k.h)) return 0.0f;
    const float rr = r * r;
    return k.visc_n *
           (-3.0f * rr / k.two_hhh + 2.0f * r / k.h2 - k.h / (2.0f * rr));
  }
};

// W of the density kernel Kd and dW/dr / r of the gradient kernel Kg at
// r^2 (cubic with cubic: both from one sqrtf, as before the other kernels
// were added).
template <int Kd, int Kg>
__device__ __forceinline__ void pair_w_dwr(float r2, const Params& k,
                                           float& w, float& dwr) {
  if constexpr (Kd == kCubic && Kg == kCubic) {
    cubic_w_dwr(r2, k, w, dwr);
  } else {
    w = Sph<Kd>::w(r2, k);
    dwr = Sph<Kg>::dwr(r2, k);
  }
}

// Whether a pass that evaluates kernels Kd and Kg queues the pair at r^2:
// either kernel's rule.
template <int Kd, int Kg>
__device__ __forceinline__ bool queue_either(float r2, const Params& k) {
  if constexpr (Kd == Kg) {
    return Sph<Kg>::queue(r2, k);
  } else {
    return Sph<Kg>::queue(r2, k) || Sph<Kd>::queue(r2, k);
  }
}

// Calls fn(std::integral_constant<int, K>()) for the kernel id K = id.
template <class Fn>
int with_kernel(int id, Fn&& fn) {
  switch (id) {
    case kCubic: return fn(std::integral_constant<int, kCubic>());
    case kPoly6: return fn(std::integral_constant<int, kPoly6>());
    case kSpiky: return fn(std::integral_constant<int, kSpiky>());
    case kVisc: return fn(std::integral_constant<int, kVisc>());
  }
  return (int)cudaErrorInvalidValue;
}

Params load_params(const float* params) {
  Params k;
  memcpy(&k, params, sizeof(Params));
  return k;
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

// ---- k_pass, t_pass, hoist_ff: tiles of cells, neighbour rows in shared
// memory
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

// r^2 = dp_0^2 + dp_1^2 (+ dp_2^2), each product and each sum rounded, as
// the plain versions and the JAX package on the CPU compute it. nvcc
// would contract `r2 + dp * dp` into a fused multiply-add (one rounding
// fewer): at a near tie r^2 = h^2 (the dam-break lattice holds pairs at
// r = h) the two forms fall on either side of h^2 and the pair counts
// part. Only r^2 is held to this; the weights keep their contraction.
template <int DIM>
__device__ __forceinline__ float r2_rounded(const float (&dp)[DIM]) {
  float r2 = __fmul_rn(dp[0], dp[0]);
#pragma unroll
  for (int d = 1; d < DIM; ++d) r2 = __fadd_rn(r2, __fmul_rn(dp[d], dp[d]));
  return r2;
}

// What a pass reads beyond P, M and X (Extra, a kernel parameter) and
// keeps of its own slot i for the pair terms (Own, loaded once an item):
// nothing, for k_pass, t_pass and hoist_ff.
struct PlainPass {
  struct Extra {};
  struct Own {};
  __device__ static void own(Own&, const float4*, size_t, const Extra&) {}
};

// What k_pass stages per neighbour slot, and adds per pair: one float4
// (p_j, (m k)_j), (m k)_j = M[js] * K[js] premultiplied as the pair term
// takes it. A block: 8 warps and at most 56 KB of shared memory, 4 blocks
// resident on an H100 SM (228 KB, 1 KB of it reserved per block); the
// fastest of the sizes measured at the 97k dam break (PERF.md). Kg: the
// gradient kernel.
template <int DIM, int Kg>
struct KPass : PlainPass {
  static constexpr int kWords = 1;  // float4 words of a staged slot
  static constexpr int kOut = DIM;  // float output channels
  static constexpr bool kCount = false;  // an int pair-count channel after them
  static constexpr int kThreads = 256;
  static constexpr int kSmemBudget = 56 * 1024;
  static constexpr int kRaw = DIM + 2;  // words read per slot: p_j, m_j, k_j
  __device__ static void fetch(float (&v)[kRaw], const float* P,
                               const float* M, const float* X, size_t plane,
                               size_t js, const Extra&) {
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
  __device__ static bool queue(float r2, const Params& k) {
    return Sph<Kg>::queue(r2, k);
  }
  __device__ static void add(float (&acc)[kOut], const float (&dp)[DIM],
                             float r2, const float4* s, const Params& k,
                             const Own&) {
    const float coeff = word(s[0], DIM) * Sph<Kg>::dwr(r2, k);
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc[d] += dp[d] * coeff;
  }
};

// t_pass: (p_j, m_j) and Q_j, two float4 words. Its slots are twice
// k_pass's, so a block takes 16 warps and up to 100 KB (2 per SM) to reach
// tiles as long.
template <int DIM, int Kg>
struct TPass : PlainPass {
  static constexpr int kWords = 2;
  static constexpr int kOut = 1;
  static constexpr bool kCount = false;
  static constexpr int kThreads = 512;
  static constexpr int kSmemBudget = 100 * 1024;
  static constexpr int kRaw = 2 * DIM + 1;  // p_j, m_j, Q_j
  __device__ static void fetch(float (&v)[kRaw], const float* P,
                               const float* M, const float* X, size_t plane,
                               size_t js, const Extra&) {
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
  __device__ static bool queue(float r2, const Params& k) {
    return Sph<Kg>::queue(r2, k);
  }
  __device__ static void add(float (&acc)[kOut], const float (&dp)[DIM],
                             float r2, const float4* s, const Params& k,
                             const Own&) {
    float t = word(s[1], 0) * dp[0];
#pragma unroll
    for (int d = 1; d < DIM; ++d) t = t + word(s[1], d) * dp[d];
    acc[0] += t * Sph<Kg>::dwr(r2, k) * word(s[0], DIM);
  }
};

// hoist_ff: (p_j, m_j), one float4 word, the mass not premultiplied; the
// float channels rho, Gf, sq, s2 (s2 summed only when kS2) and the pair
// count, DIM + 4 output words a slot. A block: 16 warps and up to 100 KB,
// 2 resident on an H100 SM (registers set it), tiles of 16 cells at cap
// 16: faster at the 97k dam break than k_pass's 8 warps and 56 KB (tiles
// of 15 cells, 4 a SM) and than 8 warps with 48 or 72 KB (PERF.md). Kd,
// Kg: the density and gradient kernels.
template <int DIM, bool kS2, int Kd, int Kg>
struct HoistFF : PlainPass {
  static constexpr int kWords = 1;
  static constexpr int kOut = DIM + 3;
  static constexpr bool kCount = true;
  static constexpr int kThreads = 512;
  static constexpr int kSmemBudget = 100 * 1024;
  static constexpr int kRaw = DIM + 1;  // p_j, m_j
  __device__ static void fetch(float (&v)[kRaw], const float* P,
                               const float* M, const float* X, size_t plane,
                               size_t js, const Extra&) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) v[d] = P[d * plane + js];
    v[DIM] = M[js];
  }
  __device__ static void pack(float4* s, const float (&v)[kRaw]) {
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d <= DIM; ++d) w[d] = v[d];
    s[0] = make_float4(w[0], w[1], w[2], w[3]);
  }
  __device__ static bool queue(float r2, const Params& k) {
    return queue_either<Kd, Kg>(r2, k);
  }
  __device__ static void add(float (&acc)[kOut], const float (&dp)[DIM],
                             float r2, const float4* s, const Params& k,
                             const Own&) {
    const float mj = word(s[0], DIM);
    float w, dwr;
    pair_w_dwr<Kd, Kg>(r2, k, w, dwr);
    acc[0] += mj * w;
    float gsq = 0.0f;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const float g = dp[d] * dwr;
      acc[1 + d] += g * mj;
      gsq = gsq + g * g;
    }
    acc[DIM + 1] += gsq * mj * mj;
    if (kS2) acc[DIM + 2] += gsq * mj;
  }
};

// The fluid-fluid term of the dense Monaghan artificial viscosity
// (solver/forces_dense.py ArtificialViscosityDense; artificial_viscosity.rs
// :40-125): per live slot i, over the slots j of the same fluid within h
// that approach it (v_ij . r_ij < 0),
//   a_i += coeff visc vol_j rho0_i / max((rho_i + rho_j) / 2, eps)
//          (p_i - p_j) dW/dr / r,
//   visc = c_s alpha mu - beta mu^2,  mu = h v.r / (r^2 + 0.01 h^2),
// with (coeff, alpha, beta, c_s) of fluid i's row of the per-fluid table.
// It replaces no TPU kernel: the JAX package runs these forces as plain
// jnp, a fold over the 27 shifted [cap, cap, C] pair blocks, which is
// what the port ran before this pass (about 90 eager operations an offset,
// ~2,400 launches a substep). What bounds it: per live slot 10 words
// read (p, v, vol, rho and the fluid id of j; rho0 of i) and DIM
// written, and ~45 float operations a pair within h; at 64,000 particles
// (~29 pairs within h each) the two take about the same time at the
// card's peaks (~1 us each), and as built the pass, like the other tiled
// passes, is held by its pair loops (every candidate a shared load and a
// distance), not by either peak (PERF.md). The design is the tiled
// passes' (file note): each neighbour cell's slots cross L2 once per
// tile into shared memory, a warp works on live (cell, 8-slot group)
// items only, and only pairs the gradient kernel queues run the pair
// term. Staged per slot, in float4 words: 3D (p, fid) (v, vol)
// (rho), 2D (p, fid, vol) (v, rho); the fluid id as its int bits. A
// slot's own v, rho and fid come from its staged slot, rho0 and the
// table row once an item (Own). Every product and sum of a pair term is
// rounded as the plain fold rounds it (no contraction into fused
// multiply-adds, an IEEE division), so a pair's term is the plain one's
// given the same dW/dr / r and only the order of the sums differs; the
// mask follows the plain one: r^2 <= h^2, the same fluid, v.r < 0.
// Skipping a pair the queue rule leaves out is exact: its dW/dr / r is
// +-0 (file note), so its term is too. 16 warps and up to 100 KB a block,
// as t_pass (two float4 words a slot in 2D, three in 3D).
template <int DIM, int Kg>
struct ViscFF {
  // The per-slot fields beyond P (positions), M (volumes) and X
  // (velocities), and the per-fluid table.
  struct Extra {
    const float* rho;    // [cap, C] densities
    const float* r0;     // [cap, C] rest densities
    const int* fid;      // [cap, C] fluid ids
    const float* table;  // [n_fluids, 4]: coeff, alpha, beta, c_s
    int n_fluids;
    float eta2;          // 0.01 h^2, as float32
  };
  // Slot i's terms: v_i, rho_i, fid_i, rho0_i, coeff, c_s alpha, beta
  // (and eta2, for add).
  struct Own {
    float v[DIM];
    float rho, r0, coeff, csa, beta, eta2;
    int fid;
  };
  static constexpr int kWords = DIM == 3 ? 3 : 2;
  static constexpr int kOut = DIM;
  static constexpr bool kCount = false;
  static constexpr int kThreads = 512;
  static constexpr int kSmemBudget = 100 * 1024;
  static constexpr int kRaw = 2 * DIM + 3;  // p, v, vol, rho, fid bits
  __device__ static void fetch(float (&v)[kRaw], const float* P,
                               const float* M, const float* X, size_t plane,
                               size_t js, const Extra& ex) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      v[d] = P[d * plane + js];
      v[DIM + d] = X[d * plane + js];
    }
    v[2 * DIM] = M[js];
    v[2 * DIM + 1] = __ldg(ex.rho + js);
    v[2 * DIM + 2] = __int_as_float(__ldg(ex.fid + js));
  }
  __device__ static void pack(float4* s, const float (&v)[kRaw]) {
    if (DIM == 3) {
      s[0] = make_float4(v[0], v[1], v[2], v[2 * DIM + 2]);
      s[1] = make_float4(v[DIM], v[DIM + 1], v[DIM + 2], v[2 * DIM]);
      s[2] = make_float4(v[2 * DIM + 1], 0.0f, 0.0f, 0.0f);
    } else {
      s[0] = make_float4(v[0], v[1], v[2 * DIM + 2], v[2 * DIM]);
      s[1] = make_float4(v[DIM], v[DIM + 1], v[2 * DIM + 1], 0.0f);
    }
  }
  // The staged fields of slot s (pack's layout).
  __device__ static int fid_of(const float4* s) {
    return __float_as_int(word(s[0], DIM));
  }
  __device__ static float vol_of(const float4* s) {
    return DIM == 3 ? s[1].w : s[0].w;
  }
  __device__ static float rho_of(const float4* s) {
    return DIM == 3 ? s[2].x : s[1].z;
  }
  __device__ static void own(Own& me, const float4* s, size_t gi,
                             const Extra& ex) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) me.v[d] = word(s[1], d);
    me.rho = rho_of(s);
    me.fid = fid_of(s);
    me.r0 = __ldg(ex.r0 + gi);
    me.eta2 = ex.eta2;
    // A fluid outside the table has no coefficient (the plain per-slot
    // grids hold 0 there): its terms are all +-0.
    me.coeff = me.csa = me.beta = 0.0f;
    if (me.fid >= 0 && me.fid < ex.n_fluids) {
      const float* row = ex.table + 4 * me.fid;
      me.coeff = __ldg(row);
      me.csa = __fmul_rn(__ldg(row + 3), __ldg(row + 1));
      me.beta = __ldg(row + 2);
    }
  }
  __device__ static bool queue(float r2, const Params& k) {
    return Sph<Kg>::queue(r2, k);
  }
  // The pair term, each operation rounded in the plain fold's order.
  __device__ static void add(float (&acc)[kOut], const float (&dp)[DIM],
                             float r2, const float4* s, const Params& k,
                             const Own& me) {
    if (!(r2 <= k.h2) || fid_of(s) != me.fid) return;
    float vr = __fmul_rn(dp[0], __fsub_rn(me.v[0], word(s[1], 0)));
#pragma unroll
    for (int d = 1; d < DIM; ++d) {
      vr = __fadd_rn(vr, __fmul_rn(dp[d], __fsub_rn(me.v[d], word(s[1], d))));
    }
    if (!(vr < 0.0f)) return;
    const float mu = __fdiv_rn(__fmul_rn(k.h, vr), __fadd_rn(r2, me.eta2));
    const float visc =
        __fsub_rn(__fmul_rn(me.csa, mu), __fmul_rn(__fmul_rn(me.beta, mu), mu));
    const float rho_avg = __fmul_rn(__fadd_rn(me.rho, rho_of(s)), 0.5f);
    const float scale = __fdiv_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(me.coeff, visc), vol_of(s)), me.r0),
        fmaxf(rho_avg, kEpsilon));
    const float dwr = Sph<Kg>::dwr(r2, k);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      acc[d] = __fadd_rn(acc[d], __fmul_rn(__fmul_rn(dp[d], dwr), scale));
    }
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
         (size_t)(Pass::kOut + Pass::kCount) * cap * tile * sizeof(float) +
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

// k_pass (Pass = KPass), t_pass (TPass), hoist_ff (HoistFF) and the
// artificial viscosity's fluid-fluid term (ViscFF) over tiles of `tile`
// consecutive cells; see the file note. Every output slot of the block's
// cells is written (zero for dead slots and air cells). `out` is
// [kOut + kCount, cap, C]: the float channels, then the pair count's
// int32 plane. `ex`: the pass's operands beyond P, M and X.
template <int DIM, class Pass>
__global__ void __launch_bounds__(Pass::kThreads)
    tile_pass_kernel(const float* __restrict__ P, const float* __restrict__ M,
                     const float* __restrict__ X,
                     const int* __restrict__ count, float* __restrict__ out,
                     int cap, int C, int ny, int nz, int tile, Params k,
                     typename Pass::Extra ex) {
  using R = Rows<DIM>;
  constexpr int kW = Pass::kWords;
  constexpr int kWarps = Pass::kThreads / 32;
  extern __shared__ float4 smem[];
  const int width = tile + 2;          // staged cells of a row
  const int row_slots = width * cap;   // slots a staged row holds
  const int n_staged = R::kRows * width;
  constexpr int kChan = Pass::kOut + Pass::kCount;  // output channels
  const int n_out = kChan * cap * tile;  // output tile entries
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
    for (int line = warp; line < kChan * cap; line += kWarps) {
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
                      (size_t)rank * C + c0 + R::shift(row, ny, nz) - 1 + m,
                      ex);
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
    typename Pass::Own me{};
    {
      const int own = R::kOwn * row_slots +
                      off[R::kOwn * (width + 1) + lc + 1] + r;
      const float4 a = live_i ? slots[(size_t)own * kW]
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int d = 0; d < DIM; ++d) pi[d] = word(a, d);
      if (live_i) {
        Pass::own(me, slots + (size_t)own * kW, (size_t)r * C + c0 + lc, ex);
      }
    }
    float acc[Pass::kOut];
#pragma unroll
    for (int d = 0; d < Pass::kOut; ++d) acc[d] = 0.0f;
    int len = 0, pairs = 0;
    // r^2 of the pair (i, staged slot idx), p_i - p_j, and the slot's
    // word DIM (hoist_ff: m_j). r^2 is rounded as the plain versions
    // round it (see r2_rounded).
    auto dist2 = [&](int idx, float (&dp)[DIM], float& wj) {
      const float4 a = slots[(size_t)idx * kW];
#pragma unroll
      for (int d = 0; d < DIM; ++d) dp[d] = pi[d] - word(a, d);
      wj = word(a, DIM);
      return r2_rounded<DIM>(dp);
    };
    // Queue the pair on its kernels' rule (Pass::queue): beyond it the
    // pair term is +-0 (file note), so skipping the pair changes no sum.
    // hoist_ff counts the pair on its own rule.
    auto visit = [&](int idx, float r2, float mj) {
      if (Pass::queue(r2, k)) q[len++ * 32] = (unsigned short)idx;
      if (Pass::kCount) pairs += (r2 <= k.h2 && mj != 0.0f) ? 1 : 0;
    };
    // Add the queued pairs, in the order they were found, two at a time
    // (their splines overlap; the sums take them in order).
    auto flush = [&]() {
      int e = 0;
      float w0, w1;
      for (; e + 1 < len; e += 2) {
        const int i0 = q[e * 32], i1 = q[(e + 1) * 32];
        float dp0[DIM], dp1[DIM];
        const float r20 = dist2(i0, dp0, w0), r21 = dist2(i1, dp1, w1);
        Pass::add(acc, dp0, r20, slots + (size_t)i0 * kW, k, me);
        Pass::add(acc, dp1, r21, slots + (size_t)i1 * kW, k, me);
      }
      if (e < len) {
        const int i0 = q[e * 32];
        float dp0[DIM];
        const float r20 = dist2(i0, dp0, w0);
        Pass::add(acc, dp0, r20, slots + (size_t)i0 * kW, k, me);
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
        float dp[DIM], ma, mb;
        const float r2a = dist2(idx, dp, ma), r2b = dist2(idx + 4, dp, mb);
        visit(idx, r2a, ma);
        visit(idx + 4, r2b, mb);
      }
      if (idx < end) {
        float dp[DIM], ma;
        const float r2a = dist2(idx, dp, ma);
        visit(idx, r2a, ma);
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
    if (Pass::kCount) {
      pairs += __shfl_xor_sync(0xffffffffu, pairs, 1);
      pairs += __shfl_xor_sync(0xffffffffu, pairs, 2);
    }
    if (jl == 0 && live_i) {
#pragma unroll
      for (int d = 0; d < Pass::kOut; ++d) {
        out_t[(d * cap + r) * tile + lc] = acc[d];
      }
      if (Pass::kCount) {
        out_t[(Pass::kOut * cap + r) * tile + lc] = __int_as_float(pairs);
      }
    }
  }
  __syncthreads();
  // Every slot of the tile's cells: a warp per (channel, rank) line of
  // `tile` consecutive cells (the output is [kChan][cap][C], so line
  // d * cap + r starts at line * C), copied as 32-bit words (the count
  // plane holds int32).
  const unsigned* words = reinterpret_cast<const unsigned*>(out_t);
  unsigned* out_w = reinterpret_cast<unsigned*>(out);
  for (int line = warp; line < kChan * cap; line += kWarps) {
    for (int lc = lane; lc < tile && c0 + lc < C; lc += 32) {
      out_w[(size_t)line * C + c0 + lc] = words[line * tile + lc];
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
                     int nz, const Params& k, cudaStream_t s,
                     const typename Pass::Extra& ex = {}) {
  TileShape t;
  const cudaError_t err = tile_setup<DIM, Pass>(cap, C, &t);
  if (err != cudaSuccess) return (int)err;
  tile_pass_kernel<DIM, Pass><<<t.blocks, Pass::kThreads, t.smem, s>>>(
      P, M, X, count, out, cap, C, ny, nz, t.tile, k, ex);
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

// ---- hoist_fb: a warp per live (listed column, 8-slot group) -------------
// (design and bound: the file note)

constexpr int kFbThreads = 256;
// Entries of each lane's queue of within-h boundary pairs; a full queue is
// added before the next candidate step.
constexpr int kFbQueue = 16;

// Fluid-boundary hoist: per live fluid slot i of a listed column, over the
// boundary particles j of its 3^dim neighbour cells within h:
//   rho = sum Volb_j W,  Gb = sum Volb_j grad,  sq = sum |grad|^2 Volb_j^2,
//   s2 = sum |grad|^2 Volb_j (when need_s2),  Sb = sum Volb_j (vb_j . grad),
//   cnt = the number of such pairs.
// `out` is [DIM + 5, cap, C] (rho, Gb, sq, s2, Sb, then the count's int32
// plane), zero-filled by the caller: a warp writes the live slots of its
// item only. Item w = entry t (of `cols`, or column t when cols is null)
// and 8-slot group g, w = t * groups + g. Kd, Kg: the density and
// gradient kernels.
template <int DIM, int Kd, int Kg>
__global__ void __launch_bounds__(kFbThreads)
    hoist_fb_warps(const float* __restrict__ P, const int* __restrict__ count,
                   const int* __restrict__ cols, int n_cols,
                   const float* __restrict__ Pb,
                   const float* __restrict__ Volb,
                   const float* __restrict__ Vb,
                   const int* __restrict__ count_b,
                   const int* __restrict__ cell_to_col,
                   float* __restrict__ out, int cap, int C, int cap_b,
                   int Cb, int ny, int nz, int need_s2, Params k) {
  constexpr int kWarps = kFbThreads / 32;
  constexpr int kOut = DIM + 4;  // float channels: rho, Gb, sq, s2, Sb
  __shared__ int queues[kWarps][kFbQueue][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (cap + 7) >> 3;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  // Every exit below is warp-uniform.
  if (item >= (long long)n_cols * groups) return;
  const int t = (int)(item / groups);
  const int g = (int)(item - (long long)t * groups);
  const int c = cols ? cols[t] : t;
  if (c < 0 || c >= C) return;           // unused table entry
  const int n_i = min(count[c], cap);
  if (n_i <= 8 * g) return;              // dead group: the fill's zeros
  // Lane o < 3^dim: neighbour cell o's boundary column and count.
  int bcol = 0, bcnt = 0;
  if (lane < Stencil<DIM>::kOffsets) {
    const int n = c + flat_shift<DIM>(lane, ny, nz);
    if (n >= 0 && n < C) {  // outside the grid: an empty cell
      const int b = cell_to_col ? cell_to_col[n] : n;
      if (b >= 0 && b < Cb) {
        bcol = b;
        bcnt = min(count_b[b], cap_b);
      }
    }
  }
  unsigned cells = __ballot_sync(0xffffffffu, bcnt > 0);
  if (!cells) return;  // no boundary particle around: zeros
  const int il = lane >> 2, jl = lane & 3;
  const int r = 8 * g + il;
  const bool live_i = r < n_i;
  const size_t plane = (size_t)cap * C;
  const size_t plane_b = (size_t)cap_b * Cb;
  float pi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    pi[d] = live_i ? P[d * plane + (size_t)r * C + c] : 0.0f;
  }
  float acc[kOut];
#pragma unroll
  for (int d = 0; d < kOut; ++d) acc[d] = 0.0f;
  int pairs = 0, len = 0;
  int* q = &queues[warp][0][lane];
  // p_i - p_j and r^2 (rounded as the plain version rounds it) for
  // boundary slot js.
  auto dist2 = [&](size_t js, float (&dp)[DIM]) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) dp[d] = pi[d] - Pb[d * plane_b + js];
    return r2_rounded<DIM>(dp);
  };
  auto add = [&](size_t js) {
    float dp[DIM];
    const float r2 = dist2(js, dp);
    const float vj = Volb[js];
    float w, dwr;
    pair_w_dwr<Kd, Kg>(r2, k, w, dwr);
    acc[0] += vj * w;
    float gsq = 0.0f, vdotg = 0.0f;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const float gd = dp[d] * dwr;
      acc[1 + d] += gd * vj;
      gsq = gsq + gd * gd;
      vdotg = vdotg + Vb[d * plane_b + js] * gd * vj;
    }
    acc[DIM + 1] += gsq * vj * vj;
    if (need_s2) acc[DIM + 2] += gsq * vj;
    acc[DIM + 3] += vdotg;
  };
  // Add the queued pairs in the order they were found, two at a time.
  auto flush = [&]() {
    int e = 0;
    for (; e + 1 < len; e += 2) {
      const int j0 = q[e * 32], j1 = q[(e + 1) * 32];
      add((size_t)j0);
      add((size_t)j1);
    }
    if (e < len) add((size_t)q[e * 32]);
    len = 0;
  };
  // The cells with boundary particles, in stencil order; j-lane jl takes
  // their slots jl, jl + 4, ... and queues those within h (r^2 <= h^2,
  // the count's rule and the plain version's mask).
  while (cells) {
    const int o = __ffs(cells) - 1;
    cells &= cells - 1;
    const int b = __shfl_sync(0xffffffffu, bcol, o);
    const int nb = __shfl_sync(0xffffffffu, bcnt, o);
    for (int j0 = 0; j0 < nb; j0 += 4) {
      if (__any_sync(0xffffffffu, len == kFbQueue)) flush();
      const int j = j0 + jl;
      if (live_i && j < nb) {
        const size_t js = (size_t)j * Cb + b;
        float dp[DIM];
        if (dist2(js, dp) <= k.h2) {
          q[len++ * 32] = (int)js;
          ++pairs;
        }
      }
    }
  }
  flush();
  // The 4 j-lane partial sums of each i-slot, in a fixed order.
#pragma unroll
  for (int d = 0; d < kOut; ++d) {
    float v = acc[d];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    acc[d] = v;
  }
  pairs += __shfl_xor_sync(0xffffffffu, pairs, 1);
  pairs += __shfl_xor_sync(0xffffffffu, pairs, 2);
  if (jl == 0 && live_i) {
    const size_t slot = (size_t)r * C + c;
#pragma unroll
    for (int d = 0; d < kOut; ++d) out[d * plane + slot] = acc[d];
    reinterpret_cast<int*>(out)[kOut * plane + slot] = pairs;
  }
}

// The passes of tile_pass_kernel, as salva_pass_tiling names them.
enum TiledPass {
  kTileK = 0, kTileT = 1, kTileHoist = 2, kTileHoistS2 = 3, kTileVisc = 4
};

template <int DIM, int Kd, int Kg>
int query_tiling(int pass, int cap, int C, int* shape) {
  switch (pass) {
    case kTileK: return query_tile_pass<DIM, KPass<DIM, Kg>>(cap, C, shape);
    case kTileT: return query_tile_pass<DIM, TPass<DIM, Kg>>(cap, C, shape);
    case kTileHoist:
      return query_tile_pass<DIM, HoistFF<DIM, false, Kd, Kg>>(cap, C, shape);
    case kTileHoistS2:
      return query_tile_pass<DIM, HoistFF<DIM, true, Kd, Kg>>(cap, C, shape);
    case kTileVisc:
      return query_tile_pass<DIM, ViscFF<DIM, Kg>>(cap, C, shape);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = success) so that the Python wrapper can raise on a refused launch,
// or kNotLaunched when the grid is empty and there is nothing to launch
// (the outputs are then complete as the wrapper allocated them). `kd` /
// `kg` are the density / gradient kernel ids (Kern; an unknown id is
// refused with cudaErrorInvalidValue) and `params` the kParams floats of
// Params, in its order.
static const int kNotLaunched = -1;

// The number of floats salva_* entry points read from `params`.
int salva_pair_params() { return kParams; }

int salva_k_pass(const float* P, const float* M, const float* K,
                 const int* count, float* out, int dim, int cap, int C,
                 int ny, int nz, int kg, const float* params, void* stream) {
  if (cap <= 0 || C <= 0) return kNotLaunched;
  const Params k = load_params(params);
  cudaStream_t s = (cudaStream_t)stream;
  return with_kernel(kg, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if (dim == 3) {
      return launch_tile_pass<3, KPass<3, G>>(P, M, K, count, out, cap, C,
                                              ny, nz, k, s);
    }
    if (dim == 2) {
      return launch_tile_pass<2, KPass<2, G>>(P, M, K, count, out, cap, C,
                                              ny, nz, k, s);
    }
    return (int)cudaErrorInvalidValue;
  });
}

int salva_t_pass(const float* P, const float* M, const float* Q,
                 const int* count, float* out, int dim, int cap, int C,
                 int ny, int nz, int kg, const float* params, void* stream) {
  if (cap <= 0 || C <= 0) return kNotLaunched;
  const Params k = load_params(params);
  cudaStream_t s = (cudaStream_t)stream;
  return with_kernel(kg, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if (dim == 3) {
      return launch_tile_pass<3, TPass<3, G>>(P, M, Q, count, out, cap, C,
                                              ny, nz, k, s);
    }
    if (dim == 2) {
      return launch_tile_pass<2, TPass<2, G>>(P, M, Q, count, out, cap, C,
                                              ny, nz, k, s);
    }
    return (int)cudaErrorInvalidValue;
  });
}

// How salva_k_pass (pass 0), salva_t_pass (1), salva_hoist_ff (2: without
// s2, 3: with it) or salva_visc_ff (4) tiles a [cap, C] grid under kernels
// kd / kg: shape[0..3]
// = cells a block owns, bytes of shared memory a block takes, blocks
// launched, blocks resident on one SM of the current device. Returns a
// CUDA error code (0 = success).
int salva_pass_tiling(int pass, int dim, int cap, int C, int kd, int kg,
                      int* shape) {
  if (cap <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  return with_kernel(kd, [&](auto d) {
    return with_kernel(kg, [&](auto g) {
      constexpr int D = decltype(d)::value, G = decltype(g)::value;
      if (dim == 3) return query_tiling<3, D, G>(pass, cap, C, shape);
      if (dim == 2) return query_tiling<2, D, G>(pass, cap, C, shape);
      return (int)cudaErrorInvalidValue;
    });
  });
}

// `out` is [dim + 4, cap, C]: rho, Gf (dim planes), sq, s2, and the pair
// count as int32; every slot is written.
int salva_hoist_ff(const float* P, const float* M, const int* count,
                   float* out, int dim, int cap, int C, int ny, int nz,
                   int need_s2, int kd, int kg, const float* params,
                   void* stream) {
  if (cap <= 0 || C <= 0) return kNotLaunched;
  const Params k = load_params(params);
  cudaStream_t s = (cudaStream_t)stream;
  return with_kernel(kd, [&](auto d) {
    return with_kernel(kg, [&](auto g) {
      constexpr int D = decltype(d)::value, G = decltype(g)::value;
      if (dim == 3) {
        return need_s2 ? launch_tile_pass<3, HoistFF<3, true, D, G>>(
                             P, M, nullptr, count, out, cap, C, ny, nz, k, s)
                       : launch_tile_pass<3, HoistFF<3, false, D, G>>(
                             P, M, nullptr, count, out, cap, C, ny, nz, k, s);
      }
      if (dim == 2) {
        return need_s2 ? launch_tile_pass<2, HoistFF<2, true, D, G>>(
                             P, M, nullptr, count, out, cap, C, ny, nz, k, s)
                       : launch_tile_pass<2, HoistFF<2, false, D, G>>(
                             P, M, nullptr, count, out, cap, C, ny, nz, k, s);
      }
      return (int)cudaErrorInvalidValue;
    });
  });
}

// The artificial viscosity's fluid-fluid term (ViscFF). P, V [dim, cap,
// C], VOL, RHO, R0 [cap, C] float32 and FID [cap, C] int32 on the grid;
// `table` [n_fluids, 4] (coeff, alpha, beta, c_s per fluid); eta2 =
// 0.01 h^2 as float32. `out` is [dim, cap, C]; every slot is written.
int salva_visc_ff(const float* P, const float* V, const float* VOL,
                  const float* RHO, const float* R0, const int* FID,
                  const float* table, int n_fluids, const int* count,
                  float* out, int dim, int cap, int C, int ny, int nz, int kg,
                  float eta2, const float* params, void* stream) {
  if (cap <= 0 || C <= 0) return kNotLaunched;
  const Params k = load_params(params);
  cudaStream_t s = (cudaStream_t)stream;
  return with_kernel(kg, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if (dim == 3) {
      const typename ViscFF<3, G>::Extra ex{RHO, R0, FID, table, n_fluids, eta2};
      return launch_tile_pass<3, ViscFF<3, G>>(P, VOL, V, count, out, cap,
                                               C, ny, nz, k, s, ex);
    }
    if (dim == 2) {
      const typename ViscFF<2, G>::Extra ex{RHO, R0, FID, table, n_fluids, eta2};
      return launch_tile_pass<2, ViscFF<2, G>>(P, VOL, V, count, out, cap,
                                               C, ny, nz, k, s, ex);
    }
    return (int)cudaErrorInvalidValue;
  });
}

// k_pass_pallas2's slot-group formulation gates pair blocks by live
// 8-slot groups; the dead slots inside a live group hold the far sentinel
// and zero mass, so they add exactly +-0 there, and its result is
// k_pass's. The tiled k_pass body computes that function on the true
// counts (a warp per live (cell, 8-slot group) item, the spline only
// within h), so this entry launches it: the thread-per-group kernel of the
// first port is gone.
int salva_k_pass_v2(const float* P, const float* M, const float* K,
                    const int* count, float* out, int dim, int cap, int C,
                    int ny, int nz, int kg, const float* params,
                    void* stream) {
  return salva_k_pass(P, M, K, count, out, dim, cap, C, ny, nz, kg, params,
                      stream);
}

// `cols` may be null (visit all C columns; n_cols = C) and `cell_to_col`
// may be null (the boundary grid is the full grid, Cb = C). `out` is
// [dim + 5, cap, C]: rho, Gb (dim planes), sq, s2, Sb, and the pair count
// as int32; it must be zero-filled: only listed live slots are written.
int salva_hoist_fb(const float* P, const int* count, const int* cols,
                   int n_cols, const float* Pb, const float* Volb,
                   const float* Vb, const int* count_b,
                   const int* cell_to_col, float* out, int dim, int cap,
                   int C, int cap_b, int Cb, int ny, int nz, int need_s2,
                   int kd, int kg, const float* params, void* stream) {
  if (cap <= 0 || C <= 0 || n_cols <= 0 || cap_b <= 0 || Cb <= 0) {
    return kNotLaunched;
  }
  // A queued boundary slot is an int index j * Cb + b.
  if ((long long)cap_b * Cb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params k = load_params(params);
  cudaStream_t s = (cudaStream_t)stream;
  const long long warps = (long long)n_cols * ((cap + 7) / 8);
  const int per_block = kFbThreads / 32;
  const dim3 grid((unsigned)((warps + per_block - 1) / per_block));
  return with_kernel(kd, [&](auto d) {
    return with_kernel(kg, [&](auto g) {
      constexpr int D = decltype(d)::value, G = decltype(g)::value;
      if (dim == 3) {
        hoist_fb_warps<3, D, G><<<grid, kFbThreads, 0, s>>>(
            P, count, cols, n_cols, Pb, Volb, Vb, count_b, cell_to_col, out,
            cap, C, cap_b, Cb, ny, nz, need_s2, k);
      } else if (dim == 2) {
        hoist_fb_warps<2, D, G><<<grid, kFbThreads, 0, s>>>(
            P, count, cols, n_cols, Pb, Volb, Vb, count_b, cell_to_col, out,
            cap, C, cap_b, Cb, ny, nz, need_s2, k);
      } else {
        return (int)cudaErrorInvalidValue;
      }
      return (int)cudaGetLastError();
    });
  });
}

}  // extern "C"
