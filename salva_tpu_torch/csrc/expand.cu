// The sorted -> slot expansion of the dense binning as a hand-written CUDA
// kernel for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes; see ops/_build.py and ops/binning.py).
//
// Replaces tools/exp_pallas_expand.py build_expand / expand (the Pallas
// prototype of the binning shuffle), and computes what
// geometry/dense_grid.py to_grid_multi computes with its packed row
// gather: for every slot (r, c) of a [cap, C] grid and every channel k,
//
//   out_k[r, c] = vals_k[order[start[c] + r]]   if r < min(count[c], cap)
//               = fill_k                          otherwise,
//
// where (order, start, count) is the binning's run table: the stable sort
// order of the particles by cell, and each column's first sorted index and
// particle count. Starts are read per column, never as differences of a
// monotone start[C+1]: bin_particles leaves start = 0 for empty cells.
// The TPU prototype reads one DMA window of sorted rows per block of cells
// and marks a slot invalid when its source row lies beyond that window, so
// a block whose cells hold more sorted rows than the window loses slots;
// here every thread reads its own source row, and over-cap cells keep
// exactly the rows to_grid_multi keeps (the first cap of their run).
//
// What bounds it on the H100: bytes. It moves each live slot's channels
// once (a gathered read, through `order`) and writes every output element
// once; at the 97k dam-break state the 8 output planes of the fluid
// binning (8 x 16 x 32,768 x 4 B, ~16.8 MB) dominate, ~5 us at 3.35 TB/s.
// The design: one thread per slot, consecutive threads along c (so that
// each plane's writes coalesce), all channels written by the same thread
// (one run-table lookup per slot), channel pointers and strides passed by
// value in one small struct (so that a [N, D] input's columns are read in
// place, with no per-channel copy).
//
// Two binnings, one launch. A substep expands its fluid binning and its
// boundary binning (each with its own run table, cap, column count,
// channels and output). The boundary's output is small (~3.4 MB at the
// 97k state, ~1 us of bytes), so a launch of its own costs the fixed
// latency of a dependent count -> order -> vals chain over a grid of few
// blocks, not its bytes. So one launch takes up to kMaxTables run tables:
// the flat block range is cut into one range per table (blocks
// [first[t], first[t + 1]) serve table t), and the boundary's blocks run
// in the fluid call's waves.
//
// Determinism: pure data movement, no atomics; the result is bitwise the
// gather's.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kMaxChannels = 16;
constexpr int kMaxTables = 2;
constexpr int kThreads = 128;

// One binning's expansion: its run table, its grid shape, its channels
// and its output [nch, cap, C].
struct Table {
  const int* order;
  const int* start;
  const int* count;
  float* out;
  int cap, C, nch;
  int col_blocks;                  // blocks along c: ceil(C / kThreads)
  const float* in[kMaxChannels];   // channel k of particle i: in[k][i * stride[k]]
  long long stride[kMaxChannels];  // in elements
  float fill[kMaxChannels];        // value of an empty slot
};

struct Tables {
  Table t[kMaxTables];
  int first[kMaxTables + 1];  // table t's blocks: [first[t], first[t + 1])
  int n;
};

__global__ void __launch_bounds__(kThreads)
    expand_kernel(const __grid_constant__ Tables tabs) {
  int b = blockIdx.x, ti = 0;
  while (ti + 1 < tabs.n && b >= tabs.first[ti + 1]) ++ti;  // block-uniform
  const Table& t = tabs.t[ti];
  b -= tabs.first[ti];
  const int r = b / t.col_blocks;
  const int c = (b - r * t.col_blocks) * kThreads + threadIdx.x;
  if (c >= t.C) return;
  const size_t plane = (size_t)t.cap * t.C;
  const size_t slot = (size_t)r * t.C + c;
  if (r < min(t.count[c], t.cap)) {
    const long long src = t.order[t.start[c] + r];
    for (int k = 0; k < t.nch; ++k) {
      t.out[k * plane + slot] = t.in[k][src * t.stride[k]];
    }
  } else {
    for (int k = 0; k < t.nch; ++k) t.out[k * plane + slot] = t.fill[k];
  }
}

}  // namespace

extern "C" {

// Expands `n_tables` (1 or kMaxTables) binnings in one launch on `stream`
// and returns cudaGetLastError() (0 = success), or kNotLaunched (-1) when
// every table's grid is empty and there is nothing to launch. Per table
// t: `order[t]`, `start[t]`, `count[t]` its run table (device int32),
// `cap[t]`, `C[t]`, `nch[t]` its shape, `out[t]` its [nch, cap, C]
// float32 output; `in_ptrs`, `strides` and `fills` hold the channels of
// every table, table after table (sum of nch entries, host arrays).
int salva_expand(int n_tables, const void* const* order,
                 const void* const* start, const void* const* count,
                 const int* cap, const int* C, const int* nch,
                 const void* const* in_ptrs, const long long* strides,
                 const float* fills, void* const* out, void* stream) {
  static const int kNotLaunched = -1;
  if (n_tables < 1 || n_tables > kMaxTables) {
    return (int)cudaErrorInvalidValue;
  }
  Tables tabs = {};
  tabs.n = n_tables;
  long long blocks = 0;
  int k0 = 0;
  for (int i = 0; i < n_tables; ++i) {
    if (nch[i] <= 0 || nch[i] > kMaxChannels || cap[i] < 0 || C[i] < 0) {
      return (int)cudaErrorInvalidValue;
    }
    Table& t = tabs.t[i];
    t.order = static_cast<const int*>(order[i]);
    t.start = static_cast<const int*>(start[i]);
    t.count = static_cast<const int*>(count[i]);
    t.out = static_cast<float*>(out[i]);
    t.cap = cap[i];
    t.C = C[i];
    t.nch = nch[i];
    t.col_blocks = (C[i] + kThreads - 1) / kThreads;
    for (int k = 0; k < nch[i]; ++k) {
      t.in[k] = static_cast<const float*>(in_ptrs[k0 + k]);
      t.stride[k] = strides[k0 + k];
      t.fill[k] = fills[k0 + k];
    }
    k0 += nch[i];
    tabs.first[i] = (int)blocks;
    blocks += (long long)t.col_blocks * cap[i];
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  tabs.first[n_tables] = (int)blocks;
  if (blocks == 0) return kNotLaunched;
  expand_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tabs);
  return (int)cudaGetLastError();
}

}  // extern "C"
