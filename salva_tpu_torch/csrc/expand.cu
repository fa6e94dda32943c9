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
// Determinism: pure data movement, no atomics; the result is bitwise the
// gather's.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kMaxChannels = 16;
constexpr int kThreads = 128;

struct Channels {
  const float* in[kMaxChannels];   // channel k of particle i: in[k][i * stride[k]]
  long long stride[kMaxChannels];  // in elements
  float fill[kMaxChannels];        // value of an empty slot
};

__global__ void expand_kernel(const int* __restrict__ order,
                              const int* __restrict__ start,
                              const int* __restrict__ count,
                              float* __restrict__ out, int cap, int C,
                              int nch, Channels ch) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const size_t plane = (size_t)cap * C;
  const size_t slot = (size_t)r * C + c;
  if (r < min(count[c], cap)) {
    const long long src = order[start[c] + r];
    for (int k = 0; k < nch; ++k) {
      out[k * plane + slot] = ch.in[k][src * ch.stride[k]];
    }
  } else {
    for (int k = 0; k < nch; ++k) out[k * plane + slot] = ch.fill[k];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = success), or
// kNotLaunched (-1) when the grid is empty and there is nothing to launch.
// `in_ptrs`, `strides` and `fills` are host arrays of `nch` entries; `out`
// is [nch, cap, C] float32 on the device.
int salva_expand(const int* order, const int* start, const int* count,
                 int cap, int C, int nch, const void* const* in_ptrs,
                 const long long* strides, const float* fills, float* out,
                 void* stream) {
  static const int kNotLaunched = -1;
  if (cap <= 0 || C <= 0 || nch <= 0) return kNotLaunched;
  if (nch > kMaxChannels) return (int)cudaErrorInvalidValue;
  Channels ch;
  for (int k = 0; k < nch; ++k) {
    ch.in[k] = static_cast<const float*>(in_ptrs[k]);
    ch.stride[k] = strides[k];
    ch.fill[k] = fills[k];
  }
  for (int k = nch; k < kMaxChannels; ++k) {
    ch.in[k] = nullptr;
    ch.stride[k] = 0;
    ch.fill[k] = 0.0f;
  }
  const dim3 grid((unsigned)((C + kThreads - 1) / kThreads), (unsigned)cap);
  expand_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      order, start, count, out, cap, C, nch, ch);
  return (int)cudaGetLastError();
}

}  // extern "C"
