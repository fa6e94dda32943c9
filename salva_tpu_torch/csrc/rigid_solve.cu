// The rigid bodies' sequential-impulse contact solve as a hand-written CUDA
// kernel for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes; see ops/_build.py and ops/rigid.py).
//
// Replaces the device coupling's _solve_velocities_dev
// (salva_tpu/coupling/device_pipeline.py:347-416), a lax.scan over a
// compacted contact table of K = 64 rows inside a scan of 8 iterations,
// which the JAX package leaves to XLA (it has no Pallas kernel). For every
// iteration and every contact k < count, in order:
//
//   v   = v_a(p) - v_b(p)              (v_b = 0 for a fixed collider, b < 0)
//   kn  = m_a(p, n) + m_b(p, n)        (inverse effective masses)
//   if kn > 0:
//     acc' = max(acc_k - (1 + e) (v . n) / kn, 0);  apply (acc' - acc_k) n
//     if friction > 0 and acc' > 0 and |v_t| > 1e-6 (v_t recomputed):
//       t = v_t / |v_t|;  if kt = m_a(p, t) + m_b(p, t) > 0:
//       apply clamp(-|v_t| / kt, -mu acc', mu acc') t
//
// with "apply J" adding J / m to the linear velocity and the world inverse
// inertia R diag(I^-1) R^T (r x J) to the angular velocity of body a, and
// the opposite to body b.
//
// What bounds it on the H100: neither bytes nor operations (a few KB and
// ~10^5 flops); every contact reads the velocities the one before it
// wrote, so the work is one dependent chain of at most 8 x 64 updates. As
// eager PyTorch ops that chain is ~10^4 launches, each waiting on the
// host. The design: one thread runs the whole chain in registers and local
// memory, reading `count` from device memory, so the solve is one launch
// with no host sync; a single block of one warp, with lane 0 working.
//
// Determinism: one thread, a fixed order; no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxContacts = 256;

struct Bodies {
  int dim;
  const float* trans;        // [B, dim]
  const float* rot;          // [B, dim, dim], row-major
  const float* inv_mass;     // [B]
  const float* inv_inertia;  // [B, 1] (2D) or [B, 3] (3D), body frame
  float* lin;                // [B, dim]
  float* ang;                // [B] (2D) or [B, 3] (3D)
};

__device__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ float dotn(const float* a, const float* b, int dim) {
  float s = a[0] * b[0];
  for (int i = 1; i < dim; ++i) s += a[i] * b[i];
  return s;
}

// R diag(inv) R^T tau for body `body` (3D).
__device__ void world_inv_inertia(const Bodies& B, int body, const float* tau,
                                  float* out) {
  const float* R = B.rot + body * 9;
  const float* inv = B.inv_inertia + body * 3;
  float local[3];
  for (int i = 0; i < 3; ++i) {
    local[i] = inv[i] * (R[0 * 3 + i] * tau[0] + R[1 * 3 + i] * tau[1] +
                         R[2 * 3 + i] * tau[2]);
  }
  for (int i = 0; i < 3; ++i) {
    out[i] = R[i * 3 + 0] * local[0] + R[i * 3 + 1] * local[1] +
             R[i * 3 + 2] * local[2];
  }
}

__device__ void point_vel(const Bodies& B, int body, const float* p,
                          float* v) {
  const int d = B.dim;
  float r[3];
  for (int i = 0; i < d; ++i) r[i] = p[i] - B.trans[body * d + i];
  if (d == 2) {
    const float w = B.ang[body];
    v[0] = B.lin[body * 2 + 0] + w * -r[1];
    v[1] = B.lin[body * 2 + 1] + w * r[0];
  } else {
    float wr[3];
    cross3(B.ang + body * 3, r, wr);
    for (int i = 0; i < 3; ++i) v[i] = B.lin[body * 3 + i] + wr[i];
  }
}

__device__ float eff_mass(const Bodies& B, int body, const float* p,
                          const float* axis) {
  const int d = B.dim;
  float r[3];
  for (int i = 0; i < d; ++i) r[i] = p[i] - B.trans[body * d + i];
  if (d == 2) {
    const float rn = r[0] * axis[1] - r[1] * axis[0];
    return B.inv_mass[body] + rn * rn * B.inv_inertia[body];
  }
  float rn[3], iw[3], c[3];
  cross3(r, axis, rn);
  world_inv_inertia(B, body, rn, iw);
  cross3(iw, r, c);
  return B.inv_mass[body] + dotn(c, axis, 3);
}

__device__ void apply(const Bodies& B, int body, const float* imp,
                      const float* p) {
  const int d = B.dim;
  const float im = B.inv_mass[body];
  for (int i = 0; i < d; ++i) B.lin[body * d + i] += imp[i] * im;
  float r[3];
  for (int i = 0; i < d; ++i) r[i] = p[i] - B.trans[body * d + i];
  if (d == 2) {
    const float tau = r[0] * imp[1] - r[1] * imp[0];
    B.ang[body] += tau * B.inv_inertia[body];
  } else {
    float tau[3], dw[3];
    cross3(r, imp, tau);
    world_inv_inertia(B, body, tau, dw);
    for (int i = 0; i < 3; ++i) B.ang[body * 3 + i] += dw[i];
  }
}

__device__ void rel_vel(const Bodies& B, int a, int b, const float* p,
                        float* v) {
  point_vel(B, a, p, v);
  if (b >= 0) {
    float vb[3];
    point_vel(B, b, p, vb);
    for (int i = 0; i < B.dim; ++i) v[i] -= vb[i];
  }
}

__device__ float pair_mass(const Bodies& B, int a, int b, const float* p,
                           const float* axis) {
  const float m = eff_mass(B, a, p, axis);
  return b >= 0 ? m + eff_mass(B, b, p, axis) : m;
}

__device__ void apply_pair(const Bodies& B, int a, int b, const float* imp,
                           const float* p) {
  apply(B, a, imp, p);
  if (b >= 0) {
    float neg[3];
    for (int i = 0; i < B.dim; ++i) neg[i] = -imp[i];
    apply(B, b, neg, p);
  }
}

__global__ void rigid_solve_kernel(Bodies B, const int* __restrict__ a,
                                   const int* __restrict__ b,
                                   const float* __restrict__ p,
                                   const float* __restrict__ n,
                                   const int* __restrict__ count_ptr, int K,
                                   int iterations, float restitution,
                                   float friction) {
  if (threadIdx.x != 0) return;
  const int d = B.dim;
  const int count = min(*count_ptr, K);
  float acc[kMaxContacts];
  for (int k = 0; k < count; ++k) acc[k] = 0.0f;
  for (int it = 0; it < iterations; ++it) {
    for (int k = 0; k < count; ++k) {
      const int ka = a[k], kb = b[k];
      const float* pk = p + k * d;
      const float* nk = n + k * d;
      float v[3];
      rel_vel(B, ka, kb, pk, v);
      const float vn = dotn(v, nk, d);
      const float kn = pair_mass(B, ka, kb, pk, nk);
      if (!(kn > 0.0f)) continue;
      const float j = -(1.0f + restitution) * vn / kn;
      const float new_acc = fmaxf(acc[k] + j, 0.0f);
      const float dj = new_acc - acc[k];
      acc[k] = new_acc;
      float imp[3];
      for (int i = 0; i < d; ++i) imp[i] = dj * nk[i];
      apply_pair(B, ka, kb, imp, pk);
      if (!(friction > 0.0f)) continue;
      rel_vel(B, ka, kb, pk, v);
      const float vdn = dotn(v, nk, d);
      float vt[3];
      for (int i = 0; i < d; ++i) vt[i] = v[i] - vdn * nk[i];
      const float vt_norm = sqrtf(dotn(vt, vt, d));
      if (!(acc[k] > 0.0f && vt_norm > 1e-6f)) continue;
      float t[3];
      for (int i = 0; i < d; ++i) t[i] = vt[i] / vt_norm;
      const float kt = pair_mass(B, ka, kb, pk, t);
      if (!(kt > 0.0f)) continue;
      const float lim = friction * acc[k];
      const float jt = fminf(fmaxf(-vt_norm / kt, -lim), lim);
      for (int i = 0; i < d; ++i) imp[i] = jt * t[i];
      apply_pair(B, ka, kb, imp, pk);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = success).
// `lin` and `ang` are updated in place; every other pointer is read.
int salva_rigid_solve(const float* trans, const float* rot,
                      const float* inv_mass, const float* inv_inertia,
                      const int* a, const int* b, const float* p,
                      const float* n, const int* count, float* lin,
                      float* ang, int num_bodies, int K, int dim,
                      int iterations, float restitution, float friction,
                      void* stream) {
  (void)num_bodies;
  if (K > kMaxContacts || (dim != 2 && dim != 3)) return cudaErrorInvalidValue;
  Bodies B{dim, trans, rot, inv_mass, inv_inertia, lin, ang};
  rigid_solve_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      B, a, b, p, n, count, K, iterations, restitution, friction);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
