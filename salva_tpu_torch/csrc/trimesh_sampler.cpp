// Triangle-mesh boundary-particle sampler (host-side C++ of
// salva_tpu_torch; the same code as salva_tpu's native/trimesh_sampler.cpp,
// so both packages sample a mesh to the same points).
//
// Re-implements the semantics of the reference's ray-cast shape sampling
// (src/sampling/ray_sampling.rs) for arbitrary triangle meshes, which the
// SDF lattice sampler (salva_tpu_torch/sampling/shape_sampling.py) cannot
// handle: axis-aligned rays on a (2 * radius) lattice, Moller-Trumbore
// triangle intersection, quantized-hit dedup for surface sampling
// (ray_sampling.rs:27-88) and even-odd span fill for volume sampling
// (ray_sampling.rs:91-164).
//
// Exposed as a C ABI consumed through ctypes (salva_tpu_torch/native.py),
// built with g++ at first use (salva_tpu_torch/ops/_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_set>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// Moller-Trumbore: distance t of ray (origin, dir) hitting triangle, or
// negative if no hit. dir is a unit axis vector.
inline bool ray_tri(V3 orig, V3 dir, V3 v0, V3 v1, V3 v2, float* t_out) {
  const float kEps = 1e-9f;
  V3 e1 = sub(v1, v0);
  V3 e2 = sub(v2, v0);
  V3 p = cross(dir, e2);
  float det = dot(e1, p);
  if (std::fabs(det) < kEps) return false;
  float inv_det = 1.0f / det;
  V3 tv = sub(orig, v0);
  float u = dot(tv, p) * inv_det;
  if (u < -1e-6f || u > 1.0f + 1e-6f) return false;
  V3 q = cross(tv, e1);
  float v = dot(dir, q) * inv_det;
  if (v < -1e-6f || u + v > 1.0f + 1e-6f) return false;
  float t = dot(e2, q) * inv_det;
  if (t < 0.0f) return false;
  *t_out = t;
  return true;
}

struct Key {
  int64_t a, b, c;
  bool operator==(const Key& o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    // FNV-1a over the three coordinates (the reference's grids hash with
    // a deterministic FNV too, hgrid.rs:10-18).
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](int64_t v) {
      for (int i = 0; i < 8; i++) {
        h ^= (uint64_t)(v >> (i * 8)) & 0xff;
        h *= 1099511628211ull;
      }
    };
    mix(k.a);
    mix(k.b);
    mix(k.c);
    return (size_t)h;
  }
};

void mesh_aabb(const float* verts, int nv, V3* mn, V3* mx) {
  mn->x = mn->y = mn->z = 1e30f;
  mx->x = mx->y = mx->z = -1e30f;
  for (int i = 0; i < nv; i++) {
    V3 v = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    mn->x = std::min(mn->x, v.x);
    mn->y = std::min(mn->y, v.y);
    mn->z = std::min(mn->z, v.z);
    mx->x = std::max(mx->x, v.x);
    mx->y = std::max(mx->y, v.y);
    mx->z = std::max(mx->z, v.z);
  }
}

// Collect sorted hit distances of one ray against all triangles.
void ray_hits(const float* verts, const int32_t* tris, int nt, V3 orig,
              V3 dir, std::vector<float>* hits) {
  hits->clear();
  for (int t = 0; t < nt; t++) {
    V3 v0 = {verts[3 * tris[3 * t]], verts[3 * tris[3 * t] + 1],
             verts[3 * tris[3 * t] + 2]};
    V3 v1 = {verts[3 * tris[3 * t + 1]], verts[3 * tris[3 * t + 1] + 1],
             verts[3 * tris[3 * t + 1] + 2]};
    V3 v2 = {verts[3 * tris[3 * t + 2]], verts[3 * tris[3 * t + 2] + 1],
             verts[3 * tris[3 * t + 2] + 2]};
    float tt;
    if (ray_tri(orig, dir, v0, v1, v2, &tt)) hits->push_back(tt);
  }
  std::sort(hits->begin(), hits->end());
  // Merge duplicate hits on shared triangle edges.
  hits->erase(std::unique(hits->begin(), hits->end(),
                          [](float a, float b) {
                            return std::fabs(a - b) < 1e-6f;
                          }),
              hits->end());
}

}  // namespace

extern "C" {

// Surface sampling: one quantized point per ray/surface crossing.
// Returns the number of points written (<= max_out); negative on error.
int trimesh_surface_sample(const float* verts, int nv, const int32_t* tris,
                           int nt, float radius, float* out, int max_out) {
  if (nv <= 0 || nt <= 0 || radius <= 0.0f) return -1;
  const float spacing = 2.0f * radius;
  V3 mn, mx;
  mesh_aabb(verts, nv, &mn, &mx);

  std::unordered_set<Key, KeyHash> seen;
  std::vector<float> hits;
  int count = 0;

  const V3 axes[3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int axis = 0; axis < 3; axis++) {
    int u = (axis + 1) % 3;
    int w = (axis + 2) % 3;
    float mn_a = (axis == 0) ? mn.x : (axis == 1) ? mn.y : mn.z;
    float mn_u = (u == 0) ? mn.x : (u == 1) ? mn.y : mn.z;
    float mx_u = (u == 0) ? mx.x : (u == 1) ? mx.y : mx.z;
    float mn_w = (w == 0) ? mn.x : (w == 1) ? mn.y : mn.z;
    float mx_w = (w == 0) ? mx.x : (w == 1) ? mx.y : mx.z;

    for (float cu = mn_u; cu <= mx_u + spacing * 0.5f; cu += spacing) {
      for (float cw = mn_w; cw <= mx_w + spacing * 0.5f; cw += spacing) {
        float o[3];
        o[axis] = mn_a - spacing;
        o[u] = cu;
        o[w] = cw;
        V3 orig = {o[0], o[1], o[2]};
        ray_hits(verts, tris, nt, orig, axes[axis], &hits);
        for (float t : hits) {
          float p[3] = {orig.x, orig.y, orig.z};
          p[axis] += t;
          // Quantize to the lattice, dedup (ray_sampling.rs:193-207).
          Key k = {(int64_t)std::llround(p[0] / radius),
                   (int64_t)std::llround(p[1] / radius),
                   (int64_t)std::llround(p[2] / radius)};
          if (seen.insert(k).second) {
            if (count >= max_out) return count;
            out[3 * count] = k.a * radius;
            out[3 * count + 1] = k.b * radius;
            out[3 * count + 2] = k.c * radius;
            count++;
          }
        }
      }
    }
  }
  return count;
}

// Volume sampling: lattice points between alternating (enter, exit) hit
// pairs along the x axis (even-odd rule), plus the quantized surface.
int trimesh_volume_sample(const float* verts, int nv, const int32_t* tris,
                          int nt, float radius, float* out, int max_out) {
  if (nv <= 0 || nt <= 0 || radius <= 0.0f) return -1;
  const float spacing = 2.0f * radius;
  V3 mn, mx;
  mesh_aabb(verts, nv, &mn, &mx);

  std::unordered_set<Key, KeyHash> seen;
  std::vector<float> hits;
  int count = 0;

  for (float cy = mn.y; cy <= mx.y + spacing * 0.5f; cy += spacing) {
    for (float cz = mn.z; cz <= mx.z + spacing * 0.5f; cz += spacing) {
      V3 orig = {mn.x - spacing, cy, cz};
      ray_hits(verts, tris, nt, orig, {1, 0, 0}, &hits);
      for (size_t i = 0; i + 1 < hits.size(); i += 2) {
        float x0 = orig.x + hits[i];
        float x1 = orig.x + hits[i + 1];
        for (float x = x0; x <= x1 + 1e-6f; x += spacing) {
          Key k = {(int64_t)std::llround(x / radius),
                   (int64_t)std::llround(cy / radius),
                   (int64_t)std::llround(cz / radius)};
          if (seen.insert(k).second) {
            if (count >= max_out) return count;
            out[3 * count] = k.a * radius;
            out[3 * count + 1] = k.b * radius;
            out[3 * count + 2] = k.c * radius;
            count++;
          }
        }
      }
    }
  }
  return count;
}

}  // extern "C"
