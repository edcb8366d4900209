// Isosurface extraction (marching tetrahedra) for SDF grids.
//
// A copy of native/marching.cpp for the PyTorch port (built by
// unislam_tpu_torch/utils/native.py into build/): the device queries the SDF
// on a uniform grid, this library turns it into a triangle mesh on the host.
//
// Marching tetrahedra (each cell split into 6 tetrahedra around the main
// diagonal) is used instead of table-based marching cubes: no ambiguous
// cases, watertight by construction. Vertices on shared edges are deduped
// via an edge-key hash map so the mesh is indexed, not triangle soup.
//
// C ABI (ctypes): mt_run fills internally-allocated buffers; caller frees
// with mt_free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MeshBuf {
  std::vector<float> verts;   // xyz triples
  std::vector<int64_t> faces; // index triples
};

// Edge key: the two grid-linear vertex ids (a < b), packed into 128-ish bits.
struct EdgeKey {
  int64_t a, b;
  bool operator==(const EdgeKey &o) const { return a == o.a && b == o.b; }
};
struct EdgeKeyHash {
  size_t operator()(const EdgeKey &k) const {
    return std::hash<int64_t>()(k.a * 2654435761LL) ^
           std::hash<int64_t>()(k.b + 0x9e3779b97f4a7c15LL);
  }
};

class Extractor {
public:
  Extractor(const float *grid, int64_t nx, int64_t ny, int64_t nz, float iso)
      : g_(grid), nx_(nx), ny_(ny), nz_(nz), iso_(iso) {}

  // grid layout: value(x, y, z) = grid[(x * ny + y) * nz + z]
  float val(int64_t x, int64_t y, int64_t z) const {
    return g_[(x * ny_ + y) * nz_ + z];
  }
  int64_t vid(int64_t x, int64_t y, int64_t z) const {
    return (x * ny_ + y) * nz_ + z;
  }

  int64_t edge_vertex(int64_t va, int64_t vb, float fa, float fb) {
    if (va > vb) {
      std::swap(va, vb);
      std::swap(fa, fb);
    }
    EdgeKey key{va, vb};
    auto it = edge_map_.find(key);
    if (it != edge_map_.end()) return it->second;
    // linear interpolation to the iso crossing
    float denom = fb - fa;
    float t = (denom == 0.0f) ? 0.5f : (iso_ - fa) / denom;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    int64_t az = va % nz_, ay = (va / nz_) % ny_, ax = va / (nz_ * ny_);
    int64_t bz = vb % nz_, by = (vb / nz_) % ny_, bx = vb / (nz_ * ny_);
    int64_t id = (int64_t)(mesh_.verts.size() / 3);
    mesh_.verts.push_back(ax + t * (bx - ax));
    mesh_.verts.push_back(ay + t * (by - ay));
    mesh_.verts.push_back(az + t * (bz - az));
    edge_map_.emplace(key, id);
    return id;
  }

  // Emit with consistent orientation: the face normal must point away from
  // the inside (f < iso) region, whose representative point (grid coords) is
  // in in_pt_.
  void emit_tri(int64_t i0, int64_t i1, int64_t i2) {
    if (i0 == i1 || i1 == i2 || i0 == i2) return; // degenerate
    const float *p0 = &mesh_.verts[i0 * 3];
    const float *p1 = &mesh_.verts[i1 * 3];
    const float *p2 = &mesh_.verts[i2 * 3];
    float e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    float e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                  e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float c[3] = {(p0[0] + p1[0] + p2[0]) / 3.f - in_pt_[0],
                  (p0[1] + p1[1] + p2[1]) / 3.f - in_pt_[1],
                  (p0[2] + p1[2] + p2[2]) / 3.f - in_pt_[2]};
    float dot = n[0] * c[0] + n[1] * c[1] + n[2] * c[2];
    if (dot < 0.f) std::swap(i1, i2);
    mesh_.faces.push_back(i0);
    mesh_.faces.push_back(i1);
    mesh_.faces.push_back(i2);
  }

  // Process one tetrahedron given grid-vertex ids and values. Triangles are
  // oriented so the face normal points toward the negative (inside) side.
  void tet(const int64_t v[4], const float f[4]) {
    int inside = 0;
    int code = 0;
    for (int i = 0; i < 4; i++) {
      if (f[i] < iso_) {
        code |= (1 << i);
        inside++;
      }
    }
    if (inside == 0 || inside == 4) return;

    // indices of inside / outside vertices
    int in_idx[4], out_idx[4], ni = 0, no = 0;
    for (int i = 0; i < 4; i++) {
      if (code & (1 << i)) in_idx[ni++] = i;
      else out_idx[no++] = i;
    }

    // representative inside point = mean of inside grid vertices
    in_pt_[0] = in_pt_[1] = in_pt_[2] = 0.f;
    for (int k = 0; k < ni; k++) {
      int64_t id = v[in_idx[k]];
      in_pt_[0] += (float)(id / (nz_ * ny_));
      in_pt_[1] += (float)((id / nz_) % ny_);
      in_pt_[2] += (float)(id % nz_);
    }
    in_pt_[0] /= ni; in_pt_[1] /= ni; in_pt_[2] /= ni;

    if (inside == 1) {
      int a = in_idx[0];
      int64_t e0 = edge_vertex(v[a], v[out_idx[0]], f[a], f[out_idx[0]]);
      int64_t e1 = edge_vertex(v[a], v[out_idx[1]], f[a], f[out_idx[1]]);
      int64_t e2 = edge_vertex(v[a], v[out_idx[2]], f[a], f[out_idx[2]]);
      emit_tri(e0, e1, e2);
    } else if (inside == 3) {
      int a = out_idx[0];
      int64_t e0 = edge_vertex(v[a], v[in_idx[0]], f[a], f[in_idx[0]]);
      int64_t e1 = edge_vertex(v[a], v[in_idx[1]], f[a], f[in_idx[1]]);
      int64_t e2 = edge_vertex(v[a], v[in_idx[2]], f[a], f[in_idx[2]]);
      emit_tri(e0, e1, e2);
    } else { // 2-2: quad split into two triangles
      int a0 = in_idx[0], a1 = in_idx[1];
      int b0 = out_idx[0], b1 = out_idx[1];
      int64_t e00 = edge_vertex(v[a0], v[b0], f[a0], f[b0]);
      int64_t e01 = edge_vertex(v[a0], v[b1], f[a0], f[b1]);
      int64_t e10 = edge_vertex(v[a1], v[b0], f[a1], f[b0]);
      int64_t e11 = edge_vertex(v[a1], v[b1], f[a1], f[b1]);
      emit_tri(e00, e01, e11);
      emit_tri(e00, e11, e10);
    }
  }

  void run() {
    // 6-tetrahedra decomposition of the unit cube around diagonal (0 -> 7).
    // Cube corner numbering: bit0 -> +x, bit1 -> +y, bit2 -> +z.
    static const int tets[6][4] = {
        {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
        {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
    };
    for (int64_t x = 0; x + 1 < nx_; x++) {
      for (int64_t y = 0; y + 1 < ny_; y++) {
        for (int64_t z = 0; z + 1 < nz_; z++) {
          // skip cells with no crossing (fast path)
          float f0 = val(x, y, z);
          bool lo = f0 < iso_, hi = !lo, any_lo = lo, any_hi = hi;
          float fc[8];
          int64_t vc[8];
          fc[0] = f0;
          vc[0] = vid(x, y, z);
          for (int c = 1; c < 8; c++) {
            int64_t cx = x + ((c & 1) ? 1 : 0);
            int64_t cy = y + ((c & 2) ? 1 : 0);
            int64_t cz = z + ((c & 4) ? 1 : 0);
            fc[c] = val(cx, cy, cz);
            vc[c] = vid(cx, cy, cz);
            any_lo |= fc[c] < iso_;
            any_hi |= fc[c] >= iso_;
          }
          if (!any_lo || !any_hi) continue;
          for (int t = 0; t < 6; t++) {
            int64_t v[4];
            float f[4];
            for (int k = 0; k < 4; k++) {
              v[k] = vc[tets[t][k]];
              f[k] = fc[tets[t][k]];
            }
            tet(v, f);
          }
        }
      }
    }
  }

  MeshBuf mesh_;

private:
  const float *g_;
  int64_t nx_, ny_, nz_;
  float iso_;
  float in_pt_[3] = {0.f, 0.f, 0.f};
  std::unordered_map<EdgeKey, int64_t, EdgeKeyHash> edge_map_;
};

} // namespace

extern "C" {

// Returns 0 on success. Outputs are malloc'd; free with mt_free.
int mt_run(const float *grid, int64_t nx, int64_t ny, int64_t nz, float iso,
           float **out_verts, int64_t *n_verts, int64_t **out_faces,
           int64_t *n_faces) {
  Extractor ex(grid, nx, ny, nz, iso);
  ex.run();
  *n_verts = (int64_t)(ex.mesh_.verts.size() / 3);
  *n_faces = (int64_t)(ex.mesh_.faces.size() / 3);
  *out_verts = (float *)std::malloc(ex.mesh_.verts.size() * sizeof(float));
  *out_faces =
      (int64_t *)std::malloc(ex.mesh_.faces.size() * sizeof(int64_t));
  if ((*out_verts == nullptr && !ex.mesh_.verts.empty()) ||
      (*out_faces == nullptr && !ex.mesh_.faces.empty()))
    return 1;
  std::memcpy(*out_verts, ex.mesh_.verts.data(),
              ex.mesh_.verts.size() * sizeof(float));
  std::memcpy(*out_faces, ex.mesh_.faces.data(),
              ex.mesh_.faces.size() * sizeof(int64_t));
  return 0;
}

void mt_free(void *p) { std::free(p); }

// Frustum-visibility mask used by mesh culling (cull_mesh.py rewrite):
// for each point, test projection into a camera with intrinsics K and
// world-to-camera matrix w2c (OpenGL camera: visible z < 0, x negated
// before projection like the reference, cull_mesh.py:78-94). depth_img may
// be null (no depth test). Marks mask[i] = 1 when visible in this view.
void frustum_mask(const float *points, int64_t n_points, const float *w2c,
                  float fx, float fy, float cx, float cy, int64_t W,
                  int64_t H, const float *depth_img, float trunc,
                  uint8_t *mask) {
  for (int64_t i = 0; i < n_points; i++) {
    const float *p = points + i * 3;
    float cxp = w2c[0] * p[0] + w2c[1] * p[1] + w2c[2] * p[2] + w2c[3];
    float cyp = w2c[4] * p[0] + w2c[5] * p[1] + w2c[6] * p[2] + w2c[7];
    float czp = w2c[8] * p[0] + w2c[9] * p[1] + w2c[10] * p[2] + w2c[11];
    cxp = -cxp; // reference negates camera x before projecting
    float z = czp + 1e-5f;
    float u = (fx * cxp + cx * z) / z;
    float v = (fy * cyp + cy * z) / z;
    if (!(z < 0.f)) continue;
    if (!(u > 0.f && u < (float)W && v > 0.f && v < (float)H)) continue;
    if (depth_img != nullptr) {
      // bilinear depth sample (align_corners=True convention)
      float gu = u, gv = v;
      int64_t u0 = (int64_t)gu, v0 = (int64_t)gv;
      if (u0 < 0) u0 = 0;
      if (v0 < 0) v0 = 0;
      if (u0 > W - 2) u0 = W - 2;
      if (v0 > H - 2) v0 = H - 2;
      float du = gu - u0, dv = gv - v0;
      const float *d = depth_img;
      float d00 = d[v0 * W + u0], d01 = d[v0 * W + u0 + 1];
      float d10 = d[(v0 + 1) * W + u0], d11 = d[(v0 + 1) * W + u0 + 1];
      float ds = d00 * (1 - du) * (1 - dv) + d01 * du * (1 - dv) +
                 d10 * (1 - du) * dv + d11 * du * dv;
      if (!(ds + trunc >= -z)) continue;
    }
    mask[i] = 1;
  }
}

// Depth rasterizer (z-buffer) for triangle meshes, OpenGL-style camera
// (camera x negated before projection, -z forward; depth output = -z_cam).
// Replaces open3d's offscreen depth render used by the original 2D
// reconstruction metric.
void rasterize_depth(const float *verts, int64_t n_verts,
                     const int64_t *faces, int64_t n_faces, const float *w2c,
                     float fx, float fy, float cx, float cy, int64_t W,
                     int64_t H, float *depth_out) {
  for (int64_t i = 0; i < W * H; i++) depth_out[i] = 0.f;

  std::vector<float> u(n_verts), v(n_verts), z(n_verts);
  for (int64_t i = 0; i < n_verts; i++) {
    const float *p = verts + i * 3;
    float cxp = w2c[0] * p[0] + w2c[1] * p[1] + w2c[2] * p[2] + w2c[3];
    float cyp = w2c[4] * p[0] + w2c[5] * p[1] + w2c[6] * p[2] + w2c[7];
    float czp = w2c[8] * p[0] + w2c[9] * p[1] + w2c[10] * p[2] + w2c[11];
    cxp = -cxp;
    z[i] = -czp; // positive depth in front of the camera
    if (z[i] > 1e-6f) {
      // divide by the (negative) camera z, like the reference projection
      u[i] = fx * cxp / czp + cx;
      v[i] = fy * cyp / czp + cy;
    } else {
      u[i] = -1e9f;
      v[i] = -1e9f;
    }
  }

  for (int64_t t = 0; t < n_faces; t++) {
    int64_t i0 = faces[t * 3], i1 = faces[t * 3 + 1], i2 = faces[t * 3 + 2];
    float z0 = z[i0], z1 = z[i1], z2 = z[i2];
    if (z0 <= 1e-6f || z1 <= 1e-6f || z2 <= 1e-6f) continue; // clip
    float u0 = u[i0], v0 = v[i0], u1 = u[i1], v1 = v[i1], u2 = u[i2],
          v2 = v[i2];
    float min_u = std::min(u0, std::min(u1, u2));
    float max_u = std::max(u0, std::max(u1, u2));
    float min_v = std::min(v0, std::min(v1, v2));
    float max_v = std::max(v0, std::max(v1, v2));
    int64_t x0 = (int64_t)std::max(0.f, std::floor(min_u));
    int64_t x1 = (int64_t)std::min((float)(W - 1), std::ceil(max_u));
    int64_t y0 = (int64_t)std::max(0.f, std::floor(min_v));
    int64_t y1 = (int64_t)std::min((float)(H - 1), std::ceil(max_v));
    if (x0 > x1 || y0 > y1) continue;
    float denom = (v1 - v2) * (u0 - u2) + (u2 - u1) * (v0 - v2);
    if (std::abs(denom) < 1e-12f) continue;
    float inv_z0 = 1.f / z0, inv_z1 = 1.f / z1, inv_z2 = 1.f / z2;
    for (int64_t y = y0; y <= y1; y++) {
      for (int64_t x = x0; x <= x1; x++) {
        float l0 = ((v1 - v2) * (x - u2) + (u2 - u1) * (y - v2)) / denom;
        float l1 = ((v2 - v0) * (x - u2) + (u0 - u2) * (y - v2)) / denom;
        float l2 = 1.f - l0 - l1;
        if (l0 < -1e-5f || l1 < -1e-5f || l2 < -1e-5f) continue;
        // perspective-correct depth
        float zz = 1.f / (l0 * inv_z0 + l1 * inv_z1 + l2 * inv_z2);
        float *d = &depth_out[y * W + x];
        if (*d == 0.f || zz < *d) *d = zz;
      }
    }
  }
}

} // extern "C"
