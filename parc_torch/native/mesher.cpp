// Native voxelized-trimesh builder for heightfields.
//
// C++ equivalent of the reference's Python double loop
// (util/terrain_util.py:1099-1251, timed as a startup bottleneck at
// envs/ig_env.py:503-504): each cell becomes a flat top quad plus vertical
// side quads where neighboring cells differ in height (Minecraft-style),
// with an optional skirt around the border.
//
// The simulator collides directly against the heightfield, so this mesh
// is only needed for export/visualization — but it must still be fast for
// large tiled terrains. Host code: g++ builds it at first use
// (parc_torch/cuda_build.py load_host).
//
// C ABI for ctypes (see parc_torch/utils/terrain.py hf_to_trimesh).

#include <cstdint>
#include <vector>

extern "C" {

// Pass 1: count vertices and triangles so the caller can allocate.
// Pass 2 (called with non-null outputs): fill buffers.
// verts: (num_verts, 3) float32; tris: (num_tris, 3) int32.
// Returns 0 on success, -1 on bad args.
//
// Exact element counts are returned through out_num_verts/out_num_tris.
int32_t parc_hf_mesh(const float* hf, int32_t h, int32_t w, float min_x,
                     float min_y, float dx, float dy, float skirt_depth,
                     float* verts, int32_t* tris, int64_t* out_num_verts,
                     int64_t* out_num_tris) {
  if (!hf || h <= 0 || w <= 0 || !out_num_verts || !out_num_tris) return -1;

  const bool count_only = (verts == nullptr || tris == nullptr);
  int64_t nv = 0, nt = 0;

  auto emit_quad = [&](float ax, float ay, float az, float bx, float by,
                       float bz, float cx, float cy, float cz, float dx_,
                       float dy_, float dz_) {
    // quad a-b-c-d as two triangles (a,b,c), (a,c,d)
    if (!count_only) {
      const int64_t base = nv;
      const float vs[12] = {ax, ay, az, bx, by, bz, cx, cy, cz, dx_, dy_, dz_};
      for (int k = 0; k < 12; ++k) verts[3 * base + k] = vs[k];
      tris[3 * nt + 0] = static_cast<int32_t>(base + 0);
      tris[3 * nt + 1] = static_cast<int32_t>(base + 1);
      tris[3 * nt + 2] = static_cast<int32_t>(base + 2);
      tris[3 * (nt + 1) + 0] = static_cast<int32_t>(base + 0);
      tris[3 * (nt + 1) + 1] = static_cast<int32_t>(base + 2);
      tris[3 * (nt + 1) + 2] = static_cast<int32_t>(base + 3);
    }
    nv += 4;
    nt += 2;
  };

  const float hx = dx * 0.5f, hy = dy * 0.5f;
  for (int32_t i = 0; i < h; ++i) {
    for (int32_t j = 0; j < w; ++j) {
      const float z = hf[i * w + j];
      const float cx = min_x + i * dx, cy = min_y + j * dy;
      const float x0 = cx - hx, x1 = cx + hx, y0 = cy - hy, y1 = cy + hy;
      // top quad (ccw seen from +z)
      emit_quad(x0, y0, z, x1, y0, z, x1, y1, z, x0, y1, z);
      // +x side: face toward +x if next cell (or skirt) is lower
      const float zpx = (i + 1 < h) ? hf[(i + 1) * w + j] : z - skirt_depth;
      if (zpx < z) emit_quad(x1, y0, zpx, x1, y1, zpx, x1, y1, z, x1, y0, z);
      const float zmx = (i - 1 >= 0) ? hf[(i - 1) * w + j] : z - skirt_depth;
      if (zmx < z) emit_quad(x0, y1, zmx, x0, y0, zmx, x0, y0, z, x0, y1, z);
      const float zpy = (j + 1 < w) ? hf[i * w + j + 1] : z - skirt_depth;
      if (zpy < z) emit_quad(x1, y1, zpy, x0, y1, zpy, x0, y1, z, x1, y1, z);
      const float zmy = (j - 1 >= 0) ? hf[i * w + j - 1] : z - skirt_depth;
      if (zmy < z) emit_quad(x0, y0, zmy, x1, y0, zmy, x1, y0, z, x0, y0, z);
    }
  }
  *out_num_verts = nv;
  *out_num_tris = nt;
  return 0;
}

}  // extern "C"
