// Native runtime components for mitransient_tpu.
//
// The reference's native layer is the Mitsuba3/DrJit C++ stack (ray kernels,
// loaders, schedulers — SURVEY.md section 2.2).  Here the *compute* path is
// JAX/Pallas; the host-side runtime pieces that benefit
// from native code are implemented here and bound via ctypes
// (mitransient_tpu/native.py):
//
//  * fast OBJ triangle-mesh parsing (large NLOS meshes; the Python parser is
//    the fallback and the semantic reference)
//  * median-split / binned-SAH BVH construction producing flat arrays (node
//    AABBs + topology) for a future GPU traversal of large meshes — build
//    is irregular pointer-chasing host work, best kept off the device.
//
// Build: g++ -O3 -shared -fPIC -o libmitr_native.so mitr_native.cpp
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader: returns counts first (pass 1), then fills buffers (pass 2).
// Faces are triangulated by fanning; negative indices wrap.
// ---------------------------------------------------------------------------

struct ObjCounts {
  int64_t n_verts;
  int64_t n_tris;
};

static bool obj_count(const char* path, ObjCounts* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char line[4096];
  int64_t nv = 0, nt = 0;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      nv++;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int corners = 0;
      char* p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        corners++;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
      }
      if (corners >= 3) nt += corners - 2;
    }
  }
  fclose(f);
  out->n_verts = nv;
  out->n_tris = nt;
  return true;
}

int32_t mitr_obj_count(const char* path, int64_t* n_verts, int64_t* n_tris) {
  ObjCounts c;
  if (!obj_count(path, &c)) return -1;
  *n_verts = c.n_verts;
  *n_tris = c.n_tris;
  return 0;
}

// verts: (n_verts, 3) float32;  faces: (n_tris, 3) int32
int32_t mitr_obj_load(const char* path, float* verts, int64_t n_verts,
                      int32_t* faces, int64_t n_tris) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  int64_t vi = 0, ti = 0;
  std::vector<int64_t> poly;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      if (vi >= n_verts) { fclose(f); return -2; }
      double x = 0, y = 0, z = 0;
      sscanf(line + 1, "%lf %lf %lf", &x, &y, &z);
      verts[vi * 3 + 0] = (float)x;
      verts[vi * 3 + 1] = (float)y;
      verts[vi * 3 + 2] = (float)z;
      vi++;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      poly.clear();
      char* p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        long idx = strtol(p, &p, 10);
        if (idx < 0) idx += vi + 1;  // negative indices are relative
        poly.push_back(idx - 1);
        // skip /vt/vn suffixes
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
      }
      for (size_t k = 1; k + 1 < poly.size(); k++) {
        if (ti >= n_tris) { fclose(f); return -3; }
        faces[ti * 3 + 0] = (int32_t)poly[0];
        faces[ti * 3 + 1] = (int32_t)poly[k];
        faces[ti * 3 + 2] = (int32_t)poly[k + 1];
        ti++;
      }
    }
  }
  fclose(f);
  return (vi == n_verts && ti == n_tris) ? 0 : -4;
}

// ---------------------------------------------------------------------------
// BVH builder: binned median split over triangle centroids.
// Flat output arrays (pre-allocated for 2*n_tris nodes):
//   bbox_min/bbox_max: (n_nodes, 3) f32
//   left:  (n_nodes,) i32  — child index, or -1 for leaves
//   right: (n_nodes,) i32  — child index, or first-primitive offset (leaf)
//   count: (n_nodes,) i32  — 0 for inner nodes, #prims for leaves
//   prim_order: (n_tris,) i32 — triangle permutation (leaves reference
//   contiguous ranges of this array)
// Returns the number of nodes, or -1 on error.
// ---------------------------------------------------------------------------

struct BuildCtx {
  const float* v0;
  const float* e1;
  const float* e2;
  std::vector<float> cent;   // (n, 3)
  std::vector<float> tmin;   // (n, 3)
  std::vector<float> tmax;   // (n, 3)
  float* bbox_min;
  float* bbox_max;
  int32_t* left;
  int32_t* right;
  int32_t* count;
  int32_t* order;
  int64_t n_nodes;
  int64_t max_nodes;
  int32_t leaf_size;
};

static int64_t build_node(BuildCtx& c, int32_t* prims, int64_t n) {
  if (c.n_nodes >= c.max_nodes) return -1;
  int64_t node = c.n_nodes++;
  float bmin[3] = {1e30f, 1e30f, 1e30f};
  float bmax[3] = {-1e30f, -1e30f, -1e30f};
  float cmin[3] = {1e30f, 1e30f, 1e30f};
  float cmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; i++) {
    int32_t t = prims[i];
    for (int k = 0; k < 3; k++) {
      bmin[k] = std::min(bmin[k], c.tmin[t * 3 + k]);
      bmax[k] = std::max(bmax[k], c.tmax[t * 3 + k]);
      cmin[k] = std::min(cmin[k], c.cent[t * 3 + k]);
      cmax[k] = std::max(cmax[k], c.cent[t * 3 + k]);
    }
  }
  for (int k = 0; k < 3; k++) {
    c.bbox_min[node * 3 + k] = bmin[k];
    c.bbox_max[node * 3 + k] = bmax[k];
  }
  if (n <= c.leaf_size) {
    c.left[node] = -1;
    c.right[node] = (int32_t)(prims - c.order);  // offset into prim_order
    c.count[node] = (int32_t)n;
    return node;
  }
  // split along the widest centroid axis at the median
  int axis = 0;
  float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;
  int64_t mid = n / 2;
  std::nth_element(prims, prims + mid, prims + n,
                   [&](int32_t a, int32_t b) {
                     return c.cent[a * 3 + axis] < c.cent[b * 3 + axis];
                   });
  int64_t l = build_node(c, prims, mid);
  int64_t r = build_node(c, prims + mid, n - mid);
  if (l < 0 || r < 0) return -1;
  c.left[node] = (int32_t)l;
  c.right[node] = (int32_t)r;
  c.count[node] = 0;
  return node;
}

int64_t mitr_build_bvh(const float* v0, const float* e1, const float* e2,
                       int64_t n_tris, int32_t leaf_size,
                       float* bbox_min, float* bbox_max, int32_t* left,
                       int32_t* right, int32_t* count, int32_t* prim_order) {
  if (n_tris <= 0) return -1;
  BuildCtx c;
  c.v0 = v0;
  c.e1 = e1;
  c.e2 = e2;
  c.cent.resize(n_tris * 3);
  c.tmin.resize(n_tris * 3);
  c.tmax.resize(n_tris * 3);
  for (int64_t i = 0; i < n_tris; i++) {
    for (int k = 0; k < 3; k++) {
      float a = v0[i * 3 + k];
      float b = a + e1[i * 3 + k];
      float d = a + e2[i * 3 + k];
      float lo = std::min(a, std::min(b, d));
      float hi = std::max(a, std::max(b, d));
      c.tmin[i * 3 + k] = lo;
      c.tmax[i * 3 + k] = hi;
      c.cent[i * 3 + k] = 0.5f * (lo + hi);
    }
    prim_order[i] = (int32_t)i;
  }
  c.bbox_min = bbox_min;
  c.bbox_max = bbox_max;
  c.left = left;
  c.right = right;
  c.count = count;
  c.order = prim_order;
  c.n_nodes = 0;
  c.max_nodes = 2 * n_tris;
  c.leaf_size = leaf_size > 0 ? leaf_size : 4;
  int64_t root = build_node(c, prim_order, n_tris);
  if (root < 0) return -1;
  return c.n_nodes;
}

// ---------------------------------------------------------------------------
// Binned-SAH builder (iterative, explicit stack).  Same flat output contract
// as mitr_build_bvh.  16 centroid bins on each of the 3 axes; split cost is
// the standard surface-area heuristic  SA_L*N_L + SA_R*N_R  (constant factors
// cancel when comparing splits of the same node).  Falls back to a median
// split when all centroids share a bin.  SAH buys tight, low-overlap
// subtree bounds: fewer candidate nodes per ray in a traversal.
// ---------------------------------------------------------------------------

static const int SAH_BINS = 16;

struct SahTask {
  int64_t node;    // node id already allocated for this range
  int64_t lo, hi;  // range in prim_order
};

int64_t mitr_build_bvh_sah(const float* v0, const float* e1, const float* e2,
                           int64_t n_tris, int32_t leaf_size,
                           float* bbox_min, float* bbox_max, int32_t* left,
                           int32_t* right, int32_t* count,
                           int32_t* prim_order) {
  if (n_tris <= 0) return -1;
  const int32_t leaf_n = leaf_size > 0 ? leaf_size : 4;
  std::vector<float> cent(n_tris * 3), tmin(n_tris * 3), tmax(n_tris * 3);
  for (int64_t i = 0; i < n_tris; i++) {
    for (int k = 0; k < 3; k++) {
      float a = v0[i * 3 + k];
      float b = a + e1[i * 3 + k];
      float d = a + e2[i * 3 + k];
      float lo = std::min(a, std::min(b, d));
      float hi = std::max(a, std::max(b, d));
      tmin[i * 3 + k] = lo;
      tmax[i * 3 + k] = hi;
      cent[i * 3 + k] = 0.5f * (lo + hi);
    }
    prim_order[i] = (int32_t)i;
  }
  const int64_t max_nodes = 2 * n_tris;
  int64_t n_nodes = 1;  // root pre-allocated
  std::vector<SahTask> stack;
  stack.push_back({0, 0, n_tris});

  // per-bin accumulators (reused across nodes)
  float bin_min[SAH_BINS][3], bin_max[SAH_BINS][3];
  int64_t bin_cnt[SAH_BINS];

  while (!stack.empty()) {
    SahTask task = stack.back();
    stack.pop_back();
    const int64_t node = task.node, lo = task.lo, hi = task.hi;
    const int64_t n = hi - lo;
    float bmin[3] = {1e30f, 1e30f, 1e30f};
    float bmax[3] = {-1e30f, -1e30f, -1e30f};
    float cmin[3] = {1e30f, 1e30f, 1e30f};
    float cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = lo; i < hi; i++) {
      const int32_t t = prim_order[i];
      for (int k = 0; k < 3; k++) {
        bmin[k] = std::min(bmin[k], tmin[t * 3 + k]);
        bmax[k] = std::max(bmax[k], tmax[t * 3 + k]);
        cmin[k] = std::min(cmin[k], cent[t * 3 + k]);
        cmax[k] = std::max(cmax[k], cent[t * 3 + k]);
      }
    }
    for (int k = 0; k < 3; k++) {
      bbox_min[node * 3 + k] = bmin[k];
      bbox_max[node * 3 + k] = bmax[k];
    }
    if (n <= leaf_n) {
      left[node] = -1;
      right[node] = (int32_t)lo;
      count[node] = (int32_t)n;
      continue;
    }

    // --- pick best (axis, bin split) by SAH over 16 centroid bins --------
    double best_cost = 1e300;
    int best_axis = -1, best_bin = -1;
    for (int axis = 0; axis < 3; axis++) {
      const float ext = cmax[axis] - cmin[axis];
      if (ext <= 0.0f) continue;
      const float scale = (float)SAH_BINS / ext;
      for (int b = 0; b < SAH_BINS; b++) {
        bin_cnt[b] = 0;
        for (int k = 0; k < 3; k++) {
          bin_min[b][k] = 1e30f;
          bin_max[b][k] = -1e30f;
        }
      }
      for (int64_t i = lo; i < hi; i++) {
        const int32_t t = prim_order[i];
        int b = (int)((cent[t * 3 + axis] - cmin[axis]) * scale);
        b = std::min(std::max(b, 0), SAH_BINS - 1);
        bin_cnt[b]++;
        for (int k = 0; k < 3; k++) {
          bin_min[b][k] = std::min(bin_min[b][k], tmin[t * 3 + k]);
          bin_max[b][k] = std::max(bin_max[b][k], tmax[t * 3 + k]);
        }
      }
      // left-to-right and right-to-left sweeps of area x count
      double lcost[SAH_BINS - 1], rcost[SAH_BINS - 1];
      {
        float amin[3] = {1e30f, 1e30f, 1e30f};
        float amax[3] = {-1e30f, -1e30f, -1e30f};
        int64_t cnt = 0;
        for (int b = 0; b < SAH_BINS - 1; b++) {
          cnt += bin_cnt[b];
          for (int k = 0; k < 3; k++) {
            amin[k] = std::min(amin[k], bin_min[b][k]);
            amax[k] = std::max(amax[k], bin_max[b][k]);
          }
          const double dx = std::max(0.0f, amax[0] - amin[0]);
          const double dy = std::max(0.0f, amax[1] - amin[1]);
          const double dz = std::max(0.0f, amax[2] - amin[2]);
          lcost[b] = (double)cnt * 2.0 * (dx * dy + dy * dz + dz * dx);
        }
        for (int k = 0; k < 3; k++) {
          amin[k] = 1e30f;
          amax[k] = -1e30f;
        }
        cnt = 0;
        for (int b = SAH_BINS - 1; b >= 1; b--) {
          cnt += bin_cnt[b];
          for (int k = 0; k < 3; k++) {
            amin[k] = std::min(amin[k], bin_min[b][k]);
            amax[k] = std::max(amax[k], bin_max[b][k]);
          }
          const double dx = std::max(0.0f, amax[0] - amin[0]);
          const double dy = std::max(0.0f, amax[1] - amin[1]);
          const double dz = std::max(0.0f, amax[2] - amin[2]);
          rcost[b - 1] = (double)cnt * 2.0 * (dx * dy + dy * dz + dz * dx);
        }
      }
      for (int b = 0; b < SAH_BINS - 1; b++) {
        // skip splits that leave one side empty
        int64_t nl = 0;
        for (int bb = 0; bb <= b; bb++) nl += bin_cnt[bb];
        if (nl == 0 || nl == n) continue;
        const double cost = lcost[b] + rcost[b];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }

    int64_t mid;
    if (best_axis < 0) {
      // degenerate centroid bounds: median split on the widest axis
      int axis = 0;
      float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1],
                      cmax[2] - cmin[2]};
      if (ext[1] > ext[axis]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;
      mid = lo + n / 2;
      std::nth_element(prim_order + lo, prim_order + mid, prim_order + hi,
                       [&](int32_t a, int32_t b) {
                         return cent[a * 3 + axis] < cent[b * 3 + axis];
                       });
    } else {
      const float ext = cmax[best_axis] - cmin[best_axis];
      const float scale = (float)SAH_BINS / ext;
      const float pivot_lo = cmin[best_axis];
      int32_t* first = prim_order + lo;
      int32_t* last = prim_order + hi;
      int32_t* pmid = std::partition(first, last, [&](int32_t t) {
        int b = (int)((cent[t * 3 + best_axis] - pivot_lo) * scale);
        b = std::min(std::max(b, 0), SAH_BINS - 1);
        return b <= best_bin;
      });
      mid = lo + (pmid - first);
      if (mid == lo || mid == hi) mid = lo + n / 2;  // paranoia guard
    }

    if (n_nodes + 2 > max_nodes) return -1;
    const int64_t l = n_nodes++;
    const int64_t r = n_nodes++;
    left[node] = (int32_t)l;
    right[node] = (int32_t)r;
    count[node] = 0;
    // push right first so the left child is processed next (cache-friendly,
    // and leaves end up ordered by prim range like the recursive builder)
    stack.push_back({r, mid, hi});
    stack.push_back({l, lo, mid});
  }
  return n_nodes;
}

}  // extern "C"
