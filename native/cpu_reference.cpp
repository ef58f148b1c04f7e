// CPU oracle renderer for relativitypathtracer_tpu.
//
// Implements the same per-pixel render algorithm as the reference's device
// kernel (/root/reference/opencl_kernel.cl:55-660) -- camera rays, 4D
// rest-frame transforms, sphere/cube analytic intersectors, stackless
// neighbor-walk octree traversal, retarded-time direct lighting with shadow
// rays, proper-time flash, Hable tonemap -- as standalone C++17 operating on
// a scene blob produced by utils/scene_blob.py. Written from the algorithm
// spec (SURVEY.md sections 2-3), not copied source.
//
// Dual role:
//   1. Differential-testing oracle: renders all scenes deterministically so
//      the JAX renderer can be compared per-pixel (<= 1e-3 RGB).
//   2. Performance baseline: the "OpenCL-on-CPU" stand-in the accelerator
//      build is measured against (BASELINE.md protocol), with -j threads.
//
// Usage: cpu_reference <scene.blob> <out.rgb32f> [frames] [threads]
// Prints one JSON line with timing to stdout.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kEps = 1e-7f;
constexpr float kInf = 1e20f;

struct V3 {
  float x = 0, y = 0, z = 0;
};
struct V4 {
  float t = 0, x = 0, y = 0, z = 0;
};

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
inline V3 operator/(V3 a, V3 b) { return {a.x / b.x, a.y / b.y, a.z / b.z}; }
inline V3 mul3(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline float dot(V4 a, V4 b) { return a.t * b.t + a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float len(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 norm(V3 a) { return a / len(a); }
inline V4 operator+(V4 a, V4 b) { return {a.t + b.t, a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V4 operator*(V4 a, float s) { return {a.t * s, a.x * s, a.y * s, a.z * s}; }
inline V3 spatial(V4 a) { return {a.x, a.y, a.z}; }

struct Mat4 {
  V4 row[4];
};

inline V4 apply(const Mat4 &m, V4 v) {
  return {dot(m.row[0], v), dot(m.row[1], v), dot(m.row[2], v), dot(m.row[3], v)};
}
inline V3 applyPoint(const Mat4 &m, V3 p) {
  V4 v{p.x, p.y, p.z, 1.0f};  // affine rows laid out (x,y,z,w)
  return {dot(m.row[0], v), dot(m.row[1], v), dot(m.row[2], v)};
}
inline V3 applyDir(const Mat4 &m, V3 d) {
  return {m.row[0].t * d.x + m.row[0].x * d.y + m.row[0].y * d.z,
          m.row[1].t * d.x + m.row[1].x * d.y + m.row[1].y * d.z,
          m.row[2].t * d.x + m.row[2].x * d.y + m.row[2].y * d.z};
}
// Inverse-transpose trick for normals: (M^-1)^T n using the 3x3 block.
inline V3 applyNormal(const Mat4 &inv, V3 n) {
  V3 r0{inv.row[0].t, inv.row[0].x, inv.row[0].y};
  V3 r1{inv.row[1].t, inv.row[1].x, inv.row[1].y};
  V3 r2{inv.row[2].t, inv.row[2].x, inv.row[2].y};
  return r0 * n.x + r1 * n.y + r2 * n.z;
}

enum ObjType : int32_t { kSphere = 0, kCube = 1, kMesh = 2 };

struct Object {
  Mat4 M, InvM, Lor, InvLor;
  V4 statCam;
  V3 color;
  int32_t type, meshRoot, texOffset, texW, texH, light;
  float flashPeriod, flashDuration;
};

struct Node {
  V3 bmin, bmax;
  int32_t trisIndex, trisCount;
  int32_t children[8];
  int32_t neighbors[6];
};

struct Scene {
  uint32_t width, height;
  int32_t interval;
  V3 whitePoint;
  float ambient;
  std::vector<Object> objects;
  std::vector<V3> verts;
  std::vector<int32_t> tris;  // 9 ints per tri: [v, uv, n] x 3
  std::vector<float> uvs;     // 2 per entry
  std::vector<V3> normals;
  std::vector<Node> nodes;
  std::vector<int32_t> octTris;
  std::vector<uint8_t> tex;
};

struct Ray {
  V3 o, d;
};
struct Ray4 {
  V4 o, d;
};

struct Hit {
  float dist = kInf;
  V3 normal{};
  float u = 0, v = 0;  // surface UV after attribute interpolation
  V3 color{};
  int object = -1;
};

bool readBlob(const char *path, Scene &s) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  // Every short read (truncated/garbled blob) must fail the load: a Scene
  // built from partial reads renders a wrong image with exit code 0 and
  // shows up downstream as an inexplicable parity mismatch.
  bool okAll = true;
  auto rd = [&](void *p, size_t n) {
    bool k = std::fread(p, 1, n, f) == n;
    okAll &= k;
    return k;
  };
  char magic[4];
  uint32_t version = 0;
  if (!rd(magic, 4) || std::memcmp(magic, "RPTB", 4) != 0) return false;
  rd(&version, 4);
  if (version != 3) return false;
  rd(&s.width, 4);
  rd(&s.height, 4);
  rd(&s.interval, 4);
  rd(&s.whitePoint, 12);
  rd(&s.ambient, 4);
  uint32_t n = 0;
  rd(&n, 4);
  s.objects.resize(n);
  for (auto &o : s.objects) {
    rd(&o.M, 64);
    rd(&o.InvM, 64);
    rd(&o.Lor, 64);
    rd(&o.InvLor, 64);
    rd(&o.statCam, 16);
    rd(&o.color, 12);
    rd(&o.type, 4);
    rd(&o.meshRoot, 4);
    rd(&o.texOffset, 4);
    rd(&o.texW, 4);
    rd(&o.texH, 4);
    rd(&o.light, 4);
    rd(&o.flashPeriod, 4);
    rd(&o.flashDuration, 4);
  }
  uint32_t c = 0;
  rd(&c, 4);
  s.verts.resize(c);
  rd(s.verts.data(), c * 12);
  rd(&c, 4);
  s.tris.resize(size_t(c) * 9);
  rd(s.tris.data(), size_t(c) * 36);
  rd(&c, 4);
  s.uvs.resize(size_t(c) * 2);
  rd(s.uvs.data(), size_t(c) * 8);
  rd(&c, 4);
  s.normals.resize(c);
  rd(s.normals.data(), c * 12);
  rd(&c, 4);
  s.nodes.resize(c);
  for (auto &nd : s.nodes) {
    rd(&nd.bmin, 12);
    rd(&nd.bmax, 12);
    rd(&nd.trisIndex, 4);
    rd(&nd.trisCount, 4);
    rd(nd.children, 32);
    rd(nd.neighbors, 24);
  }
  rd(&c, 4);
  s.octTris.resize(c);
  rd(s.octTris.data(), c * 4);
  uint64_t tb = 0;
  rd(&tb, 8);
  s.tex.resize(tb);
  if (tb != 0) rd(s.tex.data(), tb);
  std::fclose(f);
  return okAll;
}

Ray cameraRay(float px, float py, int w, int h) {
  float aspect = float(w) / float(h);
  V3 plane{(px / w - 0.5f) * aspect, py / h - 0.5f, 0.5f};
  return {V3{0, 0, 0}, norm(plane)};
}

bool hitSphere(const Object &ob, const Ray4 &r, Hit &h) {
  V3 toCenter = -applyPoint(ob.InvM, spatial(r.o));
  V3 d = applyDir(ob.InvM, spatial(r.d));
  float sc = len(d);
  d = d / sc;
  float b = dot(toCenter, d);
  float c = dot(toCenter, toCenter) - 1.0f;
  float disc = b * b - c;
  if (disc < 0.0f) return false;
  float sq = std::sqrt(disc);
  float dist;
  if (b - sq > kEps)
    dist = b - sq;
  else if (b + sq > kEps)
    dist = b + sq;
  else
    return false;
  V3 p = -toCenter + d * dist;
  h.dist = dist / sc;
  h.normal = norm(applyNormal(ob.InvM, p));
  h.u = 0.5f + std::atan2(p.z, p.x) / (2.0f * float(M_PI));
  h.v = std::asin(std::min(1.0f, std::max(-1.0f, p.y))) / float(M_PI) + 0.5f;
  return true;
}

bool hitCube(const Object &ob, const Ray4 &r, Hit &h) {
  V3 o = applyPoint(ob.InvM, spatial(r.o));
  V3 d = applyDir(ob.InvM, spatial(r.d));
  float sc = len(d);
  d = d / sc;
  float winding = std::max(std::max(std::fabs(o.x), std::fabs(o.y)), std::fabs(o.z)) < 1.0f ? -1.0f : 1.0f;
  V3 sg{-(d.x > 0 ? 1.0f : (d.x < 0 ? -1.0f : 0.0f)),
        -(d.y > 0 ? 1.0f : (d.y < 0 ? -1.0f : 0.0f)),
        -(d.z > 0 ? 1.0f : (d.z < 0 ? -1.0f : 0.0f))};
  V3 dc{(winding * sg.x - o.x) / d.x, (winding * sg.y - o.y) / d.y, (winding * sg.z - o.z) / d.z};
  auto faceOk = [&](float dv, float p1, float q1) {
    return dv >= 0.0f && std::fabs(p1) < 1.0f && std::fabs(q1) < 1.0f;
  };
  bool tx = faceOk(dc.x, o.y + d.y * dc.x, o.z + d.z * dc.x);
  bool ty = faceOk(dc.y, o.z + d.z * dc.y, o.x + d.x * dc.y);
  bool tz = faceOk(dc.z, o.x + d.x * dc.z, o.y + d.y * dc.z);
  V3 sel{0, 0, 0};
  if (tx)
    sel = {sg.x, 0, 0};
  else if (ty)
    sel = {0, sg.y, 0};
  else if (tz)
    sel = {0, 0, sg.z};
  if (sel.x == 0 && sel.y == 0 && sel.z == 0) return false;
  float dist = sel.x != 0 ? dc.x : (sel.y != 0 ? dc.y : dc.z);
  V3 p = o + d * dist;
  h.dist = dist / sc;
  h.normal = norm(applyNormal(ob.InvM, sel));
  if (sel.x != 0) {
    h.u = (p.y + 1) / 2;
    h.v = (p.z + 1) / 2;
  } else if (sel.y != 0) {
    h.u = (p.x + 1) / 2;
    h.v = (p.z + 1) / 2;
  } else {
    h.u = (p.x + 1) / 2;
    h.v = (p.y + 1) / 2;
  }
  return true;
}

bool hitTriangle(V3 A, V3 B, V3 C, const Ray &r, float &dist, float &u, float &v) {
  V3 e1 = B - A, e2 = C - A;
  V3 p = cross(r.d, e2);
  float det = dot(e1, p);
  if (det < kEps && det > -kEps) return false;
  float inv = 1.0f / det;
  V3 tv = r.o - A;
  u = dot(tv, p) * inv;
  if (u < 0 || u > 1) return false;
  V3 q = cross(tv, e1);
  v = dot(r.d, q) * inv;
  if (v < 0 || u + v > 1) return false;
  dist = dot(e2, q) * inv;
  return true;
}

// Slab AABB test returning entry/exit distances and face ids. Face ids:
// 0/1 = z-/z+, 2/3 = x-/x+, 4/5 = y-/y+ (matches the octree neighbor order).
// Deliberately reproduces the reference's branchless form INCLUDING its
// 0*inf NaN behavior on axis-parallel rays originating on a slab plane
// (opencl_kernel.cl:128-170): this binary is the differential oracle, so
// faithfulness beats robustness here (the JAX renderer itself uses a
// NaN-safe reciprocal instead -- ops/pallas/mesh_kernels._safe_inv).
bool hitAABB(V3 bmin, V3 bmax, const Ray &r, float &d0, float &d1, int &nearFace, int &farFace) {
  V3 inv{1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z};
  int sx = inv.x < 0, sy = inv.y < 0, sz = inv.z < 0;
  const V3 *b[2] = {&bmin, &bmax};
  d0 = (b[sx]->x - r.o.x) * inv.x;
  d1 = (b[1 - sx]->x - r.o.x) * inv.x;
  nearFace = 2 + sx;
  farFace = 3 - sx;
  float tymin = (b[sy]->y - r.o.y) * inv.y;
  float tymax = (b[1 - sy]->y - r.o.y) * inv.y;
  if (d0 > tymax || tymin > d1) return false;
  if (tymin > d0) {
    d0 = tymin;
    nearFace = 4 + sy;
  }
  if (tymax < d1) {
    d1 = tymax;
    farFace = 5 - sy;
  }
  float tzmin = (b[sz]->z - r.o.z) * inv.z;
  float tzmax = (b[1 - sz]->z - r.o.z) * inv.z;
  if (d0 > tzmax || tzmin > d1) return false;
  if (tzmin > d0) {
    d0 = tzmin;
    nearFace = sz;
  }
  if (tzmax < d1) {
    d1 = tzmax;
    farFace = 1 - sz;
  }
  return d1 > 0;
}

// Advance a unit-cube-normalized position to the exit face along scaledDir;
// returns the exit face id.
int exitFace(V3 sdir, V3 &pos) {
  V3 inv{1.0f / sdir.x, 1.0f / sdir.y, 1.0f / sdir.z};
  int sx = inv.x < 0, sy = inv.y < 0, sz = inv.z < 0;
  float dx = (1 - sx - pos.x) * inv.x;
  float dy = (1 - sy - pos.y) * inv.y;
  float dz = (1 - sz - pos.z) * inv.z;
  if (dx < dy) {
    if (dx < dz) {
      pos = pos + sdir * dx;
      return 3 - sx;
    }
    pos = pos + sdir * dz;
    return 1 - sz;
  }
  if (dy < dz) {
    pos = pos + sdir * dy;
    return 5 - sy;
  }
  pos = pos + sdir * dz;
  return 1 - sz;
}

// Stackless octree traversal: descend to the entry leaf, then neighbor-walk
// through face exits, testing each leaf's triangle list.
bool hitMesh(const Scene &s, const Object &ob, const Ray4 &ray, Hit &h,
             uint64_t *triTests) {
  Ray r{applyPoint(ob.InvM, spatial(ray.o)), applyDir(ob.InvM, spatial(ray.d))};
  float sc = len(r.d);
  r.d = r.d / sc;

  int ni = ob.meshRoot;
  float d0, d1;
  int nearF, farF;
  if (!hitAABB(s.nodes[ni].bmin, s.nodes[ni].bmax, r, d0, d1, nearF, farF)) return false;
  V3 pos = r.o + r.d * d0;

  if (d0 < 0) {
    // Origin inside: descend from the root by normalized position.
    const Node *nd = &s.nodes[ni];
    pos = (r.o - nd->bmin) / (nd->bmax - nd->bmin);
    while (nd->children[0] != -1) {
      int ci = int(std::lround(pos.z)) + 2 * int(std::lround(pos.y)) + 4 * int(std::lround(pos.x));
      ci = std::clamp(ci, 0, 7);  // fp guard: pos may sit marginally outside [0,1]
      V3 cl{std::min(pos.x, 1.0f - kEps), std::min(pos.y, 1.0f - kEps), std::min(pos.z, 1.0f - kEps)};
      pos = {2.0f * std::fmod(cl.x, 0.5f), 2.0f * std::fmod(cl.y, 0.5f), 2.0f * std::fmod(cl.z, 0.5f)};
      ni = nd->children[ci];
      nd = &s.nodes[ni];
    }
    if (!hitAABB(nd->bmin, nd->bmax, r, d0, d1, nearF, farF)) return false;
    pos = r.o + r.d * d0;
  }

  V3 ext0 = s.nodes[ni].bmax - s.nodes[ni].bmin;
  V3 sdir = norm(r.d / ext0);
  bool found = false;
  int bestTri = -1;
  float bu = 0, bv = 0;
  while (ni != -1) {
    const Node *nd = &s.nodes[ni];
    V3 ext = nd->bmax - nd->bmin;
    pos = (pos - nd->bmin) / ext;
    while (nd->children[0] != -1) {
      int ci = int(std::lround(pos.z)) + 2 * int(std::lround(pos.y)) + 4 * int(std::lround(pos.x));
      ci = std::clamp(ci, 0, 7);  // fp guard: pos may sit marginally outside [0,1]
      V3 cl{std::min(pos.x, 1.0f - kEps), std::min(pos.y, 1.0f - kEps), std::min(pos.z, 1.0f - kEps)};
      pos = {2.0f * std::fmod(cl.x, 0.5f), 2.0f * std::fmod(cl.y, 0.5f), 2.0f * std::fmod(cl.z, 0.5f)};
      ni = nd->children[ci];
      nd = &s.nodes[ni];
    }
    for (int k = nd->trisIndex; k < nd->trisIndex + nd->trisCount; ++k) {
      int tri = s.octTris[k];
      V3 A = s.verts[s.tris[9 * tri + 0]];
      V3 B = s.verts[s.tris[9 * tri + 3]];
      V3 C = s.verts[s.tris[9 * tri + 6]];
      float dist, u, v;
      if (triTests) ++*triTests;
      if (hitTriangle(A, B, C, r, dist, u, v) && dist >= 0 && dist < h.dist) {
        h.dist = dist;
        bu = u;
        bv = v;
        bestTri = tri;
        found = true;
      }
    }
    ext = nd->bmax - nd->bmin;
    int fExit = exitFace(sdir, pos);
    pos = nd->bmin + mul3(pos, ext);
    ni = nd->neighbors[fExit];
    if (len(pos - r.o) > h.dist) break;
  }
  if (!found) return false;

  float w0 = 1.0f - bu - bv;
  V3 nA = s.normals[s.tris[9 * bestTri + 2]];
  V3 nB = s.normals[s.tris[9 * bestTri + 5]];
  V3 nC = s.normals[s.tris[9 * bestTri + 8]];
  h.normal = norm(applyNormal(ob.InvM, nA * w0 + nB * bu + nC * bv));
  int uvA = s.tris[9 * bestTri + 1], uvB = s.tris[9 * bestTri + 4], uvC = s.tris[9 * bestTri + 7];
  h.u = w0 * s.uvs[2 * uvA] + bu * s.uvs[2 * uvB] + bv * s.uvs[2 * uvC];
  h.v = w0 * s.uvs[2 * uvA + 1] + bu * s.uvs[2 * uvB + 1] + bv * s.uvs[2 * uvC + 1];

  V3 objPt = r.o + r.d * h.dist;
  V3 world = applyPoint(ob.M, objPt);
  h.dist = len(world - spatial(ray.o)) / len(spatial(ray.d));
  return true;
}

struct Counters {
  uint64_t triTests = 0;
  uint64_t shadowRays = 0;
};

V3 sampleTexture(const Scene &s, const Object &ob, float u0, float v0) {
  int w = ob.texW, hgt = ob.texH;
  float u = w * u0;
  float v = hgt * (1.0f - v0);
  int x = std::min(int(std::floor(u)), w - 1);
  int y = std::min(int(std::floor(v)), hgt - 1);
  float ur = u - x, vr = v - y;
  float uo = 1 - ur, vo = 1 - vr;
  auto texel = [&](int xi, int yi) {
    size_t base = size_t(ob.texOffset) + 3 * (size_t(w) * yi + xi);
    return V3{s.tex[base] / 255.0f, s.tex[base + 1] / 255.0f, s.tex[base + 2] / 255.0f};
  };
  int xc = std::clamp(x, 0, w - 1), yc = std::clamp(y, 0, hgt - 1);
  V3 r1 = texel(xc, yc) * uo;
  int x1 = std::clamp(xc + 1, 0, w - 1);
  r1 = r1 + texel(x1, yc) * ur;
  r1 = r1 * vo;
  int y1 = std::clamp(yc + 1, 0, hgt - 1);
  V3 r2 = texel(x1, y1) * ur;
  int x2 = std::clamp(x1 - 1, 0, w - 1);
  r2 = r2 + texel(x2, y1) * uo;
  r2 = r2 * vr;
  return r1 + r2;
}

bool sceneIntersect(const Scene &s, const Ray &cam, Hit &h, Counters *cnt) {
  h.dist = kInf;
  bool any = false;
  V4 event{};
  for (size_t i = 0; i < s.objects.size(); ++i) {
    const Object &ob = s.objects[i];
    Hit nh;
    V4 d4 = apply(ob.Lor, V4{float(s.interval), cam.d.x, cam.d.y, cam.d.z});
    Ray4 r4{ob.statCam, d4};
    bool got = false;
    switch (ob.type) {
      case kSphere:
        got = hitSphere(ob, r4, nh);
        break;
      case kCube:
        got = hitCube(ob, r4, nh);
        break;
      case kMesh:
        got = hitMesh(s, ob, r4, nh, cnt ? &cnt->triTests : nullptr);
        break;
    }
    if (got && nh.dist < h.dist) {
      event = r4.o + r4.d * nh.dist;
      h = nh;
      h.object = int(i);
      any = true;
    }
  }
  if (!any) return false;
  const Object &ob = s.objects[h.object];
  if (ob.texOffset != -1) {
    h.color = sampleTexture(s, ob, h.u, h.v);
  } else {
    h.color = ob.color;
  }
  if (ob.flashPeriod > 0) {
    float ph = event.t - ob.flashPeriod * std::floor(event.t / ob.flashPeriod);
    if (ph < ob.flashDuration) h.color = h.color * 2.0f;
  }
  return true;
}

// Is any object (other than the light) closer than lightDist along this ray?
bool occluded(const Scene &s, const Ray4 &ray, float lightDist, int lightIdx, Counters *cnt) {
  for (size_t i = 0; i < s.objects.size(); ++i) {
    if (int(i) == lightIdx) continue;
    const Object &ob = s.objects[i];
    V4 o4 = apply(ob.Lor, ray.o);
    V3 dn = norm(spatial(ray.d));
    V4 d4 = apply(ob.Lor, V4{float(s.interval), dn.x, dn.y, dn.z});
    Ray4 r4{o4, d4};
    Hit nh;
    bool got = false;
    switch (ob.type) {
      case kSphere:
        got = hitSphere(ob, r4, nh);
        break;
      case kCube:
        got = hitCube(ob, r4, nh);
        break;
      case kMesh:
        got = hitMesh(s, ob, r4, nh, cnt ? &cnt->triTests : nullptr);
        break;
    }
    if (got && nh.dist < lightDist) return true;
  }
  return false;
}

V3 shade(const Scene &s, const Ray &cam, Counters *cnt) {
  Hit h;
  if (!sceneIntersect(s, cam, h, cnt)) return {0.15f, 0.15f, 0.25f};

  float amb = s.interval != 0 ? s.ambient : 1.0f;
  V3 color = h.color * amb;
  const Object &hitOb = s.objects[h.object];
  if (hitOb.light) color = color + h.color;

  if (s.interval != 0) {
    for (size_t i = 0; i < s.objects.size(); ++i) {
      if (int(i) == h.object || !s.objects[i].light) continue;
      const Object &lt = s.objects[i];
      // Reconstruct the hit event in the camera frame, biased along the
      // normal, then hop camera -> light frame for the retarded direction.
      V4 camPosObj = hitOb.statCam;
      V4 rayDirObj = apply(hitOb.Lor, V4{float(s.interval), cam.d.x, cam.d.y, cam.d.z});
      V4 hitObj = camPosObj + rayDirObj * h.dist;
      hitObj = hitObj + V4{0, h.normal.x * 0.001f, h.normal.y * 0.001f, h.normal.z * 0.001f};
      V4 hitCam = apply(hitOb.InvLor, hitObj);
      V4 hitLight = apply(lt.Lor, hitCam);
      V3 lightPos{lt.M.row[0].z, lt.M.row[1].z, lt.M.row[2].z};  // translation column (slot 3)
      V3 toLight = lightPos - spatial(hitLight);
      V4 dirLight{float(s.interval) * len(toLight), toLight.x, toLight.y, toLight.z};
      V4 dirCam = apply(lt.InvLor, dirLight);
      V4 dirObj = apply(hitOb.Lor, dirCam);
      V3 d3 = spatial(dirObj);
      V3 unitL = norm(d3);
      if (dot(h.normal, unitL) > 0) {
        Ray4 shadow{hitCam, V4{float(s.interval), 0, 0, 0}};
        V3 sd = norm(spatial(dirCam));
        shadow.d.x = sd.x;
        shadow.d.y = sd.y;
        shadow.d.z = sd.z;
        if (cnt) ++cnt->shadowRays;
        if (!occluded(s, shadow, len(spatial(dirCam)), int(i), cnt)) {
          float fall = 1.0f / (1.0f + 0.1f * len(d3) + 0.01f * dot(d3, d3));
          color = color + mul3(h.color, lt.color) * (dot(h.normal, unitL) * fall);
        }
      }
    }
  }
  return color;
}

inline float hable1(float x) {
  const float A = 0.15f, B = 0.50f, C = 0.10f, D = 0.20f, E = 0.02f, F = 0.30f;
  return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F;
}
inline V3 hable(V3 v) { return {hable1(v.x), hable1(v.y), hable1(v.z)}; }

}  // namespace

int main(int argc, char **argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s scene.blob out.rgb32f [frames] [threads]\n", argv[0]);
    return 2;
  }
  Scene s;
  if (!readBlob(argv[1], s)) {
    std::fprintf(stderr, "failed to read %s\n", argv[1]);
    return 1;
  }
  int frames = argc > 3 ? std::atoi(argv[3]) : 1;
  int threads = argc > 4 ? std::atoi(argv[4]) : int(std::thread::hardware_concurrency());
  threads = std::max(1, threads);

  const int W = int(s.width), H = int(s.height);
  std::vector<float> img(size_t(W) * H * 3);
  V3 wpHable = hable(s.whitePoint);
  std::vector<double> frameMs;
  Counters total;

  for (int fr = 0; fr < frames; ++fr) {
    auto t0 = std::chrono::steady_clock::now();
    std::atomic<int> nextRow{0};
    std::vector<Counters> perThread(threads);
    auto worker = [&](int ti) {
      Counters *cnt = fr == 0 ? &perThread[ti] : nullptr;
      for (;;) {
        int y = nextRow.fetch_add(1);
        if (y >= H) break;
        for (int x = 0; x < W; ++x) {
          Ray r = cameraRay(float(x), float(y), W, H);
          V3 c = shade(s, r, cnt);
          c = {hable1(c.x) / wpHable.x, hable1(c.y) / wpHable.y, hable1(c.z) / wpHable.z};
          c = {std::min(c.x, 1.0f), std::min(c.y, 1.0f), std::min(c.z, 1.0f)};
          size_t o = (size_t(y) * W + x) * 3;
          img[o] = c.x;
          img[o + 1] = c.y;
          img[o + 2] = c.z;
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker, t);
    for (auto &t : pool) t.join();
    auto t1 = std::chrono::steady_clock::now();
    frameMs.push_back(std::chrono::duration<double, std::milli>(t1 - t0).count());
    if (fr == 0)
      for (auto &c : perThread) {
        total.triTests += c.triTests;
        total.shadowRays += c.shadowRays;
      }
  }

  FILE *out = std::fopen(argv[2], "wb");
  if (!out) return 1;
  std::fwrite(img.data(), sizeof(float), img.size(), out);
  std::fclose(out);

  std::sort(frameMs.begin(), frameMs.end());
  double p50 = frameMs[frameMs.size() / 2];
  double raysPerFrame = double(W) * H + double(total.shadowRays);
  std::printf(
      "{\"width\": %d, \"height\": %d, \"threads\": %d, \"frames\": %d, "
      "\"p50_ms\": %.3f, \"min_ms\": %.3f, \"primary_rays\": %d, "
      "\"shadow_rays\": %llu, \"tri_tests\": %llu, \"mrays_per_sec\": %.3f}\n",
      W, H, threads, frames, p50, frameMs.front(), W * H,
      (unsigned long long)total.shadowRays, (unsigned long long)total.triTests,
      raysPerFrame / (p50 * 1000.0));
  return 0;
}
