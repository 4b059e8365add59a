// Per-env math of one 30 Hz control step: sim_steps x substeps of
// heightfield contact -> PD torque -> Featherstone ABA -> semi-implicit
// Euler -> FK with body velocities.
//
// Every function here is __host__ __device__. control_step.cu runs it with
// a team of lanes per env (one lane per body, a power of two of them, 16
// for the humanoid, so two envs share a warp); the CPU tests compile this
// header with g++ and run it with a team of width 1, which walks every
// body in turn through the same code, and hold it against the plain
// PyTorch version (physics/substep.py control_step_packed_reference). It
// mirrors that plain version operation by operation:
// engine.compute_contact_forces, engine.compute_joint_torques, engine.aba
// (per-joint form with the closed-form 3x3 inverse and the 6x6 Schur root
// solve), engine.integrate and char_model.forward_kinematics /
// body_vel_from_dof_vel.
//
// Team schedule. Lane j owns body j. Within a pass its rotation, motion
// subspace, inertia and the 3x3 and 6x6 products live in its registers;
// what one pass hands to the next (U, D^-1, u, the bias c, the spatial
// velocity and acceleration, the articulated inertia) sits in body j's
// slots of the team's shared memory, never in per-thread local arrays.
// The tree passes run one level of the tree per step (levels from the
// packed model table): outward for the velocities, the accelerations and
// FK, inward for the articulated inertias, where each body leaves its
// shifted inertia and bias force in its slot and the parent adds its
// children's slots in the table's fixed child order. Contact points are
// split over the lanes, and each body's lane sums its own points in point
// order, so the result does not depend on the schedule: a launch is
// deterministic. A hinge runs the spherical joint's 3-dof path with its
// unused dofs zeroed (its D is diag(D00, 1, 1)), which is exact in f32 and
// keeps the lanes of a level on one path; a fixed joint takes its own
// short path (a level of the humanoid's hands holds fixed joints only).
//
// Layouts (component-major; an env's column is handed over with stride 1):
//   column = state rows, const rows, contact rows:
//   state [292] for the humanoid: root_pos 3, root_rot 4, root_vel 3,
//     root_ang_vel 3, joint_rot 4(J-1), dof_vel D, body_pos 3J,
//     body_rot 4J, body_vel 3J, body_ang_vel 3J
//   const [D + 4(J-1)]: PD target / action D, target joint quats 4(J-1)
//   contact [3J]: net world contact force per body, averaged over the
//     substeps of the last sim step
// Model tables (packed once per model by physics/substep.py):
//   ints:   nb, nd, np, nlev, parent[nb], joint_type[nb], dof_offset[nb],
//           level[nb], child_start[nb + 1], child[nb - 1] (each body's
//           children, highest index first), point_body[np],
//           point_start[nb + 1], point[np] (each body's contact points in
//           point order)
//   floats: per body kBodyStride values (local_t 3, local_r 4, axis 3,
//           unit axis 3, mass 1, com 3, inertia 9), then six arrays of nd
//           values: kp, kd, effort, limit lo, limit hi, armature; then
//           point offsets 3np and point radii np.
#pragma once

#include <cmath>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#endif

#define PARC_HD __host__ __device__ inline
#ifdef __CUDACC__
#define PARC_UNROLL _Pragma("unroll")
#else
#define PARC_UNROLL
#endif

namespace parc {

constexpr int kMaxBodies = 32;
constexpr int kMaxContactPoints = 256;
constexpr int kBodyStride = 26;
constexpr int kSlotStride = 42;  // a body's 6x6 inertia and 6 bias force
// a joint's keep area: U (6x3), D^-1 (3x3; d_extra before the inward
// pass), u (3; tau before, qdd after), bias c (6; the joint's rate before
// the velocity pass); after the integration, its local rotation (4) and
// local angular velocity (3) for FK. The root's keeps its acceleration.
constexpr int kKeepU = 0, kKeepDinv = 18, kKeepUb = 27, kKeepC = 30;
constexpr int kKeepRot = 0, kKeepRate = 4;
constexpr int kKeepStride = 36;
constexpr int kHeader = 4;

enum JointType { kRoot = 0, kHinge = 1, kSpherical = 2, kFixed = 3 };
enum ControlMode {
  kPdImplicit = 0, kPdExp = 1, kPd1d = 2, kVel = 3, kTorque = 4
};

struct StepParams {
  float h;
  float torque_limit_scale;
  float hard_limit_stiffness;
  float hard_limit_damping;
  float limit_stiffness;
  float limit_damping;
  float gravity;
  float contact_stiffness;
  float contact_damping;
  float friction;
  float inv_slip_vel;
  float slip_eps;  // slip_vel^2 * 1e-4, the tangential speed's regulariser
  float max_contact_force;
  int control_mode;
  int hard_limits;
  int sim_steps;
  int substeps;
};

// StepParams from the launcher's arrays (physics/substep.py step_params):
// f = h, torque_limit_scale, hard_limit_stiffness, hard_limit_damping,
// limit_stiffness, limit_damping, gravity, contact_stiffness,
// contact_damping, friction, 1 / slip_vel, slip_vel^2 * 1e-4,
// max_contact_force; i = control_mode, hard_limits, sim_steps, substeps
PARC_HD StepParams step_params(const float* f, const int* i) {
  return StepParams{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                    f[9], f[10], f[11], f[12], i[0], i[1], i[2], i[3]};
}

// stacked heightfields [M][H][W], their min points [M][2], cell size [2]
struct Terrain {
  const float* hf;
  const float* min_point;
  const float* dxdy;
  int m, h, w;
  // an env's terrain; an index outside the stack is clamped to it
  PARC_HD int index(int ti) const { return ti < 0 ? 0 : (ti < m ? ti : m - 1); }
};

// The stages of a substep, each ended by a team barrier.
enum Phase {
  kContactPoints, kContactSums, kTorques, kVelocities, kBiasForces, kInward,
  kOutward, kIntegrate, kFk, kPhases
};

// The lanes that share one env. On the card, ``width`` lanes of a warp
// (every lane of the warp runs the same schedule, so a whole-warp barrier
// serves); on the host, width 1 and no barrier. sync(phase) ends a stage
// of the substep. Built with PARC_PHASE_CLOCKS, the block's first thread
// then adds the stage's clock64 cycles to clocks[phase] (the phase clock of
// physics/substep.py phase_cycles); otherwise that costs nothing.
struct Team {
  int lane;
  int width;
#if defined(PARC_PHASE_CLOCKS) && defined(__CUDA_ARCH__)
  unsigned long long* clocks;
  mutable long long since;
  __device__ void sync(Phase phase) const {
    __syncwarp();
    if (threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(clocks + phase, static_cast<unsigned long long>(now - since));
      since = now;
    }
  }
#else
  PARC_HD void sync(Phase) const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
#endif
};

// ---------------------------------------------------------------------------
// small vector / quaternion algebra (xyzw quats, row-major matrices)
// ---------------------------------------------------------------------------

PARC_HD void cross3(const float* a, const float* b, float* o) {
  const float x = a[1] * b[2] - a[2] * b[1];
  const float y = a[2] * b[0] - a[0] * b[2];
  const float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

PARC_HD void quat_mul(const float* a, const float* b, float* o) {
  const float x = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  const float y = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  const float z = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  const float w = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
  o[0] = x; o[1] = y; o[2] = z; o[3] = w;
}

PARC_HD void quat_rotate(const float* q, const float* v, float* o) {
  float t[3], c[3];
  cross3(q, v, t);
  t[0] *= 2.0f; t[1] *= 2.0f; t[2] *= 2.0f;
  cross3(q, t, c);
  const float x = v[0] + q[3] * t[0] + c[0];
  const float y = v[1] + q[3] * t[1] + c[1];
  const float z = v[2] + q[3] * t[2] + c[2];
  o[0] = x; o[1] = y; o[2] = z;
}

// normalize(x) with the 1e-9 guard of utils/rotation.normalize
PARC_HD void normalize_n(float* x, int n) {
  float s = 0.0f;
  PARC_UNROLL
  for (int k = 0; k < n; ++k) s += x[k] * x[k];
  const float inv = 1.0f / fmaxf(sqrtf(s), 1e-9f);
  PARC_UNROLL
  for (int k = 0; k < n; ++k) x[k] = x[k] * inv;
}

// quat_normalize: flip to w >= 0, then unit length
PARC_HD void quat_normalize(float* q) {
  if (q[3] < 0.0f) { q[0] = -q[0]; q[1] = -q[1]; q[2] = -q[2]; q[3] = -q[3]; }
  normalize_n(q, 4);
}

// quat_to_exp_map: w >= 0 branch, identity below |xyz| = 1e-5
PARC_HD void quat_to_exp_map(const float* q, float* e) {
  float x = q[0], y = q[1], z = q[2], w = q[3];
  if (w < 0.0f) { x = -x; y = -y; z = -z; w = -w; }
  const float len = sqrtf(fmaxf(x * x + y * y + z * z, 1e-18f));
  const float angle = 2.0f * atan2f(len, w);
  if (len > 1e-5f) {
    const float inv = 1.0f / len;
    e[0] = (x * inv) * angle; e[1] = (y * inv) * angle; e[2] = (z * inv) * angle;
  } else {
    e[0] = 0.0f; e[1] = 0.0f; e[2] = 0.0f;
  }
}

// exp_map_to_quat via axis-angle, identity below |e| = 1e-5
PARC_HD void exp_map_to_quat(const float* e, float* q) {
  const float angle = sqrtf(fmaxf(e[0] * e[0] + e[1] * e[1] + e[2] * e[2], 1e-18f));
  float axis[3] = {0.0f, 0.0f, 1.0f};
  float ang = 0.0f;
  if (angle > 1e-5f) {
    const float inv = 1.0f / angle;
    axis[0] = e[0] * inv; axis[1] = e[1] * inv; axis[2] = e[2] * inv;
    ang = angle;
  }
  normalize_n(axis, 3);
  const float s = sinf(ang / 2.0f);
  const float c = cosf(ang / 2.0f);
  q[0] = axis[0] * s; q[1] = axis[1] * s; q[2] = axis[2] * s; q[3] = c;
  normalize_n(q, 4);
}

PARC_HD void quat_to_matrix(const float* q, float* m) {
  const float i = q[0], j = q[1], k = q[2], w = q[3];
  const float two_s = 2.0f / (i * i + j * j + k * k + w * w);
  m[0] = 1.0f - two_s * (j * j + k * k);
  m[1] = two_s * (i * j - k * w);
  m[2] = two_s * (i * k + j * w);
  m[3] = two_s * (i * j + k * w);
  m[4] = 1.0f - two_s * (i * i + k * k);
  m[5] = two_s * (j * k - i * w);
  m[6] = two_s * (i * k - j * w);
  m[7] = two_s * (j * k + i * w);
  m[8] = 1.0f - two_s * (i * i + j * j);
}

PARC_HD void matvec3(const float* m, const float* v, float* o) {
  const float x = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  const float y = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
  const float z = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
  o[0] = x; o[1] = y; o[2] = z;
}

// closed-form 3x3 inverse (engine._inv3)
PARC_HD void inv3(const float* m, float* o) {
  const float a = m[0], b = m[1], c = m[2];
  const float d = m[3], e = m[4], f = m[5];
  const float g = m[6], h = m[7], i = m[8];
  const float co_a = e * i - f * h;
  const float co_b = f * g - d * i;
  const float co_c = d * h - e * g;
  const float det = a * co_a + b * co_b + c * co_c;
  const float inv = 1.0f / det;
  o[0] = co_a * inv; o[1] = (c * h - b * i) * inv; o[2] = (b * f - c * e) * inv;
  o[3] = co_b * inv; o[4] = (a * i - c * g) * inv; o[5] = (c * d - a * f) * inv;
  o[6] = co_c * inv; o[7] = (b * g - a * h) * inv; o[8] = (a * e - b * d) * inv;
}

// ---------------------------------------------------------------------------
// spatial algebra (6-vectors (ang; lin), 6x6 row-major)
// ---------------------------------------------------------------------------

PARC_HD void cross_motion(const float* v, const float* m, float* o) {
  float t0[3], t1[3], t2[3];
  cross3(v, m, t0);
  cross3(v, m + 3, t1);
  cross3(v + 3, m, t2);
  o[0] = t0[0]; o[1] = t0[1]; o[2] = t0[2];
  o[3] = t1[0] + t2[0]; o[4] = t1[1] + t2[1]; o[5] = t1[2] + t2[2];
}

PARC_HD void cross_force(const float* v, const float* f, float* o) {
  float t0[3], t1[3], t2[3];
  cross3(v, f, t0);
  cross3(v + 3, f + 3, t1);
  cross3(v, f + 3, t2);
  o[0] = t0[0] + t1[0]; o[1] = t0[1] + t1[1]; o[2] = t0[2] + t1[2];
  o[3] = t2[0]; o[4] = t2[1]; o[5] = t2[2];
}

// motion vector from origin o to o + r: (w, u + w x r)
PARC_HD void shift_motion(const float* m, const float* r, float* o) {
  float c[3];
  cross3(m, r, c);
  o[0] = m[0]; o[1] = m[1]; o[2] = m[2];
  o[3] = m[3] + c[0]; o[4] = m[4] + c[1]; o[5] = m[5] + c[2];
}

// force vector from origin o + r to o: (n + r x f, f)
PARC_HD void shift_force(const float* f, const float* r, float* o) {
  float c[3];
  cross3(r, f + 3, c);
  o[0] = f[0] + c[0]; o[1] = f[1] + c[1]; o[2] = f[2] + c[2];
  o[3] = f[3]; o[4] = f[4]; o[5] = f[5];
}

PARC_HD void matvec6(const float* m, const float* v, float* o) {
  PARC_UNROLL
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
    PARC_UNROLL
    for (int k = 0; k < 6; ++k) s += m[i * 6 + k] * v[k];
    o[i] = s;
  }
}

// ia = X_F(r) @ ia @ X_M(-r), in place, with X_F = [[1, rx], [0, 1]],
// X_M = [[1, 0], [-rx, 1]] (spatial.shift_inertia): rows 0-2 first (they
// read rows 3-5), then rows 3-5
PARC_HD void shift_inertia(float* ia, const float* r) {
  const float rx[9] = {0.0f, -r[2], r[1], r[2], 0.0f, -r[0], -r[1], r[0], 0.0f};
  PARC_UNROLL
  for (int i = 0; i < 6; ++i) {
    float t[6];
    PARC_UNROLL
    for (int j = 0; j < 6; ++j) {
      float s = ia[i * 6 + j];
      if (i < 3) {
        PARC_UNROLL
        for (int l = 0; l < 3; ++l) s += rx[i * 3 + l] * ia[(3 + l) * 6 + j];
      }
      t[j] = s;
    }
    PARC_UNROLL
    for (int j = 0; j < 3; ++j) {
      float s = t[j];
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) s -= t[3 + l] * rx[l * 3 + j];
      ia[i * 6 + j] = s;
    }
    PARC_UNROLL
    for (int j = 3; j < 6; ++j) ia[i * 6 + j] = t[j];
  }
}

// symmetric 6x6 solve via the 3x3 block Schur complement (engine._solve6_sym)
PARC_HD void solve6_sym(const float* m, const float* r, float* x) {
  float a[9], b[9], d[9];
  PARC_UNROLL
  for (int i = 0; i < 3; ++i) {
    PARC_UNROLL
    for (int j = 0; j < 3; ++j) {
      a[i * 3 + j] = m[i * 6 + j];
      b[i * 3 + j] = m[i * 6 + j + 3];
      d[i * 3 + j] = m[(i + 3) * 6 + j + 3];
    }
  }
  float a_inv[9], bt_ainv[9], schur[9], schur_inv[9];
  inv3(a, a_inv);
  PARC_UNROLL
  for (int i = 0; i < 3; ++i) {
    PARC_UNROLL
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) s += b[l * 3 + i] * a_inv[l * 3 + j];
      bt_ainv[i * 3 + j] = s;
    }
  }
  PARC_UNROLL
  for (int i = 0; i < 3; ++i) {
    PARC_UNROLL
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) s += bt_ainv[i * 3 + l] * b[l * 3 + j];
      schur[i * 3 + j] = d[i * 3 + j] - s;
    }
  }
  inv3(schur, schur_inv);
  float t[3], y[3];
  matvec3(bt_ainv, r, t);
  for (int k = 0; k < 3; ++k) y[k] = r[3 + k] - t[k];
  matvec3(schur_inv, y, x + 3);
  matvec3(b, x + 3, t);
  for (int k = 0; k < 3; ++k) y[k] = r[k] - t[k];
  matvec3(a_inv, y, x);
}

// ---------------------------------------------------------------------------
// model table access
// ---------------------------------------------------------------------------

struct Model {
  const int* itab;
  const float* ftab;
  int nb, nd, np, nlev;
  PARC_HD Model(const int* it, const float* ft)
      : itab(it), ftab(ft), nb(it[0]), nd(it[1]), np(it[2]), nlev(it[3]) {}
  PARC_HD int parent(int j) const { return itab[kHeader + j]; }
  PARC_HD int type(int j) const { return itab[kHeader + nb + j]; }
  PARC_HD int dof_offset(int j) const { return itab[kHeader + 2 * nb + j]; }
  PARC_HD int level(int j) const { return itab[kHeader + 3 * nb + j]; }
  PARC_HD const int* child_start() const { return itab + kHeader + 4 * nb; }
  PARC_HD const int* child() const { return child_start() + nb + 1; }
  PARC_HD int point_body(int p) const { return child()[nb - 1 + p]; }
  PARC_HD const int* point_start() const { return child() + nb - 1 + np; }
  PARC_HD const int* point() const { return point_start() + nb + 1; }
  PARC_HD const float* body(int j) const { return ftab + j * kBodyStride; }
  PARC_HD const float* local_t(int j) const { return body(j); }
  PARC_HD const float* local_r(int j) const { return body(j) + 3; }
  PARC_HD const float* axis(int j) const { return body(j) + 7; }
  PARC_HD const float* axis_n(int j) const { return body(j) + 10; }
  PARC_HD float mass(int j) const { return body(j)[13]; }
  PARC_HD const float* com(int j) const { return body(j) + 14; }
  PARC_HD const float* inertia(int j) const { return body(j) + 17; }
  PARC_HD const float* dof(int k) const { return ftab + nb * kBodyStride + k * nd; }
  PARC_HD float kp(int d) const { return dof(0)[d]; }
  PARC_HD float kd(int d) const { return dof(1)[d]; }
  PARC_HD float effort(int d) const { return dof(2)[d]; }
  PARC_HD float lo(int d) const { return dof(3)[d]; }
  PARC_HD float hi(int d) const { return dof(4)[d]; }
  PARC_HD float armature(int d) const { return dof(5)[d]; }
  PARC_HD const float* point_offset(int p) const { return dof(6) + 3 * p; }
  PARC_HD float point_radius(int p) const { return dof(6)[3 * np + p]; }
};

// the sizes of the packed model tables
PARC_HD int itab_size(int nb, int np) { return kHeader + 7 * nb + 1 + 2 * np; }
PARC_HD int ftab_size(int nb, int nd, int np) {
  return nb * kBodyStride + 6 * nd + 4 * np;
}

// row offsets of an env's column
struct Rows {
  int rp, rr, rv, ra, jr, dv, bp, br, bv, ba;  // state
  int act, qtar;                                // const
  int state, cnst, total;                       // row counts
  PARC_HD Rows(int nb, int nd) {
    rp = 0; rr = 3; rv = 7; ra = 10; jr = 13;
    dv = jr + 4 * (nb - 1);
    bp = dv + nd;
    br = bp + 3 * nb;
    bv = br + 4 * nb;
    ba = bv + 3 * nb;
    state = ba + 3 * nb;
    act = state;
    qtar = act + nd;
    cnst = nd + 4 * (nb - 1);
    total = state + cnst;
  }
};

// the shared-memory work areas of one env's team
struct Scratch {
  float* col;   // the env's column: state and const rows
  float* slot;  // [nb][kSlotStride]: each body's inertia and bias force
  float* pt;    // [np][6]: each contact point's moment and force; once the
                // bodies have summed them, [nb][kKeepStride]: each joint's
                // keep area (kKeepU ...)
  float* pub;   // [nb][6]: each body's spatial velocity, then acceleration
};

// the floats of Scratch::pt
PARC_HD constexpr int pt_size(int nb, int np) {
  return 6 * np > kKeepStride * nb ? 6 * np : kKeepStride * nb;
}

// What lane j keeps in registers about its body j across the control step.
struct BodyWork {
  int par, type, o;  // parent, joint type, dof offset
  // the joint's dof count
  PARC_HD int d() const { return type == kSpherical ? 3 : (type == kHinge ? 1 : 0); }
  float csum[3];  // contact force summed over the last sim step's substeps
};

PARC_HD void copy(const float* src, int n, float* dst) {
  PARC_UNROLL
  for (int k = 0; k < n; ++k) dst[k] = src[k];
}

// ---------------------------------------------------------------------------
// contact (engine.compute_contact_forces)
// ---------------------------------------------------------------------------

// one env's heightfield [h][w], its min point and inverse cell size, read
// from the stack once per contact pass
struct EnvTerrain {
  const float* hf;
  float mx, my, idx, idy;
  int h, w;
  PARC_HD EnvTerrain(const Terrain& ter, int ti)
      : hf(ter.hf + static_cast<long>(ti) * ter.h * ter.w),
        mx(ter.min_point[2 * ti]), my(ter.min_point[2 * ti + 1]),
        idx(1.0f / ter.dxdy[0]), idy(1.0f / ter.dxdy[1]), h(ter.h), w(ter.w) {}
};

// bilinear height and unit normal at world (x, y)
// (engine._hf_height_and_normal). Its five divisions are multiplies by a
// reciprocal here, which moves a result by about an ulp and saves 5 % of
// the kernel's time on the H100.
PARC_HD void hf_sample(const EnvTerrain& ter, float x, float y, float* hgt,
                       float* nrm) {
  const float u = fminf(fmaxf((x - ter.mx) * ter.idx, 0.0f), static_cast<float>(ter.h - 1));
  const float v = fminf(fmaxf((y - ter.my) * ter.idy, 0.0f), static_cast<float>(ter.w - 1));
  const int fu = static_cast<int>(floorf(u)), fv = static_cast<int>(floorf(v));
  const int ix0 = fu < ter.h - 2 ? fu : ter.h - 2;
  const int iy0 = fv < ter.w - 2 ? fv : ter.w - 2;
  const float fx = u - static_cast<float>(ix0);
  const float fy = v - static_cast<float>(iy0);
  const float* hf = ter.hf + ix0 * ter.w + iy0;
  const float h00 = hf[0], h01 = hf[1], h10 = hf[ter.w], h11 = hf[ter.w + 1];
  *hgt = (1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
         + (1 - fx) * fy * h01 + fx * fy * h11;
  const float dhdx = ((1 - fy) * (h10 - h00) + fy * (h11 - h01)) * ter.idx;
  const float dhdy = ((1 - fx) * (h01 - h00) + fx * (h11 - h10)) * ter.idy;
  const float inv_len = 1.0f / sqrtf(dhdx * dhdx + dhdy * dhdy + 1.0f);
  nrm[0] = -dhdx * inv_len; nrm[1] = -dhdy * inv_len; nrm[2] = inv_len;
}

// penalty + regularised Coulomb force of one contact point; writes
// (moment about the body origin; force) to out[6]
PARC_HD void contact_point(const Model& m, const StepParams& p, const EnvTerrain& ter,
                           const float* col, const Rows& R, int pnt, float* out) {
  const int b = m.point_body(pnt);
  float bp[3], bq[4], bv[3], bw[3];
  copy(col + R.bp + 3 * b, 3, bp);
  copy(col + R.br + 4 * b, 4, bq);
  copy(col + R.bv + 3 * b, 3, bv);
  copy(col + R.ba + 3 * b, 3, bw);
  float off[3], x[3], xr[3], c[3], v[3];
  quat_rotate(bq, m.point_offset(pnt), off);
  for (int k = 0; k < 3; ++k) x[k] = bp[k] + off[k];
  for (int k = 0; k < 3; ++k) xr[k] = x[k] - bp[k];
  cross3(bw, xr, c);
  for (int k = 0; k < 3; ++k) v[k] = bv[k] + c[k];
  float hgt, n[3];
  hf_sample(ter, x[0], x[1], &hgt, n);
  const float phi = (x[2] - m.point_radius(pnt) - hgt) * n[2];
  const float phi_dot = n[0] * v[0] + n[1] * v[1] + n[2] * v[2];
  float fn = fmaxf(-p.contact_stiffness * phi - p.contact_damping * phi_dot, 0.0f);
  fn = phi < 0.0f ? fminf(fn, p.max_contact_force) : 0.0f;
  float vt[3];
  for (int k = 0; k < 3; ++k) vt[k] = v[k] - n[k] * phi_dot;
  const float vt_norm = sqrtf(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2] + p.slip_eps);
  const float ft = p.friction * fn * fminf(vt_norm * p.inv_slip_vel, 1.0f);
  const float inv_vt = 1.0f / vt_norm;
  float f[3];
  for (int k = 0; k < 3; ++k) f[k] = n[k] * fn - vt[k] * inv_vt * ft;
  cross3(xr, f, out);
  out[3] = f[0]; out[4] = f[1]; out[5] = f[2];
}

// ---------------------------------------------------------------------------
// per-joint stages
// ---------------------------------------------------------------------------

// this joint's dof position (char_model.rot_to_dof) of its joint quat
PARC_HD void dof_of_quat(const Model& m, const BodyWork& w, int j, const float* q,
                         float* out) {
  float e[3];
  quat_to_exp_map(q, e);
  if (w.type == kSpherical) {
    out[0] = e[0]; out[1] = e[1]; out[2] = e[2];
  } else {
    const float* ax = m.axis_n(j);
    out[0] = w.type == kHinge ? ax[0] * e[0] + ax[1] * e[1] + ax[2] * e[2] : 0.0f;
    out[1] = 0.0f; out[2] = 0.0f;
  }
}

// this joint's exp-map (rate) from its dofs (char_model.joint_exp_maps)
PARC_HD void exp_of_dofs(const Model& m, const BodyWork& w, int j, const float* dof,
                         float* e) {
  if (w.type == kSpherical) {
    e[0] = dof[0]; e[1] = dof[1]; e[2] = dof[2];
  } else {
    const float* ax = m.axis_n(j);
    const float s = w.type == kHinge ? dof[0] : 0.0f;
    e[0] = ax[0] * s; e[1] = ax[1] * s; e[2] = ax[2] * s;
  }
}

// this joint's dof velocities (zero past its dofs)
PARC_HD void joint_dof_vel(const BodyWork& w, const float* col, const Rows& R,
                           float* dv) {
  PARC_UNROLL
  for (int c = 0; c < 3; ++c) dv[c] = c < w.d() ? col[R.dv + w.o + c] : 0.0f;
}

// engine.compute_joint_torques for joint j: explicit torque + implicit
// ABA diagonal, into tau[3] and dex[3] (zero past the joint's dofs)
PARC_HD void joint_torques(const Model& m, const StepParams& p, const float* col,
                           const Rows& R, int j, const BodyWork& w, const float* dv,
                           float* tau_out, float* dex_out) {
  const float h = p.h;
  const int mode = p.control_mode;
  float act[3];
  PARC_UNROLL
  for (int c = 0; c < 3; ++c) {
    act[c] = c < w.d() ? col[R.act + w.o + c] : 0.0f;
    tau_out[c] = 0.0f;
    dex_out[c] = 0.0f;
  }
  if (mode == kTorque || mode == kVel) {
    PARC_UNROLL
    for (int c = 0; c < 3; ++c) {
      if (c >= w.d()) continue;
      const int d = w.o + c;
      const float eff = m.effort(d) * p.torque_limit_scale;
      const float t = mode == kTorque ? act[c] * eff : m.kd(d) * (act[c] - dv[c]);
      tau_out[c] = fminf(fmaxf(t, -eff), eff);
    }
    return;
  }
  float jr[4], dof_pos[3];
  copy(col + R.jr + 4 * (j - 1), 4, jr);
  dof_of_quat(m, w, j, jr, dof_pos);
  float err[3] = {0.0f, 0.0f, 0.0f};
  if (mode != kPd1d) {
    float qt[4], diff[4];
    copy(col + R.qtar + 4 * (j - 1), 4, qt);
    const float conj[4] = {-jr[0], -jr[1], -jr[2], jr[3]};
    quat_mul(conj, qt, diff);
    dof_of_quat(m, w, j, diff, err);
  }
  PARC_UNROLL
  for (int c = 0; c < 3; ++c) {
    if (c >= w.d()) continue;
    const int d = w.o + c;
    float tau, dex = 0.0f;
    if (mode == kPd1d) {
      tau = m.kp(d) * (act[c] - dof_pos[c]) - m.kd(d) * dv[c];
    } else if (mode == kPdExp) {
      tau = m.kp(d) * err[c] - m.kd(d) * dv[c];
    } else {  // kPdImplicit (stable PD)
      const float kd_eff = m.kd(d) + h * m.kp(d);
      tau = m.kp(d) * err[c] - kd_eff * dv[c];
      dex = h * kd_eff;
    }
    const float eff = m.effort(d) * p.torque_limit_scale;
    tau = fminf(fmaxf(tau, -eff), eff);
    const float over = fmaxf(dof_pos[c] - m.hi(d), 0.0f);
    const float under = fmaxf(m.lo(d) - dof_pos[c], 0.0f);
    const bool viol = over > 0.0f || under > 0.0f;
    if (p.hard_limits) {
      // stiff unilateral boundary spring; its damping enters the ABA diagonal
      const float d_eff = p.hard_limit_damping + h * p.hard_limit_stiffness;
      const float vf = viol ? 1.0f : 0.0f;
      tau += -p.hard_limit_stiffness * (over - under) - d_eff * vf * dv[c];
      dex += h * d_eff * vf;
    } else {
      tau += -p.limit_stiffness * (over - under)
             - p.limit_damping * (viol ? dv[c] : 0.0f);
    }
    tau_out[c] = tau;
    dex_out[c] = dex;
  }
}

// spatial inertia of body j (world axes, body origin) into M[36]
PARC_HD void body_inertia(const Model& m, int j, const float* R, float* M) {
  float com_w[3];
  matvec3(R, m.com(j), com_w);
  const float* I = m.inertia(j);
  float ri[9], iw[9];
  PARC_UNROLL
  for (int a = 0; a < 3; ++a)
    PARC_UNROLL
    for (int b = 0; b < 3; ++b) {
      float s = 0.0f;
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) s += R[a * 3 + l] * I[l * 3 + b];
      ri[a * 3 + b] = s;
    }
  PARC_UNROLL
  for (int a = 0; a < 3; ++a)
    PARC_UNROLL
    for (int b = 0; b < 3; ++b) {
      float s = 0.0f;
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) s += ri[a * 3 + l] * R[b * 3 + l];
      iw[a * 3 + b] = s;
    }
  const float mass = m.mass(j);
  const float cx[9] = {0.0f, -com_w[2], com_w[1], com_w[2], 0.0f, -com_w[0],
                       -com_w[1], com_w[0], 0.0f};
  PARC_UNROLL
  for (int a = 0; a < 3; ++a) {
    PARC_UNROLL
    for (int b = 0; b < 3; ++b) {
      float s = 0.0f;  // (cx @ cx^T)[a, b]
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) s += cx[a * 3 + l] * cx[b * 3 + l];
      M[a * 6 + b] = iw[a * 3 + b] + mass * s;
      M[a * 6 + 3 + b] = mass * cx[a * 3 + b];
      M[(3 + a) * 6 + b] = mass * cx[b * 3 + a];
      M[(3 + a) * 6 + 3 + b] = a == b ? mass : 0.0f;
    }
  }
}

// joint j's angular motion subspace S (3 x 3, row stride 3, unused
// columns 0) from its body's rotation matrix
PARC_HD void joint_subspace(const Model& m, const BodyWork& w, int j,
                            const float* rmat, float* s) {
  if (w.type == kSpherical) {
    PARC_UNROLL
    for (int k = 0; k < 9; ++k) s[k] = rmat[k];
    return;
  }
  float axw[3];
  matvec3(rmat, m.axis(j), axw);
  PARC_UNROLL
  for (int k = 0; k < 3; ++k) {
    s[k * 3] = w.type == kHinge ? axw[k] : 0.0f;
    s[k * 3 + 1] = 0.0f;
    s[k * 3 + 2] = 0.0f;
  }
}

// joint j's S, from its body's quaternion in the column
PARC_HD void joint_subspace(const Model& m, const BodyWork& w, int j,
                            const float* col, const Rows& R, float* s) {
  float q[4], rmat[9];
  copy(col + R.br + 4 * j, 4, q);
  quat_to_matrix(q, rmat);
  joint_subspace(m, w, j, rmat, s);
}

// body j's origin less its parent's (engine.aba's r_of), from the column
PARC_HD void rel_pos(const float* col, const Rows& R, int j, int par, float* r) {
  PARC_UNROLL
  for (int k = 0; k < 3; ++k) r[k] = col[R.bp + 3 * j + k] - col[R.bp + 3 * par + k];
}

// body j's articulated inertia with its children's added into registers
// (ia[36]), and its bias force with theirs added in its slot (slot[36..41]),
// both in the table's child order (engine.aba's)
PARC_HD void gather_slot(const Model& m, float* slots, int j, float* ia) {
  float* slot = slots + kSlotStride * j;
  copy(slot, 36, ia);
  for (int q = m.child_start()[j]; q < m.child_start()[j + 1]; ++q) {
    const float* cs = slots + kSlotStride * m.child()[q];
    PARC_UNROLL
    for (int k = 0; k < 36; ++k) ia[k] += cs[k];
    PARC_UNROLL
    for (int k = 36; k < kSlotStride; ++k) slot[k] += cs[k];
  }
}

// the inward step of joint j (engine.aba) on its gathered inertia ``ia``,
// its slot's bias force (children added) and its keep area (tau, d_extra,
// bias c): U, D^-1 and u into keep, and the joint's shifted contribution
// to its parent into its slot. A fixed joint (no dofs, bias c = 0) hands
// its inertia and bias force on whole.
PARC_HD void inward_joint(const Model& m, const BodyWork& w, const float* col,
                          const Rows& R, int j, const float* s, float* ia,
                          float* slot, float* keep) {
  const float* pa = slot + 36;
  float r[3];
  rel_pos(col, R, j, w.par, r);
  if (w.type == kFixed) {
    float pa_c[6];
    copy(pa, 6, pa_c);
    shift_inertia(ia, r);
    copy(ia, 36, slot);
    shift_force(pa_c, r, slot + 36);
    return;
  }
  // U = IA S (6 x 3); S = [S_ang; 0]
  float u[18];
  PARC_UNROLL
  for (int a = 0; a < 6; ++a)
    PARC_UNROLL
    for (int c = 0; c < 3; ++c) {
      float sum = 0.0f;
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) sum += ia[a * 6 + l] * s[l * 3 + c];
      u[a * 3 + c] = sum;
    }
  // D = S^T U + diag(armature + d_extra); u = tau - S^T pA; unused dofs
  // get D's identity row and u = 0
  float D[9], ub[3], dinv[9];
  PARC_UNROLL
  for (int a = 0; a < 3; ++a) {
    PARC_UNROLL
    for (int c = 0; c < 3; ++c) {
      float sum = 0.0f;
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) sum += s[l * 3 + a] * u[l * 3 + c];
      D[a * 3 + c] = a < w.d() && c < w.d() ? sum : (a == c ? 1.0f : 0.0f);
    }
    if (a < w.d()) D[a * 3 + a] += m.armature(w.o + a) + keep[kKeepDinv + a];
    float sum = 0.0f;
    PARC_UNROLL
    for (int l = 0; l < 3; ++l) sum += s[l * 3 + a] * pa[l];
    ub[a] = a < w.d() ? keep[kKeepUb + a] - sum : 0.0f;
  }
  // one path for a hinge too: its D = diag(D00, 1, 1) inverts exactly to
  // 1 / D00 in the corner, and its zero U and u columns add exact zeros
  inv3(D, dinv);
  copy(u, 18, keep + kKeepU);
  copy(dinv, 9, keep + kKeepDinv);
  copy(ub, 3, keep + kKeepUb);
  // IA_art = IA - UD U^T (row by row); UD u
  float corr[6];
  PARC_UNROLL
  for (int a = 0; a < 6; ++a) {
    float ud[3];
    PARC_UNROLL
    for (int c = 0; c < 3; ++c) {
      float sum = 0.0f;
      PARC_UNROLL
      for (int l = 0; l < 3; ++l) sum += u[a * 3 + l] * dinv[l * 3 + c];
      ud[c] = sum;
    }
    PARC_UNROLL
    for (int b = 0; b < 6; ++b) {
      float sum = 0.0f;
      PARC_UNROLL
      for (int c = 0; c < 3; ++c) sum += ud[c] * u[b * 3 + c];
      ia[a * 6 + b] -= sum;
    }
    float sum = 0.0f;
    PARC_UNROLL
    for (int c = 0; c < 3; ++c) sum += ud[c] * ub[c];
    corr[a] = sum;
  }
  // pA_art = pA + IA_art c + UD u
  float cb[6], ic[6], pa_art[6];
  copy(keep + kKeepC, 6, cb);
  matvec6(ia, cb, ic);
  PARC_UNROLL
  for (int a = 0; a < 6; ++a) pa_art[a] = pa[a] + ic[a] + corr[a];
  shift_inertia(ia, r);
  copy(ia, 36, slot);
  shift_force(pa_art, r, slot + 36);
}

// ---------------------------------------------------------------------------
// one substep of one env's team
// ---------------------------------------------------------------------------

// The body loop of a lane: slot s of lane ``lane`` is body lane + s * width.
// On the card kSlots is 1 (width >= nb); on the host width is 1 and kSlots
// covers every body.
#define PARC_FOR_BODY(t, m, kSlots, s, j)                              \
  for (int s = 0, j = (t).lane; s < (kSlots); ++s, j += (t).width) \
    if (j < (m).nb)

template <int kSlots>
PARC_HD void substep_team(const Team& t, const Model& m, const Rows& R,
                          const Scratch& sc, const Terrain& ter, int ti,
                          const StepParams& p, bool last_step,
                          BodyWork (&work)[kSlots]) {
  float* col = sc.col;
  const float h = p.h;

  // contact: the points split over the lanes, then each body's sum into
  // its slot's bias-force place
  {
    const EnvTerrain et(ter, ti);
    for (int pnt = t.lane; pnt < m.np; pnt += t.width)
      contact_point(m, p, et, col, R, pnt, sc.pt + 6 * pnt);
  }
  t.sync(kContactPoints);
  PARC_FOR_BODY(t, m, kSlots, s, j) {
    BodyWork& w = work[s];
    float fext[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = m.point_start()[j]; q < m.point_start()[j + 1]; ++q) {
      const float* f = sc.pt + 6 * m.point()[q];
      PARC_UNROLL
      for (int k = 0; k < 6; ++k) fext[k] += f[k];
    }
    if (last_step) {
      PARC_UNROLL
      for (int k = 0; k < 3; ++k) w.csum[k] += fext[3 + k];
    }
    copy(fext, 6, sc.slot + kSlotStride * j + 36);
  }
  t.sync(kContactSums);  // the points are summed: their area now keeps joint data

  // torques; rotations, subspaces and joint rates; spatial inertias
  PARC_FOR_BODY(t, m, kSlots, s, j) {
    const BodyWork& w = work[s];
    float* keep = sc.pt + kKeepStride * j;
    float q[4], rmat[9];
    copy(col + R.br + 4 * j, 4, q);
    quat_to_matrix(q, rmat);
    body_inertia(m, j, rmat, sc.slot + kSlotStride * j);
    if (j == 0) {
      float* v0 = sc.pub;
      copy(col + R.ra, 3, v0);
      copy(col + R.rv, 3, v0 + 3);
      continue;
    }
    float dv[3];
    joint_dof_vel(w, col, R, dv);
    joint_torques(m, p, col, R, j, w, dv, keep + kKeepUb, keep + kKeepDinv);
    float sa[9], wj[3];
    joint_subspace(m, w, j, rmat, sa);
    if (w.type == kSpherical) {
      matvec3(rmat, dv, wj);
    } else {
      PARC_UNROLL
      for (int k = 0; k < 3; ++k) wj[k] = sa[k * 3] * dv[0];
    }
    copy(wj, 3, keep + kKeepC);  // the joint's rate until the bias replaces it
  }
  t.sync(kTorques);

  // velocities level by level, and each joint's velocity-product bias
  for (int l = 1; l < m.nlev; ++l) {
    PARC_FOR_BODY(t, m, kSlots, s, j) {
      const BodyWork& w = work[s];
      if (m.level(j) != l) continue;
      float* keep = sc.pt + kKeepStride * j;
      float r[3], vp[6];
      rel_pos(col, R, j, w.par, r);
      shift_motion(sc.pub + 6 * w.par, r, vp);
      const float vj[6] = {keep[kKeepC], keep[kKeepC + 1], keep[kKeepC + 2],
                           0.0f, 0.0f, 0.0f};
      float* v = sc.pub + 6 * j;
      PARC_UNROLL
      for (int k = 0; k < 6; ++k) v[k] = vp[k] + vj[k];
      cross_motion(v, vj, keep + kKeepC);
    }
    t.sync(kVelocities);
  }
  // bias forces: pA = v x* (IA v) - f_ext
  PARC_FOR_BODY(t, m, kSlots, s, j) {
    float* slot = sc.slot + kSlotStride * j;
    float v[6], iv[6], cf[6];
    copy(sc.pub + 6 * j, 6, v);
    matvec6(slot, v, iv);
    cross_force(v, iv, cf);
    PARC_UNROLL
    for (int k = 0; k < 6; ++k) slot[36 + k] = cf[k] - slot[36 + k];
  }
  t.sync(kBiasForces);

  // inward pass, leaves to root; the root solves for its acceleration and
  // keeps it in its own (jointless) keep area
  const float a_base[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -p.gravity};
  for (int l = m.nlev - 1; l >= 0; --l) {
    PARC_FOR_BODY(t, m, kSlots, s, j) {
      const BodyWork& w = work[s];
      if (m.level(j) != l) continue;
      float ia[36];
      gather_slot(m, sc.slot, j, ia);
      if (j == 0) {
        // free joint, gravity as a fictitious base acceleration
        float tmp[6], rhs[6], root_acc[6];
        matvec6(ia, a_base, tmp);
        PARC_UNROLL
        for (int k = 0; k < 6; ++k) rhs[k] = -(sc.slot[36 + k] + tmp[k]);
        PARC_UNROLL
        for (int k = 0; k < 6; ++k) ia[k * 6 + k] += 1e-6f;
        solve6_sym(ia, rhs, root_acc);
        copy(root_acc, 6, sc.pt);
        PARC_UNROLL
        for (int k = 0; k < 6; ++k) sc.pub[k] = a_base[k] + root_acc[k];
        continue;
      }
      float sa[9];
      joint_subspace(m, w, j, col, R, sa);
      inward_joint(m, w, col, R, j, sa, ia, sc.slot + kSlotStride * j,
                   sc.pt + kKeepStride * j);
    }
    t.sync(kInward);
  }

  // outward pass: accelerations, and qdd over u in the keep area
  for (int l = 1; l < m.nlev; ++l) {
    PARC_FOR_BODY(t, m, kSlots, s, j) {
      const BodyWork& w = work[s];
      if (m.level(j) != l) continue;
      float* keep = sc.pt + kKeepStride * j;
      float r[3], ap[6], y[3], q[3];
      rel_pos(col, R, j, w.par, r);
      shift_motion(sc.pub + 6 * w.par, r, ap);
      PARC_UNROLL
      for (int k = 0; k < 6; ++k) ap[k] += keep[kKeepC + k];
      float* a = sc.pub + 6 * j;
      if (w.type == kFixed) {
        copy(ap, 6, a);
        continue;
      }
      PARC_UNROLL
      for (int c = 0; c < 3; ++c) {
        float sum = 0.0f;  // (U^T a')[c]
        PARC_UNROLL
        for (int a = 0; a < 6; ++a) sum += keep[kKeepU + a * 3 + c] * ap[a];
        y[c] = keep[kKeepUb + c] - sum;
      }
      matvec3(keep + kKeepDinv, y, q);
      float sa[9];
      joint_subspace(m, w, j, col, R, sa);
      PARC_UNROLL
      for (int k = 0; k < 3; ++k) {
        float sum = 0.0f;
        PARC_UNROLL
        for (int c = 0; c < 3; ++c) sum += sa[k * 3 + c] * q[c];
        a[k] = ap[k] + sum;
        a[3 + k] = ap[3 + k];
      }
      copy(q, 3, keep + kKeepUb);
    }
    t.sync(kOutward);
  }

  // semi-implicit Euler (engine.integrate), every joint and the root at
  // once; then FK level by level. A joint's keep area now holds its local
  // rotation (kKeepRot) and its local angular velocity (kKeepRate).
  PARC_FOR_BODY(t, m, kSlots, s, j) {
    const BodyWork& w = work[s];
    if (j > 0) {
      float* keep = sc.pt + kKeepStride * j;
      const float* qdd = keep + kKeepUb;
      float dv[3];
      joint_dof_vel(w, col, R, dv);
      PARC_UNROLL
      for (int c = 0; c < 3; ++c) {
        if (c >= w.d()) continue;
        dv[c] = dv[c] + h * qdd[c];
        col[R.dv + w.o + c] = dv[c];
      }
      float wl[3], e[3], dq[4], jr[4], qn[4], cur[4];
      exp_of_dofs(m, w, j, dv, wl);
      PARC_UNROLL
      for (int k = 0; k < 3; ++k) e[k] = wl[k] * h;
      exp_map_to_quat(e, dq);
      copy(col + R.jr + 4 * (j - 1), 4, jr);
      quat_mul(jr, dq, qn);
      quat_normalize(qn);
      copy(qn, 4, col + R.jr + 4 * (j - 1));
      quat_mul(m.local_r(j), qn, cur);
      copy(cur, 4, keep + kKeepRot);
      copy(wl, 3, keep + kKeepRate);
      continue;
    }
    float pos[3], rq[4], vel[3], ang[3], c[3], root_acc[6];
    copy(sc.pt, 6, root_acc);
    copy(col + R.rp, 3, pos);
    copy(col + R.rr, 4, rq);
    copy(col + R.rv, 3, vel);
    copy(col + R.ra, 3, ang);
    cross3(ang, vel, c);
    float ang_new[3], vel_new[3];
    PARC_UNROLL
    for (int k = 0; k < 3; ++k) {
      ang_new[k] = ang[k] + h * root_acc[k];
      const float lin_acc = root_acc[3 + k] + c[k];
      vel_new[k] = vel[k] + h * lin_acc;
      pos[k] = pos[k] + h * vel_new[k];
    }
    float e[3], dq[4], qn[4];
    PARC_UNROLL
    for (int k = 0; k < 3; ++k) e[k] = ang_new[k] * h;
    exp_map_to_quat(e, dq);
    quat_mul(dq, rq, qn);
    quat_normalize(qn);
    copy(pos, 3, col + R.rp);
    copy(qn, 4, col + R.rr);
    copy(vel_new, 3, col + R.rv);
    copy(ang_new, 3, col + R.ra);
    copy(pos, 3, col + R.bp);
    copy(qn, 4, col + R.br);
    copy(vel_new, 3, col + R.bv);
    copy(ang_new, 3, col + R.ba);
  }
  t.sync(kIntegrate);
  for (int l = 1; l < m.nlev; ++l) {
    PARC_FOR_BODY(t, m, kSlots, s, j) {
      const BodyWork& w = work[s];
      if (m.level(j) != l) continue;
      const float* keep = sc.pt + kKeepStride * j;
      float pq[4], pp[3], pv[3], pw[3], cur[4], wl[3];
      copy(col + R.br + 4 * w.par, 4, pq);
      copy(col + R.bp + 3 * w.par, 3, pp);
      copy(col + R.bv + 3 * w.par, 3, pv);
      copy(col + R.ba + 3 * w.par, 3, pw);
      copy(keep + kKeepRot, 4, cur);
      copy(keep + kKeepRate, 3, wl);
      float wt[3], bq[4], bp[3], ww[3], r[3], c[3], bw[3], bv[3];
      quat_rotate(pq, m.local_t(j), wt);
      quat_mul(pq, cur, bq);
      PARC_UNROLL
      for (int k = 0; k < 3; ++k) bp[k] = pp[k] + wt[k];
      quat_rotate(bq, wl, ww);
      PARC_UNROLL
      for (int k = 0; k < 3; ++k) {
        bw[k] = pw[k] + ww[k];
        r[k] = bp[k] - pp[k];
      }
      cross3(pw, r, c);
      PARC_UNROLL
      for (int k = 0; k < 3; ++k) bv[k] = pv[k] + c[k];
      copy(bp, 3, col + R.bp + 3 * j);
      copy(bq, 4, col + R.br + 4 * j);
      copy(bv, 3, col + R.bv + 3 * j);
      copy(bw, 3, col + R.ba + 3 * j);
    }
    t.sync(kFk);
  }
}

// One control step of one env: sim_steps x substeps substeps, each with
// its contact pass. The state is updated in the column; the contact
// force of body j, averaged over the last sim step's substeps, goes to
// contact[3j + k rows], rows ``stride`` apart (none if contact is null).
template <int kSlots>
PARC_HD void control_step_team(const Team& t, const Model& m, const Scratch& sc,
                               const Terrain& ter, int ti, const StepParams& p,
                               float* contact, long stride) {
  const Rows R(m.nb, m.nd);
  BodyWork work[kSlots];
  PARC_FOR_BODY(t, m, kSlots, s, j) {
    BodyWork& w = work[s];
    w.par = m.parent(j);
    w.type = m.type(j);
    w.o = m.dof_offset(j);
    PARC_UNROLL
    for (int k = 0; k < 3; ++k) w.csum[k] = 0.0f;
  }
  for (int step = 0; step < p.sim_steps; ++step)
    for (int k = 0; k < p.substeps; ++k)
      substep_team<kSlots>(t, m, R, sc, ter, ti, p, step == p.sim_steps - 1, work);
  if (contact == nullptr) return;
  PARC_FOR_BODY(t, m, kSlots, s, j) {
    PARC_UNROLL
    for (int k = 0; k < 3; ++k)
      contact[(3 * j + k) * stride] = work[s].csum[k] / static_cast<float>(p.substeps);
  }
}

#ifndef __CUDACC__
// The host's version of the launch (the CPU tests' driver): for each env,
// gather its column, run a team of width 1, scatter the state.
inline void control_step_host(const float* state, const float* cnst, float* out,
                              float* contact, int n, const int* itab,
                              const float* ftab, const Terrain& ter, const int* tidx,
                              const StepParams& p) {
  const Model m(itab, ftab);
  const Rows R(m.nb, m.nd);
  // a column is at most 13 + 4 (J - 1) + 13 J + 2 D + 4 (J - 1) rows, with
  // J <= kMaxBodies and D <= 3 (J - 1)
  float col[1024], slot[kSlotStride * kMaxBodies], pub[6 * kMaxBodies],
      pt[pt_size(kMaxBodies, kMaxContactPoints)];
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < R.state; ++c) col[c] = state[static_cast<long>(c) * n + i];
    for (int c = 0; c < R.cnst; ++c) col[R.state + c] = cnst[static_cast<long>(c) * n + i];
    const Scratch sc{col, slot, pt, pub};
    control_step_team<kMaxBodies>(Team{0, 1}, m, sc, ter, ter.index(tidx[i]), p,
                                  contact + i, n);
    for (int c = 0; c < R.state; ++c) out[static_cast<long>(c) * n + i] = col[c];
  }
}
#endif

}  // namespace parc
