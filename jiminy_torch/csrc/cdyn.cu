// Component-dynamics kernels for Hopper (sm_90a): the CUDA counterparts of the
// three Pallas kernels of jiminy_tpu/ops/cdyn.py.
//
//   cdyn_accel   <- _pallas_accel_fn  (one forward-dynamics evaluation)
//   cdyn_period  <- _pallas_period_fn (one controller period + extras)
//   cdyn_rollout <- _pallas_rollout_fn (one env step: controller ticks x
//                                       substeps + extras)
//
// The spring-damper bodies are in spring.cuh (a group of lanes per env, the
// working set in shared memory), the constrained (PGS) bodies of the last
// two in pgs.cuh (cdyn_period_cm, cdyn_rollout_cm). This file holds the model
// view, the shared helpers, the launches and the plain C interface.
//
// The model's constants are read at run time from two buffers packed once
// per model (`pack_model` in jiminy_torch/ops/cdyn.py), so one build serves
// every model.
//
// Every expression mirrors the plain PyTorch version (ComponentDynamics in
// jiminy_torch/ops/cdyn.py) term for term and in the same association order,
// so float64 runs agree to rounding and float32 runs differ only by FMA
// contraction and the last bits of the math library.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -Xcompiler -fPIC, in parts linked -shared (the C interface below;
// jiminy_torch/ops/kernels.py); no fast math.

#include <cuda_runtime.h>

#include <cfloat>
#include <type_traits>

#include "cdyn.cuh"

namespace cdyn {

// --------------------------------------------------------------------------
// Model view over the packed constant buffers
// --------------------------------------------------------------------------

template <typename T>
struct Model {
  const int* __restrict__ ci;
  const T* __restrict__ cf;
  int nj, nq, nv, nc, ni, nm, nb, has_contacts, blend;
  int oc, oi, om, ob;  // int offsets: contacts, imus, motors, bounds
  int fd, fc, fi, fm, fb;  // float offsets: dofs, contacts, imus, motors, bounds

  __device__ Model(const int* ci_, const T* cf_) : ci(ci_), cf(cf_) {
    nj = ci[0]; nq = ci[1]; nv = ci[2]; nc = ci[3]; ni = ci[4]; nm = ci[5]; nb = ci[6];
    has_contacts = ci[7]; blend = ci[8];
    oc = CI_HEADER + CI_JOINT * nj;
    oi = oc + CI_CONTACT * nc;
    om = oi + CI_IMU * ni;
    ob = om + CI_MOTOR * nm;
    fd = CF_HEADER + CF_JOINT * nj;
    fc = fd + 2 * nv;
    fi = fc + CF_CONTACT * nc;
    fm = fi + CF_IMU * ni;
    fb = fm + CF_MOTOR * nm;
  }
  __device__ int parent(int j) const { return ci[CI_HEADER + CI_JOINT * j]; }
  __device__ int type(int j) const { return ci[CI_HEADER + CI_JOINT * j + 1]; }
  __device__ int iq(int j) const { return ci[CI_HEADER + CI_JOINT * j + 2]; }
  __device__ int iv(int j) const { return ci[CI_HEADER + CI_JOINT * j + 3]; }
  __device__ const T* jrot(int j) const { return cf + CF_HEADER + CF_JOINT * j; }
  __device__ const T* jpos(int j) const { return jrot(j) + 9; }
  __device__ const T* axis(int j) const { return jrot(j) + 12; }
  __device__ const T* axprod(int j) const { return jrot(j) + 15; }  // xx yy zz xy xz yz
  __device__ const T* ia0(int j) const { return jrot(j) + 21; }
  __device__ T armature(int k) const { return cf[fd + k]; }
  __device__ T damping(int k) const { return cf[fd + nv + k]; }
  __device__ int cparent(int k) const { return ci[oc + CI_CONTACT * k]; }
  __device__ int chas_radius(int k) const { return ci[oc + CI_CONTACT * k + 1]; }
  __device__ const T* cfpos(int k) const { return cf + fc + CF_CONTACT * k; }
  __device__ const T* cfrot(int k) const { return cfpos(k) + 3; }
  __device__ T cradius(int k) const { return cfpos(k)[12]; }
  __device__ int iparent(int k) const { return ci[oi + CI_IMU * k]; }
  __device__ const T* ifrot(int k) const { return cf + fi + CF_IMU * k; }
  __device__ const T* ifpos(int k) const { return ifrot(k) + 9; }
  __device__ const int* motor(int m) const { return ci + om + CI_MOTOR * m; }
  __device__ const T* motorf(int m) const { return cf + fm + CF_MOTOR * m; }
  __device__ const int* bound(int b) const { return ci + ob + CI_BOUND * b; }
  __device__ const T* boundf(int b) const { return cf + fb + CF_BOUND * b; }
  __device__ T g(int i) const { return cf[i]; }
  __device__ T stiffness() const { return cf[3]; }
  __device__ T contact_damping() const { return cf[4]; }
  __device__ T friction() const { return cf[5]; }
  __device__ T transition_velocity() const { return cf[6]; }
  __device__ T transition_eps() const { return cf[7]; }
  __device__ T dt() const { return cf[8]; }
  __device__ T half_dt() const { return cf[9]; }
  __device__ T dt6() const { return cf[10]; }
};

// --------------------------------------------------------------------------
// Small dense algebra on row-major arrays (the plain version's helpers)
// --------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ T machine_eps();
template <> __device__ __forceinline__ float machine_eps<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double machine_eps<double>() { return DBL_EPSILON; }
template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return (b < a) ? b : a; }
template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return (a < b) ? b : a; }
// torch.clamp(torch.clamp(x, min=lo), max=hi)
template <typename T> __device__ __forceinline__ T clip(T x, T lo, T hi) {
  x = (x < lo) ? lo : x;
  return (hi < x) ? hi : x;
}

template <typename T>
__device__ __forceinline__ void mv3(const T* m, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = m[3 * i] * v[0] + m[3 * i + 1] * v[1] + m[3 * i + 2] * v[2];
}
template <typename T>
__device__ __forceinline__ void tv3(const T* m, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = m[i] * v[0] + m[3 + i] * v[1] + m[6 + i] * v[2];
}
template <typename T>
__device__ __forceinline__ void mm3(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}
template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  T x = a[1] * b[2] - a[2] * b[1];
  T y = a[2] * b[0] - a[0] * b[2];
  T z = a[0] * b[1] - a[1] * b[0];
  out[0] = x; out[1] = y; out[2] = z;
}
template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
// (6x6) @ (ang, lin)
template <typename T>
__device__ __forceinline__ void sym6_mv(const T* m, const T* ang, const T* lin, T* out) {
  T vec[6] = {ang[0], ang[1], ang[2], lin[0], lin[1], lin[2]};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = m[6 * i] * vec[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) s = s + m[6 * i + j] * vec[j];
    out[i] = s;
  }
}

template <typename T>
__device__ __forceinline__ void quat_to_m(T qx, T qy, T qz, T qw, T* r) {
  T xx = qx * qx, yy = qy * qy, zz = qz * qz;
  T xy = qx * qy, xz = qx * qz, yz = qy * qz;
  T wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const T one = T(1), two = T(2);
  r[0] = one - two * (yy + zz); r[1] = two * (xy - wz); r[2] = two * (xz + wy);
  r[3] = two * (xy + wz); r[4] = one - two * (xx + zz); r[5] = two * (yz - wx);
  r[6] = two * (xz - wy); r[7] = two * (yz + wx); r[8] = one - two * (xx + yy);
}

// exp(axis * q) for a constant unit axis, with the axis products packed,
// from c = cos(q) and s = sin(q)
template <typename T>
__device__ __forceinline__ void rodrigues_cs(const T* ax, const T* p, T c, T s, T* r) {
  T one_c = T(1) - c;
  r[0] = c + p[0] * one_c; r[1] = p[3] * one_c - ax[2] * s; r[2] = p[4] * one_c + ax[1] * s;
  r[3] = p[3] * one_c + ax[2] * s; r[4] = c + p[1] * one_c; r[5] = p[5] * one_c - ax[0] * s;
  r[6] = p[4] * one_c - ax[1] * s; r[7] = p[5] * one_c + ax[0] * s; r[8] = c + p[2] * one_c;
}

template <typename T>
__device__ __forceinline__ void rodrigues(const T* ax, const T* p, T q, T* r) {
  rodrigues_cs(ax, p, cos(q), sin(q), r);
}

// I_parent = X_F I X_M^{-1} for the placement (r, pos) of the child in its
// parent, blockwise exactly as `_transform_sym6`.
template <typename T>
__device__ void transform_sym6(const T* ia, const T* r, const T* pos, T* out) {
  T a[9], b[9], bt[9], cc[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[3 * i + j] = ia[6 * i + j];
      b[3 * i + j] = ia[6 * i + 3 + j];
      bt[3 * i + j] = ia[6 * (3 + i) + j];
      cc[3 * i + j] = ia[6 * (3 + i) + 3 + j];
    }
  const T z = T(0);
  T s[9] = {z, -pos[2], pos[1], pos[2], z, -pos[0], -pos[1], pos[0], z};
  T rt[9] = {r[0], r[3], r[6], r[1], r[4], r[7], r[2], r[5], r[8]};
  T ra[9], rbt[9], rb[9], rc[9], t1[9], t2[9], top_l[9], top_r[9], neg_rts[9];
  mm3(r, a, ra);
  mm3(r, bt, rbt);
  mm3(r, b, rb);
  mm3(r, cc, rc);
  mm3(s, rbt, t1);
  mm3(s, rc, t2);
#pragma unroll
  for (int k = 0; k < 9; ++k) { top_l[k] = ra[k] + t1[k]; top_r[k] = rb[k] + t2[k]; }
  mm3(rt, s, neg_rts);
#pragma unroll
  for (int k = 0; k < 9; ++k) neg_rts[k] = -neg_rts[k];
  T o1[9], o2[9];
  // out_tl = top_l rt + top_r neg_rts ; out_tr = top_r rt
  mm3(top_l, rt, o1);
  mm3(top_r, neg_rts, o2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[6 * i + j] = o1[3 * i + j] + o2[3 * i + j];
  mm3(top_r, rt, o1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[6 * i + 3 + j] = o1[3 * i + j];
  // out_bl = rbt rt + rc neg_rts ; out_br = rc rt
  mm3(rbt, rt, o1);
  mm3(rc, neg_rts, o2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[6 * (3 + i) + j] = o1[3 * i + j] + o2[3 * i + j];
  mm3(rc, rt, o1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[6 * (3 + i) + 3 + j] = o1[3 * i + j];
}

// Unrolled LDL^T solve of a symmetric positive definite 6x6 system, in place.
template <typename T>
__device__ __forceinline__ void solve_sym6(const T* m, T* y) {
  T l[36], d[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    T dj = m[6 * j + j];
#pragma unroll
    for (int k = 0; k < j; ++k) dj = dj - l[6 * j + k] * l[6 * j + k] * d[k];
    d[j] = dj;
    T inv_dj = T(1) / dj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      T s = m[6 * i + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - l[6 * i + k] * l[6 * j + k] * d[k];
      l[6 * i + j] = s * inv_dj;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < i; ++k) y[i] = y[i] - l[6 * i + k] * y[k];
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i] = y[i] / d[i];
#pragma unroll
  for (int i = 5; i >= 0; --i)
#pragma unroll
    for (int k = i + 1; k < 6; ++k) y[i] = y[i] - l[6 * k + i] * y[k];
}

// --------------------------------------------------------------------------
// Kinematics and contact
// --------------------------------------------------------------------------

// Per-joint placement in the parent joint frame (`_joint_x`).
template <typename T>
__device__ void joint_x(const Model<T>& M, const T* q, T (*R)[9], T (*P)[3]) {
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i) {
    const T* tr = M.jrot(i);
    const T* tp = M.jpos(i);
    const int qi = M.iq(i);
    const int t = M.type(i);
    if (t == FREE) {
      T rj[9];
      quat_to_m(q[qi + 3], q[qi + 4], q[qi + 5], q[qi + 6], rj);
      mm3(tr, rj, R[i]);
      T pj[3] = {q[qi], q[qi + 1], q[qi + 2]};
      T tmp[3];
      mv3(tr, pj, tmp);
      for (int k = 0; k < 3; ++k) P[i][k] = tmp[k] + tp[k];
    } else if (t == REVOLUTE) {
      T rj[9];
      rodrigues(M.axis(i), M.axprod(i), q[qi], rj);
      mm3(tr, rj, R[i]);
      for (int k = 0; k < 3; ++k) P[i][k] = tp[k];
    } else {  // PRISMATIC
      const T* ax = M.axis(i);
      for (int k = 0; k < 9; ++k) R[i][k] = tr[k];
      T disp[3] = {ax[0] * q[qi], ax[1] * q[qi], ax[2] * q[qi]};
      T tmp[3];
      mv3(tr, disp, tmp);
      for (int k = 0; k < 3; ++k) P[i][k] = tmp[k] + tp[k];
    }
  }
}

template <typename T>
__device__ void world_placements(const Model<T>& M, const T (*R)[9], const T (*P)[3],
                                 T (*RW)[9], T (*PW)[3]) {
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i) {
    const int p = M.parent(i);
    if (p < 0) {
      for (int k = 0; k < 9; ++k) RW[i][k] = R[i][k];
      for (int k = 0; k < 3; ++k) PW[i][k] = P[i][k];
    } else {
      mm3(RW[p], R[i], RW[i]);
      T tmp[3];
      mv3(RW[p], P[i], tmp);
      for (int k = 0; k < 3; ++k) PW[i][k] = tmp[k] + PW[p][k];
    }
  }
}

// c ? a : b, kept a select: a chain of them over a register array would
// otherwise become an indexed load, which moves the array to local memory.
__device__ __forceinline__ float select_if(bool c, float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("{.reg .pred p; setp.ne.u32 p, %3, 0; selp.f32 %0, %1, %2, p;}"
      : "=f"(r) : "f"(a), "f"(b), "r"(static_cast<unsigned>(c)));
  return r;
#else
  return c ? a : b;
#endif
}
__device__ __forceinline__ double select_if(bool c, double a, double b) {
#ifdef __CUDA_ARCH__
  double r;
  asm("{.reg .pred p; setp.ne.u32 p, %3, 0; selp.f64 %0, %1, %2, p;}"
      : "=d"(r) : "d"(a), "d"(b), "r"(static_cast<unsigned>(c)));
  return r;
#else
  return c ? a : b;
#endif
}

}  // namespace cdyn

#include "terrain.cuh"

namespace cdyn {

// One spring-damper ground contact (`_contact_fext`), from the world
// placement (rw, pw) and LOCAL velocity (w, v) of its parent joint: world
// force fw, LOCAL parent-joint wrench (nj, fj), depth, and with `wl` the
// LOCAL contact-frame wrench [n(3), f(3)]. With kTerrain the ground's height
// and normal at the contact point come from the model's terrain section
// (`terrain_eval`); without, the ground is flat (z = 0, normal +z).
template <bool kTerrain, typename T>
__device__ __forceinline__ void contact_eval_at(const Model<T>& M, int k, const T* rw, const T* pw,
                                                const T* vel, T* fw, T* fj, T* nj, T* depth_out,
                                                T* wl) {
  const T* fp = M.cfpos(k);
  T pc[3], tmp[3];
  mv3(rw, fp, tmp);
  for (int i = 0; i < 3; ++i) pc[i] = tmp[i] + pw[i];
  const T* w_l = vel;
  const T* v_l = vel + 3;
  T vpt[3];
  cross3(w_l, fp, tmp);
  for (int i = 0; i < 3; ++i) vpt[i] = v_l[i] + tmp[i];
  T v_w[3];
  mv3(rw, vpt, v_w);
  T n[3] = {T(0), T(0), T(1)};
  T depth = pc[2];
  T v_depth = v_w[2];
  if constexpr (kTerrain) {
    const GroundPoint<T> g = terrain_eval(M.ci, M.cf, pc[0], pc[1]);
    n[0] = g.nx; n[1] = g.ny; n[2] = g.nz;
    const T nn = sqrt(tmax(dot3(n, n), T(1e-24)));
    const T inv = T(1) / nn;
    for (int i = 0; i < 3; ++i) n[i] = n[i] * inv;
    depth = (pc[2] - g.h) * n[2];
    v_depth = dot3(v_w, n);
  }
  const bool has_r = M.chas_radius(k) != 0;
  T d_off[3] = {T(0), T(0), T(0)};
  if (has_r) {
    const T radius = M.cradius(k);
    depth = depth - radius;
    for (int i = 0; i < 3; ++i) d_off[i] = n[i] * (-radius);
    T w_w[3];
    mv3(rw, w_l, w_w);
    cross3(w_w, d_off, tmp);
    for (int i = 0; i < 3; ++i) v_w[i] = v_w[i] + tmp[i];
    v_depth = dot3(v_w, n);
  }
  const T f_normal = -tmin(M.stiffness() * depth + M.contact_damping() * v_depth, T(0));
  T v_tang[3];
  for (int i = 0; i < 3; ++i) {
    fw[i] = n[i] * f_normal;
    v_tang[i] = v_w[i] - n[i] * v_depth;
  }
  const T v_norm = sqrt(tmax(dot3(v_tang, v_tang), T(1e-24)));
  const T v_ratio = tmin(v_norm / M.transition_velocity(), T(1));
  const T scale_t = M.friction() * v_ratio * f_normal / v_norm;
  for (int i = 0; i < 3; ++i) fw[i] = fw[i] - v_tang[i] * scale_t;
  if (M.blend) {
    const T blend = tanh(T(2) * (-depth) / M.transition_eps());
    for (int i = 0; i < 3; ++i) fw[i] = fw[i] * blend;
  }
  const bool active = depth < T(0);
  for (int i = 0; i < 3; ++i) fw[i] = active ? fw[i] : T(0);
  T lever[3];
  for (int i = 0; i < 3; ++i) lever[i] = pc[i] - pw[i];
  if (has_r)
    for (int i = 0; i < 3; ++i) lever[i] = lever[i] + d_off[i];
  T tau_w[3];
  cross3(lever, fw, tau_w);
  tv3(rw, fw, fj);
  tv3(rw, tau_w, nj);
  *depth_out = depth;
  if (wl != nullptr) {
    const T* frot = M.cfrot(k);
    tv3(frot, fj, wl + 3);
    if (has_r) {
      T t2[3];
      cross3(d_off, fw, tmp);
      tv3(rw, tmp, t2);
      tv3(frot, t2, wl);
    } else {
      wl[0] = T(0); wl[1] = T(0); wl[2] = T(0);
    }
  }
}

// Velocity and gravity-free acceleration recursion given solved joint
// accelerations (`_fk_accel_components`).
template <typename T>
__device__ void fk_vel_acc(const Model<T>& M, const T (*R)[9], const T (*P)[3], const T* v,
                           const T* a, T (*VEL)[6], T (*ACC)[6]) {
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i) {
    const int p = M.parent(i);
    const int t = M.type(i);
    const int vi = M.iv(i);
    T w_p[3] = {T(0), T(0), T(0)}, v_p[3] = {T(0), T(0), T(0)};
    T aa_p[3] = {T(0), T(0), T(0)}, al_p[3] = {T(0), T(0), T(0)};
    if (p >= 0)
      for (int k = 0; k < 3; ++k) {
        w_p[k] = VEL[p][k]; v_p[k] = VEL[p][3 + k];
        aa_p[k] = ACC[p][k]; al_p[k] = ACC[p][3 + k];
      }
    T w_in[3], v_in[3], aw_in[3], al_in[3], tmp[3];
    tv3(R[i], w_p, w_in);
    cross3(P[i], w_p, tmp);
    for (int k = 0; k < 3; ++k) tmp[k] = v_p[k] - tmp[k];
    tv3(R[i], tmp, v_in);
    tv3(R[i], aa_p, aw_in);
    cross3(P[i], aa_p, tmp);
    for (int k = 0; k < 3; ++k) tmp[k] = al_p[k] - tmp[k];
    tv3(R[i], tmp, al_in);
    T vj_ang[3], vj_lin[3], aj_ang[3], aj_lin[3];
    if (t == FREE) {
      for (int k = 0; k < 3; ++k) {
        vj_lin[k] = v[vi + k]; vj_ang[k] = v[vi + 3 + k];
        aj_lin[k] = a[vi + k]; aj_ang[k] = a[vi + 3 + k];
      }
    } else {
      const T* ax = M.axis(i);
      const bool rev = (t == REVOLUTE);
      for (int k = 0; k < 3; ++k) {
        vj_ang[k] = rev ? ax[k] * v[vi] : T(0);
        vj_lin[k] = rev ? T(0) : ax[k] * v[vi];
        aj_ang[k] = rev ? ax[k] * a[vi] : T(0);
        aj_lin[k] = rev ? T(0) : ax[k] * a[vi];
      }
    }
    T* w_i = VEL[i];
    T* v_i = VEL[i] + 3;
    for (int k = 0; k < 3; ++k) { w_i[k] = w_in[k] + vj_ang[k]; v_i[k] = v_in[k] + vj_lin[k]; }
    T b_ang[3], c1[3], c2[3];
    cross3(w_i, vj_ang, b_ang);
    cross3(w_i, vj_lin, c1);
    cross3(v_i, vj_ang, c2);
    for (int k = 0; k < 3; ++k) {
      ACC[i][k] = (aw_in[k] + aj_ang[k]) + b_ang[k];
      ACC[i][3 + k] = (al_in[k] + aj_lin[k]) + (c1[k] + c2[k]);
    }
  }
}

// The joint torque of motor m under command cc[m] (`MotorTransmission.__call__`).
template <typename T>
__device__ __forceinline__ T motor_effort(const Model<T>& M, int m, const T* v, const T* cc) {
  const int* mi = M.motor(m);
  const T* mf = M.motorf(m);  // red el vl denom fvp fvn fdp fdn fds
  const T v_j = v[mi[0]];
  T u = cc[m];
  if (mi[1] == MOTOR_ENVELOPE) {
    const T v_m = mf[0] * v_j;
    const T smin = clip((mf[2] + v_m) / mf[3], T(0), T(1));
    const T smax = clip((mf[2] - v_m) / mf[3], T(0), T(1));
    u = clip(u, -mf[1] * smin, mf[1] * smax);
  } else if (mi[1] == MOTOR_CLIP) {
    u = clip(u, -mf[1], mf[1]);
  }
  T u_t = mf[0] * u;
  if (mi[2]) {
    const T fr = (v_j > T(0)) ? mf[4] * v_j + mf[6] * tanh(mf[8] * v_j)
                              : mf[5] * v_j + mf[7] * tanh(mf[8] * v_j);
    u_t = u_t + fr;
  }
  return u_t;
}

// Motor commands -> joint torques (`MotorTransmission.__call__`).
template <typename T>
__device__ void tau_c(const Model<T>& M, const T* v, const T* cc, T* tc) {
#pragma unroll 1
  for (int i = 0; i < M.nv; ++i) tc[i] = T(0);
#pragma unroll 1
  for (int m = 0; m < M.nm; ++m) {
    const int vi = M.motor(m)[0];
    tc[vi] = tc[vi] + motor_effort(M, m, v, cc);
  }
}

// The free-flyer retraction q (+) dv of one FREE joint (`integrate_components`):
// q its 7 coordinates, dv its 6 (linear, angular), into out (which may be q).
template <typename T>
__device__ __forceinline__ void free_integrate(const T* q, const T* dv, T* out) {
  const T vl[3] = {dv[0], dv[1], dv[2]};
  const T w[3] = {dv[3], dv[4], dv[5]};
  const T eps = machine_eps<T>();
  const T theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const T theta = sqrt(tmax(theta2, eps * eps));
  const bool small = theta2 < T(1e-6);
  // V(omega) @ v of the SE(3) exponential
  const T b = small ? T(0.5) - theta2 / T(24) : (T(1) - cos(theta)) / tmax(theta2, T(1e-30));
  const T c = small ? T(1.0 / 6.0) - theta2 / T(120)
                    : (theta - sin(theta)) / tmax(theta2 * theta, T(1e-30));
  T wxv[3], wxwxv[3], p_d[3];
  cross3(w, vl, wxv);
  cross3(w, wxv, wxwxv);
  for (int k = 0; k < 3; ++k) p_d[k] = vl[k] + b * wxv[k] + c * wxwxv[k];
  T rot[9], tmp[3];
  quat_to_m(q[3], q[4], q[5], q[6], rot);
  mv3(rot, p_d, tmp);
  // quat * exp3(omega), normalized
  const T s_over = small ? T(0.5) - theta2 / T(48) : sin(T(0.5) * theta) / theta;
  const T cw = small ? T(1) - theta2 / T(8) + theta2 * theta2 / T(384) : cos(T(0.5) * theta);
  const T x2 = w[0] * s_over, y2 = w[1] * s_over, z2 = w[2] * s_over, w2 = cw;
  const T x1 = q[3], y1 = q[4], z1 = q[5], w1 = q[6];
  const T qx = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  const T qy = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  const T qz = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  const T qw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  const T nrm = sqrt(qx * qx + qy * qy + qz * qz + qw * qw);
  const T p0 = q[0] + tmp[0], p1 = q[1] + tmp[1], p2 = q[2] + tmp[2];
  out[0] = p0;
  out[1] = p1;
  out[2] = p2;
  out[3] = qx / nrm;
  out[4] = qy / nrm;
  out[5] = qz / nrm;
  out[6] = qw / nrm;
}

// Configuration retraction q (+) dv (`integrate_components`).
template <typename T>
__device__ void integrate(const Model<T>& M, const T* q, const T* dv, T* out) {
#pragma unroll 1
  for (int i = 0; i < M.nq; ++i) out[i] = q[i];
#pragma unroll 1
  for (int j = 0; j < M.nj; ++j) {
    const int qi = M.iq(j), vi = M.iv(j);
    if (M.type(j) != FREE) {
      out[qi] = q[qi] + dv[vi];
      continue;
    }
    free_integrate(q + qi, dv + vi, out + qi);
  }
}

// PD controller with ZOH command-state integration (`PDComponents.__call__`).
template <typename T>
__device__ void pd_controller(const int* __restrict__ pi, const T* __restrict__ pf, const T* q,
                              const T* v, const T* bc, const T* ac, T* cc, T* bc_new) {
  const int nm = pi[0];
  const T dt = pf[0];
#pragma unroll 1
  for (int i = 0; i < nm; ++i) {
    const int* mi = pi + 1 + PI_MOTOR * i;
    const T* f = pf + 1 + PF_MOTOR * i;  // kp kd smin0 smin1 smin2 smax0 smax1 smax2 eff red
    const T acc_min = f[4], acc_max = f[7];
    T p = bc[i], vel = bc[nm + i];
    const T accel = clip(ac[i], acc_min, acc_max);
    const T v_prev = vel;
    vel = clip(vel + accel * dt, f[3], f[6]);
    const T horizon = tmax(floor(fabs(v_prev) / acc_max / dt) * dt, dt);
    const T pos_min_d = f[2] - p;
    const T pos_max_d = f[5] - p;
    const T drift = (horizon > dt) ? T(0.5) * (horizon * (horizon - dt)) * acc_max : T(0);
    vel = clip(vel, (pos_min_d - drift) / horizon, (pos_max_d + drift) / horizon);
    const bool over = fabs(vel) > dt * acc_max;
    const T safe_v = (fabs(vel) > T(1e-12)) ? vel : T(1);
    const T v_lo2 = -tmax((pos_min_d - drift) / safe_v, dt) * acc_max;
    const T v_hi2 = tmax((pos_max_d + drift) / safe_v, dt) * acc_max;
    vel = over ? clip(vel, v_lo2, v_hi2) : vel;
    const T accel_out = (vel - v_prev) / dt;
    p = p + dt * vel;
    T pos_m = q[mi[0]], vel_m = v[mi[1]];
    if (!mi[2]) {
      pos_m = pos_m * f[9];
      vel_m = vel_m * f[9];
    }
    const T u = f[0] * ((p - pos_m) + f[1] * (vel - vel_m));
    cc[i] = clip(u, -f[8], f[8]);
    bc_new[i] = p;
    bc_new[nm + i] = vel;
    bc_new[2 * nm + i] = accel_out;
  }
}

}  // namespace cdyn

#include "pgs.cuh"
#include "spring.cuh"

namespace cdyn {

// The spring kernels: SP_LANES lanes per env, ENVS envs per block (SP_ENVS,
// SPA_ENVS for cdyn_accel), `smem_per_env` bytes of dynamic shared memory per
// env (`cdyn_sp_smem_bytes`, `cdyn_accel_smem_bytes`); a block's share past
// the card's limit fails here.
template <int ENVS = SP_ENVS, typename K>
int prepare_sp(K kernel, int smem_per_env) {
  cudaGetLastError();
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_per_env * ENVS));
}

template <typename T, bool kTerrain, bool kSph = false>
int launch_accel(const void* ci, const void* cf, const void* q, const void* v, const void* tau,
                 void* out, int B, int smem_per_env, void* stream) {
  const int rc = prepare_sp<SPA_ENVS>(cdyn_accel_kernel<T, kTerrain, kSph>, smem_per_env);
  if (rc != 0) return rc;
  cdyn_accel_kernel<T, kTerrain, kSph><<<(B + SPA_ENVS - 1) / SPA_ENVS, SP_LANES * SPA_ENVS,
                         (size_t)smem_per_env * SPA_ENVS, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const T*>(q),
      static_cast<const T*>(v), static_cast<const T*>(tau), static_cast<T*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTerrain>
int launch_period(const void* ci, const void* cf, const void* q, const void* v, const void* cmd,
                  void* qo, void* vo, void* eo, int B, int n_cmd, int n_substeps, int integrator,
                  int smem_per_env, void* stream) {
  const int rc = prepare_sp(cdyn_period_kernel<T, kTerrain>, smem_per_env);
  if (rc != 0) return rc;
  cdyn_period_kernel<T, kTerrain><<<(B + SP_ENVS - 1) / SP_ENVS, SP_LANES * SP_ENVS,
                          (size_t)smem_per_env * SP_ENVS, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const T*>(q),
      static_cast<const T*>(v), static_cast<const T*>(cmd), static_cast<T*>(qo),
      static_cast<T*>(vo), static_cast<T*>(eo), B, n_cmd, n_substeps, integrator);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTerrain>
int launch_rollout(const void* ci, const void* cf, const void* pi, const void* pf, int controller,
                   const void* q, const void* v, const void* action, const void* carry, void* qo,
                   void* vo, void* eo, int B, int n_action, int n_carry, int n_cmd, int n_ticks,
                   int n_substeps, int integrator, int smem_per_env, void* stream) {
  const int rc = prepare_sp(cdyn_rollout_kernel<T, kTerrain>, smem_per_env);
  if (rc != 0) return rc;
  cdyn_rollout_kernel<T, kTerrain><<<(B + SP_ENVS - 1) / SP_ENVS, SP_LANES * SP_ENVS,
                           (size_t)smem_per_env * SP_ENVS, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const int*>(pi),
      static_cast<const T*>(pf), controller, static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<const T*>(action), static_cast<const T*>(carry), static_cast<T*>(qo),
      static_cast<T*>(vo), static_cast<T*>(eo), B, n_action, n_carry, n_cmd, n_ticks, n_substeps,
      integrator);
  return static_cast<int>(cudaGetLastError());
}

// The constrained kernels: CM_LANES lanes per env, `envs` envs per block (1
// to CM_ENVS, `cdyn_cm_geometry`), `smem_per_env` bytes of dynamic shared
// memory per env (`cdyn_cm_smem_bytes`); a block's share past the card's
// limit fails here.
template <typename K>
int prepare_cm(K kernel, int smem_per_env, int envs) {
  cudaGetLastError();
  if (envs < 1 || envs > CM_ENVS) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_per_env * envs));
}

template <typename T, bool kTerrain, bool kExt>
int launch_period_cm(const void* ci, const void* cf, const void* si, const void* sf, const void* q,
                     const void* v, const void* cc, void* qo, void* vo, void* eo, int B, int n_cmd,
                     int n_substeps, int integrator, int smem_per_env, int envs, void* stream) {
  const int rc = prepare_cm(cdyn_period_cm_kernel<T, kTerrain, kExt>, smem_per_env, envs);
  if (rc != 0) return rc;
  cdyn_period_cm_kernel<T, kTerrain, kExt><<<(B + envs - 1) / envs, CM_LANES * envs,
                             (size_t)smem_per_env * envs, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const int*>(si),
      static_cast<const T*>(sf), static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<const T*>(cc), static_cast<T*>(qo), static_cast<T*>(vo), static_cast<T*>(eo), B,
      n_cmd, n_substeps, integrator);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTerrain, bool kExt>
int launch_rollout_cm(const void* ci, const void* cf, const void* si, const void* sf,
                      const void* pi, const void* pf, int controller, const void* q, const void* v,
                      const void* action, const void* carry, void* qo, void* vo, void* eo, int B,
                      int n_action, int n_block, int n_cmd, int n_ticks, int n_substeps,
                      int integrator, int smem_per_env, int envs, void* stream) {
  const int rc = prepare_cm(cdyn_rollout_cm_kernel<T, kTerrain, kExt>, smem_per_env, envs);
  if (rc != 0) return rc;
  cdyn_rollout_cm_kernel<T, kTerrain, kExt><<<(B + envs - 1) / envs, CM_LANES * envs,
                              (size_t)smem_per_env * envs, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const int*>(si),
      static_cast<const T*>(sf), static_cast<const int*>(pi), static_cast<const T*>(pf), controller,
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(action),
      static_cast<const T*>(carry), static_cast<T*>(qo), static_cast<T*>(vo), static_cast<T*>(eo),
      B, n_action, n_block, n_cmd, n_ticks, n_substeps, integrator);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cdyn

// --------------------------------------------------------------------------
// Plain C interface (bound with ctypes by jiminy_torch/ops/kernels.py)
// --------------------------------------------------------------------------
//
// The library is built in parts: kernels.py compiles this file once for each
// part (-DCDYN_PART=n), every part at once, and links the objects into one
// library. A build without CDYN_PART holds every part (one with
// CDYN_CM_PROFILE is such a build: its phase counters are one array). Part 0
// holds the host helpers and the occupancy queries' dispatch; parts 1 and 2
// the spring kernels at float and double; parts 3 and 4 cdyn_period_cm,
// parts 5 and 6 cdyn_rollout_cm, at float and double, each with its terrain
// and extended-body instances; part 7 cdyn_accel's SPHERICAL instances
// (kSph) at both.

#ifdef CDYN_PART
#ifdef CDYN_CM_PROFILE
#error "a CDYN_CM_PROFILE build is one part: its phase counters must be one array"
#endif
#define CDYN_IN_PART(n) (CDYN_PART == (n))
#else
#define CDYN_IN_PART(n) 1
#endif

namespace cdyn {

// Blocks of kernel k with `threads` threads and `smem` bytes of dynamic
// shared memory a block that the runtime would keep on one SM, its limit
// raised to that share first; a negative CUDA error code on failure.
template <typename K>
int blocks_per_sm(K k, int threads, int smem) {
  int blocks = 0;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  cudaGetLastError();
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// Blocks of a spring kernel (0 cdyn_accel, 1 cdyn_period, 2 cdyn_rollout;
// its terrain instance with `terrain`) at float type T that the runtime
// would keep on one SM (`cdyn_sp_blocks_per_sm`).
template <typename T>
int sp_blocks_per_sm(int kernel, int smem_per_env, int terrain) {
  const int threads = SP_LANES * (kernel == 0 ? SPA_ENVS : SP_ENVS);
  const int smem = smem_per_env * (kernel == 0 ? SPA_ENVS : SP_ENVS);
  auto occupancy = [&](auto k) { return blocks_per_sm(k, threads, smem); };
  auto of_ground = [&](auto flag) {
    constexpr bool kTerrain = decltype(flag)::value;
    return kernel == 0 ? occupancy(cdyn_accel_kernel<T, kTerrain>)
         : kernel == 1 ? occupancy(cdyn_period_kernel<T, kTerrain>)
                       : occupancy(cdyn_rollout_kernel<T, kTerrain>);
  };
  return terrain ? of_ground(std::true_type{}) : of_ground(std::false_type{});
}

// The launch geometry of a constrained kernel (cdyn_rollout_cm with
// kRollout, else cdyn_period_cm) at float type T (`cdyn_cm_geometry`).
template <bool kRollout, typename T>
int cm_geometry(int smem_per_env, int terrain, int ext, int* out) {
  auto occupancy = [&](auto k, int envs) {
    int blocks = 0;
    const int smem = smem_per_env * envs;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, CM_LANES * envs, smem);
    cudaGetLastError();
    return e == cudaSuccess ? blocks * envs : -static_cast<int>(e);
  };
  auto best = [&](auto k) {
    out[0] = out[1] = 0;
    int err = 0;
    for (int envs = CM_ENVS; envs >= 1; --envs) {
      const int per_sm = occupancy(k, envs);
      if (per_sm < 0) {
        err = -per_sm;
      } else if (per_sm > out[1]) {
        out[0] = envs;
        out[1] = per_sm;
      }
    }
    return out[1] > 0 ? 0 : (err ? err : static_cast<int>(cudaErrorInvalidConfiguration));
  };
  auto of_body = [&](auto flag, auto ext_flag) {
    constexpr bool kTerrain = decltype(flag)::value, kExt = decltype(ext_flag)::value;
    if constexpr (kRollout)
      return best(cdyn_rollout_cm_kernel<T, kTerrain, kExt>);
    else
      return best(cdyn_period_cm_kernel<T, kTerrain, kExt>);
  };
  auto of_ext = [&](auto flag) {
    return ext ? of_body(flag, std::true_type{}) : of_body(flag, std::false_type{});
  };
  return terrain ? of_ext(std::true_type{}) : of_ext(std::false_type{});
}

}  // namespace cdyn

extern "C" {

// Each part's occupancy queries, dispatched by part 0
int cdyn_sp_blocks_per_sm_f32(int kernel, int smem_per_env, int terrain);
int cdyn_sp_blocks_per_sm_f64(int kernel, int smem_per_env, int terrain);
int cdyn_period_cm_geometry_f32(int smem_per_env, int terrain, int ext, int* out);
int cdyn_period_cm_geometry_f64(int smem_per_env, int terrain, int ext, int* out);
int cdyn_rollout_cm_geometry_f32(int smem_per_env, int terrain, int ext, int* out);
int cdyn_rollout_cm_geometry_f64(int smem_per_env, int terrain, int ext, int* out);
// cdyn_accel's SPHERICAL instances (part 7)
int cdyn_accel_sph_f32(const void* ci, const void* cf, const void* q, const void* v,
                       const void* tau, void* out, int B, int smem_per_env, int terrain,
                       void* stream);
int cdyn_accel_sph_f64(const void* ci, const void* cf, const void* q, const void* v,
                       const void* tau, void* out, int B, int smem_per_env, int terrain,
                       void* stream);
int cdyn_accel_sph_blocks_per_sm_f32(int smem_per_env, int terrain);
int cdyn_accel_sph_blocks_per_sm_f64(int smem_per_env, int terrain);

#if CDYN_IN_PART(0)

// Bytes of dynamic shared memory one env of the constrained kernels takes
// (its slice and the padding to the next one) for a model of nj joints, nq
// and nv coordinates, n rows (nc contacts, nb bounds, nd loop closures, nr
// rolling constraints) and supports of up to ns dofs, with ncs spring-damper
// contacts beside them, a command of n_cmd, an action of n_act and a
// controller carry of n_blk values, at elt bytes a float.
int cdyn_cm_smem_bytes(int nj, int nq, int nv, int n, int nc, int nb, int ns, int nd, int ncs,
                       int nr, int n_cmd, int n_act, int n_blk, int elt) {
  return cdyn::cm_env_stride(
      cdyn::CmLayout(nj, nq, nv, n, nc, nb, ns, nd, ncs, nr, n_cmd, n_act, n_blk, elt).bytes, elt);
}

// Bytes of dynamic shared memory one env of the spring kernels takes (its
// slice and the padding to the next one) for a model of nj joints, nq and nv
// coordinates and nc contacts, a command of n_cmd, an action of n_act and a
// carry of n_carry values, at elt bytes a float; then the lanes per env and
// the envs per block of this build into geometry[0..1].
int cdyn_sp_smem_bytes(int nj, int nq, int nv, int nc, int n_cmd, int n_act, int n_carry, int elt,
                       int* geometry) {
  geometry[0] = cdyn::SP_LANES;
  geometry[1] = cdyn::SP_ENVS;
  return cdyn::sp_env_stride(cdyn::SpLayout(nj, nq, nv, nc, n_cmd, n_act, n_carry).elems, elt);
}

// Bytes of dynamic shared memory one env of cdyn_accel takes (its slice and
// the padding to the next one) for a model of nj joints, nq and nv
// coordinates, nc contacts and nsph SPHERICAL joints, at elt bytes a float;
// then the lanes per env and the envs per block of this build into
// geometry[0..1].
int cdyn_accel_smem_bytes(int nj, int nq, int nv, int nc, int elt, int nsph, int* geometry) {
  geometry[0] = cdyn::SP_LANES;
  geometry[1] = cdyn::SPA_ENVS;
  return cdyn::sp_env_stride(cdyn::SpAccelLayout(nj, nq, nv, nc, nsph).elems, elt);
}

// Blocks of a spring kernel (0 cdyn_accel, 1 cdyn_period, 2 cdyn_rollout, 3
// cdyn_accel's SPHERICAL instance; its terrain instance with `terrain`) the
// runtime would keep on one SM with
// smem_per_env bytes of dynamic shared memory an env, at elt bytes a float,
// the kernel's shared-memory limit raised to that block's share first, as a
// launch raises it; a negative CUDA error code on failure (a block past what
// the card grants).
int cdyn_sp_blocks_per_sm(int kernel, int elt, int smem_per_env, int terrain) {
  if (kernel == 3)
    return elt == 4 ? cdyn_accel_sph_blocks_per_sm_f32(smem_per_env, terrain)
                    : cdyn_accel_sph_blocks_per_sm_f64(smem_per_env, terrain);
  return elt == 4 ? cdyn_sp_blocks_per_sm_f32(kernel, smem_per_env, terrain)
                  : cdyn_sp_blocks_per_sm_f64(kernel, smem_per_env, terrain);
}

// The launch geometry of a constrained kernel (0 cdyn_period_cm, 1
// cdyn_rollout_cm; its terrain instance with `terrain`, its extended body
// with `ext`) for smem_per_env bytes of dynamic shared memory an env at elt
// bytes a float: of 1 to CM_ENVS envs a block, the count that the runtime
// keeps the most envs of on one SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`
// x envs, the kernel's shared-memory limit raised to the block's share
// first, as a launch raises it; the larger count on a tie). Writes (envs a
// block, envs an SM) into out[0..1]; 0, or a CUDA error code when no block
// of one env fits.
int cdyn_cm_geometry(int kernel, int elt, int smem_per_env, int terrain, int ext, int* out) {
  if (kernel == 0)
    return elt == 4 ? cdyn_period_cm_geometry_f32(smem_per_env, terrain, ext, out)
                    : cdyn_period_cm_geometry_f64(smem_per_env, terrain, ext, out);
  return elt == 4 ? cdyn_rollout_cm_geometry_f32(smem_per_env, terrain, ext, out)
                  : cdyn_rollout_cm_geometry_f64(smem_per_env, terrain, ext, out);
}

#ifdef CDYN_CM_PROFILE
// The phase cycles of the constrained solves since the last call (`out`
// holds cdyn::CM_PHASES values), then zeroed.
int cdyn_cm_phase_cycles(unsigned long long* out) {
  const size_t bytes = sizeof(unsigned long long) * cdyn::CM_PHASES;
  cudaError_t e = cudaMemcpyFromSymbol(out, cdyn::cm_phase_cycles, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[cdyn::CM_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cdyn::cm_phase_cycles, zero, bytes));
}
#endif

const char* cdyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // part 0

// Each entry launches the flat-ground instance of its kernel, or with
// `terrain` the instance that evaluates the model's terrain section.
#define CDYN_LAUNCH(NAME, T, ...) \
  (terrain ? cdyn::NAME<T, true>(__VA_ARGS__) : cdyn::NAME<T, false>(__VA_ARGS__))
// The constrained kernels also take `ext`: the instance of the extended body
// (loop closures, spring-damper contacts and penalty bounds beside the rows).
#define CDYN_LAUNCH_CM(NAME, T, ...)                                                    \
  (ext ? (terrain ? cdyn::NAME<T, true, true>(__VA_ARGS__)                              \
                  : cdyn::NAME<T, false, true>(__VA_ARGS__))                            \
       : (terrain ? cdyn::NAME<T, true, false>(__VA_ARGS__)                             \
                  : cdyn::NAME<T, false, false>(__VA_ARGS__)))
// cdyn_accel also takes `sph`: the instance that takes SPHERICAL joints (part 7).
#define CDYN_SP_ENTRIES(SUFFIX, T)                                                               \
  int cdyn_accel_##SUFFIX(const void* ci, const void* cf, const void* q, const void* v,          \
                          const void* tau, void* out, int B, int smem_per_env, int terrain,      \
                          int sph, void* stream) {                                               \
    if (sph)                                                                                     \
      return cdyn_accel_sph_##SUFFIX(ci, cf, q, v, tau, out, B, smem_per_env, terrain, stream);  \
    return CDYN_LAUNCH(launch_accel, T, ci, cf, q, v, tau, out, B, smem_per_env, stream);        \
  }                                                                                              \
  int cdyn_period_##SUFFIX(const void* ci, const void* cf, const void* q, const void* v,         \
                           const void* cmd, void* qo, void* vo, void* eo, int B, int n_cmd,      \
                           int n_substeps, int integrator, int smem_per_env, int terrain,         \
                           void* stream) {                                                       \
    return CDYN_LAUNCH(launch_period, T, ci, cf, q, v, cmd, qo, vo, eo, B, n_cmd, n_substeps,    \
                       integrator, smem_per_env, stream);                                        \
  }                                                                                              \
  int cdyn_rollout_##SUFFIX(const void* ci, const void* cf, const void* pi, const void* pf,      \
                            int controller, const void* q, const void* v, const void* action,    \
                            const void* carry, void* qo, void* vo, void* eo, int B,              \
                            int n_action, int n_carry, int n_cmd, int n_ticks, int n_substeps,   \
                            int integrator, int smem_per_env, int terrain, void* stream) {       \
    return CDYN_LAUNCH(launch_rollout, T, ci, cf, pi, pf, controller, q, v, action, carry, qo,   \
                       vo, eo, B, n_action, n_carry, n_cmd, n_ticks, n_substeps, integrator,     \
                       smem_per_env, stream);                                                    \
  }                                                                                              \
  int cdyn_sp_blocks_per_sm_##SUFFIX(int kernel, int smem_per_env, int terrain) {                \
    return cdyn::sp_blocks_per_sm<T>(kernel, smem_per_env, terrain);                            \
  }
#define CDYN_PERIOD_CM_ENTRIES(SUFFIX, T)                                                        \
  int cdyn_period_cm_##SUFFIX(const void* ci, const void* cf, const void* si, const void* sf,    \
                              const void* q, const void* v, const void* cc, void* qo, void* vo,  \
                              void* eo, int B, int n_cmd, int n_substeps, int integrator,        \
                              int smem_per_env, int envs, int terrain, int ext, void* stream) {  \
    return CDYN_LAUNCH_CM(launch_period_cm, T, ci, cf, si, sf, q, v, cc, qo, vo, eo, B, n_cmd,   \
                          n_substeps, integrator, smem_per_env, envs, stream);                   \
  }                                                                                              \
  int cdyn_period_cm_geometry_##SUFFIX(int smem_per_env, int terrain, int ext, int* out) {       \
    return cdyn::cm_geometry<false, T>(smem_per_env, terrain, ext, out);                         \
  }
#define CDYN_ROLLOUT_CM_ENTRIES(SUFFIX, T)                                                       \
  int cdyn_rollout_cm_##SUFFIX(const void* ci, const void* cf, const void* si, const void* sf,   \
                               const void* pi, const void* pf, int controller, const void* q,    \
                               const void* v, const void* action, const void* carry, void* qo,   \
                               void* vo, void* eo, int B, int n_action, int n_block, int n_cmd,  \
                               int n_ticks, int n_substeps, int integrator, int smem_per_env,    \
                               int envs, int terrain, int ext, void* stream) {                   \
    return CDYN_LAUNCH_CM(launch_rollout_cm, T, ci, cf, si, sf, pi, pf, controller, q, v,        \
                          action, carry, qo, vo, eo, B, n_action, n_block, n_cmd, n_ticks,       \
                          n_substeps, integrator, smem_per_env, envs, stream);                   \
  }                                                                                              \
  int cdyn_rollout_cm_geometry_##SUFFIX(int smem_per_env, int terrain, int ext, int* out) {      \
    return cdyn::cm_geometry<true, T>(smem_per_env, terrain, ext, out);                          \
  }

#define CDYN_SPH_ENTRIES(SUFFIX, T)                                                              \
  int cdyn_accel_sph_##SUFFIX(const void* ci, const void* cf, const void* q, const void* v,      \
                              const void* tau, void* out, int B, int smem_per_env, int terrain,  \
                              void* stream) {                                                    \
    return terrain ? cdyn::launch_accel<T, true, true>(ci, cf, q, v, tau, out, B, smem_per_env,  \
                                                       stream)                                   \
                   : cdyn::launch_accel<T, false, true>(ci, cf, q, v, tau, out, B, smem_per_env, \
                                                        stream);                                 \
  }                                                                                              \
  int cdyn_accel_sph_blocks_per_sm_##SUFFIX(int smem_per_env, int terrain) {                     \
    const int threads = cdyn::SP_LANES * cdyn::SPA_ENVS, smem = smem_per_env * cdyn::SPA_ENVS;   \
    return terrain ? cdyn::blocks_per_sm(cdyn::cdyn_accel_kernel<T, true, true>, threads, smem)  \
                   : cdyn::blocks_per_sm(cdyn::cdyn_accel_kernel<T, false, true>, threads, smem); \
  }

#if CDYN_IN_PART(1)
CDYN_SP_ENTRIES(f32, float)
#endif
#if CDYN_IN_PART(2)
CDYN_SP_ENTRIES(f64, double)
#endif
#if CDYN_IN_PART(3)
CDYN_PERIOD_CM_ENTRIES(f32, float)
#endif
#if CDYN_IN_PART(4)
CDYN_PERIOD_CM_ENTRIES(f64, double)
#endif
#if CDYN_IN_PART(5)
CDYN_ROLLOUT_CM_ENTRIES(f32, float)
#endif
#if CDYN_IN_PART(6)
CDYN_ROLLOUT_CM_ENTRIES(f64, double)
#endif
#if CDYN_IN_PART(7)
CDYN_SPH_ENTRIES(f32, float)
CDYN_SPH_ENTRIES(f64, double)
#endif

#undef CDYN_LAUNCH
#undef CDYN_LAUNCH_CM
#undef CDYN_SP_ENTRIES
#undef CDYN_PERIOD_CM_ENTRIES
#undef CDYN_ROLLOUT_CM_ENTRIES
#undef CDYN_SPH_ENTRIES

}  // extern "C"
