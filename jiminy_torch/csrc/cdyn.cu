// Component-dynamics kernels for Hopper (sm_90a): the CUDA counterparts of the
// three Pallas kernels of jiminy_tpu/ops/cdyn.py.
//
//   cdyn_accel   <- _pallas_accel_fn  (one forward-dynamics evaluation)
//   cdyn_period  <- _pallas_period_fn (one controller period + extras)
//   cdyn_rollout <- _pallas_rollout_fn (one env step: controller ticks x
//                                       substeps + extras)
//
// They compute what the Pallas kernels compute, not their block structure.
// One thread integrates one environment: the whole state of an env step
// stays in the thread, and the I/O is read and written once in
// struct-of-arrays (n, B) layout, so neighbouring threads touch neighbouring
// addresses. The model's constants are read at run time from two buffers
// packed once per model (`pack_model` in jiminy_torch/ops/cdyn.py), so one
// build serves every model; joint loops stay loops (`#pragma unroll 1`).
//
// What bounds them: arithmetic. One ANYmal evaluation is about 19 k scalar
// operations per env; an env step is 161 evaluations. The design spends
// nothing on memory traffic beyond one read and one write of the state; the
// per-joint arrays live in local memory (cached in L1/L2).
//
// Every expression mirrors the plain PyTorch version (ComponentDynamics in
// jiminy_torch/ops/cdyn.py) term for term and in the same association order,
// so float64 runs agree to rounding and float32 runs differ only by FMA
// contraction and the last bits of the math library.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC (jiminy_torch/ops/kernels.py); no fast math.

#include <cuda_runtime.h>

#include <cfloat>

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

// exp(axis * q) for a constant unit axis, with the axis products packed
template <typename T>
__device__ __forceinline__ void rodrigues(const T* ax, const T* p, T q, T* r) {
  T c = cos(q), s = sin(q);
  T one_c = T(1) - c;
  r[0] = c + p[0] * one_c; r[1] = p[3] * one_c - ax[2] * s; r[2] = p[4] * one_c + ax[1] * s;
  r[3] = p[3] * one_c + ax[2] * s; r[4] = c + p[1] * one_c; r[5] = p[5] * one_c - ax[0] * s;
  r[6] = p[4] * one_c - ax[1] * s; r[7] = p[5] * one_c + ax[0] * s; r[8] = c + p[2] * one_c;
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
__device__ void solve_sym6(const T* m, T* y) {
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

// One spring-damper ground contact on flat ground (`_contact_fext`):
// world force fw, LOCAL parent-joint wrench (nj, fj), depth, and with `wl`
// the LOCAL contact-frame wrench [n(3), f(3)].
template <typename T>
__device__ void contact_eval(const Model<T>& M, int k, const T (*RW)[9], const T (*PW)[3],
                             const T (*VEL)[6], T* fw, T* fj, T* nj, T* depth_out, T* wl) {
  const int parent = M.cparent(k);
  const T* fp = M.cfpos(k);
  const T* rw = RW[parent];
  const T* pw = PW[parent];
  T pc[3], tmp[3];
  mv3(rw, fp, tmp);
  for (int i = 0; i < 3; ++i) pc[i] = tmp[i] + pw[i];
  const T* w_l = VEL[parent];
  const T* v_l = VEL[parent] + 3;
  T vpt[3];
  cross3(w_l, fp, tmp);
  for (int i = 0; i < 3; ++i) vpt[i] = v_l[i] + tmp[i];
  T v_w[3];
  mv3(rw, vpt, v_w);
  const T n[3] = {T(0), T(0), T(1)};
  T depth = pc[2];
  T v_depth = v_w[2];
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

// --------------------------------------------------------------------------
// The dynamics core (`_accel_core`): ABA with armature, joint damping,
// penalty joint bounds and spring-damper contact.
// --------------------------------------------------------------------------

template <typename T>
__device__ __noinline__ void accel_core(const Model<T>& M, const T* q, const T* v, const T* tc_in,
                                        T* qdd) {
  T tc[NV_MAX];
#pragma unroll 1
  for (int i = 0; i < M.nv; ++i) {
    const T damp = M.damping(i);
    tc[i] = (damp != T(0)) ? tc_in[i] - damp * v[i] : tc_in[i];
  }
  T R[NJ_MAX][9], P[NJ_MAX][3];
  joint_x(M, q, R, P);

  // Pass 1: velocities, bias, body articulated inertia, bias force
  T VEL[NJ_MAX][6], BIAS[NJ_MAX][6], IA[NJ_MAX][36], PA[NJ_MAX][6], S6[NJ_MAX][6];
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i) {
    const int p = M.parent(i);
    const int t = M.type(i);
    const int vi = M.iv(i);
    T w_p[3] = {T(0), T(0), T(0)}, v_p[3] = {T(0), T(0), T(0)};
    if (p >= 0)
      for (int k = 0; k < 3; ++k) { w_p[k] = VEL[p][k]; v_p[k] = VEL[p][3 + k]; }
    T w_in[3], v_in[3], tmp[3];
    tv3(R[i], w_p, w_in);
    cross3(P[i], w_p, tmp);
    for (int k = 0; k < 3; ++k) tmp[k] = v_p[k] - tmp[k];
    tv3(R[i], tmp, v_in);
    T vj_ang[3], vj_lin[3];
    if (t == FREE) {
      for (int k = 0; k < 3; ++k) { vj_lin[k] = v[vi + k]; vj_ang[k] = v[vi + 3 + k]; }
    } else {
      const T* ax = M.axis(i);
      if (t == REVOLUTE) {
        for (int k = 0; k < 3; ++k) {
          vj_ang[k] = ax[k] * v[vi]; vj_lin[k] = T(0);
          S6[i][k] = ax[k]; S6[i][3 + k] = T(0);
        }
      } else {
        for (int k = 0; k < 3; ++k) {
          vj_ang[k] = T(0); vj_lin[k] = ax[k] * v[vi];
          S6[i][k] = T(0); S6[i][3 + k] = ax[k];
        }
      }
    }
    T* w_i = VEL[i];
    T* v_i = VEL[i] + 3;
    for (int k = 0; k < 3; ++k) { w_i[k] = w_in[k] + vj_ang[k]; v_i[k] = v_in[k] + vj_lin[k]; }
    T c1[3], c2[3];
    cross3(w_i, vj_ang, BIAS[i]);
    cross3(w_i, vj_lin, c1);
    cross3(v_i, vj_ang, c2);
    for (int k = 0; k < 3; ++k) BIAS[i][3 + k] = c1[k] + c2[k];
    const T* ia0 = M.ia0(i);
    for (int k = 0; k < 36; ++k) IA[i][k] = ia0[k];
    T iv[6];
    sym6_mv(IA[i], w_i, v_i, iv);
    cross3(w_i, iv, c1);
    cross3(v_i, iv + 3, c2);
    for (int k = 0; k < 3; ++k) PA[i][k] = c1[k] + c2[k];
    cross3(w_i, iv + 3, PA[i] + 3);
  }

  // Contacts subtract from the bias force (LOCAL joint wrenches)
  if (M.has_contacts) {
    T RW[NJ_MAX][9], PW[NJ_MAX][3];
    world_placements(M, R, P, RW, PW);
    T FEXT[NJ_MAX][6];
    bool has[NJ_MAX];
#pragma unroll 1
    for (int i = 0; i < M.nj; ++i) has[i] = false;
#pragma unroll 1
    for (int k = 0; k < M.nc; ++k) {
      T fw[3], fj[3], nj[3], depth;
      contact_eval(M, k, RW, PW, VEL, fw, fj, nj, &depth, static_cast<T*>(nullptr));
      const int parent = M.cparent(k);
      if (!has[parent]) {
        for (int c = 0; c < 3; ++c) { FEXT[parent][c] = nj[c]; FEXT[parent][3 + c] = fj[c]; }
        has[parent] = true;
      } else {
        for (int c = 0; c < 3; ++c) {
          FEXT[parent][c] = FEXT[parent][c] + nj[c];
          FEXT[parent][3 + c] = FEXT[parent][3 + c] + fj[c];
        }
      }
    }
#pragma unroll 1
    for (int i = 0; i < M.nj; ++i)
      if (has[i])
        for (int c = 0; c < 6; ++c) PA[i][c] = PA[i][c] - FEXT[i][c];
  }

  // Stable penalty joint bounds
  T te[NV_MAX];
#pragma unroll 1
  for (int k = 0; k < M.nv; ++k) te[k] = T(0);
#pragma unroll 1
  for (int b = 0; b < M.nb; ++b) {
    const int vi = M.bound(b)[0], qi = M.bound(b)[1];
    const T* bf = M.boundf(b);
    const T over = tmax(q[qi] - bf[1], T(0));
    const T under = tmax(bf[0] - q[qi], T(0));
    const bool active = (over > T(0)) || (under > T(0));
    te[vi] = bf[2] * (under - over) - (active ? bf[3] * v[vi] : T(0));
  }

  // Pass 2: articulated inertia, inward
  T U[NJ_MAX][6], DINV[NJ_MAX], URHS[NJ_MAX];
  int root = -1;
#pragma unroll 1
  for (int i = M.nj - 1; i >= 0; --i) {
    const int p = M.parent(i);
    if (M.type(i) == FREE) {
      root = i;
      continue;
    }
    const int vi = M.iv(i);
    const T* s6 = S6[i];
    const T* pa6 = PA[i];
    T* u6 = U[i];
    sym6_mv(IA[i], s6, s6 + 3, u6);
    T d = s6[0] * u6[0];
    for (int k = 1; k < 6; ++k) d = d + s6[k] * u6[k];
    const T dinv = T(1) / (d + M.armature(vi));
    T spa = s6[0] * pa6[0];
    for (int k = 1; k < 6; ++k) spa = spa + s6[k] * pa6[k];
    const T u_r = tc[vi] + te[vi] - spa;
    DINV[i] = dinv;
    URHS[i] = u_r;
    if (p >= 0) {
      T ia_a[36];
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) ia_a[6 * r + c] = IA[i][6 * r + c] - u6[r] * u6[c] * dinv;
      T iab[6];
      sym6_mv(ia_a, BIAS[i], BIAS[i] + 3, iab);
      const T coef = u_r * dinv;
      T pa_n[6];
      for (int k = 0; k < 6; ++k) pa_n[k] = pa6[k] + iab[k] + u6[k] * coef;
      T ia_p[36];
      transform_sym6(ia_a, R[i], P[i], ia_p);
      for (int k = 0; k < 36; ++k) IA[p][k] = IA[p][k] + ia_p[k];
      T f_a[3], n_a[3], tmp[3];
      mv3(R[i], pa_n + 3, f_a);
      mv3(R[i], pa_n, n_a);
      cross3(P[i], f_a, tmp);
      for (int k = 0; k < 3; ++k) {
        PA[p][k] = PA[p][k] + (n_a[k] + tmp[k]);
        PA[p][3 + k] = PA[p][3 + k] + f_a[k];
      }
    }
  }

  // Pass 3: outward accelerations (-gravity at the root)
  T ACC[NJ_MAX][6];
  const T a0[6] = {T(0), T(0), T(0), -M.g(0), -M.g(1), -M.g(2)};
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i) {
    const int p = M.parent(i);
    const int vi = M.iv(i);
    const T* a_p = (p >= 0) ? ACC[p] : a0;
    T am[6], tmp[3], tmp2[3];
    tv3(R[i], a_p, am);
    cross3(P[i], a_p, tmp);
    for (int k = 0; k < 3; ++k) tmp2[k] = a_p[3 + k] - tmp[k];
    tv3(R[i], tmp2, am + 3);
    for (int k = 0; k < 6; ++k) am[k] = am[k] + BIAS[i][k];
    if (M.type(i) == FREE) {
      const T* ia_root = IA[root];
      T m6[36];
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) m6[6 * r + c] = ia_root[6 * ((r + 3) % 6) + (c + 3) % 6];
      for (int k = 0; k < 6; ++k) m6[7 * k] = m6[7 * k] + M.armature(vi + k);
      T iam[6];
      sym6_mv(ia_root, am, am + 3, iam);
      T y[6];
      for (int k = 0; k < 3; ++k) {
        y[k] = tc[vi + k] - PA[i][3 + k] - iam[3 + k];
        y[3 + k] = tc[vi + 3 + k] - PA[i][k] - iam[k];
      }
      solve_sym6(m6, y);
      for (int k = 0; k < 6; ++k) qdd[vi + k] = y[k];
      for (int k = 0; k < 3; ++k) {
        ACC[i][k] = am[k] + y[3 + k];
        ACC[i][3 + k] = am[3 + k] + y[k];
      }
    } else {
      const T* u6 = U[i];
      T s = u6[0] * am[0];
      for (int k = 1; k < 6; ++k) s = s + u6[k] * am[k];
      const T a = DINV[i] * (URHS[i] - s);
      qdd[vi] = a;
      for (int k = 0; k < 6; ++k) ACC[i][k] = am[k] + S6[i][k] * a;
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

// Motor commands -> joint torques (`MotorTransmission.__call__`).
template <typename T>
__device__ void tau_c(const Model<T>& M, const T* v, const T* cc, T* tc) {
#pragma unroll 1
  for (int i = 0; i < M.nv; ++i) tc[i] = T(0);
#pragma unroll 1
  for (int m = 0; m < M.nm; ++m) {
    const int* mi = M.motor(m);
    const T* mf = M.motorf(m);  // red el vl denom fvp fvn fdp fdn fds
    const int vi = mi[0];
    const T v_j = v[vi];
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
    tc[vi] = tc[vi] + u_t;
  }
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
    const T* vl = dv + vi;
    const T* w = dv + vi + 3;
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
    quat_to_m(q[qi + 3], q[qi + 4], q[qi + 5], q[qi + 6], rot);
    mv3(rot, p_d, tmp);
    for (int k = 0; k < 3; ++k) out[qi + k] = q[qi + k] + tmp[k];
    // quat * exp3(omega), normalized
    const T s_over = small ? T(0.5) - theta2 / T(48) : sin(T(0.5) * theta) / theta;
    const T cw = small ? T(1) - theta2 / T(8) + theta2 * theta2 / T(384) : cos(T(0.5) * theta);
    const T x2 = w[0] * s_over, y2 = w[1] * s_over, z2 = w[2] * s_over, w2 = cw;
    const T x1 = q[qi + 3], y1 = q[qi + 4], z1 = q[qi + 5], w1 = q[qi + 6];
    const T qx = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
    const T qy = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
    const T qz = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
    const T qw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
    const T nrm = sqrt(qx * qx + qy * qy + qz * qz + qw * qw);
    out[qi + 3] = qx / nrm;
    out[qi + 4] = qy / nrm;
    out[qi + 5] = qz / nrm;
    out[qi + 6] = qw / nrm;
  }
}

// One fixed-dt substep (`_build_substep`), q and v updated in place.
template <typename T>
__device__ __noinline__ void substep(const Model<T>& M, T* q, T* v, const T* cc, int integrator) {
  T tc[NV_MAX], k1[NV_MAX], dq[NV_MAX], qt[NQ_MAX];
  const int nv = M.nv;
  const T dt = M.dt(), hdt = M.half_dt();
  tau_c(M, v, cc, tc);
  accel_core(M, q, v, tc, k1);
  if (integrator == EULER) {
    for (int k = 0; k < nv; ++k) dq[k] = dt * v[k];
    integrate(M, q, dq, qt);
    for (int k = 0; k < M.nq; ++k) q[k] = qt[k];
    for (int k = 0; k < nv; ++k) v[k] = v[k] + dt * k1[k];
    return;
  }
  T k2[NV_MAX], k3[NV_MAX], k4[NV_MAX], v2[NV_MAX], v3[NV_MAX], v4[NV_MAX];
  for (int k = 0; k < nv; ++k) dq[k] = hdt * v[k];
  integrate(M, q, dq, qt);
  for (int k = 0; k < nv; ++k) v2[k] = v[k] + hdt * k1[k];
  tau_c(M, v2, cc, tc);
  accel_core(M, qt, v2, tc, k2);
  for (int k = 0; k < nv; ++k) dq[k] = hdt * v2[k];
  integrate(M, q, dq, qt);
  for (int k = 0; k < nv; ++k) v3[k] = v[k] + hdt * k2[k];
  tau_c(M, v3, cc, tc);
  accel_core(M, qt, v3, tc, k3);
  for (int k = 0; k < nv; ++k) dq[k] = dt * v3[k];
  integrate(M, q, dq, qt);
  for (int k = 0; k < nv; ++k) v4[k] = v[k] + dt * k3[k];
  tau_c(M, v4, cc, tc);
  accel_core(M, qt, v4, tc, k4);
  const T dt6 = M.dt6();
  for (int k = 0; k < nv; ++k) dq[k] = dt6 * (v[k] + T(2) * v2[k] + T(2) * v3[k] + v4[k]);
  integrate(M, q, dq, qt);
  for (int k = 0; k < M.nq; ++k) q[k] = qt[k];
  for (int k = 0; k < nv; ++k) v[k] = v[k] + dt6 * (k1[k] + T(2) * k2[k] + T(2) * k3[k] + k4[k]);
}

// End-of-period outputs `[a | f_world | w_local | depth | imu]` written to
// rows of the (n_extra, B) extras array (`_build_final_outputs`).
template <typename T>
__device__ __noinline__ void final_outputs(const Model<T>& M, const T* q, const T* v, const T* cc,
                                           T* eo, int B, int b) {
  T tc[NV_MAX], a[NV_MAX];
  tau_c(M, v, cc, tc);
  accel_core(M, q, v, tc, a);
  T R[NJ_MAX][9], P[NJ_MAX][3], RW[NJ_MAX][9], PW[NJ_MAX][3], VEL[NJ_MAX][6], ACC[NJ_MAX][6];
  joint_x(M, q, R, P);
  world_placements(M, R, P, RW, PW);
  fk_vel_acc(M, R, P, v, a, VEL, ACC);
  const int nv = M.nv, nc = M.has_contacts ? M.nc : 0;
  for (int k = 0; k < nv; ++k) eo[(size_t)k * B + b] = a[k];
  const int o_fw = nv, o_wl = nv + 3 * nc, o_d = nv + 9 * nc, o_imu = nv + 10 * nc;
#pragma unroll 1
  for (int k = 0; k < nc; ++k) {
    T fw[3], fj[3], nj[3], depth, wl[6];
    contact_eval(M, k, RW, PW, VEL, fw, fj, nj, &depth, wl);
    for (int c = 0; c < 3; ++c) eo[(size_t)(o_fw + 3 * k + c) * B + b] = fw[c];
    for (int c = 0; c < 6; ++c) eo[(size_t)(o_wl + 6 * k + c) * B + b] = wl[c];
    eo[(size_t)(o_d + k) * B + b] = depth;
  }
#pragma unroll 1
  for (int k = 0; k < M.ni; ++k) {
    const int parent = M.iparent(k);
    const T* frot = M.ifrot(k);
    const T* fp = M.ifpos(k);
    const T* w_l = VEL[parent];
    const T* v_l = VEL[parent] + 3;
    const T* a_a = ACC[parent];
    const T* a_l = ACC[parent] + 3;
    T w_f[3], v_f[3], al_f[3], tmp[3], tmp2[3];
    tv3(frot, w_l, w_f);
    cross3(fp, w_l, tmp);
    for (int c = 0; c < 3; ++c) tmp2[c] = v_l[c] - tmp[c];
    tv3(frot, tmp2, v_f);
    cross3(fp, a_a, tmp);
    for (int c = 0; c < 3; ++c) tmp2[c] = a_l[c] - tmp[c];
    tv3(frot, tmp2, al_f);
    cross3(w_f, v_f, tmp);
    T rot_f[9], g_f[3];
    mm3(RW[parent], frot, rot_f);
    const T g[3] = {M.g(0), M.g(1), M.g(2)};
    tv3(rot_f, g, g_f);
    for (int c = 0; c < 3; ++c) {
      eo[(size_t)(o_imu + 6 * k + c) * B + b] = w_f[c];
      eo[(size_t)(o_imu + 6 * k + 3 + c) * B + b] = (al_f[c] + tmp[c]) - g_f[c];
    }
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

// --------------------------------------------------------------------------
// The three entry kernels: one thread per environment, (n, B) layout.
// --------------------------------------------------------------------------

template <typename T>
__global__ void cdyn_accel_kernel(const int* ci, const T* cf, const T* __restrict__ q_g,
                                  const T* __restrict__ v_g, const T* __restrict__ tau_g,
                                  T* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Model<T> M(ci, cf);
  T q[NQ_MAX], v[NV_MAX], tau[NV_MAX], qdd[NV_MAX];
  for (int i = 0; i < M.nq; ++i) q[i] = q_g[(size_t)i * B + b];
  for (int i = 0; i < M.nv; ++i) { v[i] = v_g[(size_t)i * B + b]; tau[i] = tau_g[(size_t)i * B + b]; }
  accel_core(M, q, v, tau, qdd);
  for (int i = 0; i < M.nv; ++i) out[(size_t)i * B + b] = qdd[i];
}

template <typename T>
__global__ void cdyn_period_kernel(const int* ci, const T* cf, const T* __restrict__ q_g,
                                   const T* __restrict__ v_g, const T* __restrict__ cmd_g,
                                   T* __restrict__ qo, T* __restrict__ vo, T* __restrict__ eo,
                                   int B, int n_cmd, int n_substeps, int integrator) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Model<T> M(ci, cf);
  T q[NQ_MAX], v[NV_MAX], cc[NCMD_MAX];
  for (int i = 0; i < M.nq; ++i) q[i] = q_g[(size_t)i * B + b];
  for (int i = 0; i < M.nv; ++i) v[i] = v_g[(size_t)i * B + b];
  for (int i = 0; i < n_cmd; ++i) cc[i] = cmd_g[(size_t)i * B + b];
#pragma unroll 1
  for (int s = 0; s < n_substeps; ++s) substep(M, q, v, cc, integrator);
  for (int i = 0; i < M.nq; ++i) qo[(size_t)i * B + b] = q[i];
  for (int i = 0; i < M.nv; ++i) vo[(size_t)i * B + b] = v[i];
  final_outputs(M, q, v, cc, eo, B, b);
}

template <typename T>
__global__ void cdyn_rollout_kernel(const int* ci, const T* cf, const int* pi, const T* pf,
                                    int controller, const T* __restrict__ q_g,
                                    const T* __restrict__ v_g, const T* __restrict__ a_g,
                                    const T* __restrict__ c_g, T* __restrict__ qo,
                                    T* __restrict__ vo, T* __restrict__ eo, int B, int n_action,
                                    int n_carry, int n_cmd, int n_ticks, int n_substeps,
                                    int integrator) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Model<T> M(ci, cf);
  T q[NQ_MAX], v[NV_MAX], ac[NACT_MAX], bc[NCARRY_MAX], bc_new[NCARRY_MAX], cc[NCMD_MAX];
  for (int i = 0; i < M.nq; ++i) q[i] = q_g[(size_t)i * B + b];
  for (int i = 0; i < M.nv; ++i) v[i] = v_g[(size_t)i * B + b];
  for (int i = 0; i < n_action; ++i) ac[i] = a_g[(size_t)i * B + b];
  for (int i = 0; i < n_carry; ++i) bc[i] = c_g[(size_t)i * B + b];
  for (int i = 0; i < n_cmd; ++i) cc[i] = T(0);
#pragma unroll 1
  for (int t = 0; t < n_ticks; ++t) {
    if (controller == CONTROLLER_PD) {
      pd_controller(pi, pf, q, v, bc, ac, cc, bc_new);
      for (int i = 0; i < n_carry; ++i) bc[i] = bc_new[i];
    } else {  // zero-order hold of the action, carry unchanged
      for (int i = 0; i < n_cmd; ++i) cc[i] = ac[i];
    }
#pragma unroll 1
    for (int s = 0; s < n_substeps; ++s) substep(M, q, v, cc, integrator);
  }
  for (int i = 0; i < M.nq; ++i) qo[(size_t)i * B + b] = q[i];
  for (int i = 0; i < M.nv; ++i) vo[(size_t)i * B + b] = v[i];
  final_outputs(M, q, v, cc, eo, B, b);
  const int n_std = M.nv + 10 * (M.has_contacts ? M.nc : 0) + 6 * M.ni;
  for (int i = 0; i < n_cmd; ++i) eo[(size_t)(n_std + i) * B + b] = cc[i];
  for (int i = 0; i < n_carry; ++i) eo[(size_t)(n_std + n_cmd + i) * B + b] = bc[i];
}

constexpr int kThreads = 128;

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

template <typename T>
int launch_accel(const void* ci, const void* cf, const void* q, const void* v, const void* tau,
                 void* out, int B, void* stream) {
  cudaGetLastError();
  cdyn_accel_kernel<T><<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const T*>(q),
      static_cast<const T*>(v), static_cast<const T*>(tau), static_cast<T*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_period(const void* ci, const void* cf, const void* q, const void* v, const void* cmd,
                  void* qo, void* vo, void* eo, int B, int n_cmd, int n_substeps, int integrator,
                  void* stream) {
  cudaGetLastError();
  cdyn_period_kernel<T><<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const T*>(q),
      static_cast<const T*>(v), static_cast<const T*>(cmd), static_cast<T*>(qo),
      static_cast<T*>(vo), static_cast<T*>(eo), B, n_cmd, n_substeps, integrator);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rollout(const void* ci, const void* cf, const void* pi, const void* pf, int controller,
                   const void* q, const void* v, const void* action, const void* carry, void* qo,
                   void* vo, void* eo, int B, int n_action, int n_carry, int n_cmd, int n_ticks,
                   int n_substeps, int integrator, void* stream) {
  cudaGetLastError();
  cdyn_rollout_kernel<T><<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ci), static_cast<const T*>(cf), static_cast<const int*>(pi),
      static_cast<const T*>(pf), controller, static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<const T*>(action), static_cast<const T*>(carry), static_cast<T*>(qo),
      static_cast<T*>(vo), static_cast<T*>(eo), B, n_action, n_carry, n_cmd, n_ticks, n_substeps,
      integrator);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cdyn

// --------------------------------------------------------------------------
// Plain C interface (bound with ctypes by jiminy_torch/ops/kernels.py)
// --------------------------------------------------------------------------

extern "C" {

int cdyn_caps(int* out, int n) {
  const int caps[] = {cdyn::NJ_MAX,  cdyn::NQ_MAX,   cdyn::NV_MAX,   cdyn::NC_MAX,
                      cdyn::NI_MAX,  cdyn::NM_MAX,   cdyn::NB_MAX,   cdyn::NCMD_MAX,
                      cdyn::NACT_MAX, cdyn::NCARRY_MAX};
  const int count = static_cast<int>(sizeof(caps) / sizeof(caps[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = caps[i];
  return count;
}

const char* cdyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define CDYN_ENTRIES(SUFFIX, T)                                                                  \
  int cdyn_accel_##SUFFIX(const void* ci, const void* cf, const void* q, const void* v,          \
                          const void* tau, void* out, int B, void* stream) {                     \
    return cdyn::launch_accel<T>(ci, cf, q, v, tau, out, B, stream);                             \
  }                                                                                              \
  int cdyn_period_##SUFFIX(const void* ci, const void* cf, const void* q, const void* v,         \
                           const void* cmd, void* qo, void* vo, void* eo, int B, int n_cmd,      \
                           int n_substeps, int integrator, void* stream) {                       \
    return cdyn::launch_period<T>(ci, cf, q, v, cmd, qo, vo, eo, B, n_cmd, n_substeps,           \
                                  integrator, stream);                                           \
  }                                                                                              \
  int cdyn_rollout_##SUFFIX(const void* ci, const void* cf, const void* pi, const void* pf,      \
                            int controller, const void* q, const void* v, const void* action,    \
                            const void* carry, void* qo, void* vo, void* eo, int B,              \
                            int n_action, int n_carry, int n_cmd, int n_ticks, int n_substeps,   \
                            int integrator, void* stream) {                                      \
    return cdyn::launch_rollout<T>(ci, cf, pi, pf, controller, q, v, action, carry, qo, vo, eo,  \
                                   B, n_action, n_carry, n_cmd, n_ticks, n_substeps, integrator, \
                                   stream);                                                      \
  }

CDYN_ENTRIES(f32, float)
CDYN_ENTRIES(f64, double)

#undef CDYN_ENTRIES

}  // extern "C"
