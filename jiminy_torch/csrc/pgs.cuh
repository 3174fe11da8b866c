// Constrained (PGS) bodies of the period and rollout kernels: the CUDA
// counterparts of jiminy_tpu/engine/solver.py's component path
// (`constrained_accel_full_components`, `make_constrained_period_integrator`,
// `make_constrained_rollout_integrator`), run inside
//
//   cdyn_period_cm  <- _pallas_period_fn  with the constrained body
//   cdyn_rollout_cm <- _pallas_rollout_fn with the constrained body
//
// One thread per environment, as in cdyn.cu, whose device functions
// (joint_x, world_placements, fk_vel_acc, integrate, tau_c, pd_controller,
// transform_sym6, sym6_mv) this header reuses; it is included by cdyn.cu
// after them. One constrained solve: component CRBA and RNEA, an LDL^T
// factor of the mass matrix, the joint-bound and ground-contact rows with
// their Baumgarte drifts and active-set hysteresis, the Delassus matrix
// A = J M^-1 J^T with its diagonal regularization, and a fixed number of
// boxed/cone Gauss-Seidel sweeps warm-started from the carried multipliers.
// Every sum runs in the order of the plain version (jiminy_torch/engine/
// solver.py) and of jiminy_tpu; the structural zeros that jiminy_tpu prunes
// at trace time are multiplied here (exact for finite operands). The dense
// per-thread arrays (J, M^-1 J^T, A, M) live in local memory.
#pragma once

namespace cdyn {

constexpr int NROW_MAX = 40;  // constraint rows: bounds + 4 per contact
// Int buffer `si`: header [N nb nc iter_max stage_warm_start ...], then per
// bound (q index, v index), per contact (parent joint).
// Float buffer `sf`: header [kp kd friction torsion regularization
// min_regularizer transition_eps ...], the relaxation weight of every sweep,
// then per bound (lo hi lo+eps hi-eps), per contact fpos(3) frot(9).
constexpr int SI_HEADER = 8, SF_HEADER = 8, SI_BOUND = 2, SI_CONTACT = 1, SF_BOUND = 4,
              SF_CONTACT = 12;

template <typename T>
struct CModel {
  const int* __restrict__ si;
  const T* __restrict__ sf;
  int n, nb, nc, iter_max, stage_warm;
  int fb, fc;  // float offsets: bounds, contacts

  __device__ CModel(const int* si_, const T* sf_) : si(si_), sf(sf_) {
    n = si[0]; nb = si[1]; nc = si[2]; iter_max = si[3]; stage_warm = si[4];
    fb = SF_HEADER + iter_max;
    fc = fb + SF_BOUND * nb;
  }
  __device__ int bq(int b) const { return si[SI_HEADER + SI_BOUND * b]; }
  __device__ int bv(int b) const { return si[SI_HEADER + SI_BOUND * b + 1]; }
  __device__ int cparent(int k) const { return si[SI_HEADER + SI_BOUND * nb + SI_CONTACT * k]; }
  __device__ T kp() const { return sf[0]; }
  __device__ T kd() const { return sf[1]; }
  __device__ T friction() const { return sf[2]; }
  __device__ T torsion() const { return sf[3]; }
  __device__ T reg() const { return sf[4]; }
  __device__ T min_reg() const { return sf[5]; }
  __device__ T eps() const { return sf[6]; }
  __device__ T relax(int it) const { return sf[SF_HEADER + it]; }
  __device__ const T* boundf(int b) const { return sf + fb + SF_BOUND * b; }
  __device__ const T* cfpos(int k) const { return sf + fc + SF_CONTACT * k; }
  __device__ const T* cfrot(int k) const { return cfpos(k) + 3; }
};

// Right-handed basis with column 2 = the unit ground normal n
// (`_normal_basis_components`): columns c0, c1.
template <typename T>
__device__ void normal_basis(const T* n, T* c0, T* c1) {
  T a[3] = {T(0), n[2], -n[1]};      // cross(n, ex)
  const T b[3] = {-n[2], T(0), n[0]};  // cross(n, ey), if n ~ ex
  T nrm = sqrt(tmax(dot3(a, a), T(0)));
  if (nrm < T(1e-6))
    for (int i = 0; i < 3; ++i) a[i] = b[i];
  nrm = sqrt(tmax(dot3(a, a), T(0)));
  const T inv = T(1) / tmax(nrm, T(1e-12));
  for (int i = 0; i < 3; ++i) c1[i] = a[i] * inv;
  cross3(c1, n, c0);
}

// Force (n, f) from a child joint frame to its parent's (`_force_transform_col`).
template <typename T>
__device__ __forceinline__ void force_to_parent(const T* r, const T* pos, T* n, T* f) {
  T f_a[3], n_a[3], tmp[3];
  mv3(r, f, f_a);
  mv3(r, n, n_a);
  cross3(pos, f_a, tmp);
  for (int k = 0; k < 3; ++k) { n[k] = n_a[k] + tmp[k]; f[k] = f_a[k]; }
}

// (angular, linear) motion axis of a 1-dof joint
template <typename T>
__device__ __forceinline__ void motion_axis(const Model<T>& M, int j, T* ax_a, T* ax_l) {
  const T* ax = M.axis(j);
  const bool rev = M.type(j) == REVOLUTE;
  for (int k = 0; k < 3; ++k) { ax_a[k] = rev ? ax[k] : T(0); ax_l[k] = rev ? T(0) : ax[k]; }
}

// CRBA with armature (`mass_matrix_components`), row-major nv x nv with
// row stride NV_MAX.
template <typename T>
__device__ void crba(const Model<T>& M, const T (*R)[9], const T (*P)[3], T* Mm, T (*IC)[36]) {
  const int nv = M.nv;
#pragma unroll 1
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) Mm[NV_MAX * i + j] = T(0);
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i)
    for (int k = 0; k < 36; ++k) IC[i][k] = M.ia0(i)[k];
#pragma unroll 1
  for (int i = M.nj - 1; i >= 0; --i) {
    const int vi = M.iv(i);
    if (M.type(i) == FREE) {  // permuted composite inertia + armature
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) Mm[NV_MAX * (vi + r) + vi + c] = IC[i][6 * ((r + 3) % 6) + (c + 3) % 6];
      for (int r = 0; r < 6; ++r)
        Mm[NV_MAX * (vi + r) + vi + r] = Mm[NV_MAX * (vi + r) + vi + r] + M.armature(vi + r);
      continue;
    }
    T ax_a[3], ax_l[3], fv[6];
    motion_axis(M, i, ax_a, ax_l);
    sym6_mv(IC[i], ax_a, ax_l, fv);
    Mm[NV_MAX * vi + vi] = (dot3(ax_a, fv) + dot3(ax_l, fv + 3)) + M.armature(vi);
    T n_c[3] = {fv[0], fv[1], fv[2]}, f_c[3] = {fv[3], fv[4], fv[5]};
    int j = i;
#pragma unroll 1
    while (M.parent(j) >= 0) {  // transport the column up the tree
      force_to_parent(R[j], P[j], n_c, f_c);
      j = M.parent(j);
      const int vj = M.iv(j);
      if (M.type(j) == FREE) {
        const T full[6] = {n_c[0], n_c[1], n_c[2], f_c[0], f_c[1], f_c[2]};
        for (int k = 0; k < 6; ++k) {
          Mm[NV_MAX * vi + vj + k] = full[(k + 3) % 6];
          Mm[NV_MAX * (vj + k) + vi] = full[(k + 3) % 6];
        }
      } else {
        T aj_a[3], aj_l[3];
        motion_axis(M, j, aj_a, aj_l);
        const T val = dot3(aj_a, n_c) + dot3(aj_l, f_c);
        Mm[NV_MAX * vi + vj] = val;
        Mm[NV_MAX * vj + vi] = val;
      }
    }
    const int p = M.parent(i);
    if (p >= 0) {
      T ia_p[36];
      transform_sym6(IC[i], R[i], P[i], ia_p);
      for (int k = 0; k < 36; ++k) IC[p][k] = IC[p][k] + ia_p[k];
    }
  }
}

// Nonlinear effects: RNEA with zero joint acceleration (`nle_components`).
template <typename T>
__device__ void rnea_nle(const Model<T>& M, const T (*R)[9], const T (*P)[3], const T* v,
                         T (*VEL)[6], T (*ACC)[6], T (*F)[6], T* tau) {
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i) {
    const int p = M.parent(i);
    const int t = M.type(i);
    const int vi = M.iv(i);
    T w_p[3] = {T(0), T(0), T(0)}, v_p[3] = {T(0), T(0), T(0)};
    T aa_p[3] = {T(0), T(0), T(0)}, al_p[3] = {-M.g(0), -M.g(1), -M.g(2)};
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
    T vj_ang[3], vj_lin[3];
    if (t == FREE) {
      for (int k = 0; k < 3; ++k) { vj_lin[k] = v[vi + k]; vj_ang[k] = v[vi + 3 + k]; }
    } else {
      const T* ax = M.axis(i);
      const bool rev = (t == REVOLUTE);
      for (int k = 0; k < 3; ++k) {
        vj_ang[k] = rev ? ax[k] * v[vi] : T(0);
        vj_lin[k] = rev ? T(0) : ax[k] * v[vi];
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
      ACC[i][k] = aw_in[k] + b_ang[k];
      ACC[i][3 + k] = al_in[k] + (c1[k] + c2[k]);
    }
  }
  bool has[NJ_MAX];
#pragma unroll 1
  for (int i = 0; i < M.nj; ++i) has[i] = false;
#pragma unroll 1
  for (int i = M.nj - 1; i >= 0; --i) {
    const T* w_i = VEL[i];
    const T* v_i = VEL[i] + 3;
    T ia_av[6], iv[6], c1[3], c2[3];
    sym6_mv(M.ia0(i), ACC[i], ACC[i] + 3, ia_av);
    sym6_mv(M.ia0(i), w_i, v_i, iv);
    cross3(w_i, iv, c1);
    cross3(v_i, iv + 3, c2);
    T f_a[3], f_l[3];
    for (int k = 0; k < 3; ++k) f_a[k] = ia_av[k] + (c1[k] + c2[k]);
    cross3(w_i, iv + 3, c1);
    for (int k = 0; k < 3; ++k) f_l[k] = ia_av[3 + k] + c1[k];
    if (has[i])
      for (int k = 0; k < 3; ++k) { f_a[k] = f_a[k] + F[i][k]; f_l[k] = f_l[k] + F[i][3 + k]; }
    const int vi = M.iv(i);
    if (M.type(i) == FREE) {
      const T full[6] = {f_a[0], f_a[1], f_a[2], f_l[0], f_l[1], f_l[2]};
      for (int k = 0; k < 6; ++k) tau[vi + k] = full[(k + 3) % 6];
    } else {
      T ax_a[3], ax_l[3];
      motion_axis(M, i, ax_a, ax_l);
      tau[vi] = dot3(ax_a, f_a) + dot3(ax_l, f_l);
    }
    const int p = M.parent(i);
    if (p >= 0) {
      force_to_parent(R[i], P[i], f_a, f_l);
      if (has[p]) {
        for (int k = 0; k < 3; ++k) { F[p][k] = F[p][k] + f_a[k]; F[p][3 + k] = F[p][3 + k] + f_l[k]; }
      } else {
        for (int k = 0; k < 3; ++k) { F[p][k] = f_a[k]; F[p][3 + k] = f_l[k]; }
        has[p] = true;
      }
    }
  }
}

// In-place LDL^T of the nv x nv matrix Mm (`_ldl_factor_components`): L
// below the diagonal, the inverse pivots in dinv.
template <typename T>
__device__ void ldl_factor(int n, T* Mm, T* dinv) {
  T d[NV_MAX];
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    T dj = Mm[NV_MAX * j + j];
    for (int k = 0; k < j; ++k) dj = dj - Mm[NV_MAX * j + k] * Mm[NV_MAX * j + k] * d[k];
    d[j] = dj;
    dinv[j] = T(1) / dj;
#pragma unroll 1
    for (int i = j + 1; i < n; ++i) {
      T s = Mm[NV_MAX * i + j];
      for (int k = 0; k < j; ++k) s = s - Mm[NV_MAX * i + k] * Mm[NV_MAX * j + k] * d[k];
      Mm[NV_MAX * i + j] = s * dinv[j];
    }
  }
}

// Solve in place with the factor (`_ldl_solve_components`).
template <typename T>
__device__ void ldl_solve(int n, const T* L, const T* dinv, T* y) {
#pragma unroll 1
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < i; ++k) y[i] = y[i] - L[NV_MAX * i + k] * y[k];
#pragma unroll 1
  for (int i = 0; i < n; ++i) y[i] = y[i] * dinv[i];
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i)
    for (int k = i + 1; k < n; ++k) y[i] = y[i] - L[NV_MAX * k + i] * y[k];
}

// Joint-bound and ground-contact rows on flat ground
// (`constraint_system_components`): J (row stride NV_MAX) and drifts, masked
// by activity, and the new active sets; depth per contact.
template <typename T>
__device__ void constraint_rows(const Model<T>& M, const CModel<T>& C, const T* q, const T* v,
                                const T (*RW)[9], const T (*PW)[3], const T (*VEL)[6],
                                const T (*ACC)[6], const bool* cact_in, const bool* bact_in,
                                T* J, T* drift, bool* cact_out, bool* bact_out, T* depth_out) {
  const int nv = M.nv;
  const T kp = C.kp(), kd = C.kd();
#pragma unroll 1
  for (int r = 0; r < C.n; ++r)
    for (int d = 0; d < nv; ++d) J[NV_MAX * r + d] = T(0);
#pragma unroll 1
  for (int b = 0; b < C.nb; ++b) {
    const int qi = C.bq(b), vi = C.bv(b);
    const T* bf = C.boundf(b);  // lo hi lo+eps hi-eps
    const T qj = q[qi], vj = v[vi];
    const bool over = qj > bf[1];
    const bool raw = over || (qj < bf[0]);
    const bool inside = (qj > bf[2]) && (qj < bf[3]);
    const bool act = raw || (bact_in[b] && !inside);
    bact_out[b] = act;
    const T sign = over ? T(-1) : T(1);
    J[NV_MAX * b + vi] = act ? sign : T(0);
    const T dq = qj - clip(qj, bf[0], bf[1]);
    drift[b] = act ? sign * (kp * dq + kd * vj) : T(0);
  }
#pragma unroll 1
  for (int k = 0; k < C.nc; ++k) {
    const int r0 = C.nb + 4 * k;
    const int parent = C.cparent(k);
    const T* fp = C.cfpos(k);
    const T* rw = RW[parent];
    T pc[3], tmp[3];
    mv3(rw, fp, tmp);
    for (int i = 0; i < 3; ++i) pc[i] = tmp[i] + PW[parent][i];
    const T n[3] = {T(0), T(0), T(1)};  // flat ground: height 0, unit normal
    const T depth = (pc[2] - T(0)) * n[2];
    const bool act = (depth < T(0)) || (cact_in[k] && depth <= C.eps());
    cact_out[k] = act;
    depth_out[k] = depth;
    T c0[3], c1[3];
    normal_basis(n, c0, c1);
    // Jacobian columns over the support dofs (the ancestors' dofs)
#pragma unroll 1
    for (int j = parent; j >= 0; j = M.parent(j)) {
      const T* rj = RW[j];
      T lever[3];
      for (int i = 0; i < 3; ++i) lever[i] = pc[i] - PW[j][i];
      const int vi = M.iv(j);
      const int t = M.type(j);
      const int ndof = (t == FREE) ? 6 : 1;
      for (int m = 0; m < ndof; ++m) {
        T ang[3], lin[3];
        if (t == FREE && m < 3) {  // translational dofs: R e_m
          for (int i = 0; i < 3; ++i) { lin[i] = rj[3 * i + m]; ang[i] = T(0); }
        } else if (t == FREE || t == REVOLUTE) {
          if (t == FREE) {
            for (int i = 0; i < 3; ++i) ang[i] = rj[3 * i + m - 3];
          } else {
            mv3(rj, M.axis(j), ang);
          }
          cross3(ang, lever, lin);
        } else {  // PRISMATIC
          mv3(rj, M.axis(j), lin);
          for (int i = 0; i < 3; ++i) ang[i] = T(0);
        }
        const int d = vi + m;
        J[NV_MAX * (r0 + 0) + d] = act ? dot3(c0, lin) : T(0);
        J[NV_MAX * (r0 + 1) + d] = act ? dot3(c1, lin) : T(0);
        J[NV_MAX * (r0 + 2) + d] = act ? dot3(n, lin) : T(0);
        J[NV_MAX * (r0 + 3) + d] = act ? dot3(n, ang) : T(0);
      }
    }
    // Frame world velocity and bias acceleration; Baumgarte drifts
    const T* w_l = VEL[parent];
    const T* v_l = VEL[parent] + 3;
    const T* a_a = ACC[parent];
    const T* a_l = ACC[parent] + 3;
    T vw_ang[3], vw_lin[3], aw_ang[3], aw_lin[3], t2[3];
    mv3(rw, w_l, vw_ang);
    cross3(w_l, fp, tmp);
    for (int i = 0; i < 3; ++i) t2[i] = v_l[i] + tmp[i];
    mv3(rw, t2, vw_lin);
    mv3(rw, a_a, aw_ang);
    cross3(fp, a_a, tmp);
    for (int i = 0; i < 3; ++i) t2[i] = a_l[i] - tmp[i];
    mv3(rw, t2, aw_lin);
    cross3(vw_ang, vw_lin, tmp);
    for (int i = 0; i < 3; ++i) aw_lin[i] = aw_lin[i] + tmp[i];
    T g_lin[3], g_ang[3];
    for (int i = 0; i < 3; ++i) {
      g_lin[i] = aw_lin[i] + kp * depth * n[i] + kd * vw_lin[i];
      g_ang[i] = aw_ang[i] + kd * vw_ang[i];
    }
    drift[r0 + 0] = act ? dot3(c0, g_lin) : T(0);
    drift[r0 + 1] = act ? dot3(c1, g_lin) : T(0);
    drift[r0 + 2] = act ? dot3(n, g_lin) : T(0);
    drift[r0 + 3] = act ? dot3(n, g_ang) : T(0);
  }
}

// The boxed/cone Gauss-Seidel sweeps (`_pgs_sweep_components`), x in place.
template <typename T>
__device__ void pgs_sweeps(const CModel<T>& C, const T (*A)[NROW_MAX], const T* b, T* x) {
  const int n = C.n;
  const T friction = C.friction(), torsion = C.torsion();
#pragma unroll 1
  for (int it = 0; it < C.iter_max; ++it) {
    const T w = C.relax(it);
    auto dot_col = [&](int i) {
      T s = A[0][i] * x[0];
      for (int j = 1; j < n; ++j) s = s + A[j][i] * x[j];
      return s;
    };
    // bounds, then the contact normals
#pragma unroll 1
    for (int r = 0; r < C.nb + C.nc; ++r) {
      const int i = (r < C.nb) ? r : C.nb + 4 * (r - C.nb) + 2;
      const T y = b[i] - dot_col(i);
      x[i] = tmax(x[i] + w * y / A[i][i], T(0));
    }
    // level 1: torsional friction |lam_rz| <= torsion * lam_z
#pragma unroll 1
    for (int k = 0; k < C.nc; ++k) {
      const int i = C.nb + 4 * k + 3, iz = C.nb + 4 * k + 2;
      if (torsion <= T(0)) {
        x[i] = T(0);
        continue;
      }
      const T y = b[i] - dot_col(i);
      const T thr = torsion * x[iz];
      x[i] = clip(x[i] + w * y / A[i][i], -thr, thr);
    }
    // level 2: tangential friction cone ||lam_xy|| <= mu lam_z
#pragma unroll 1
    for (int k = 0; k < C.nc; ++k) {
      const int i0 = C.nb + 4 * k, i1 = i0 + 1, iz = i0 + 2;
      if (friction <= T(0)) {
        x[i0] = T(0);
        x[i1] = T(0);
        continue;
      }
      const T y0 = b[i0] - dot_col(i0);
      const T y1 = b[i1] - dot_col(i1);
      const T a_max = tmax(A[i0][i0], A[i1][i1]);
      const T x0 = x[i0] + w * y0 / a_max;
      const T x1 = x[i1] + w * y1 / a_max;
      const T thr = friction * x[iz];
      const T norm2 = x0 * x0 + x1 * x1;
      const T scale = (norm2 > thr * thr) ? thr / sqrt(tmax(norm2, T(1e-30))) : T(1);
      x[i0] = x0 * scale;
      x[i1] = x1 * scale;
    }
  }
}

// One constrained forward-dynamics evaluation
// (`constrained_accel_full_components`): qdd from the motor torques tc, the
// multipliers and the new active sets from the carried ones. The outputs
// may alias the inputs (stage-chained warm start). depth_out: nc depths.
template <typename T>
__device__ __noinline__ void constrained_accel(const Model<T>& M, const CModel<T>& C, const T* q,
                                               const T* v, const T* tc_in, const T* lam_in,
                                               const bool* cact_in, const bool* bact_in,
                                               T* lam_out, bool* cact_out, bool* bact_out, T* qdd,
                                               T* depth_out) {
  const int nv = M.nv, n = C.n;
  T R[NJ_MAX][9], P[NJ_MAX][3], RW[NJ_MAX][9], PW[NJ_MAX][3], VEL[NJ_MAX][6], ACC[NJ_MAX][6];
  joint_x(M, q, R, P);
  world_placements(M, R, P, RW, PW);
  T zero[NV_MAX];
#pragma unroll 1
  for (int i = 0; i < nv; ++i) zero[i] = T(0);
  fk_vel_acc(M, R, P, v, zero, VEL, ACC);  // velocity-bias kinematics, no gravity

  T J[NROW_MAX * NV_MAX], drift[NROW_MAX];
  bool act_row[NROW_MAX];
  constraint_rows(M, C, q, v, RW, PW, VEL, ACC, cact_in, bact_in, J, drift, cact_out, bact_out,
                  depth_out);
#pragma unroll 1
  for (int r = 0; r < n; ++r) act_row[r] = (r < C.nb) ? bact_out[r] : cact_out[(r - C.nb) / 4];

  T Mm[NV_MAX * NV_MAX], dinv[NV_MAX], tau_res[NV_MAX];
  {
    T IC[NJ_MAX][36];
    crba(M, R, P, Mm, IC);
  }
  {
    T F[NJ_MAX][6];
    rnea_nle(M, R, P, v, VEL, ACC, F, tau_res);  // nle into tau_res
  }
#pragma unroll 1
  for (int i = 0; i < nv; ++i) {
    const T damp = M.damping(i);
    const T tc = (damp != T(0)) ? tc_in[i] - damp * v[i] : tc_in[i];
    tau_res[i] = tc - tau_res[i];
  }
  ldl_factor(nv, Mm, dinv);
  ldl_solve(nv, Mm, dinv, tau_res);

  T W[NROW_MAX * NV_MAX];  // rows of M^-1 J^T
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    for (int d = 0; d < nv; ++d) W[NV_MAX * r + d] = J[NV_MAX * r + d];
    ldl_solve(nv, Mm, dinv, W + NV_MAX * r);
  }
  T A[NROW_MAX][NROW_MAX], b[NROW_MAX], x[NROW_MAX];
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    const T* jr = J + NV_MAX * r;
#pragma unroll 1
    for (int c = r; c < n; ++c) {
      const T* wc = W + NV_MAX * c;
      T s = jr[0] * wc[0];
      for (int d = 1; d < nv; ++d) s = s + jr[d] * wc[d];
      A[r][c] = s;
      A[c][r] = s;
    }
    T s = jr[0] * tau_res[0];
    for (int d = 1; d < nv; ++d) s = s + jr[d] * tau_res[d];
    b[r] = -drift[r] - s;
    x[r] = act_row[r] ? lam_in[r] : T(0);
  }
#pragma unroll 1
  for (int r = 0; r < n; ++r) A[r][r] = A[r][r] + tmax(A[r][r] * C.reg(), C.min_reg());
  pgs_sweeps(C, A, b, x);
#pragma unroll 1
  for (int k = 0; k < nv; ++k) {
    T s = x[0] * W[k];
    for (int r = 1; r < n; ++r) s = s + x[r] * W[NV_MAX * r + k];
    qdd[k] = tau_res[k] + s;
  }
#pragma unroll 1
  for (int r = 0; r < n; ++r) lam_out[r] = x[r];
}

// Solver state of one env: the warm-start multipliers and active sets
template <typename T>
struct SolverState {
  T lam[NROW_MAX];
  bool cact[NC_MAX];
  bool bact[NB_MAX];
};

template <typename T>
__device__ __forceinline__ void solve(const Model<T>& M, const CModel<T>& C, const T* q,
                                      const T* v, const T* cmd, const SolverState<T>& in,
                                      SolverState<T>& out, T* qdd, T* depth) {
  T tc[NV_MAX];
  tau_c(M, v, cmd, tc);
  constrained_accel(M, C, q, v, tc, in.lam, in.cact, in.bact, out.lam, out.cact, out.bact, qdd,
                    depth);
}

// One substep (`_ConstrainedCore.substep`), q, v and (with stage chaining)
// the solver state updated in place.
template <typename T>
__device__ __noinline__ void substep_cm(const Model<T>& M, const CModel<T>& C, T* q, T* v,
                                        const T* cmd, SolverState<T>& s, int integrator) {
  T k1[NV_MAX], dq[NV_MAX], qt[NQ_MAX], depth[NC_MAX];
  SolverState<T> unchained;  // the stage outputs when stages are not chained
  SolverState<T>& out = C.stage_warm ? s : unchained;
  const int nv = M.nv;
  const T dt = M.dt(), hdt = M.half_dt();
  solve(M, C, q, v, cmd, s, out, k1, depth);
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
  solve(M, C, qt, v2, cmd, s, out, k2, depth);
  for (int k = 0; k < nv; ++k) dq[k] = hdt * v2[k];
  integrate(M, q, dq, qt);
  for (int k = 0; k < nv; ++k) v3[k] = v[k] + hdt * k2[k];
  solve(M, C, qt, v3, cmd, s, out, k3, depth);
  for (int k = 0; k < nv; ++k) dq[k] = dt * v3[k];
  integrate(M, q, dq, qt);
  for (int k = 0; k < nv; ++k) v4[k] = v[k] + dt * k3[k];
  solve(M, C, qt, v4, cmd, s, out, k4, depth);
  const T dt6 = M.dt6();
  for (int k = 0; k < nv; ++k) dq[k] = dt6 * (v[k] + T(2) * v2[k] + T(2) * v3[k] + v4[k]);
  integrate(M, q, dq, qt);
  for (int k = 0; k < M.nq; ++k) q[k] = qt[k];
  for (int k = 0; k < nv; ++k) v[k] = v[k] + dt6 * (k1[k] + T(2) * k2[k] + T(2) * k3[k] + k4[k]);
}

// End-of-period outputs `[a | f_world | w_local | depth | imu | lam | cact |
// bact]` (`_ConstrainedCore.final_outputs`), rows of the (n_extra, B) array.
template <typename T>
__device__ __noinline__ void final_outputs_cm(const Model<T>& M, const CModel<T>& C, const T* q,
                                              const T* v, const T* cmd, const SolverState<T>& s,
                                              T* eo, int B, int b) {
  T a[NV_MAX], depth[NC_MAX];
  SolverState<T> out;
  solve(M, C, q, v, cmd, s, out, a, depth);
  T R[NJ_MAX][9], P[NJ_MAX][3], RW[NJ_MAX][9], PW[NJ_MAX][3], VEL[NJ_MAX][6], ACC[NJ_MAX][6];
  joint_x(M, q, R, P);
  world_placements(M, R, P, RW, PW);
  fk_vel_acc(M, R, P, v, a, VEL, ACC);
  const int nv = M.nv, nc = C.nc;
  for (int k = 0; k < nv; ++k) eo[(size_t)k * B + b] = a[k];
  const int o_fw = nv, o_wl = nv + 3 * nc, o_d = nv + 9 * nc, o_imu = nv + 10 * nc;
#pragma unroll 1
  for (int k = 0; k < nc; ++k) {
    const T n[3] = {T(0), T(0), T(1)};
    T c0[3], c1[3], f_w[3], n_w[3], t1[3], f_l[3], n_l[3];
    normal_basis(n, c0, c1);
    const T* lb = out.lam + C.nb + 4 * k;
    for (int i = 0; i < 3; ++i) {
      f_w[i] = c0[i] * lb[0] + c1[i] * lb[1] + n[i] * lb[2];
      n_w[i] = n[i] * lb[3];
    }
    const T* rw = RW[C.cparent(k)];
    const T* frot = C.cfrot(k);
    tv3(rw, n_w, t1);
    tv3(frot, t1, n_l);
    tv3(rw, f_w, t1);
    tv3(frot, t1, f_l);
    for (int i = 0; i < 3; ++i) {
      eo[(size_t)(o_fw + 3 * k + i) * B + b] = f_w[i];
      eo[(size_t)(o_wl + 6 * k + i) * B + b] = n_l[i];
      eo[(size_t)(o_wl + 6 * k + 3 + i) * B + b] = f_l[i];
    }
    eo[(size_t)(o_d + k) * B + b] = depth[k];
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
  const int o_lam = o_imu + 6 * M.ni;
  for (int r = 0; r < C.n; ++r) eo[(size_t)(o_lam + r) * B + b] = out.lam[r];
  for (int k = 0; k < nc; ++k) eo[(size_t)(o_lam + C.n + k) * B + b] = out.cact[k] ? T(1) : T(0);
  for (int k = 0; k < C.nb; ++k)
    eo[(size_t)(o_lam + C.n + nc + k) * B + b] = out.bact[k] ? T(1) : T(0);
}

// Read / write the solver channels [lam (N) | cact (nc) | bact (nb)] at
// row `off` of an (n, B) array.
template <typename T>
__device__ void load_solver_state(const CModel<T>& C, const T* src, int off, int B, int b,
                                  SolverState<T>& s) {
  for (int r = 0; r < C.n; ++r) s.lam[r] = src[(size_t)(off + r) * B + b];
  for (int k = 0; k < C.nc; ++k) s.cact[k] = src[(size_t)(off + C.n + k) * B + b] > T(0.5);
  for (int k = 0; k < C.nb; ++k) s.bact[k] = src[(size_t)(off + C.n + C.nc + k) * B + b] > T(0.5);
}

template <typename T>
__device__ void store_solver_state(const CModel<T>& C, const SolverState<T>& s, T* dst, int off,
                                   int B, int b) {
  for (int r = 0; r < C.n; ++r) dst[(size_t)(off + r) * B + b] = s.lam[r];
  for (int k = 0; k < C.nc; ++k) dst[(size_t)(off + C.n + k) * B + b] = s.cact[k] ? T(1) : T(0);
  for (int k = 0; k < C.nb; ++k)
    dst[(size_t)(off + C.n + C.nc + k) * B + b] = s.bact[k] ? T(1) : T(0);
}

// --------------------------------------------------------------------------
// The two entry kernels
// --------------------------------------------------------------------------

// One controller period: cc = [cmd (n_cmd) | lam | cact | bact].
template <typename T>
__global__ void cdyn_period_cm_kernel(const int* ci, const T* cf, const int* si, const T* sf,
                                      const T* __restrict__ q_g, const T* __restrict__ v_g,
                                      const T* __restrict__ cc_g, T* __restrict__ qo,
                                      T* __restrict__ vo, T* __restrict__ eo, int B, int n_cmd,
                                      int n_substeps, int integrator) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Model<T> M(ci, cf);
  const CModel<T> C(si, sf);
  T q[NQ_MAX], v[NV_MAX], cmd[NCMD_MAX];
  SolverState<T> s;
  for (int i = 0; i < M.nq; ++i) q[i] = q_g[(size_t)i * B + b];
  for (int i = 0; i < M.nv; ++i) v[i] = v_g[(size_t)i * B + b];
  for (int i = 0; i < n_cmd; ++i) cmd[i] = cc_g[(size_t)i * B + b];
  load_solver_state(C, cc_g, n_cmd, B, b, s);
#pragma unroll 1
  for (int k = 0; k < n_substeps; ++k) substep_cm(M, C, q, v, cmd, s, integrator);
  for (int i = 0; i < M.nq; ++i) qo[(size_t)i * B + b] = q[i];
  for (int i = 0; i < M.nv; ++i) vo[(size_t)i * B + b] = v[i];
  final_outputs_cm(M, C, q, v, cmd, s, eo, B, b);
}

// One env step: carry = [block carry (n_block) | lam | cact | bact]; extras
// = period extras + [cc_last | carry'].
template <typename T>
__global__ void cdyn_rollout_cm_kernel(const int* ci, const T* cf, const int* si, const T* sf,
                                       const int* pi, const T* pf, int controller,
                                       const T* __restrict__ q_g, const T* __restrict__ v_g,
                                       const T* __restrict__ a_g, const T* __restrict__ c_g,
                                       T* __restrict__ qo, T* __restrict__ vo, T* __restrict__ eo,
                                       int B, int n_action, int n_block, int n_cmd, int n_ticks,
                                       int n_substeps, int integrator) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Model<T> M(ci, cf);
  const CModel<T> C(si, sf);
  T q[NQ_MAX], v[NV_MAX], ac[NACT_MAX], bc[NCARRY_MAX], bc_new[NCARRY_MAX], cmd[NCMD_MAX];
  SolverState<T> carry, cc;  // the carry's solver channels and the command row's
  for (int i = 0; i < M.nq; ++i) q[i] = q_g[(size_t)i * B + b];
  for (int i = 0; i < M.nv; ++i) v[i] = v_g[(size_t)i * B + b];
  for (int i = 0; i < n_action; ++i) ac[i] = a_g[(size_t)i * B + b];
  for (int i = 0; i < n_block; ++i) bc[i] = c_g[(size_t)i * B + b];
  load_solver_state(C, c_g, n_block, B, b, carry);
  for (int i = 0; i < n_cmd; ++i) cmd[i] = T(0);
#pragma unroll 1
  for (int t = 0; t < n_ticks; ++t) {
    if (controller == CONTROLLER_PD) {
      pd_controller(pi, pf, q, v, bc, ac, cmd, bc_new);
      for (int i = 0; i < n_block; ++i) bc[i] = bc_new[i];
    } else {  // zero-order hold of the action, block carry unchanged
      for (int i = 0; i < n_cmd; ++i) cmd[i] = ac[i];
    }
    cc = carry;
#pragma unroll 1
    for (int k = 0; k < n_substeps; ++k) substep_cm(M, C, q, v, cmd, cc, integrator);
    if (t < n_ticks - 1) {  // end-of-tick refresh of the carried warm start
      T a[NV_MAX], depth[NC_MAX];
      solve(M, C, q, v, cmd, cc, carry, a, depth);
    }
  }
  for (int i = 0; i < M.nq; ++i) qo[(size_t)i * B + b] = q[i];
  for (int i = 0; i < M.nv; ++i) vo[(size_t)i * B + b] = v[i];
  final_outputs_cm(M, C, q, v, cmd, cc, eo, B, b);
  const int n_std = M.nv + 10 * C.nc + 6 * M.ni + C.n + C.nc + C.nb;
  const int n_ccrow = n_cmd + C.n + C.nc + C.nb;
  for (int i = 0; i < n_cmd; ++i) eo[(size_t)(n_std + i) * B + b] = cmd[i];
  store_solver_state(C, cc, eo, n_std + n_cmd, B, b);
  for (int i = 0; i < n_block; ++i) eo[(size_t)(n_std + n_ccrow + i) * B + b] = bc[i];
  store_solver_state(C, carry, eo, n_std + n_ccrow + n_block, B, b);
}

}  // namespace cdyn
