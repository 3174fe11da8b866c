// Spring-damper bodies of the three kernels for Hopper: the CUDA
// counterparts of jiminy_tpu/ops/cdyn.py's
//
//   cdyn_period  <- _pallas_period_fn  (n_substeps RK4/Euler substeps, extras)
//   cdyn_rollout <- _pallas_rollout_fn (n_ticks x (controller, n_substeps
//                                       substeps), extras, command, carry)
//   cdyn_accel   <- _pallas_accel_fn   (one evaluation; DOPRI's stages)
//
// What bounds them: arithmetic, once the working set stays on the chip. An
// ANYmal env step is 161 evaluations of `_accel_core` (ABA with armature,
// damping, penalty bounds and spring-damper contact), about 1.8 M scalar
// operations per env with the model's structural zeros folded, against
// about a thousand bytes of I/O; one evaluation is about 11 k operations
// against 292 bytes. A thread per env with the ABA's per-joint arrays on its
// stack streams that working set, some 17 KB an evaluation, through local
// memory, which at full occupancy misses L1 and L2 (PERF.md). Kept on the
// chip, an evaluation is a chain of dependent steps: the time follows how
// many envs an SM holds.
//
// Design. A group of SP_LANES lanes (aligned in its warp) steps one env,
// SP_ENVS envs to a block; a group past the end of the batch leaves whole.
// The env's working set lives in dynamic shared memory, one slice per env
// sized from the model and kept small so that many envs fit an SM
// (`SpLayout`): per joint a record of what lives across the passes, its
// fields shared by lifetime; the root's placement; the integrator's
// vectors; the contact wrenches; the motor torques, command, action and
// carry. A joint's articulated inertia is gathered in registers from its
// constant body inertia (read from the model's buffer) and its children's
// contributions, and handed to the parent as a symmetric 6x6 of 21 values;
// the 6x6 temporaries stay in the registers of the lane that owns the joint.
// A 1-dof joint's rotation is rebuilt from (cos q, sin q) and every joint's
// velocity-product bias from its velocity where a pass needs them. Nothing
// is indexed at run time on the stack.
//  - The outward passes (placements, velocities, bias forces; then the
//    accelerations) run depth after depth of the tree, a joint per lane; the
//    inward pass too, each parent summing its children's contributions in the
//    serial order (descending joint index), so float64 results stay equal to
//    the serial arithmetic up to rounding, and each joint adding its penalty
//    bound. `pack_model` lists the joints by depth (slots), each slot's
//    parent and children, and each joint's bound.
//  - Contacts and motors take a lane each; the substep's stage updates and
//    the retraction a joint per lane; the PD controller runs on the leading
//    lane once a tick.
//  - A 1-dof joint whose axis is a coordinate axis (`pack_model` classifies
//    it: AX_X, AX_Y, AX_Z, else AX_GENERAL) drops the structural zeros of
//    its motion subspace: exp(axis q), S v, U = I S, S^T U, S^T p and
//    S a read one component, column or row instead of three or six. This is
//    exact: the dropped terms are x * 0 added to y, equal to y for finite x.
//  - cdyn_accel has an instance for models with SPHERICAL joints (kSph; the
//    flexibility joints, so only the per-stage path meets them, as in
//    jiminy_tpu): such a joint stays on one lane of its depth, its rotation
//    rebuilt from its quaternion, its motion subspace the angular 3x6 block.
//    Pass 2 keeps U = IA[:, 0:3], the LDL^T factor of D = IA[0:3, 0:3] +
//    armature in `solve_sym3`'s order and u in a block of its own at the end
//    of the slice (`SPH_REC` values a SPHERICAL joint), so the other
//    instances keep their record, slice and registers.
// Group barriers are __syncwarp on the group's mask. Every expression
// otherwise mirrors the plain PyTorch version (ComponentDynamics in
// jiminy_torch/ops/cdyn.py) in the same association order; float64 runs
// differ from it by FMA contraction and by the symmetric storage of the
// articulated inertias (the plain version keeps all 36 entries, which
// rounding leaves slightly unsymmetric).
#pragma once

namespace cdyn {

// Lanes per env and envs per block; a build may set others (-DCDYN_SP_LANES,
// -DCDYN_SP_ENVS) to time them (spring_profile.py).
#ifndef CDYN_SP_LANES
#define CDYN_SP_LANES 4
#endif
#ifndef CDYN_SP_ENVS
#define CDYN_SP_ENVS 8
#endif
constexpr int SP_LANES = CDYN_SP_LANES, SP_ENVS = CDYN_SP_ENVS;
static_assert(SP_LANES == 1 || SP_LANES == 2 || SP_LANES == 4 || SP_LANES == 8 ||
                  SP_LANES == 16 || SP_LANES == 32,
              "SP_LANES: a power of two up to 32");
static_assert(SP_LANES * SP_ENVS <= 1024, "SP_LANES * SP_ENVS threads a block");

// Axis classes of a 1-dof joint (packed by `pack_model`); -1 for FREE.
enum AxisClass { AX_X = 0, AX_Y = 1, AX_Z = 2, AX_GENERAL = 3 };

// The spring section of the int buffer, at ci[CI_SPRING] (`pack_model`):
// [nlev, motors on distinct dofs, lstart (nlev + 1), then per slot the
// joint, per joint the slot, per slot the parent's slot (-1), the slot of
// the child of highest joint index (-1) and of the next lower-index sibling
// (-1), per joint the axis class and the penalty bound on its dof (-1)].
// Slots list the joints by depth.
constexpr int CI_SPRING = 9;

struct SpTree {
  const int* __restrict__ t;
  int nj, nlev, distinct, o;
  __device__ SpTree(const int* ci) : t(ci + ci[CI_SPRING]), nj(ci[0]) {
    nlev = t[0];
    distinct = t[1];
    o = 3 + nlev;
  }
  __device__ int lstart(int d) const { return t[2 + d]; }
  __device__ int joint(int s) const { return t[o + s]; }
  __device__ int slot(int j) const { return t[o + nj + j]; }
  __device__ int pslot(int s) const { return t[o + 2 * nj + s]; }
  __device__ int fchild(int s) const { return t[o + 3 * nj + s]; }
  __device__ int nsib(int s) const { return t[o + 4 * nj + s]; }
  __device__ int axis(int j) const { return t[o + 5 * nj + j]; }
  __device__ int bound(int j) const { return t[o + 6 * nj + j]; }
};

// Per-joint record of a slice, by slot, its fields shared by lifetime:
//  CS    (cos q, sin q) of a revolute joint, its rotation rebuilt from them
//  VEL   spatial velocity (pass 1 on; the bias is recomputed from it)
//  PA    bias force (pass 1), then the force handed to the parent (PAP, pass
//        2), then the spatial acceleration (ACC, pass 3 and the outputs)
//  IAP   world placement RW PW (pass 1, read by the contacts), then the
//        articulated inertia handed to the parent (21 values, pass 2)
//  U DINV URHS  (pass 2 to pass 3)
// The FREE root's placement has a block of its own (R 9, P 3). An odd record
// size keeps the records of one depth, one a lane, in distinct banks.
constexpr int J_CS = 0, J_VEL = 2, J_PA = 8, J_PAP = 8, J_ACC = 8, J_IAP = 14, J_RW = 14,
              J_PW = 23, J_U = 35, J_DINV = 41, J_URHS = 42, JREC = 43;

// Element offsets of one env's slice (the same on host and device).
struct SpLayout {
  int rec, root, q, qs, v, vs, qdd, ksum, vsum, tc, fext, cc, bc, ac, elems;
  __host__ __device__ SpLayout(int nj, int nq, int nv, int nc, int n_cmd, int n_act, int n_carry) {
    int off = 0;
    auto take = [&](int count) {
      const int at = off;
      off += count;
      return at;
    };
    rec = take(JREC * nj);
    root = take(12);
    q = take(nq);
    qs = take(nq);
    v = take(nv);
    vs = take(nv);
    qdd = take(nv);
    ksum = take(nv);
    vsum = take(nv);
    tc = take(nv);
    fext = take(6 * nc);
    cc = take(n_cmd);
    bc = take(n_carry);
    ac = take(n_act);
    elems = off;
  }
};

// Bytes between two envs' slices: the slice padded so that the groups of a
// warp start SP_LANES element widths apart in the 32 four-byte banks.
__host__ __device__ inline int sp_env_stride(int elems, int elt) {
  const int words = (elems * elt + 15) / 16 * 4;
  const int want = (SP_LANES * elt / 4) % 32;
  return 4 * (words + (want - words % 32 + 32) % 32);
}

// The SP_LANES lanes of one env, aligned in their warp.
struct SpLanes {
  int lane;
  unsigned mask;
  __device__ SpLanes() : lane(threadIdx.x & (SP_LANES - 1)) {
    mask = (SP_LANES == 32) ? 0xffffffffu
                            : (((1u << SP_LANES) - 1u) << ((threadIdx.x & 31) & ~(SP_LANES - 1)));
  }
  __device__ bool leader() const { return lane == 0; }
  __device__ void sync() const { __syncwarp(mask); }
};

// A SPHERICAL joint's block of the accel slice (kSph): U = IA[:, 0:3] (18,
// row-major 6x3), the LDL^T factor of D (l10 l20 l21, d0 d1 d2) and u (3).
constexpr int SPH_U = 0, SPH_L = 18, SPH_D = 21, SPH_URHS = 24, SPH_REC = 27;

// Views of one env's slice (`sph`: the SPHERICAL joints' blocks, kSph only).
template <typename T>
struct SpWork {
  T *J, *root, *q, *qs, *v, *vs, *qdd, *ksum, *vsum, *tc, *fext, *cc, *bc, *ac;
  T* sph = nullptr;
  __device__ T* rec(int s) const { return J + JREC * s; }
};

// This thread's env slice, built from the shared-memory symbol.
template <typename T>
__device__ __forceinline__ SpWork<T> sp_work(const Model<T>& M, int n_cmd, int n_act, int n_carry) {
  const SpLayout lo(M.nj, M.nq, M.nv, M.nc, n_cmd, n_act, n_carry);
  const int slot = threadIdx.x / SP_LANES;
  T* b = reinterpret_cast<T*>(dynamic_smem() +
                              (size_t)slot * sp_env_stride(lo.elems, static_cast<int>(sizeof(T))));
  return {b + lo.rec,  b + lo.root, b + lo.q,    b + lo.qs, b + lo.v,
          b + lo.vs,   b + lo.qdd,  b + lo.ksum, b + lo.vsum, b + lo.tc,
          b + lo.fext, b + lo.cc,   b + lo.bc,   b + lo.ac};
}

// --------------------------------------------------------------------------
// Symmetric 6x6 in 21 values (the upper triangle row by row)
// --------------------------------------------------------------------------

__host__ __device__ constexpr int s21(int r, int c) {
  return r <= c ? 6 * r - r * (r - 1) / 2 + (c - r) : 6 * c - c * (c - 1) / 2 + (r - c);
}

template <typename T>
__device__ __forceinline__ void sym21_mv(const T* m, const T* ang, const T* lin, T* out) {
  const T vec[6] = {ang[0], ang[1], ang[2], lin[0], lin[1], lin[2]};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = m[s21(i, 0)] * vec[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) s = s + m[s21(i, j)] * vec[j];
    out[i] = s;
  }
}

// (S X)[:, j] for S = skew(p), X 3x3 row-major: S's zero diagonal left out.
template <typename T>
__device__ __forceinline__ void skew_mm(const T* p, const T* x, T* out) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j] = -p[2] * x[3 + j] + p[1] * x[6 + j];
    out[3 + j] = p[2] * x[j] + -p[0] * x[6 + j];
    out[6 + j] = -p[1] * x[j] + p[0] * x[3 + j];
  }
}

// I_parent = X_F I X_M^{-1} for the placement (r, pos) of the child in its
// parent (`_transform_sym6`) on the upper triangle: the blocks top-left
// (upper), top-right (full) and bottom-right (upper); the bottom-left block
// is the transpose of the top-right one.
template <typename T>
__device__ __forceinline__ void transform_sym21(const T* ia, const T* r, const T* pos, T* out) {
  T a[9], b[9], bt[9], cc[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[3 * i + j] = ia[s21(i, j)];
      b[3 * i + j] = ia[s21(i, 3 + j)];
      bt[3 * i + j] = ia[s21(3 + i, j)];
      cc[3 * i + j] = ia[s21(3 + i, 3 + j)];
    }
  const T rt[9] = {r[0], r[3], r[6], r[1], r[4], r[7], r[2], r[5], r[8]};
  T ra[9], rbt[9], rb[9], rc[9], t1[9], t2[9], top_l[9], top_r[9], rts[9], neg_rts[9];
  mm3(r, a, ra);
  mm3(r, bt, rbt);
  mm3(r, b, rb);
  mm3(r, cc, rc);
  skew_mm(pos, rbt, t1);
  skew_mm(pos, rc, t2);
#pragma unroll
  for (int k = 0; k < 9; ++k) { top_l[k] = ra[k] + t1[k]; top_r[k] = rb[k] + t2[k]; }
  // rt S: S's zero diagonal left out
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rts[3 * i] = rt[3 * i + 1] * pos[2] + rt[3 * i + 2] * -pos[1];
    rts[3 * i + 1] = rt[3 * i] * -pos[2] + rt[3 * i + 2] * pos[0];
    rts[3 * i + 2] = rt[3 * i] * pos[1] + rt[3 * i + 1] * -pos[0];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) neg_rts[k] = -rts[k];
  // top-left = top_l rt + top_r neg_rts, top-right = top_r rt, bottom-right = rc rt
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T tr = top_r[3 * i] * rt[j] + top_r[3 * i + 1] * rt[3 + j] + top_r[3 * i + 2] * rt[6 + j];
      out[s21(i, 3 + j)] = tr;
      if (j >= i) {
        const T o1 = top_l[3 * i] * rt[j] + top_l[3 * i + 1] * rt[3 + j] + top_l[3 * i + 2] * rt[6 + j];
        const T o2 = top_r[3 * i] * neg_rts[j] + top_r[3 * i + 1] * neg_rts[3 + j] +
                     top_r[3 * i + 2] * neg_rts[6 + j];
        out[s21(i, j)] = o1 + o2;
        out[s21(3 + i, 3 + j)] =
            rc[3 * i] * rt[j] + rc[3 * i + 1] * rt[3 + j] + rc[3 * i + 2] * rt[6 + j];
      }
    }
}

// cross(a, c e_K): the cross product with a vector along coordinate axis K.
template <int K, typename T>
__device__ __forceinline__ void cross_axis(const T* a, T c, T* out) {
  constexpr int K1 = (K + 1) % 3, K2 = (K + 2) % 3;
  out[K] = T(0);
  out[K1] = a[K2] * c;
  out[K2] = -(a[K1] * c);
}

// --------------------------------------------------------------------------
// The passes of one evaluation, a slot (joint) per call. A 1-dof joint's
// work is specialised on its motion subspace: S = 0..5 the one non-zero
// component of the 6-vector (ang, lin), 6 a general axis.
// --------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ int motion_class(const Model<T>& M, const SpTree& tr, int j) {
  const int ax = tr.axis(j);
  return ax == AX_GENERAL ? 6 : ax + (M.type(j) == PRISMATIC ? 3 : 0);
}

// The 6-vector motion subspace of a 1-dof joint (general axis).
template <typename T>
__device__ __forceinline__ void motion6(const Model<T>& M, int j, T* s6) {
  const T* ax = M.axis(j);
  const bool rev = M.type(j) == REVOLUTE;
#pragma unroll
  for (int k = 0; k < 3; ++k) { s6[k] = rev ? ax[k] : T(0); s6[3 + k] = rev ? T(0) : ax[k]; }
}

// The placement (R, P) of a 1-dof joint in its parent (`_joint_x`): a
// revolute joint's from (c, s) = (cos q, sin q), a prismatic one's from q.
template <int S, typename T>
__device__ __forceinline__ void place_1dof(const Model<T>& M, int j, T qj, T c, T s, T* R, T* P) {
  const T* tr = M.jrot(j);
  const T* tp = M.jpos(j);
  if constexpr (S < 3) {  // revolute about +-e_S: exp(axis q) has 5 non-zeros
    constexpr int K1 = (S + 1) % 3, K2 = (S + 2) % 3;
    const T one_c = T(1) - c;
    const T dk = c + M.axprod(j)[S] * one_c;  // (axis products: xx yy zz ...)
    const T as = M.axis(j)[S] * s;
    // rj[S][S] = dk, rj[K1][K1] = rj[K2][K2] = c, rj[K2][K1] = as, rj[K1][K2] = -as
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      R[3 * i + S] = tr[3 * i + S] * dk;
      R[3 * i + K1] = tr[3 * i + K1] * c + tr[3 * i + K2] * as;
      R[3 * i + K2] = tr[3 * i + K1] * -as + tr[3 * i + K2] * c;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) P[k] = tp[k];
  } else if constexpr (S < 6) {  // prismatic along +-e_(S-3)
    constexpr int K = S - 3;
    const T d = M.axis(j)[K] * qj;
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = tr[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) P[i] = tr[3 * i + K] * d + tp[i];
  } else if (M.type(j) == REVOLUTE) {
    T rj[9];
    rodrigues_cs(M.axis(j), M.axprod(j), c, s, rj);
    mm3(tr, rj, R);
#pragma unroll
    for (int k = 0; k < 3; ++k) P[k] = tp[k];
  } else {
    const T* ax = M.axis(j);
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = tr[k];
    const T disp[3] = {ax[0] * qj, ax[1] * qj, ax[2] * qj};
    T tmp[3];
    mv3(tr, disp, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) P[k] = tmp[k] + tp[k];
  }
}

// The motion class of a SPHERICAL joint in the passes (kSph instances).
constexpr int S_SPH = 7;

// The placement (R, P) of a SPHERICAL joint in its parent (`_joint_x`): the
// tree placement times the rotation of its quaternion q[qi .. qi + 3].
template <typename T>
__device__ __forceinline__ void place_sph(const Model<T>& M, int j, const T* q, T* R, T* P) {
  const int qi = M.iq(j);
  T rj[9];
  quat_to_m(q[qi], q[qi + 1], q[qi + 2], q[qi + 3], rj);
  mm3(M.jrot(j), rj, R);
#pragma unroll
  for (int k = 0; k < 3; ++k) P[k] = M.jpos(j)[k];
}

// The ordinal of slot s among the SPHERICAL slots: its block in the slice.
template <typename T>
__device__ __forceinline__ int sph_ordinal(const Model<T>& M, const SpTree& tr, int s) {
  int n = 0;
#pragma unroll 1
  for (int k = 0; k < s; ++k) n += M.type(tr.joint(k)) == SPHERICAL;
  return n;
}

// `solve_sym3`'s LDL^T of the symmetric 3x3 D (its upper triangle d00 d01
// d02 d11 d12 d22): l = (l10, l20, l21), d = (d0, d1, d2).
template <typename T>
__device__ __forceinline__ void sym3_factor(T d00, T d01, T d02, T d11, T d12, T d22, T* l,
                                            T* d) {
  d[0] = d00;
  const T inv0 = T(1) / d[0];
  l[0] = d01 * inv0;
  l[1] = d02 * inv0;
  d[1] = d11 - l[0] * l[0] * d[0];
  const T inv1 = T(1) / d[1];
  l[2] = (d12 - l[1] * l[0] * d[0]) * inv1;
  d[2] = d22 - l[1] * l[1] * d[0] - l[2] * l[2] * d[1];
}

// y = D^-1 y in place from the factor, in `solve_sym3`'s order.
template <typename T>
__device__ __forceinline__ void sym3_solve(const T* l, const T* d, T* y) {
  y[1] = y[1] - l[0] * y[0];
  y[2] = y[2] - l[1] * y[0] - l[2] * y[1];
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = y[i] / d[i];
  y[1] = y[1] - l[2] * y[2];
  y[0] = y[0] - l[0] * y[1] - l[1] * y[2];
}

// The placement of slot s (joint j) from what pass 1 kept: the root's
// block, a revolute joint's (cos, sin), a prismatic joint's q, a SPHERICAL
// joint's quaternion.
template <int S, typename T>
__device__ __forceinline__ void joint_place(const Model<T>& M, const SpWork<T>& w, int s, int j,
                                            T* R, T* P) {
  if constexpr (S < 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = w.root[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) P[k] = w.root[9 + k];
  } else if constexpr (S == S_SPH) {
    place_sph(M, j, w.qs, R, P);
  } else {
    const T* r = w.rec(s);
    place_1dof<S>(M, j, w.qs[M.iq(j)], r[J_CS], r[J_CS + 1], R, P);
  }
}

// The joint's velocity vj = S v added to (w_i, v_i), the parent's velocity
// in the joint frame (`_accel_core`, pass 1).
template <int S, typename T>
__device__ __forceinline__ void add_joint_vel(const Model<T>& M, int j, const T* v, T* w_i, T* v_i) {
  const int vi = M.iv(j);
  if constexpr (S < 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) { w_i[k] = w_i[k] + v[vi + 3 + k]; v_i[k] = v_i[k] + v[vi + k]; }
  } else if constexpr (S == S_SPH) {
#pragma unroll
    for (int k = 0; k < 3; ++k) w_i[k] = w_i[k] + v[vi + k];
  } else if constexpr (S < 3) {
    w_i[S] = w_i[S] + M.axis(j)[S] * v[vi];
  } else if constexpr (S < 6) {
    v_i[S - 3] = v_i[S - 3] + M.axis(j)[S - 3] * v[vi];
  } else {
    T s6[6];
    motion6(M, j, s6);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w_i[k] = w_i[k] + s6[k] * v[vi];
      v_i[k] = v_i[k] + s6[3 + k] * v[vi];
    }
  }
}

// The velocity-product bias (w x vj_ang, w x vj_lin + v x vj_ang) of a joint
// moving at (w_i, v_i) (`_accel_core`, pass 1), from its velocity.
template <int S, typename T>
__device__ __forceinline__ void joint_bias(const Model<T>& M, int j, const T* v, const T* w_i,
                                           const T* v_i, T* bias) {
  const int vi = M.iv(j);
  if constexpr (S < 0) {
    const T vj_lin[3] = {v[vi], v[vi + 1], v[vi + 2]};
    const T vj_ang[3] = {v[vi + 3], v[vi + 4], v[vi + 5]};
    T c1[3], c2[3];
    cross3(w_i, vj_ang, bias);
    cross3(w_i, vj_lin, c1);
    cross3(v_i, vj_ang, c2);
#pragma unroll
    for (int k = 0; k < 3; ++k) bias[3 + k] = c1[k] + c2[k];
  } else if constexpr (S == S_SPH) {
    const T vj_ang[3] = {v[vi], v[vi + 1], v[vi + 2]};
    cross3(w_i, vj_ang, bias);      // w x vj_ang
    cross3(v_i, vj_ang, bias + 3);  // w x 0 + v x vj_ang
  } else if constexpr (S < 3) {
    const T c = M.axis(j)[S] * v[vi];
    cross_axis<S>(w_i, c, bias);      // w x vj_ang
    cross_axis<S>(v_i, c, bias + 3);  // w x 0 + v x vj_ang
  } else if constexpr (S < 6) {
    const T c = M.axis(j)[S - 3] * v[vi];
    bias[0] = T(0); bias[1] = T(0); bias[2] = T(0);  // w x 0
    cross_axis<S - 3>(w_i, c, bias + 3);            // w x vj_lin + v x 0
  } else {
    T s6[6];
    motion6(M, j, s6);
    T vj_ang[3], vj_lin[3], c1[3], c2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) { vj_ang[k] = s6[k] * v[vi]; vj_lin[k] = s6[3 + k] * v[vi]; }
    cross3(w_i, vj_ang, bias);
    cross3(w_i, vj_lin, c1);
    cross3(v_i, vj_ang, c2);
#pragma unroll
    for (int k = 0; k < 3; ++k) bias[3 + k] = c1[k] + c2[k];
  }
}

// The placement and the bias of slot s, rebuilt from the record.
template <int S, typename T>
__device__ __forceinline__ void joint_frame(const Model<T>& M, const SpWork<T>& w, int s, int j,
                                            T* R, T* P, T* bias) {
  joint_place<S>(M, w, s, j, R, P);
  const T* r = w.rec(s);
  const T w_i[3] = {r[J_VEL], r[J_VEL + 1], r[J_VEL + 2]};
  const T v_i[3] = {r[J_VEL + 3], r[J_VEL + 4], r[J_VEL + 5]};
  joint_bias<S>(M, j, w.vs, w_i, v_i, bias);
}

// Pass 1 (outward) for slot s: the placement, the world placement (for the
// contacts), the velocity and the bias force of the body inertia.
template <int S, typename T>
__device__ __forceinline__ void sp_pass1(const Model<T>& M, const SpTree& tr, const SpWork<T>& w,
                                         int s) {
  const int j = tr.joint(s), ps = tr.pslot(s);
  const int qi = M.iq(j);
  const T* q = w.qs;
  T* r = w.rec(s);
  T R[9], P[3];
  if constexpr (S < 0) {  // FREE: its placement into the root's block
    const T* rot = M.jrot(j);
    const T* tp = M.jpos(j);
    T rj[9], tmp[3];
    quat_to_m(q[qi + 3], q[qi + 4], q[qi + 5], q[qi + 6], rj);
    mm3(rot, rj, R);
    const T pj[3] = {q[qi], q[qi + 1], q[qi + 2]};
    mv3(rot, pj, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) P[k] = tmp[k] + tp[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) w.root[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) w.root[9 + k] = P[k];
  } else if constexpr (S == S_SPH) {
    place_sph(M, j, q, R, P);
  } else {
    T c = T(1), sn = T(0);
    if (M.type(j) == REVOLUTE) {
      c = cos(q[qi]);
      sn = sin(q[qi]);
      r[J_CS] = c;
      r[J_CS + 1] = sn;
    }
    place_1dof<S>(M, j, q[qi], c, sn, R, P);
  }
  // World placement (the contacts'), into the inertia's space
  if (M.has_contacts) {
    if (ps < 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) r[J_RW + k] = R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) r[J_PW + k] = P[k];
    } else {
      const T* pr = w.rec(ps);
      T rw_p[9], rw[9], tmp[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) rw_p[k] = pr[J_RW + k];
      mm3(rw_p, R, rw);
      mv3(rw_p, P, tmp);
#pragma unroll
      for (int k = 0; k < 9; ++k) r[J_RW + k] = rw[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) r[J_PW + k] = tmp[k] + pr[J_PW + k];
    }
  }
  // Velocity: the parent's in this frame, plus the joint's
  T w_i[3] = {T(0), T(0), T(0)}, v_i[3] = {T(0), T(0), T(0)};
  if (ps >= 0) {
    const T* pr = w.rec(ps);
    const T w_p[3] = {pr[J_VEL], pr[J_VEL + 1], pr[J_VEL + 2]};
    const T v_p[3] = {pr[J_VEL + 3], pr[J_VEL + 4], pr[J_VEL + 5]};
    T tmp[3];
    tv3(R, w_p, w_i);
    cross3(P, w_p, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) tmp[k] = v_p[k] - tmp[k];
    tv3(R, tmp, v_i);
  }
  add_joint_vel<S>(M, j, w.vs, w_i, v_i);
  // Bias force of the body inertia
  T iv[6], c1[3], c2[3];
  sym6_mv(M.ia0(j), w_i, v_i, iv);
  cross3(w_i, iv, c1);
  cross3(v_i, iv + 3, c2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[J_VEL + k] = w_i[k];
    r[J_VEL + 3 + k] = v_i[k];
    r[J_PA + k] = c1[k] + c2[k];
  }
  cross3(w_i, iv + 3, c1);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[J_PA + 3 + k] = c1[k];
}

// The torque of dof k net of its damping (`_accel_core`'s first line).
template <typename T>
__device__ __forceinline__ T damped_tc(const Model<T>& M, const SpWork<T>& w, int k) {
  const T damp = M.damping(k);
  return (damp != T(0)) ? w.tc[k] - damp * w.vs[k] : w.tc[k];
}

// Bound b's penalty torque (`_accel_core`'s stable penalty bounds).
template <typename T>
__device__ __forceinline__ T bound_torque(const Model<T>& M, const SpWork<T>& w, int b) {
  const int vi = M.bound(b)[0], qi = M.bound(b)[1];
  const T* bf = M.boundf(b);
  const T qb = w.qs[qi];
  const T over = tmax(qb - bf[1], T(0));
  const T under = tmax(bf[0] - qb, T(0));
  const bool active = (over > T(0)) || (under > T(0));
  return bf[2] * (under - over) - (active ? bf[3] * w.vs[vi] : T(0));
}

// Pass 2 (inward) for slot s: gather the children (descending joint index),
// then the FREE root keeps its inertia and bias force for pass 3, a 1-dof
// joint computes U, 1/D, u and hands its inertia and force to its parent.
template <int S, typename T>
__device__ __forceinline__ void sp_pass2(const Model<T>& M, const SpTree& tr, const SpWork<T>& w,
                                         int s) {
  const int j = tr.joint(s), ps = tr.pslot(s);
  T* r = w.rec(s);
  T ia[21], pa[6];
  const T* i0 = M.ia0(j);
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) ia[s21(a, b)] = i0[6 * a + b];
#pragma unroll
  for (int k = 0; k < 6; ++k) pa[k] = r[J_PA + k];
  if (M.has_contacts) {  // the contacts' wrenches on this joint, summed in contact order
    T fs[6] = {};
    bool any = false;
#pragma unroll 1
    for (int k = 0; k < M.nc; ++k) {
      if (M.cparent(k) != j) continue;
      const T* f = w.fext + 6 * k;
#pragma unroll
      for (int c = 0; c < 6; ++c) fs[c] = any ? fs[c] + f[c] : f[c];
      any = true;
    }
    if (any)
#pragma unroll
      for (int c = 0; c < 6; ++c) pa[c] = pa[c] - fs[c];
  }
#pragma unroll 1
  for (int c = tr.fchild(s); c >= 0; c = tr.nsib(c)) {
    const T* cr = w.rec(c);
#pragma unroll
    for (int k = 0; k < 21; ++k) ia[k] = ia[k] + cr[J_IAP + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) pa[k] = pa[k] + cr[J_PAP + k];
  }
  if constexpr (S < 0) {  // FREE: the root's inertia and bias force, for pass 3
#pragma unroll
    for (int k = 0; k < 21; ++k) r[J_IAP + k] = ia[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) r[J_PA + k] = pa[k];
    return;
  } else if constexpr (S == S_SPH) {  // 3 dofs: U = IA[:, 0:3], D = IA[0:3, 0:3] + armature
    const int vi = M.iv(j);
    T* sb = w.sph + SPH_REC * sph_ordinal(M, tr, s);
    T u[18], l[3], dd[3], u_r[3];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int k = 0; k < 3; ++k) u[3 * a + k] = ia[s21(a, k)];
    sym3_factor(ia[s21(0, 0)] + M.armature(vi), ia[s21(0, 1)], ia[s21(0, 2)],
                ia[s21(1, 1)] + M.armature(vi + 1), ia[s21(1, 2)],
                ia[s21(2, 2)] + M.armature(vi + 2), l, dd);
#pragma unroll
    for (int k = 0; k < 3; ++k) u_r[k] = damped_tc(M, w, vi + k) - pa[k];
#pragma unroll
    for (int k = 0; k < 18; ++k) sb[SPH_U + k] = u[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sb[SPH_L + k] = l[k];
      sb[SPH_D + k] = dd[k];
      sb[SPH_URHS + k] = u_r[k];
    }
    if (ps < 0) return;
    T R[9], P[3], bias[6];
    joint_frame<S>(M, w, s, j, R, P, bias);
    // Ia = IA - U D^-1 U^T, a column of D^-1 U^T a solve
    T x[18], ia_a[21], iab[6], pa_n[6], ia_p[21];
#pragma unroll
    for (int b = 0; b < 6; ++b) {
#pragma unroll
      for (int k = 0; k < 3; ++k) x[3 * b + k] = u[3 * b + k];
      sym3_solve(l, dd, x + 3 * b);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b)
        ia_a[s21(a, b)] = ia[s21(a, b)] - (u[3 * a] * x[3 * b] + u[3 * a + 1] * x[3 * b + 1] +
                                           u[3 * a + 2] * x[3 * b + 2]);
    sym21_mv(ia_a, bias, bias + 3, iab);
    sym3_solve(l, dd, u_r);  // D^-1 u
#pragma unroll
    for (int k = 0; k < 6; ++k)
      pa_n[k] = pa[k] + iab[k] + (u[3 * k] * u_r[0] + u[3 * k + 1] * u_r[1] + u[3 * k + 2] * u_r[2]);
    transform_sym21(ia_a, R, P, ia_p);
#pragma unroll
    for (int k = 0; k < 21; ++k) r[J_IAP + k] = ia_p[k];
    T f_a[3], n_a[3], tmp[3];
    mv3(R, pa_n + 3, f_a);
    mv3(R, pa_n, n_a);
    cross3(P, f_a, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[J_PAP + k] = n_a[k] + tmp[k];
      r[J_PAP + 3 + k] = f_a[k];
    }
  } else {
    const int vi = M.iv(j);
    T u[6], d, spa;
    if constexpr (S < 6) {
      const T a = M.axis(j)[S % 3];
#pragma unroll
      for (int i = 0; i < 6; ++i) u[i] = ia[s21(i, S)] * a;
      d = a * u[S];
      spa = a * pa[S];
    } else {
      T s6[6];
      motion6(M, j, s6);
      sym21_mv(ia, s6, s6 + 3, u);
      d = s6[0] * u[0];
      spa = s6[0] * pa[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) { d = d + s6[k] * u[k]; spa = spa + s6[k] * pa[k]; }
    }
    const T dinv = T(1) / (d + M.armature(vi));
    const int bnd = tr.bound(j);
    const T te = (bnd >= 0) ? bound_torque(M, w, bnd) : T(0);
    const T u_r = damped_tc(M, w, vi) + te - spa;
#pragma unroll
    for (int k = 0; k < 6; ++k) r[J_U + k] = u[k];
    r[J_DINV] = dinv;
    r[J_URHS] = u_r;
    if (ps < 0) return;
    T R[9], P[3], bias[6];
    joint_frame<S>(M, w, s, j, R, P, bias);
    T ia_a[21], iab[6], pa_n[6], ia_p[21];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) ia_a[s21(a, b)] = ia[s21(a, b)] - u[a] * u[b] * dinv;
    sym21_mv(ia_a, bias, bias + 3, iab);
    const T coef = u_r * dinv;
#pragma unroll
    for (int k = 0; k < 6; ++k) pa_n[k] = pa[k] + iab[k] + u[k] * coef;
    transform_sym21(ia_a, R, P, ia_p);
#pragma unroll
    for (int k = 0; k < 21; ++k) r[J_IAP + k] = ia_p[k];
    T f_a[3], n_a[3], tmp[3];
    mv3(R, pa_n + 3, f_a);
    mv3(R, pa_n, n_a);
    cross3(P, f_a, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[J_PAP + k] = n_a[k] + tmp[k];
      r[J_PAP + 3 + k] = f_a[k];
    }
  }
}

// Pass 3 (outward) for slot s: the joint accelerations into w.qdd and the
// spatial acceleration (-gravity at the root) into the record.
template <int S, typename T>
__device__ __forceinline__ void sp_pass3(const Model<T>& M, const SpTree& tr, const SpWork<T>& w,
                                         int s) {
  const int j = tr.joint(s), ps = tr.pslot(s), vi = M.iv(j);
  T* r = w.rec(s);
  T a_p[6] = {T(0), T(0), T(0), -M.g(0), -M.g(1), -M.g(2)};
  if (ps >= 0) {
    const T* pr = w.rec(ps);
#pragma unroll
    for (int k = 0; k < 6; ++k) a_p[k] = pr[J_ACC + k];
  }
  T R[9], P[3], bias[6], am[6], tmp[3], tmp2[3];
  joint_frame<S>(M, w, s, j, R, P, bias);
  tv3(R, a_p, am);
  cross3(P, a_p, tmp);
#pragma unroll
  for (int k = 0; k < 3; ++k) tmp2[k] = a_p[3 + k] - tmp[k];
  tv3(R, tmp2, am + 3);
#pragma unroll
  for (int k = 0; k < 6; ++k) am[k] = am[k] + bias[k];
  if constexpr (S < 0) {  // FREE: the root's 6x6 solve
    T ia[21], pa[6];
#pragma unroll
    for (int k = 0; k < 21; ++k) ia[k] = r[J_IAP + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) pa[k] = r[J_PA + k];
    T m6[36];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b < 6; ++b) m6[6 * a + b] = ia[s21((a + 3) % 6, (b + 3) % 6)];
#pragma unroll
    for (int k = 0; k < 6; ++k) m6[7 * k] = m6[7 * k] + M.armature(vi + k);
    T iam[6], y[6];
    sym21_mv(ia, am, am + 3, iam);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      y[k] = damped_tc(M, w, vi + k) - pa[3 + k] - iam[3 + k];
      y[3 + k] = damped_tc(M, w, vi + 3 + k) - pa[k] - iam[k];
    }
    solve_sym6(m6, y);
#pragma unroll
    for (int k = 0; k < 6; ++k) w.qdd[vi + k] = y[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[J_ACC + k] = am[k] + y[3 + k];
      r[J_ACC + 3 + k] = am[3 + k] + y[k];
    }
  } else if constexpr (S == S_SPH) {  // qdd = D^-1 (u - U^T a')
    const T* sb = w.sph + SPH_REC * sph_ordinal(M, tr, s);
    T y[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T sum = sb[SPH_U + k] * am[0];
#pragma unroll
      for (int a = 1; a < 6; ++a) sum = sum + sb[SPH_U + 3 * a + k] * am[a];
      y[k] = sb[SPH_URHS + k] - sum;
    }
    sym3_solve(sb + SPH_L, sb + SPH_D, y);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w.qdd[vi + k] = y[k];
      am[k] = am[k] + y[k];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) r[J_ACC + k] = am[k];
  } else {
    const T* u = r + J_U;
    T sum = u[0] * am[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) sum = sum + u[k] * am[k];
    const T a = r[J_DINV] * (r[J_URHS] - sum);
    w.qdd[vi] = a;
    if constexpr (S < 6) {
      am[S] = am[S] + M.axis(j)[S % 3] * a;
    } else {
      T s6[6];
      motion6(M, j, s6);
#pragma unroll
      for (int k = 0; k < 6; ++k) am[k] = am[k] + s6[k] * a;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) r[J_ACC + k] = am[k];
  }
}

// The gravity-free spatial acceleration of slot s given the solved joint
// accelerations (`_fk_accel_components`), after the parent's, into the
// record; the world placement too.
template <int S, typename T>
__device__ __forceinline__ void sp_fk(const Model<T>& M, const SpTree& tr, const SpWork<T>& w,
                                      int s) {
  const int j = tr.joint(s), ps = tr.pslot(s), vi = M.iv(j);
  T* r = w.rec(s);
  T R[9], P[3], bias[6];
  joint_frame<S>(M, w, s, j, R, P, bias);
  T aw_in[3] = {T(0), T(0), T(0)}, al_in[3] = {T(0), T(0), T(0)};
  if (ps < 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) r[J_RW + k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) r[J_PW + k] = P[k];
  } else {
    const T* pr = w.rec(ps);
    T rw_p[9], rw[9], tmp[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) rw_p[k] = pr[J_RW + k];
    mm3(rw_p, R, rw);
    mv3(rw_p, P, tmp);
#pragma unroll
    for (int k = 0; k < 9; ++k) r[J_RW + k] = rw[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) r[J_PW + k] = tmp[k] + pr[J_PW + k];
    const T aa_p[3] = {pr[J_ACC], pr[J_ACC + 1], pr[J_ACC + 2]};
    const T al_p[3] = {pr[J_ACC + 3], pr[J_ACC + 4], pr[J_ACC + 5]};
    tv3(R, aa_p, aw_in);
    cross3(P, aa_p, tmp);
    T t2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) t2[k] = al_p[k] - tmp[k];
    tv3(R, t2, al_in);
  }
  T aj_ang[3], aj_lin[3];
  if constexpr (S < 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) { aj_lin[k] = w.qdd[vi + k]; aj_ang[k] = w.qdd[vi + 3 + k]; }
  } else if constexpr (S == S_SPH) {
#pragma unroll
    for (int k = 0; k < 3; ++k) { aj_ang[k] = w.qdd[vi + k]; aj_lin[k] = T(0); }
  } else {
    T s6[6];
    motion6(M, j, s6);
#pragma unroll
    for (int k = 0; k < 3; ++k) { aj_ang[k] = s6[k] * w.qdd[vi]; aj_lin[k] = s6[3 + k] * w.qdd[vi]; }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[J_ACC + k] = (aw_in[k] + aj_ang[k]) + bias[k];
    r[J_ACC + 3 + k] = (al_in[k] + aj_lin[k]) + bias[3 + k];
  }
}

// Pass `PASS` (1, 2, 3, or 4 for the outputs' accelerations) for slot s, by
// the joint's motion class (with kSph, SPHERICAL joints first).
template <int PASS, bool kSph = false, typename T>
__device__ __forceinline__ void sp_pass(const Model<T>& M, const SpTree& tr, const SpWork<T>& w,
                                        int s) {
  const int j = tr.joint(s);
#define CDYN_SP_PASS(CLS)                                              \
  do {                                                                 \
    if (PASS == 1) sp_pass1<CLS>(M, tr, w, s);                         \
    else if (PASS == 2) sp_pass2<CLS>(M, tr, w, s);                    \
    else if (PASS == 3) sp_pass3<CLS>(M, tr, w, s);                    \
    else sp_fk<CLS>(M, tr, w, s);                                      \
  } while (0)
  if (M.type(j) == FREE) {
    CDYN_SP_PASS(-1);
    return;
  }
  if constexpr (kSph) {
    if (M.type(j) == SPHERICAL) {
      CDYN_SP_PASS(S_SPH);
      return;
    }
  }
  switch (motion_class(M, tr, j)) {
    case 0: CDYN_SP_PASS(0); break;
    case 1: CDYN_SP_PASS(1); break;
    case 2: CDYN_SP_PASS(2); break;
    case 3: CDYN_SP_PASS(3); break;
    case 4: CDYN_SP_PASS(4); break;
    case 5: CDYN_SP_PASS(5); break;
    default: CDYN_SP_PASS(6); break;
  }
#undef CDYN_SP_PASS
}

// One evaluation of `_accel_core` by the group, at (w.qs, w.vs): the joint
// accelerations into w.qdd. With MOTORS the motor efforts under the command
// w.cc first become the torques w.tc; without, w.tc holds the torques. With
// kTerrain the contacts meet the model's terrain, else flat ground; with
// kSph SPHERICAL joints take their 3-dof passes.
template <bool kTerrain, bool MOTORS = true, bool kSph = false, typename T>
__device__ __forceinline__ void sp_evaluate(const SpLanes& L, const Model<T>& M, const SpTree& tr,
                                            const SpWork<T>& w) {
  const int lane = L.lane, G = SP_LANES, nlev = tr.nlev;
#pragma unroll 1
  for (int d = 0; d < nlev; ++d) {
#pragma unroll 1
    for (int s = tr.lstart(d) + lane; s < tr.lstart(d + 1); s += G) sp_pass<1, kSph>(M, tr, w, s);
    L.sync();
  }
  // Contacts, then motors (one task for all when two share a dof)
  const int nc = M.has_contacts ? M.nc : 0;
  const int n_mt = !MOTORS ? 0 : tr.distinct ? M.nm : (M.nm > 0 ? 1 : 0);
#pragma unroll 1
  for (int t = lane; t < nc + n_mt; t += G) {
    if (t < nc) {
      const T* pr = w.rec(tr.slot(M.cparent(t)));
      T fw[3], fj[3], nj[3], depth;
      contact_eval_at<kTerrain>(M, t, pr + J_RW, pr + J_PW, pr + J_VEL, fw, fj, nj, &depth,
                                static_cast<T*>(nullptr));
      T* f = w.fext + 6 * t;
#pragma unroll
      for (int c = 0; c < 3; ++c) { f[c] = nj[c]; f[3 + c] = fj[c]; }
    } else if (tr.distinct) {
      const int m = t - nc;
      w.tc[M.motor(m)[0]] = motor_effort(M, m, w.vs, w.cc);
    } else {
#pragma unroll 1
      for (int m = 0; m < M.nm; ++m) w.tc[M.motor(m)[0]] = T(0);
#pragma unroll 1
      for (int m = 0; m < M.nm; ++m) {
        const int vi = M.motor(m)[0];
        w.tc[vi] = w.tc[vi] + motor_effort(M, m, w.vs, w.cc);
      }
    }
  }
  L.sync();
#pragma unroll 1
  for (int d = nlev - 1; d >= 0; --d) {
#pragma unroll 1
    for (int s = tr.lstart(d) + lane; s < tr.lstart(d + 1); s += G) sp_pass<2, kSph>(M, tr, w, s);
    L.sync();
  }
#pragma unroll 1
  for (int d = 0; d < nlev; ++d) {
#pragma unroll 1
    for (int s = tr.lstart(d) + lane; s < tr.lstart(d + 1); s += G) sp_pass<3, kSph>(M, tr, w, s);
    L.sync();
  }
}

// The integrator after evaluation `stage` of a substep (`_build_substep`), a
// joint per lane: its dofs' RK4 sums, the next stage's (q, v) into (w.qs,
// w.vs) and, after the last stage, the substep's result into (w.q, w.v) too.
template <typename T>
__device__ __forceinline__ void sp_stage(const SpLanes& L, const Model<T>& M, const SpWork<T>& w,
                                         int stage, int integrator) {
  const T dt = M.dt(), hdt = M.half_dt(), dt6 = M.dt6();
  const bool last = integrator == EULER || stage == 3;
  // the retraction's step: scale x (the stage's v, or the sum of the four)
  const T scale = integrator == EULER ? dt : (stage == 2 ? dt : (stage == 3 ? dt6 : hdt));
  // the next stage's v = v + h k
  const T h = stage < 2 ? hdt : dt;
  auto dof = [&](int k) {  // returns the retraction's dv of dof k
    const T kq = w.qdd[k], vk = w.v[k], vsk = w.vs[k];
    if (integrator == EULER) {
      const T vn = vk + dt * kq;
      w.v[k] = vn;
      w.vs[k] = vn;
      return scale * vk;
    }
    T dv;
    if (stage == 0) {
      const T vn = vk + h * kq;
      w.ksum[k] = kq;
      w.vsum[k] = vk + T(2) * vn;
      w.vs[k] = vn;
      dv = scale * vsk;
    } else if (stage < 3) {
      const T vn = vk + h * kq;
      w.ksum[k] = w.ksum[k] + T(2) * kq;
      w.vsum[k] = stage == 1 ? w.vsum[k] + T(2) * vn : w.vsum[k] + vn;
      w.vs[k] = vn;
      dv = scale * vsk;
    } else {
      dv = scale * w.vsum[k];
      const T vn = vk + dt6 * (w.ksum[k] + kq);
      w.v[k] = vn;
      w.vs[k] = vn;
    }
    return dv;
  };
#pragma unroll 1
  for (int j = L.lane; j < M.nj; j += SP_LANES) {
    const int qi = M.iq(j), vi = M.iv(j);
    if (M.type(j) == FREE) {
      T dv[6], qj[7];
#pragma unroll
      for (int k = 0; k < 6; ++k) dv[k] = dof(vi + k);
#pragma unroll
      for (int k = 0; k < 7; ++k) qj[k] = w.q[qi + k];
      free_integrate(qj, dv, qj);
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        w.qs[qi + k] = qj[k];
        if (last) w.q[qi + k] = qj[k];
      }
    } else {
      const T qn = w.q[qi] + dof(vi);
      w.qs[qi] = qn;
      if (last) w.q[qi] = qn;
    }
  }
  L.sync();
}

// End-of-period outputs `[a | f_world | w_local | depth | imu]` after an
// evaluation at (w.qs, w.vs) (`_build_final_outputs`): the world placements
// and the gravity-free accelerations outward, depth after depth, then a
// contact or IMU per lane, rows of the (n_extra, B) array.
template <bool kTerrain, typename T>
__device__ __forceinline__ void sp_final(const SpLanes& L, const Model<T>& M, const SpTree& tr,
                                         const SpWork<T>& w, T* eo, int B, int b) {
  const int lane = L.lane, G = SP_LANES;
#pragma unroll 1
  for (int d = 0; d < tr.nlev; ++d) {
#pragma unroll 1
    for (int s = tr.lstart(d) + lane; s < tr.lstart(d + 1); s += G) sp_pass<4>(M, tr, w, s);
    L.sync();
  }
  const int nv = M.nv, nc = M.has_contacts ? M.nc : 0;
  const int o_fw = nv, o_wl = nv + 3 * nc, o_d = nv + 9 * nc, o_imu = nv + 10 * nc;
#pragma unroll 1
  for (int k = lane; k < nv; k += G) eo[(size_t)k * B + b] = w.qdd[k];
#pragma unroll 1
  for (int t = lane; t < nc + M.ni; t += G) {
    if (t < nc) {
      const T* pr = w.rec(tr.slot(M.cparent(t)));
      T fw[3], fj[3], nj[3], depth, wl[6];
      contact_eval_at<kTerrain>(M, t, pr + J_RW, pr + J_PW, pr + J_VEL, fw, fj, nj, &depth, wl);
#pragma unroll
      for (int c = 0; c < 3; ++c) eo[(size_t)(o_fw + 3 * t + c) * B + b] = fw[c];
#pragma unroll
      for (int c = 0; c < 6; ++c) eo[(size_t)(o_wl + 6 * t + c) * B + b] = wl[c];
      eo[(size_t)(o_d + t) * B + b] = depth;
      continue;
    }
    const int k = t - nc;
    const T* pr = w.rec(tr.slot(M.iparent(k)));
    const T* frot = M.ifrot(k);
    const T* fp = M.ifpos(k);
    const T w_l[3] = {pr[J_VEL], pr[J_VEL + 1], pr[J_VEL + 2]};
    const T v_l[3] = {pr[J_VEL + 3], pr[J_VEL + 4], pr[J_VEL + 5]};
    const T a_a[3] = {pr[J_ACC], pr[J_ACC + 1], pr[J_ACC + 2]};
    const T a_l[3] = {pr[J_ACC + 3], pr[J_ACC + 4], pr[J_ACC + 5]};
    T rw[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) rw[c] = pr[J_RW + c];
    T w_f[3], v_f[3], al_f[3], tmp[3], tmp2[3];
    tv3(frot, w_l, w_f);
    cross3(fp, w_l, tmp);
#pragma unroll
    for (int c = 0; c < 3; ++c) tmp2[c] = v_l[c] - tmp[c];
    tv3(frot, tmp2, v_f);
    cross3(fp, a_a, tmp);
#pragma unroll
    for (int c = 0; c < 3; ++c) tmp2[c] = a_l[c] - tmp[c];
    tv3(frot, tmp2, al_f);
    cross3(w_f, v_f, tmp);
    T rot_f[9], g_f[3];
    mm3(rw, frot, rot_f);
    const T g[3] = {M.g(0), M.g(1), M.g(2)};
    tv3(rot_f, g, g_f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      eo[(size_t)(o_imu + 6 * k + c) * B + b] = w_f[c];
      eo[(size_t)(o_imu + 6 * k + 3 + c) * B + b] = (al_f[c] + tmp[c]) - g_f[c];
    }
  }
}

// Reads rows [0, n) of an (n, B) array into dst, a row per lane.
template <typename T>
__device__ __forceinline__ void load_rows(const SpLanes& L, const T* __restrict__ src, int n, int B,
                                          int b, T* dst) {
#pragma unroll 1
  for (int i = L.lane; i < n; i += SP_LANES) dst[i] = src[(size_t)i * B + b];
}

template <typename T>
__device__ __forceinline__ void store_rows(const SpLanes& L, const T* src, int n, T* __restrict__ dst,
                                           int B, int b) {
#pragma unroll 1
  for (int i = L.lane; i < n; i += SP_LANES) dst[(size_t)i * B + b] = src[i];
}

// The state at the start: (q, v) and the stage inputs, the torques zeroed.
template <typename T>
__device__ __forceinline__ void sp_load_state(const SpLanes& L, const Model<T>& M,
                                              const SpWork<T>& w, const T* __restrict__ q_g,
                                              const T* __restrict__ v_g, int B, int b) {
  load_rows(L, q_g, M.nq, B, b, w.q);
  load_rows(L, q_g, M.nq, B, b, w.qs);
  load_rows(L, v_g, M.nv, B, b, w.v);
  load_rows(L, v_g, M.nv, B, b, w.vs);
#pragma unroll 1
  for (int i = L.lane; i < M.nv; i += SP_LANES) w.tc[i] = T(0);
}

// --------------------------------------------------------------------------
// The two entry kernels: SP_LANES lanes per env, SP_ENVS envs per block, one
// SpLayout slice of dynamic shared memory per env; an instance on flat
// ground and one on the model's terrain (kTerrain).
// --------------------------------------------------------------------------

template <typename T, bool kTerrain>
__global__ void __launch_bounds__(SP_LANES * SP_ENVS)
    cdyn_period_kernel(const int* ci, const T* cf, const T* __restrict__ q_g,
                       const T* __restrict__ v_g, const T* __restrict__ cmd_g, T* __restrict__ qo,
                       T* __restrict__ vo, T* __restrict__ eo, int B, int n_cmd, int n_substeps,
                       int integrator) {
  const SpLanes L;
  const int b = blockIdx.x * SP_ENVS + threadIdx.x / SP_LANES;
  if (b >= B) return;  // the whole group
  const Model<T> M(ci, cf);
  const SpTree tr(ci);
  const SpWork<T> w = sp_work(M, n_cmd, 0, 0);
  sp_load_state(L, M, w, q_g, v_g, B, b);
  load_rows(L, cmd_g, n_cmd, B, b, w.cc);
  L.sync();
  const int n_stage = integrator == EULER ? 1 : 4;
  const int n_eval = n_substeps * n_stage + 1;
#pragma unroll 1
  for (int e = 0;; ++e) {
    sp_evaluate<kTerrain>(L, M, tr, w);
    if (e == n_eval - 1) break;
    sp_stage(L, M, w, e % n_stage, integrator);
  }
  store_rows(L, w.q, M.nq, qo, B, b);
  store_rows(L, w.v, M.nv, vo, B, b);
  sp_final<kTerrain>(L, M, tr, w, eo, B, b);
}

template <typename T, bool kTerrain>
__global__ void __launch_bounds__(SP_LANES * SP_ENVS)
    cdyn_rollout_kernel(const int* ci, const T* cf, const int* pi, const T* pf, int controller,
                        const T* __restrict__ q_g, const T* __restrict__ v_g,
                        const T* __restrict__ a_g, const T* __restrict__ c_g, T* __restrict__ qo,
                        T* __restrict__ vo, T* __restrict__ eo, int B, int n_action, int n_carry,
                        int n_cmd, int n_ticks, int n_substeps, int integrator) {
  const SpLanes L;
  const int b = blockIdx.x * SP_ENVS + threadIdx.x / SP_LANES;
  if (b >= B) return;  // the whole group
  const Model<T> M(ci, cf);
  const SpTree tr(ci);
  const SpWork<T> w = sp_work(M, n_cmd, n_action, n_carry);
  sp_load_state(L, M, w, q_g, v_g, B, b);
  load_rows(L, a_g, n_action, B, b, w.ac);
  load_rows(L, c_g, n_carry, B, b, w.bc);
#pragma unroll 1
  for (int i = L.lane; i < n_cmd; i += SP_LANES) w.cc[i] = T(0);
  L.sync();
  // The controller at each tick's start (`PDComponents` or the pass-through)
  auto tick = [&]() {
    if (controller == CONTROLLER_PD) {
      if (L.leader()) pd_controller(pi, pf, w.q, w.v, w.bc, w.ac, w.cc, w.bc);  // in place
    } else {
#pragma unroll 1
      for (int i = L.lane; i < n_cmd; i += SP_LANES) w.cc[i] = w.ac[i];
    }
    L.sync();
  };
  const int n_stage = integrator == EULER ? 1 : 4;
  const int per_tick = n_substeps * n_stage;
  if (per_tick == 0)
#pragma unroll 1
    for (int t = 0; t < n_ticks; ++t) tick();
  // Every evaluation of the env step, then the final one, from one loop
  const int n_eval = n_ticks * per_tick + 1;
#pragma unroll 1
  for (int e = 0;; ++e) {
    if (per_tick > 0 && e < n_eval - 1 && e % per_tick == 0) tick();
    sp_evaluate<kTerrain>(L, M, tr, w);
    if (e == n_eval - 1) break;
    sp_stage(L, M, w, e % n_stage, integrator);
  }
  store_rows(L, w.q, M.nq, qo, B, b);
  store_rows(L, w.v, M.nv, vo, B, b);
  sp_final<kTerrain>(L, M, tr, w, eo, B, b);
  const int n_std = M.nv + 10 * (M.has_contacts ? M.nc : 0) + 6 * M.ni;
  store_rows(L, w.cc, n_cmd, eo + (size_t)n_std * B, B, b);
  store_rows(L, w.bc, n_carry, eo + (size_t)(n_std + n_cmd) * B, B, b);
}

// --------------------------------------------------------------------------
// cdyn_accel: one evaluation of `_accel_core` an env (jiminy_tpu's
// _pallas_accel_fn; the per-stage kernel of adaptive DOPRI, once a reset
// otherwise). The same group passes as the period kernel's, with the torques
// given, so the motor task is skipped. The slice holds what one evaluation
// needs (`SpAccelLayout`): the joint records, the root's placement, (q, v)
// and the contact wrenches; no integrator vectors, command, action or carry,
// so more envs fit an SM. The torques are read, and the accelerations
// written, in the caller's row-major (B, n) layout straight from the lanes
// (a row is one env's; the groups of a warp cover neighbouring rows).
// --------------------------------------------------------------------------

// Envs a block of cdyn_accel; a build may set another (-DCDYN_ACCEL_ENVS) to
// time it (spring_profile.py). Both 8 and 16 hold 80 envs an SM; 16 halves
// the blocks of a launch of one evaluation and measured 2.6 % faster.
#ifndef CDYN_ACCEL_ENVS
#define CDYN_ACCEL_ENVS 16
#endif
constexpr int SPA_ENVS = CDYN_ACCEL_ENVS;
static_assert(SP_LANES * SPA_ENVS <= 1024, "SP_LANES * SPA_ENVS threads a block");

// Element offsets of one env's accel slice (the same on host and device),
// with `nsph` SPHERICAL joints' blocks at its end (kSph).
struct SpAccelLayout {
  int rec, root, q, v, fext, sph, elems;
  __host__ __device__ SpAccelLayout(int nj, int nq, int nv, int nc, int nsph = 0) {
    rec = 0;
    root = JREC * nj;
    q = root + 12;
    v = q + nq;
    fext = v + nv;
    sph = fext + 6 * nc;
    elems = sph + SPH_REC * nsph;
  }
};

// This thread's env accel slice, built from the shared-memory symbol, with
// the env's torque row (read only) and acceleration row in global memory;
// with kSph the SPHERICAL joints' blocks too.
template <bool kSph, typename T>
__device__ __forceinline__ SpWork<T> sp_accel_work(const Model<T>& M, const T* tau, T* qdd) {
  int nsph = 0;
  if constexpr (kSph) {
#pragma unroll 1
    for (int j = 0; j < M.nj; ++j) nsph += M.type(j) == SPHERICAL;
  }
  const SpAccelLayout lo(M.nj, M.nq, M.nv, M.nc, nsph);
  const int slot = threadIdx.x / SP_LANES;
  T* b = reinterpret_cast<T*>(dynamic_smem() +
                              (size_t)slot * sp_env_stride(lo.elems, static_cast<int>(sizeof(T))));
  T* tc = const_cast<T*>(tau);  // only read: no motor task runs
  return {b + lo.rec, b + lo.root, b + lo.q, b + lo.q, b + lo.v, b + lo.v, qdd,
          nullptr,    nullptr,     tc,       b + lo.fext, nullptr, nullptr, nullptr,
          kSph ? b + lo.sph : nullptr};
}

template <typename T, bool kTerrain, bool kSph = false>
__global__ void __launch_bounds__(SP_LANES * SPA_ENVS)
    cdyn_accel_kernel(const int* ci, const T* cf, const T* __restrict__ q_g,
                      const T* __restrict__ v_g, const T* __restrict__ tau_g, T* __restrict__ out,
                      int B) {
  const SpLanes L;
  const int b = blockIdx.x * SPA_ENVS + threadIdx.x / SP_LANES;
  if (b >= B) return;  // the whole group
  const Model<T> M(ci, cf);
  const SpTree tr(ci);
  const SpWork<T> w = sp_accel_work<kSph>(M, tau_g + (size_t)b * M.nv, out + (size_t)b * M.nv);
  const T* q = q_g + (size_t)b * M.nq;
  const T* v = v_g + (size_t)b * M.nv;
#pragma unroll 1
  for (int i = L.lane; i < M.nq; i += SP_LANES) w.qs[i] = q[i];
#pragma unroll 1
  for (int i = L.lane; i < M.nv; i += SP_LANES) w.vs[i] = v[i];
  L.sync();
  sp_evaluate<kTerrain, false, kSph>(L, M, tr, w);
}

}  // namespace cdyn
