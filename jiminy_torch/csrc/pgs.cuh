// Constrained (PGS) bodies of the period and rollout kernels: the CUDA
// counterparts of jiminy_tpu/engine/solver.py's component path
// (`constrained_accel_full_components`, `_pgs_sweep_components`,
// `make_constrained_period_integrator`, `make_constrained_rollout_integrator`),
// run inside
//
//   cdyn_period_cm  <- _pallas_period_fn  with the constrained body
//   cdyn_rollout_cm <- _pallas_rollout_fn with the constrained body
//
// What bounds them on an H100: operations. An env step of the ANYmal is 168
// constrained solves, 6.08 M scalar operations per env with the zero operands
// folded away (a period 0.76 M), against about a thousand bytes of I/O per
// env. One solve: component CRBA and RNEA, an LDL^T factor of the mass
// matrix, the joint-bound and ground-contact rows with their Baumgarte drifts
// and active-set hysteresis, the Delassus matrix A = J M^-1 J^T with its
// diagonal regularization, and a fixed number of boxed/cone Gauss-Seidel
// sweeps warm-started from the carried multipliers.
//
// Design. A group of CM_LANES = 8 lanes (aligned in its warp) steps one env,
// up to CM_ENVS = 4 envs to a block: the launcher picks the count from the
// slice so that a block fits and the most envs stay resident an SM
// (`cdyn_cm_geometry`), and the kernels read it from blockDim; a group past
// the end of the batch leaves whole. Everything an env keeps lives in
// dynamic shared memory, one slice per env sized from the model's joints,
// dofs, rows and supports and the kernel's command, action and carry widths
// at launch (`CmLayout`, about 8 KB at float32 for the ANYmal, so 28 envs fit
// on an SM; 36,000 B for the 78 rows of the full Atlas): J over each row's
// support dofs and M^-1 J^T over the active rows, A's upper triangle, the
// LDL^T factor of M (its lower triangle), the per-joint arrays of the tree
// passes (whose arrays share space by lifetime, and with M^-1 J^T and A,
// alive only after them), the three solver states, the env's state and its
// RK4 sums (the stage states are the solve's inputs, the stage
// accelerations its output), the command, the action and the controller's
// carry. No array is sized at compile time. Inside a solve:
//  - the tree passes (placements, the bias kinematics, RNEA, CRBA) run
//    depth after depth of the tree, a joint per lane, each joint's
//    arithmetic that of the serial passes; lanes build the rows a bound or
//    contact each;
//  - only the active rows are built and solved, listed in the order the
//    sweeps visit them (bounds, normals, torsion, tangent pairs); the
//    inactive rows' multipliers are written as 0. This is exact: in the
//    dense system an inactive row has J = 0, drift = 0 and a zero warm
//    start, so the projections keep its multiplier at 0 in every sweep and
//    it adds exact zeros to every other row;
//  - sums over dofs run over a row's support (`CModel::csup`, `bsup`: a contact's
//    ancestor dofs, a bound's one dof), in ascending dof order as in the
//    plain version (dropping exact zeros from a sum is exact);
//  - lanes share the LDL^T factor by rows, the right-hand sides of M^-1 J^T,
//    the entries of A and b, and the accelerations. The sweeps keep the
//    residual y = b - A x in registers, each lane the rows congruent to it
//    mod CM_LANES: a row update takes its y from its lane (one shuffle) and
//    every lane subtracts the update times A's column from its rows, so the
//    chain of a Gauss-Seidel step is a shuffle, a division and an FMA. Every
//    lane keeps its own copy of the multipliers up to date: no barrier. A
//    lane keeps CM_SLOTS rows in registers (the first CM_REG_ROWS rows of
//    the group, all of the ANYmal's); the x and y of the rows past them stay
//    in the slice (in x and b), each written by its lane alone.
// Group barriers are __syncwarp on the group's mask only, so groups of one
// warp with different active counts never wait on each other. Float64 runs
// agree with the plain version to rounding (the residual is updated rather
// than recomputed, and sums run in another order than the plain version's);
// float32 also by FMA contraction.
//
// The extended body (`kExt`, an instance of its own so that the bound and
// contact rows' instances keep their code): loop closures as distance rows
// (always active and unbounded, swept first with a plain Gauss-Seidel
// update, their lengths riding the command or action row), the core's
// spring-damper ground contacts as external forces in the RNEA (evaluated
// per contact by the spring kernels' `contact_eval_at`, the end-of-period
// forces into the extras) and its penalty joint bounds in the torques;
// sphere contacts (radius r > 0: the depth less r, the rows and drifts at the
// surface point -r n through r skew(n)); rolling constraints (a sphere or a
// wheel on a frame, 3 rows each, always active and unbounded, swept after the
// loop rows with the same update, their reference heights riding the command
// or action row).
#pragma once

namespace cdyn {

// Int buffer `si`: header [N nb nc iter_max stage_warm_start support_width nd
// nr], then per bound (q index, v index), per contact (parent joint,
// support size, offset of its support dofs in `si`), per loop closure (the
// parent joints of its two frames, support size, offset), per rolling
// constraint (parent joint, support size, offset, 1 for a wheel), then the
// support dof lists (ascending; a loop's the union of its two chains');
// support_width is the largest support size (1 for a bound).
// Float buffer `sf`: header [kp kd friction torsion regularization
// min_regularizer transition_eps ...], the relaxation weight of every sweep,
// then per bound (lo hi lo+eps hi-eps), per contact fpos(3) frot(9), per
// loop closure the two frames' fpos(3), the contacts' radii, per rolling
// constraint fpos(3), radius, a wheel's axis in its joint's coordinates (3).
constexpr int SI_HEADER = 8, SF_HEADER = 8, SI_BOUND = 2, SI_CONTACT = 3, SI_DISTANCE = 4,
              SI_ROLLING = 4, SF_BOUND = 4, SF_CONTACT = 12, SF_DISTANCE = 6, SF_ROLLING = 7;

template <typename T>
struct CModel {
  const int* __restrict__ si;
  const T* __restrict__ sf;
  int n, nb, nc, iter_max, stage_warm, ns;
  int fb, fc;  // float offsets: bounds, contacts
  int ncmd, nact, nblk;  // the kernel's command, action and controller-carry widths

  __device__ CModel(const int* si_, const T* sf_, int ncmd_, int nact_, int nblk_)
      : si(si_), sf(sf_), ncmd(ncmd_), nact(nact_), nblk(nblk_) {
    n = si[0]; nb = si[1]; nc = si[2]; iter_max = si[3]; stage_warm = si[4]; ns = si[5];
    fb = SF_HEADER + iter_max;
    fc = fb + SF_BOUND * nb;
  }
  __device__ int bq(int b) const { return si[SI_HEADER + SI_BOUND * b]; }
  __device__ int bv(int b) const { return si[SI_HEADER + SI_BOUND * b + 1]; }
  __device__ const int* cinfo(int k) const { return si + SI_HEADER + SI_BOUND * nb + SI_CONTACT * k; }
  __device__ int cparent(int k) const { return cinfo(k)[0]; }
  // support dofs of a row: offset in `si` and count (a bound: its v index)
  __device__ int bsup(int b) const { return SI_HEADER + SI_BOUND * b + 1; }
  __device__ int csup(int k) const { return cinfo(k)[2]; }
  __device__ int csup_n(int k) const { return cinfo(k)[1]; }
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
  // loop closures (read by the kExt instances only)
  __device__ int nd() const { return si[6]; }
  __device__ const int* dinfo(int k) const { return cinfo(nc) + SI_DISTANCE * k; }
  __device__ int dsup(int k) const { return dinfo(k)[3]; }
  __device__ int dsup_n(int k) const { return dinfo(k)[2]; }
  __device__ const T* dfpos(int k) const { return cfpos(nc) + SF_DISTANCE * k; }
  // contact radii and rolling constraints (read by the kExt instances only)
  __device__ T cradius(int k) const { return dfpos(nd())[k]; }
  __device__ int nr() const { return si[7]; }
  __device__ const int* rinfo(int k) const { return dinfo(nd()) + SI_ROLLING * k; }
  __device__ const T* rfl(int k) const { return dfpos(nd()) + nc + SF_ROLLING * k; }
};

// --------------------------------------------------------------------------
// Lane groups and the per-env shared-memory slice
// --------------------------------------------------------------------------

// Lanes per env and the most envs a block (the launcher picks up to that
// many from the slice); a build may set others (-DCDYN_CM_LANES,
// -DCDYN_CM_ENVS: 4, 8, 16 or 32 lanes) to time them.
#ifndef CDYN_CM_LANES
#define CDYN_CM_LANES 8
#endif
#ifndef CDYN_CM_ENVS
#define CDYN_CM_ENVS 4
#endif
constexpr int CM_LANES = CDYN_CM_LANES, CM_ENVS = CDYN_CM_ENVS;
constexpr int CM_REG_ROWS = 40;  // rows whose sweep state lives in registers
constexpr int CM_SLOTS = (CM_REG_ROWS + CM_LANES - 1) / CM_LANES;  // register rows per lane
static_assert(CM_LANES == 4 || CM_LANES == 8 || CM_LANES == 16 || CM_LANES == 32,
              "CM_LANES: a power of two from 4 to 32");
static_assert(CM_LANES * CM_ENVS <= 1024, "CM_LANES * CM_ENVS threads a block");
// The blocks an SM the period kernel's instance asks its registers to allow:
// the float32 instances of the bound and contact rows keep to 168 registers,
// 384 threads an SM (48 envs where the slice allows: the pendulum's; 212
// registers left it 32); the others keep the compiler's count (the cap
// spills in the extended body and at float64).
template <typename T, bool kExt>
struct CmPeriodBlocks {
  static constexpr int threads = CM_LANES * CM_ENVS;
  static constexpr int value =
      (sizeof(T) == 4 && !kExt && threads <= 384) ? 384 / threads : 1;
};

// The CM_LANES lanes of one env, aligned in their warp.
struct Lanes {
  int lane;
  unsigned mask;
  __device__ Lanes() : lane(threadIdx.x & (CM_LANES - 1)) {
    mask = (CM_LANES == 32) ? 0xffffffffu
                            : (((1u << CM_LANES) - 1u) << ((threadIdx.x & 31) & ~(CM_LANES - 1)));
  }
  __device__ bool leader() const { return lane == 0; }
  __device__ void sync() const { __syncwarp(mask); }
};

// Position of entry (r, c), r <= c, of the packed upper triangle of an
// na x na symmetric matrix, row by row.
__device__ __forceinline__ int upper_at(int na, int r, int c) {
  return r * (2 * na - r + 1) / 2 + (c - r);
}

// Position of entry (r, c), c <= r, of a packed lower triangle, row by row
// (the mass matrix and its LDL^T factor).
__device__ __forceinline__ int lower_at(int r, int c) { return r * (r + 1) / 2 + c; }
// Entry (r, c) of a symmetric matrix kept as its lower triangle.
__device__ __forceinline__ int sym_at(int r, int c) { return r >= c ? lower_at(r, c) : lower_at(c, r); }

// Byte offsets of one env's slice of dynamic shared memory, from the model's
// joints, dofs, rows, contacts, bounds and support width, for the kExt body
// its loop closures (nd), spring-damper contacts (ncs) and rolling
// constraints (nr), whose regions take no space without them, and the
// kernel's command, action and controller-carry widths (the same on host
// and device).
struct CmLayout {
  int tree, wmat, amat, jmat, mmat, dinv, d, tau, tc, qs, vs, qdd, drift, b, x, depth, lam;
  int rows, pos, soff, scnt, cnt, clist, jorder, lstart, masks, dref, fx, rref;
  int q, v, ksum, vsum, cmd, act, blk, bytes;

  __host__ __device__ CmLayout(int nj, int nq, int nv, int n, int nc, int nb, int ns, int nd,
                               int ncs, int nr, int n_cmd, int n_act, int n_blk, int elt) {
    int off = 0;
    auto take = [&](int count, int size) {
      const int at = off;
      off += (count * size + 15) / 16 * 16;
      return at;
    };
    // The tree passes' per-joint arrays, 72 values a joint: R P VELg ACCg
    // throughout, RW PW VEL ACC up to the rows, then IC F FT in their place
    // (`Work`). Their space is M^-1 J^T's and A's (upper triangle) after them.
    const int tree_n = 72 * nj, wa_n = n * nv + n * (n + 1) / 2;
    tree = take(tree_n > wa_n ? tree_n : wa_n, elt);
    wmat = tree;
    amat = tree + n * nv * elt;
    jmat = take(n * ns, elt);
    mmat = take(nv * (nv + 1) / 2, elt);  // lower triangle
    dinv = take(nv, elt);
    d = take(nv, elt);
    tau = take(nv, elt);
    tc = take(nv, elt);
    qs = take(nq, elt);
    vs = take(nv, elt);
    qdd = take(nv, elt);
    drift = take(n, elt);
    b = take(n, elt);
    x = take(n, elt);
    depth = take(nc, elt);
    lam = take(3 * n, elt);
    rows = take(n, 4);
    pos = take(n, 4);
    soff = take(n, 4);
    scnt = take(n, 4);
    cnt = take(4, 4);
    clist = take(nc, 4);
    jorder = take(nj, 4);
    lstart = take(nj + 1, 4);
    masks = take(3 * (nc + nb), 1);
    dref = take(nd, elt);
    fx = take(6 * ncs, elt);  // the spring contacts' LOCAL wrenches on their joints
    rref = take(nr, elt);     // the rolling constraints' reference heights
    // The env's state, its RK4 sums, command, action and controller carry:
    // alive across the solves (a substep's stage states are qs and vs, its
    // stage accelerations qdd)
    q = take(nq, elt);
    v = take(nv, elt);
    ksum = take(nv, elt);
    vsum = take(nv, elt);
    cmd = take(n_cmd, elt);
    act = take(n_act, elt);
    blk = take(n_blk, elt);
    bytes = off;
  }
};

// Bytes between two envs' slices: the slice padded so that the groups of one
// warp start CM_LANES element widths apart in the 32 four-byte banks of
// shared memory. Then the same offset in each group's slice (lane 0's serial
// code) and consecutive offsets across a group's lanes fall in distinct banks.
__host__ __device__ inline int cm_env_stride(int bytes, int elt) {
  const int words = bytes / 4;  // a multiple of 4
  const int want = (CM_LANES * elt / 4) % 32;
  return 4 * (words + (want - words % 32 + 32) % 32);
}

// Solver state of one env: the warm-start multipliers and active sets
template <typename T>
struct SolverState {
  T* lam;
  unsigned char* cact;
  unsigned char* bact;
};

// Solver states of a slice: the carry's, the command row's, the stages'
constexpr int ST_CARRY = 0, ST_CC = 1, ST_TMP = 2;

// Views of one env's slice.
template <typename T>
struct Work {
  T (*R)[9];
  T (*P)[3];
  T (*RW)[9];
  T (*PW)[3];
  T (*VEL)[6];
  T (*ACC)[6];
  T (*IC)[36];
  T (*F)[6];
  T (*VELg)[6];
  T (*ACCg)[6];
  T (*FT)[6];  // joint forces in their parent's frame (RNEA)
  T *W, *A, *J, *Mm, *dinv, *d, *tau, *tc, *qs, *vs, *qdd, *drift, *b, *x, *depth;
  int *rows, *pos, *soff, *scnt, *cnt, *clist;
  int *jorder, *lstart;  // joints by tree depth; where each depth starts in jorder
  T* lam;                // the three solver states, one after another
  unsigned char* masks;
  T* dref;               // the loops' lengths (kExt)
  T (*FX)[6];            // the spring contacts' wrenches (n, f) on their joints (kExt)
  T* rref;               // the rolling constraints' reference heights (kExt)
  T *q, *v, *ksum, *vsum;  // the env's state and a substep's RK4 sums
  T *cmd, *act, *blk;      // its command, action and controller carry
  int n, nc, nmask;

  __device__ Work(unsigned char* base, const Model<T>& M, const CModel<T>& C, int nd, int ncs,
                  int nr) {
    const CmLayout lo(M.nj, M.nq, M.nv, C.n, C.nc, C.nb, C.ns, nd, ncs, nr, C.ncmd, C.nact,
                      C.nblk, static_cast<int>(sizeof(T)));
    T* t = reinterpret_cast<T*>(base + lo.tree);
    const int nj = M.nj;
    R = reinterpret_cast<T(*)[9]>(t);
    P = reinterpret_cast<T(*)[3]>(t + 9 * nj);
    VELg = reinterpret_cast<T(*)[6]>(t + 12 * nj);
    ACCg = reinterpret_cast<T(*)[6]>(t + 18 * nj);
    // the forward pass and the rows' arrays; the backward pass's in their place
    T* u = t + 24 * nj;
    RW = reinterpret_cast<T(*)[9]>(u);
    PW = reinterpret_cast<T(*)[3]>(u + 9 * nj);
    VEL = reinterpret_cast<T(*)[6]>(u + 12 * nj);
    ACC = reinterpret_cast<T(*)[6]>(u + 18 * nj);
    IC = reinterpret_cast<T(*)[36]>(u);
    F = reinterpret_cast<T(*)[6]>(u + 36 * nj);
    FT = reinterpret_cast<T(*)[6]>(u + 42 * nj);
    W = reinterpret_cast<T*>(base + lo.wmat);
    A = reinterpret_cast<T*>(base + lo.amat);
    J = reinterpret_cast<T*>(base + lo.jmat);
    Mm = reinterpret_cast<T*>(base + lo.mmat);
    dinv = reinterpret_cast<T*>(base + lo.dinv);
    d = reinterpret_cast<T*>(base + lo.d);
    tau = reinterpret_cast<T*>(base + lo.tau);
    tc = reinterpret_cast<T*>(base + lo.tc);
    qs = reinterpret_cast<T*>(base + lo.qs);
    vs = reinterpret_cast<T*>(base + lo.vs);
    qdd = reinterpret_cast<T*>(base + lo.qdd);
    drift = reinterpret_cast<T*>(base + lo.drift);
    b = reinterpret_cast<T*>(base + lo.b);
    x = reinterpret_cast<T*>(base + lo.x);
    depth = reinterpret_cast<T*>(base + lo.depth);
    rows = reinterpret_cast<int*>(base + lo.rows);
    pos = reinterpret_cast<int*>(base + lo.pos);
    soff = reinterpret_cast<int*>(base + lo.soff);
    scnt = reinterpret_cast<int*>(base + lo.scnt);
    cnt = reinterpret_cast<int*>(base + lo.cnt);
    clist = reinterpret_cast<int*>(base + lo.clist);
    jorder = reinterpret_cast<int*>(base + lo.jorder);
    lstart = reinterpret_cast<int*>(base + lo.lstart);
    lam = reinterpret_cast<T*>(base + lo.lam);
    masks = base + lo.masks;
    dref = reinterpret_cast<T*>(base + lo.dref);
    FX = reinterpret_cast<T(*)[6]>(base + lo.fx);
    rref = reinterpret_cast<T*>(base + lo.rref);
    q = reinterpret_cast<T*>(base + lo.q);
    v = reinterpret_cast<T*>(base + lo.v);
    ksum = reinterpret_cast<T*>(base + lo.ksum);
    vsum = reinterpret_cast<T*>(base + lo.vsum);
    cmd = reinterpret_cast<T*>(base + lo.cmd);
    act = reinterpret_cast<T*>(base + lo.act);
    blk = reinterpret_cast<T*>(base + lo.blk);
    n = C.n;
    nc = C.nc;
    nmask = C.nc + C.nb;
  }
  // solver state s (ST_CARRY, ST_CC, ST_TMP)
  __device__ SolverState<T> state(int s) const {
    unsigned char* cact = masks + s * nmask;
    return {lam + s * n, cact, cact + nc};
  }
};

// Phase timing of a solve, in a build with -DCDYN_CM_PROFILE only: lane 0 of
// every group adds the clock64() cycles its group spends in each phase of
// `constrained_accel` (kinematics, active sets, CRBA | RNEA | rows, LDL^T,
// M^-1 solves, A and b, sweeps, accelerations) to cm_phase_cycles.
constexpr int CM_PHASES = 8;
#ifdef CDYN_CM_PROFILE
__device__ unsigned long long cm_phase_cycles[CM_PHASES];
#define CM_PROFILE_START(t) long long t = clock64()
#define CM_PROFILE_PHASE(L, k, t)                                                   \
  do {                                                                              \
    if ((L).leader()) {                                                             \
      const long long now_ = clock64();                                             \
      atomicAdd(&cm_phase_cycles[k], static_cast<unsigned long long>(now_ - (t)));  \
      (t) = now_;                                                                   \
    }                                                                               \
  } while (0)
#else
#define CM_PROFILE_START(t)
#define CM_PROFILE_PHASE(L, k, t)
#endif

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char cm_smem[];
  return cm_smem;
}

// This thread's env slice. Each function builds it from the shared-memory
// symbol rather than taking it by reference: the compiler then sees shared
// memory behind the pointers, and keeps them and the model's constants in
// registers (a reference to the stack is reloaded after every store). Only
// the kExt instances read the loops, the spring contacts and the rolling
// constraints.
template <bool kExt, typename T>
__device__ __forceinline__ Work<T> env_work(const Model<T>& M, const CModel<T>& C) {
  const int nd = kExt ? C.nd() : 0, ncs = kExt ? M.nc : 0, nr = kExt ? C.nr() : 0;
  const CmLayout lo(M.nj, M.nq, M.nv, C.n, C.nc, C.nb, C.ns, nd, ncs, nr, C.ncmd, C.nact, C.nblk,
                    static_cast<int>(sizeof(T)));
  const int slot = threadIdx.x / CM_LANES;
  return Work<T>(dynamic_smem() + (size_t)slot * cm_env_stride(lo.bytes, sizeof(T)), M, C, nd,
                 ncs, nr);
}

// --------------------------------------------------------------------------
// Pieces of one solve
// --------------------------------------------------------------------------

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

// The tree passes run joint by joint within a depth of the tree and depth
// after depth, a joint per lane; each joint's arithmetic is that of the
// serial passes (`_joint_x`, `_world_placements`, `nle_components`,
// `mass_matrix_components`), and each parent sums its children in the
// serial passes' order (descending joint index), so the results are the
// same. `tree_levels` lists the joints by depth once per launch.
template <typename T>
__device__ void tree_levels(const Model<T>& M, int* jorder, int* lstart, int* nlev) {
  int k = 0, d = 0;
  for (;; ++d) {
    lstart[d] = k;
    for (int j = 0; j < M.nj; ++j) {
      int depth = 0;
      for (int p = M.parent(j); p >= 0; p = M.parent(p)) ++depth;
      if (depth == d) jorder[k++] = j;
    }
    if (k == lstart[d]) break;
  }
  *nlev = d;
}

// Spatial velocity and acceleration of joint i with zero joint acceleration
// (the first pass of `nle_components`): the root's parent accelerates at -g
// with `gravity`, at 0 without (the velocity-bias kinematics of the rows).
template <typename T>
__device__ void vel_acc_joint(const Model<T>& M, int i, const T* R, const T* P, const T* v,
                              bool gravity, T (*VEL)[6], T (*ACC)[6]) {
  const int p = M.parent(i);
  const int t = M.type(i);
  const int vi = M.iv(i);
  T w_p[3] = {T(0), T(0), T(0)}, v_p[3] = {T(0), T(0), T(0)};
  T aa_p[3] = {T(0), T(0), T(0)}, al_p[3] = {T(0), T(0), T(0)};
  if (gravity)
    for (int k = 0; k < 3; ++k) al_p[k] = -M.g(k);
  if (p >= 0)
    for (int k = 0; k < 3; ++k) {
      w_p[k] = VEL[p][k]; v_p[k] = VEL[p][3 + k];
      aa_p[k] = ACC[p][k]; al_p[k] = ACC[p][3 + k];
    }
  T w_in[3], v_in[3], aw_in[3], al_in[3], tmp[3];
  tv3(R, w_p, w_in);
  cross3(P, w_p, tmp);
  for (int k = 0; k < 3; ++k) tmp[k] = v_p[k] - tmp[k];
  tv3(R, tmp, v_in);
  tv3(R, aa_p, aw_in);
  cross3(P, aa_p, tmp);
  for (int k = 0; k < 3; ++k) tmp[k] = al_p[k] - tmp[k];
  tv3(R, tmp, al_in);
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

// The forward pass for joint i: its placement in the parent frame and in
// the world, the velocity-bias kinematics, and RNEA's recursion (gravity).
template <typename T>
__device__ void forward_joint(const Model<T>& M, int i, const T* q, const T* v, Work<T>& w) {
  const T* tr = M.jrot(i);
  const T* tp = M.jpos(i);
  const int qi = M.iq(i);
  const int t = M.type(i);
  T* R = w.R[i];
  T* P = w.P[i];
  T tmp[3];
  if (t == FREE) {
    T rj[9];
    quat_to_m(q[qi + 3], q[qi + 4], q[qi + 5], q[qi + 6], rj);
    mm3(tr, rj, R);
    T pj[3] = {q[qi], q[qi + 1], q[qi + 2]};
    mv3(tr, pj, tmp);
    for (int k = 0; k < 3; ++k) P[k] = tmp[k] + tp[k];
  } else if (t == REVOLUTE) {
    T rj[9];
    rodrigues(M.axis(i), M.axprod(i), q[qi], rj);
    mm3(tr, rj, R);
    for (int k = 0; k < 3; ++k) P[k] = tp[k];
  } else {  // PRISMATIC
    const T* ax = M.axis(i);
    for (int k = 0; k < 9; ++k) R[k] = tr[k];
    T disp[3] = {ax[0] * q[qi], ax[1] * q[qi], ax[2] * q[qi]};
    mv3(tr, disp, tmp);
    for (int k = 0; k < 3; ++k) P[k] = tmp[k] + tp[k];
  }
  const int p = M.parent(i);
  if (p < 0) {
    for (int k = 0; k < 9; ++k) w.RW[i][k] = R[k];
    for (int k = 0; k < 3; ++k) w.PW[i][k] = P[k];
  } else {
    mm3(w.RW[p], R, w.RW[i]);
    mv3(w.RW[p], P, tmp);
    for (int k = 0; k < 3; ++k) w.PW[i][k] = tmp[k] + w.PW[p][k];
  }
  vel_acc_joint(M, i, R, P, v, false, w.VEL, w.ACC);
  vel_acc_joint(M, i, R, P, v, true, w.VELg, w.ACCg);
}

// The backward pass for joint i, its children gathered: the CRBA column of
// its dofs (armature included) with its composite inertia moved into the
// parent frame in place, and its RNEA force with tau[vi] and the force in
// the parent frame (FT).
template <bool kExt, typename T>
__device__ void backward_joint(const Model<T>& M, int i, Work<T>& w) {
  const int vi = M.iv(i);
  const int p = M.parent(i);
  T* Mm = w.Mm;
  T (*IC)[36] = w.IC;
  if (M.type(i) == FREE) {  // permuted composite inertia + armature
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c <= r; ++c) Mm[lower_at(vi + r, vi + c)] = IC[i][6 * ((r + 3) % 6) + (c + 3) % 6];
    for (int r = 0; r < 6; ++r)
      Mm[lower_at(vi + r, vi + r)] = Mm[lower_at(vi + r, vi + r)] + M.armature(vi + r);
  } else {
    T ax_a[3], ax_l[3], fv[6];
    motion_axis(M, i, ax_a, ax_l);
    sym6_mv(IC[i], ax_a, ax_l, fv);
    Mm[lower_at(vi, vi)] = (dot3(ax_a, fv) + dot3(ax_l, fv + 3)) + M.armature(vi);
    T n_c[3] = {fv[0], fv[1], fv[2]}, f_c[3] = {fv[3], fv[4], fv[5]};
    int j = i;
#pragma unroll 1
    while (M.parent(j) >= 0) {  // transport the column up the tree
      force_to_parent(w.R[j], w.P[j], n_c, f_c);
      j = M.parent(j);
      const int vj = M.iv(j);
      if (M.type(j) == FREE) {
        const T full[6] = {n_c[0], n_c[1], n_c[2], f_c[0], f_c[1], f_c[2]};
        for (int k = 0; k < 6; ++k) Mm[sym_at(vi, vj + k)] = full[(k + 3) % 6];
      } else {
        T aj_a[3], aj_l[3];
        motion_axis(M, j, aj_a, aj_l);
        Mm[sym_at(vi, vj)] = dot3(aj_a, n_c) + dot3(aj_l, f_c);
      }
    }
    if (p >= 0) {
      T ia_p[36];
      transform_sym6(IC[i], w.R[i], w.P[i], ia_p);
      for (int k = 0; k < 36; ++k) IC[i][k] = ia_p[k];
    }
  }
  // RNEA: the joint's force from its motion and its children's forces
  const T* w_i = w.VELg[i];
  const T* v_i = w.VELg[i] + 3;
  T ia_av[6], iv[6], c1[3], c2[3];
  sym6_mv(M.ia0(i), w.ACCg[i], w.ACCg[i] + 3, ia_av);
  sym6_mv(M.ia0(i), w_i, v_i, iv);
  cross3(w_i, iv, c1);
  cross3(v_i, iv + 3, c2);
  T f_a[3], f_l[3];
  for (int k = 0; k < 3; ++k) f_a[k] = ia_av[k] + (c1[k] + c2[k]);
  cross3(w_i, iv + 3, c1);
  for (int k = 0; k < 3; ++k) f_l[k] = ia_av[3 + k] + c1[k];
  if constexpr (kExt) {  // the joint's spring contacts, summed in contact order
    T e[6];
    bool any = false;
#pragma unroll 1
    for (int k = 0; k < M.nc; ++k) {
      if (M.cparent(k) != i) continue;
      for (int c = 0; c < 6; ++c) e[c] = any ? e[c] + w.FX[k][c] : w.FX[k][c];
      any = true;
    }
    if (any)
      for (int k = 0; k < 3; ++k) { f_a[k] = f_a[k] - e[k]; f_l[k] = f_l[k] - e[3 + k]; }
  }
  bool has_child = false;
  for (int c = i + 1; c < M.nj; ++c) has_child = has_child || M.parent(c) == i;
  if (has_child)
    for (int k = 0; k < 3; ++k) { f_a[k] = f_a[k] + w.F[i][k]; f_l[k] = f_l[k] + w.F[i][3 + k]; }
  if (M.type(i) == FREE) {
    const T full[6] = {f_a[0], f_a[1], f_a[2], f_l[0], f_l[1], f_l[2]};
    for (int k = 0; k < 6; ++k) w.tau[vi + k] = full[(k + 3) % 6];
  } else {
    T ax_a[3], ax_l[3];
    motion_axis(M, i, ax_a, ax_l);
    w.tau[vi] = dot3(ax_a, f_a) + dot3(ax_l, f_l);
  }
  if (p >= 0) {
    force_to_parent(w.R[i], w.P[i], f_a, f_l);
    for (int k = 0; k < 3; ++k) { w.FT[i][k] = f_a[k]; w.FT[i][3 + k] = f_l[k]; }
  }
}

// Parent p sums its children's composite inertias (moved into its frame)
// and forces, in descending child index as the serial passes do.
template <typename T>
__device__ void gather_children(const Model<T>& M, int p, Work<T>& w) {
  bool has = false;
#pragma unroll 1
  for (int c = M.nj - 1; c > p; --c) {
    if (M.parent(c) != p) continue;
    if (M.type(c) != FREE)
      for (int k = 0; k < 36; ++k) w.IC[p][k] = w.IC[p][k] + w.IC[c][k];
    for (int k = 0; k < 6; ++k) w.F[p][k] = has ? w.F[p][k] + w.FT[c][k] : w.FT[c][k];
    has = true;
  }
}

// Solve with the in-place LDL^T factor L (its packed lower triangle,
// `lower_at`) and the inverse pivots (`_ldl_solve_components`); y[i] = 0 for
// i < first, which the forward pass skips (exact).
template <typename T>
__device__ void ldl_solve(int n, const T* L, const T* dinv, T* y, int first) {
  // y[i] accumulates in a register: the same operations in the same order,
  // with no shared-memory round trip between them
#pragma unroll 1
  for (int i = first; i < n; ++i) {
    const T* li = L + lower_at(i, 0);
    T s = y[i];
#pragma unroll 4
    for (int k = first; k < i; ++k) s = s - li[k] * y[k];
    y[i] = s;
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) y[i] = y[i] * dinv[i];
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {
    T s = y[i];
    int at = lower_at(i + 1, i);  // L[k][i], k = i + 1, ...: the next row's entry i
#pragma unroll 4
    for (int k = i + 1; k < n; ++k) {
      s = s - L[at] * y[k];
      at += k + 1;
    }
    y[i] = s;
  }
}

// Hysteresis of bound b (`constraint_system_components`).
template <typename T>
__device__ __forceinline__ bool bound_active(const CModel<T>& C, int b, const T* q, bool was) {
  const T* bf = C.boundf(b);  // lo hi lo+eps hi-eps
  const T qj = q[C.bq(b)];
  const bool raw = (qj > bf[1]) || (qj < bf[0]);
  const bool inside = (qj > bf[2]) && (qj < bf[3]);
  return raw || (was && !inside);
}

// World position pc of contact k.
template <typename T>
__device__ __forceinline__ void contact_pos(const CModel<T>& C, int k, const T (*RW)[9],
                                            const T (*PW)[3], T* pc) {
  const int parent = C.cparent(k);
  T tmp[3];
  mv3(RW[parent], C.cfpos(k), tmp);
  for (int i = 0; i < 3; ++i) pc[i] = tmp[i] + PW[parent][i];
}

// World contact point of contact k; returns its depth. On flat ground the
// height is 0 and the normal +z; with kTerrain the model's terrain gives
// both, the unit normal into n (`constraint_system_components`).
template <bool kTerrain, typename T>
__device__ __forceinline__ T contact_point(const Model<T>& M, const CModel<T>& C, int k,
                                           const T (*RW)[9], const T (*PW)[3], T* pc, T* n) {
  contact_pos(C, k, RW, PW, pc);
  if constexpr (kTerrain) {
    const GroundPoint<T> g = terrain_eval(M.ci, M.cf, pc[0], pc[1]);
    n[0] = g.nx; n[1] = g.ny; n[2] = g.nz;
    const T nn = tmax(sqrt(dot3(n, n)), T(1e-12));
    const T inv = T(1) / nn;
    for (int i = 0; i < 3; ++i) n[i] = n[i] * inv;
    return (pc[2] - g.h) * n[2];
  } else {
    return (pc[2] - T(0)) * T(1);  // height 0, unit normal
  }
}

// The row and drift of active bound b at position p; J holds each row over
// its support dofs, C.ns entries a row (a bound's one dof).
template <typename T>
__device__ void bound_row(const CModel<T>& C, int b, int p, const T* q, const T* v, T* J,
                          T* drift) {
  const int vi = C.bv(b);
  const T* bf = C.boundf(b);
  const T qj = q[C.bq(b)], vj = v[vi];
  const T sign = (qj > bf[1]) ? T(-1) : T(1);
  J[C.ns * p] = sign;
  const T dq = qj - clip(qj, bf[0], bf[1]);
  drift[p] = sign * (C.kp() * dq + C.kd() * vj);
}

// scale skew(vec) (row-major), the plain version's `_skew_mat`.
template <typename T>
__device__ __forceinline__ void skew_scaled(const T* vec, T scale, T* sk) {
  sk[0] = T(0);              sk[1] = -scale * vec[2];   sk[2] = scale * vec[1];
  sk[3] = scale * vec[2];    sk[4] = T(0);              sk[5] = -scale * vec[0];
  sk[6] = -scale * vec[1];   sk[7] = scale * vec[0];    sk[8] = T(0);
}

// a += sk b
template <typename T>
__device__ __forceinline__ void add_mv3(const T* sk, const T* b, T* a) {
  T t[3];
  mv3(sk, b, t);
  for (int i = 0; i < 3; ++i) a[i] = a[i] + t[i];
}

// The four rows and drifts of active contact k (tangent c0, tangent c1,
// normal, torsion) at positions p[0..3], each row over the contact's
// support dofs; with kTerrain about the unit ground normal nrm[3k..3k+3)
// the active-set pass stored, else about +z. With kExt a contact of radius
// r > 0 is a sphere: its linear columns, velocity and bias acceleration
// are those of the surface point -r n (r skew(n) times the angular ones
// added).
template <bool kTerrain, bool kExt, typename T>
__device__ void contact_rows(const Model<T>& M, const CModel<T>& C, int k, const int* p,
                             const T (*RW)[9], const T (*PW)[3], const T (*VEL)[6],
                             const T (*ACC)[6], const T* depth, const T* nrm, T* J, T* drift) {
  const T kp = C.kp(), kd = C.kd();
  const int parent = C.cparent(k);
  const int* sd = C.si + C.csup(k);
  const int ns = C.csup_n(k);
  const T* fp = C.cfpos(k);
  const T* rw = RW[parent];
  T pc[3], tmp[3];
  contact_pos(C, k, RW, PW, pc);
  T n[3] = {T(0), T(0), T(1)};
  if constexpr (kTerrain)
    for (int i = 0; i < 3; ++i) n[i] = nrm[3 * k + i];
  T c0[3], c1[3];
  normal_basis(n, c0, c1);
  bool sphere = false;
  T sk[9];
  if constexpr (kExt) {
    const T r = C.cradius(k);
    sphere = r > T(0);
    if (sphere) skew_scaled(n, r, sk);
  }
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
      if constexpr (kExt)
        if (sphere) add_mv3(sk, ang, lin);
      const int d = vi + m;
      int s = 0;  // d's place in the support list
      while (s < ns - 1 && sd[s] != d) ++s;
      J[C.ns * p[0] + s] = dot3(c0, lin);
      J[C.ns * p[1] + s] = dot3(c1, lin);
      J[C.ns * p[2] + s] = dot3(n, lin);
      J[C.ns * p[3] + s] = dot3(n, ang);
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
  if constexpr (kExt) {
    if (sphere) {
      add_mv3(sk, vw_ang, vw_lin);
      add_mv3(sk, aw_ang, aw_lin);
    }
  }
  T g_lin[3], g_ang[3];
  for (int i = 0; i < 3; ++i) {
    g_lin[i] = aw_lin[i] + kp * depth[k] * n[i] + kd * vw_lin[i];
    g_ang[i] = aw_ang[i] + kd * vw_ang[i];
  }
  drift[p[0]] = dot3(c0, g_lin);
  drift[p[1]] = dot3(c1, g_lin);
  drift[p[2]] = dot3(n, g_lin);
  drift[p[3]] = dot3(n, g_ang);
}

// The world-aligned (angular, linear) Jacobian columns of dof m of joint j
// (rotation rj) at a point `lever` from the joint's origin
// (`_frame_jacobian_cols`, `_point_jacobian_cols`).
template <typename T>
__device__ __forceinline__ void dof_columns(const Model<T>& M, int j, int m, const T* rj,
                                            const T* lever, T* ang, T* lin) {
  const int t = M.type(j);
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
}

// The row and drift of loop closure k at position p (`distance_rows_components`):
// the two frames' point Jacobians over the union of their chains' dofs
// projected on the unit direction between them (chain a added, chain b
// taken off), and the Baumgarte drift from the frames' bias kinematics and
// the loop's length dref[k].
template <typename T>
__device__ void distance_row(const Model<T>& M, const CModel<T>& C, int k, int p,
                             const T (*RW)[9], const T (*PW)[3], const T (*VEL)[6],
                             const T (*ACC)[6], const T* dref, T* J, T* drift) {
  const int* di = C.dinfo(k);
  const int* sd = C.si + di[3];
  const int ns = di[2];
  T pf[2][3], vl[2][3], al[2][3];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int parent = di[e];
    const T* fp = C.dfpos(k) + 3 * e;
    const T* rw = RW[parent];
    const T* w_l = VEL[parent];
    const T* v_l = VEL[parent] + 3;
    const T* a_a = ACC[parent];
    const T* a_l = ACC[parent] + 3;
    T tmp[3], t2[3], vw_ang[3];
    mv3(rw, fp, tmp);
    for (int i = 0; i < 3; ++i) pf[e][i] = tmp[i] + PW[parent][i];
    cross3(w_l, fp, tmp);
    for (int i = 0; i < 3; ++i) t2[i] = v_l[i] + tmp[i];
    mv3(rw, t2, vl[e]);
    mv3(rw, w_l, vw_ang);
    cross3(fp, a_a, tmp);
    for (int i = 0; i < 3; ++i) t2[i] = a_l[i] - tmp[i];
    mv3(rw, t2, al[e]);
    cross3(vw_ang, vl[e], tmp);
    for (int i = 0; i < 3; ++i) al[e][i] = al[e][i] + tmp[i];
  }
  T dp[3], dir[3];
  for (int i = 0; i < 3; ++i) dp[i] = pf[0][i] - pf[1][i];
  const T dist = sqrt(tmax(dot3(dp, dp), T(1e-24)));
  const T inv = T(1) / dist;
  for (int i = 0; i < 3; ++i) dir[i] = dp[i] * inv;
  T* jr = J + C.ns * p;
  for (int s = 0; s < ns; ++s) jr[s] = T(0);
#pragma unroll 1
  for (int e = 0; e < 2; ++e) {
#pragma unroll 1
    for (int j = di[e]; j >= 0; j = M.parent(j)) {
      const T* rj = RW[j];
      T lever[3];
      for (int i = 0; i < 3; ++i) lever[i] = pf[e][i] - PW[j][i];
      const int vi = M.iv(j);
      const int ndof = (M.type(j) == FREE) ? 6 : 1;
      for (int m = 0; m < ndof; ++m) {
        T ang[3], lin[3];
        dof_columns(M, j, m, rj, lever, ang, lin);
        const int d = vi + m;
        int s = 0;  // d's place in the support list
        while (s < ns - 1 && sd[s] != d) ++s;
        const T val = dot3(dir, lin);
        jr[s] = (e == 0) ? jr[s] + val : jr[s] - val;
      }
    }
  }
  T dv[3], da[3];
  for (int i = 0; i < 3; ++i) { dv[i] = vl[0][i] - vl[1][i]; da[i] = al[0][i] - al[1][i]; }
  const T dv_proj = dot3(dv, dir);
  T g = dot3(dir, da);
  g = g + (dot3(dv, dv) - dv_proj * dv_proj) / dist;
  drift[p] = g + C.kp() * (dist - dref[k]) + C.kd() * dv_proj;
}

// The three rows and drifts of rolling constraint k at positions p..p+2
// (the rolling rows of `constraint_system_components`): the contact point's
// velocity, r skew(u) times the frame's angular columns added to its linear
// ones, u = +z for a sphere and for a wheel the unit vector from its centre
// towards the ground in the wheel's plane; each row over the frame's chain.
// The Baumgarte drift holds the frame's height at rref[k] (a wheel's its
// contact point's).
template <typename T>
__device__ void rolling_rows(const Model<T>& M, const CModel<T>& C, int k, int p,
                             const T (*RW)[9], const T (*PW)[3], const T (*VEL)[6],
                             const T (*ACC)[6], const T* rref, T* J, T* drift) {
  const int* ri = C.rinfo(k);
  const int parent = ri[0], ns = ri[1];
  const int* sd = C.si + ri[2];
  const T* rf = C.rfl(k);
  const T* fp = rf;
  const T radius = rf[3];
  const T* rw = RW[parent];
  const T* w_l = VEL[parent];
  const T* v_l = VEL[parent] + 3;
  const T* a_a = ACC[parent];
  const T* a_l = ACC[parent] + 3;
  T pc[3], tmp[3], t2[3], w_w[3], v_w[3], a_ang[3], a_lin[3];
  mv3(rw, fp, tmp);
  for (int i = 0; i < 3; ++i) pc[i] = tmp[i] + PW[parent][i];
  mv3(rw, w_l, w_w);
  cross3(w_l, fp, tmp);
  for (int i = 0; i < 3; ++i) t2[i] = v_l[i] + tmp[i];
  mv3(rw, t2, v_w);
  mv3(rw, a_a, a_ang);
  cross3(fp, a_a, tmp);
  for (int i = 0; i < 3; ++i) t2[i] = a_l[i] - tmp[i];
  mv3(rw, t2, a_lin);
  cross3(w_w, v_w, tmp);
  for (int i = 0; i < 3; ++i) a_lin[i] = a_lin[i] + tmp[i];
  const T up[3] = {T(0), T(0), T(1)};
  T sk[9], delta, extra[3] = {T(0), T(0), T(0)};
  if (ri[3] == 0) {  // a sphere
    skew_scaled(up, radius, sk);
    delta = pc[2] - rref[k];
  } else {  // a wheel
    T axis_w[3], x[3], y[3], daxis[3], dx[3], z[3], dy[3], sk_dy[9];
    mv3(rw, rf + 4, axis_w);
    cross3(axis_w, up, tmp);
    cross3(tmp, axis_w, x);
    const T x_norm = tmax(sqrt(tmax(dot3(x, x), T(0))), T(1e-9));
    const T inv = T(1) / x_norm;
    for (int i = 0; i < 3; ++i) y[i] = x[i] * inv;
    skew_scaled(y, radius, sk);
    delta = pc[2] - rref[k] + radius * (up[2] - y[2]);
    cross3(w_w, axis_w, daxis);
    cross3(daxis, up, tmp);
    cross3(tmp, axis_w, dx);
    cross3(axis_w, up, tmp);
    cross3(tmp, daxis, t2);
    for (int i = 0; i < 3; ++i) dx[i] = dx[i] + t2[i];
    for (int i = 0; i < 3; ++i) z[i] = dx[i] * inv;
    const T yz = dot3(y, z);
    for (int i = 0; i < 3; ++i) dy[i] = z[i] - y[i] * yz;
    skew_scaled(dy, radius, sk_dy);
    mv3(sk_dy, w_w, extra);
  }
  T vel_pt[3], ska[3];
  mv3(sk, w_w, tmp);
  for (int i = 0; i < 3; ++i) vel_pt[i] = v_w[i] + tmp[i];
  mv3(sk, a_ang, ska);
  const T kp = C.kp(), kd = C.kd();
  for (int i = 0; i < 3; ++i)
    drift[p + i] = a_lin[i] + ska[i] + extra[i] + kp * delta * up[i] + kd * vel_pt[i];
#pragma unroll 1
  for (int j = parent; j >= 0; j = M.parent(j)) {
    const T* rj = RW[j];
    T lever[3];
    for (int i = 0; i < 3; ++i) lever[i] = pc[i] - PW[j][i];
    const int vi = M.iv(j);
    const int ndof = (M.type(j) == FREE) ? 6 : 1;
    for (int m = 0; m < ndof; ++m) {
      T ang[3], lin[3];
      dof_columns(M, j, m, rj, lever, ang, lin);
      add_mv3(sk, ang, lin);
      const int d = vi + m;
      int s = 0;  // d's place in the support list
      while (s < ns - 1 && sd[s] != d) ++s;
      for (int i = 0; i < 3; ++i) J[C.ns * (p + i) + s] = lin[i];
    }
  }
}

// tc plus the penalty torques of the core's bounds on dof i (`u_c`).
template <typename T>
__device__ __forceinline__ T penalty_torque(const Model<T>& M, int i, const T* q, const T* v,
                                            T tc) {
#pragma unroll 1
  for (int b = 0; b < M.nb; ++b) {
    if (M.bound(b)[0] != i) continue;
    const T* bf = M.boundf(b);  // lo hi kp kd
    const T qb = q[M.bound(b)[1]];
    const T over = tmax(qb - bf[1], T(0));
    const T under = tmax(bf[0] - qb, T(0));
    const bool active = (over > T(0)) || (under > T(0));
    tc = tc + (bf[2] * (under - over) - (active ? bf[3] * v[i] : T(0)));
  }
  return tc;
}

// Sum of j[m] * a[sd[m]] over a row's support dofs sd[0..ns) (ascending; j
// the row over them), in the plain version's order with its exact zeros
// left out.
template <typename T>
__device__ __forceinline__ T support_dot(const int* sd, int ns, const T* j, const T* a) {
  T s = j[0] * a[sd[0]];
#pragma unroll 4
  for (int m = 1; m < ns; ++m) s = s + j[m] * a[sd[m]];
  return s;
}

// The boxed/cone Gauss-Seidel sweeps (`_pgs_sweep_components`) over the
// active rows, x in place: positions [0, nda) the loop closures and the
// rolling rows (kExt; a plain Gauss-Seidel update), then nba bounds, nca
// normals, nca torsion rows, nca tangent pairs. Lane l keeps the
// multipliers x and the residual y = b - A x of rows l, l + CM_LANES, ...:
// those below CM_SLOTS * CM_LANES in registers, the others in x and b
// themselves (b turns into y). A row's update takes its x and y from that
// lane (shuffles); every lane computes the new multiplier, the lane of the
// row keeps it, and every lane takes the change times A's column off the y
// of its rows. No lane reads another's rows from memory: the lanes share
// nothing but shuffles until x is written back at the end. The instance
// without kOver takes at most CM_SLOTS * CM_LANES rows, all in registers.
template <bool kExt, bool kOver, typename T>
__device__ void pgs_sweeps(const Lanes& L, const CModel<T>& C, int na, int nda, int nba, int nca,
                           const T* __restrict__ A, T* __restrict__ b, T* __restrict__ x) {
  const T friction = C.friction(), torsion = C.torsion();
  const int o = kExt ? nda : 0;  // the bounds' first position
  const int p_tor = o + nba + nca, p_tan = o + nba + 2 * nca;
  constexpr int R = CM_SLOTS * CM_LANES;  // the rows in registers
  // Entry (j, i) of A for this lane's row j = lane + CM_LANES m: at ro[m] + i
  // when j <= i, else at (upper_at(na, i, i) - i) + j.
  T xr[CM_SLOTS], y[CM_SLOTS];
  int ro[CM_SLOTS];
#pragma unroll
  for (int m = 0; m < CM_SLOTS; ++m) {
    const int j = L.lane + CM_LANES * m;
    xr[m] = (j < na) ? x[j] : T(0);
    y[m] = T(0);
    ro[m] = upper_at(na, j, j) - j;
  }
#pragma unroll 1
  for (int k = 0; k < na; ++k) {
    const T xk = x[k];
    const int dk = upper_at(na, k, k) - k;
#pragma unroll
    for (int m = 0; m < CM_SLOTS; ++m) {
      const int j = L.lane + CM_LANES * m;
      if (j < na) y[m] = y[m] + A[j <= k ? ro[m] + k : dk + j] * xk;
    }
  }
#pragma unroll
  for (int m = 0; m < CM_SLOTS; ++m) {
    const int j = L.lane + CM_LANES * m;
    y[m] = (j < na) ? b[j] - y[m] : T(0);
  }
  if constexpr (kOver) {  // the rows past the registers: y into b, in the same order
#pragma unroll 1
    for (int j = R + L.lane; j < na; j += CM_LANES) {
      const int rj = upper_at(na, j, j) - j;
      T s = T(0);
#pragma unroll 1
      for (int k = 0; k < na; ++k) s = s + A[j <= k ? rj + k : upper_at(na, k, k) - k + j] * x[k];
      b[j] = b[j] - s;
    }
  }
  L.sync();  // x is read before any lane writes it back
  // row i's entry of v (in registers) or of over (past them), from the lane
  // that keeps it
  auto fetch = [&](const T(&v)[CM_SLOTS], const T* over, int i) {
    T mine = v[0];
#pragma unroll
    for (int m = 1; m < CM_SLOTS; ++m) mine = select_if(i / CM_LANES == m, v[m], mine);
    if constexpr (kOver) {
      if (i >= R) {
        const int j = i - i % CM_LANES + L.lane;  // this lane's row of i's group
        mine = (j < na) ? over[j] : T(0);
      }
    }
    return __shfl_sync(L.mask, mine, i % CM_LANES, CM_LANES);
  };
  // x[i] = xn, from xi: the lane of row i keeps it; y -= A[:, i] (xn - xi)
  auto set = [&](int i, T xi, T xn) {
    const T dx = xn - xi;
    const int di = upper_at(na, i, i) - i;
#pragma unroll
    for (int m = 0; m < CM_SLOTS; ++m) {
      const int j = L.lane + CM_LANES * m;
      if (j == i) xr[m] = xn;
      if (j < na) y[m] = y[m] - A[j <= i ? ro[m] + i : di + j] * dx;
    }
    if constexpr (kOver) {
#pragma unroll 1
      for (int j = R + L.lane; j < na; j += CM_LANES) {
        if (j == i) x[j] = xn;
        b[j] = b[j] - A[j <= i ? upper_at(na, j, j) - j + i : di + j] * dx;
      }
    }
  };
#pragma unroll 1
  for (int it = 0; it < C.iter_max; ++it) {
    const T w = C.relax(it);
    if constexpr (kExt) {  // the loop closures and rolling rows: unbounded, unrelaxed
#pragma unroll 1
      for (int i = 0; i < o; ++i) {
        const T xi = fetch(xr, x, i), yi = fetch(y, b, i), aii = A[upper_at(na, i, i)];
        set(i, xi, xi + yi / aii);
      }
    }
    // bounds, then the contact normals
#pragma unroll 1
    for (int i = o; i < p_tor; ++i) {
      const T xi = fetch(xr, x, i), yi = fetch(y, b, i), aii = A[upper_at(na, i, i)];
      set(i, xi, tmax(xi + w * yi / aii, T(0)));
    }
    // level 1: torsional friction |lam_rz| <= torsion * lam_z
#pragma unroll 1
    for (int m = 0; m < nca; ++m) {
      const int i = p_tor + m, iz = o + nba + m;
      const T xi = fetch(xr, x, i);
      T xn = T(0);
      if (torsion > T(0)) {
        const T yi = fetch(y, b, i), thr = torsion * fetch(xr, x, iz), aii = A[upper_at(na, i, i)];
        xn = clip(xi + w * yi / aii, -thr, thr);
      }
      set(i, xi, xn);
    }
    // level 2: tangential friction cone ||lam_xy|| <= mu lam_z
#pragma unroll 1
    for (int m = 0; m < nca; ++m) {
      const int i0 = p_tan + 2 * m, i1 = i0 + 1, iz = o + nba + m;
      const T x0_old = fetch(xr, x, i0), x1_old = fetch(xr, x, i1);
      T x0 = T(0), x1 = T(0);
      if (friction > T(0)) {
        const T thr = friction * fetch(xr, x, iz);
        const T a_max = tmax(A[upper_at(na, i0, i0)], A[upper_at(na, i1, i1)]);
        const T y0 = fetch(y, b, i0), y1 = fetch(y, b, i1);
        x0 = x0_old + w * y0 / a_max;
        x1 = x1_old + w * y1 / a_max;
        const T norm2 = x0 * x0 + x1 * x1;
        const T scale = (norm2 > thr * thr) ? thr / sqrt(tmax(norm2, T(1e-30))) : T(1);
        x0 = x0 * scale;
        x1 = x1 * scale;
      }
      set(i0, x0_old, x0);
      set(i1, x1_old, x1);
    }
  }
#pragma unroll
  for (int m = 0; m < CM_SLOTS; ++m) {
    const int j = L.lane + CM_LANES * m;
    if (j < na) x[j] = xr[m];
  }
  L.sync();
}

// One constrained forward-dynamics evaluation
// (`constrained_accel_full_components`) by the group: qdd into w.qdd from
// the stage inputs w.qs, w.vs and the motor torques w.tc (written by lane 0
// before the call), the multipliers and the new active sets into solver
// state `s_out` from the carried ones in `s_in`; they may be the same
// (stage-chained warm start). Depths into w.depth. With kTerrain the unit
// ground normals ride in w.b from the active sets to the rows: b is written
// only after the rows (n >= 4 nc of it, 3 nc needed), so the slice keeps
// its size on terrain. With kExt the loop rows come first in the sweep
// order, the spring contacts' wrenches (w.FX, from the active-set pass) go
// into the RNEA, and the penalty bounds into the torques.
template <bool kTerrain, bool kExt, typename T>
__device__ __noinline__ void constrained_accel(const Model<T>& M_in, const CModel<T>& C_in,
                                               int s_in, int s_out) {
  const Lanes L;
  const Model<T> M = M_in;
  const CModel<T> C = C_in;
  Work<T> w = env_work<kExt>(M, C);
  const SolverState<T> in = w.state(s_in), out = w.state(s_out);
  const int nv = M.nv, n = C.n, nb = C.nb, nc = C.nc, G = CM_LANES, lane = L.lane;
  const T* q = w.qs;
  const T* v = w.vs;
  L.sync();  // the stage inputs are written; the last outputs are read
  CM_PROFILE_START(t_prof);
  // Kinematics, depth after depth of the tree, a joint per lane
  const int nlev = w.cnt[3];
#pragma unroll 1
  for (int d = 0; d < nlev; ++d) {
#pragma unroll 1
    for (int t = w.lstart[d] + lane; t < w.lstart[d + 1]; t += G) forward_joint(M, w.jorder[t], q, v, w);
    L.sync();
  }
  CM_PROFILE_PHASE(L, 0, t_prof);
  // Active sets and depths, one bound or contact per lane; with kExt the
  // spring contacts' wrenches on their joints
  const int nd = kExt ? C.nd() : 0, ncs = kExt ? M.nc : 0, nr = kExt ? C.nr() : 0;
  const int nu = nd + 3 * nr;  // the unbounded rows: loops, then rolling
#pragma unroll 1
  for (int t = lane; t < nb + nc + ncs; t += G) {
    if constexpr (kExt) {
      if (t >= nb + nc) {
        const int k = t - nb - nc, parent = M.cparent(k);
        T fw[3], fj[3], nj[3], depth;
        contact_eval_at<kTerrain>(M, k, w.RW[parent], w.PW[parent], w.VEL[parent], fw, fj, nj,
                                  &depth, static_cast<T*>(nullptr));
        for (int i = 0; i < 3; ++i) { w.FX[k][i] = nj[i]; w.FX[k][3 + i] = fj[i]; }
        continue;
      }
    }
    if (t < nb) {
      out.bact[t] = bound_active(C, t, q, in.bact[t] != 0);
    } else {
      const int k = t - nb;
      T pc[3], n[3];
      T depth = contact_point<kTerrain>(M, C, k, w.RW, w.PW, pc, n);
      if constexpr (kExt) {  // a sphere: the depth of its surface
        const T r = C.cradius(k);
        if (r > T(0)) depth = depth - r;
      }
      w.depth[k] = depth;
      if constexpr (kTerrain)
        for (int i = 0; i < 3; ++i) w.b[3 * k + i] = n[i];
      out.cact[k] = (depth < T(0)) || (in.cact[k] && depth <= C.eps());
    }
  }
  L.sync();
  // The active rows in sweep order: positions of loop closures and rolling
  // rows (kExt), bounds, normals, torsion, tangent pairs; their rows,
  // support dofs, and each row's position (-1)
  if (L.leader()) {
    for (int r = 0; r < n; ++r) w.pos[r] = -1;
    int p = 0;
    auto add = [&](int r, int soff, int scnt) {
      w.rows[p] = r; w.soff[p] = soff; w.scnt[p] = scnt; w.pos[r] = p; ++p;
    };
    if constexpr (kExt) {
      for (int k = 0; k < nd; ++k) add(nb + 4 * nc + k, C.dsup(k), C.dsup_n(k));
      for (int k = 0; k < nr; ++k)
        for (int i = 0; i < 3; ++i)
          add(nb + 4 * nc + nd + 3 * k + i, C.rinfo(k)[2], C.rinfo(k)[1]);
    }
    for (int b = 0; b < nb; ++b)
      if (out.bact[b]) add(b, C.bsup(b), 1);
    const int nba = p - nu;
    int nca = 0;
    for (int k = 0; k < nc; ++k)
      if (out.cact[k]) w.clist[nca++] = k;
    for (int m = 0; m < nca; ++m) {  // normals
      const int k = w.clist[m];
      add(nb + 4 * k + 2, C.csup(k), C.csup_n(k));
    }
    for (int m = 0; m < nca; ++m) {  // torsion
      const int k = w.clist[m];
      add(nb + 4 * k + 3, C.csup(k), C.csup_n(k));
    }
    for (int m = 0; m < nca; ++m) {  // tangent pairs
      const int k = w.clist[m];
      add(nb + 4 * k, C.csup(k), C.csup_n(k));
      add(nb + 4 * k + 1, C.csup(k), C.csup_n(k));
    }
    w.cnt[0] = p;
    w.cnt[1] = nba;
    w.cnt[2] = nca;
  }
  L.sync();
  const int na = w.cnt[0], nba = w.cnt[1], nca = w.cnt[2];
  CM_PROFILE_PHASE(L, 1, t_prof);
  // The active rows, a loop, rolling constraint, bound or contact per
  // lane; the mass matrix and the nonlinear effects, depth after depth from
  // the leaves, a joint per lane
#pragma unroll 1
  for (int t = lane; t < nd + nr + nba + nca; t += G) {
    if constexpr (kExt) {
      if (t < nd) {
        distance_row(M, C, t, t, w.RW, w.PW, w.VEL, w.ACC, w.dref, w.J, w.drift);
        continue;
      }
      if (t < nd + nr) {
        rolling_rows(M, C, t - nd, nd + 3 * (t - nd), w.RW, w.PW, w.VEL, w.ACC, w.rref, w.J,
                     w.drift);
        continue;
      }
    }
    const int u = t + 2 * nr;  // the row's position
    if (u < nu + nba) {
      bound_row(C, w.rows[u], u, q, v, w.J, w.drift);
    } else {
      const int m = u - nu - nba, o = nu + nba;
      const int p[4] = {o + 2 * nca + 2 * m, o + 2 * nca + 2 * m + 1, o + m, o + nca + m};
      contact_rows<kTerrain, kExt>(M, C, w.clist[m], p, w.RW, w.PW, w.VEL, w.ACC, w.depth, w.b,
                                   w.J, w.drift);
    }
  }
  L.sync();  // IC, F and FT take the place of RW, PW, VEL and ACC
#pragma unroll 1
  for (int k = lane; k < nv * (nv + 1) / 2; k += G) w.Mm[k] = T(0);
#pragma unroll 1
  for (int k = lane; k < 36 * M.nj; k += G) w.IC[k / 36][k % 36] = M.ia0(k / 36)[k % 36];
  L.sync();
#pragma unroll 1
  for (int d = nlev - 1; d >= 0; --d) {
#pragma unroll 1
    for (int t = w.lstart[d] + lane; t < w.lstart[d + 1]; t += G)
      backward_joint<kExt>(M, w.jorder[t], w);
    L.sync();
    if (d == 0) break;
#pragma unroll 1
    for (int t = w.lstart[d - 1] + lane; t < w.lstart[d]; t += G) gather_children(M, w.jorder[t], w);
    L.sync();
  }
  CM_PROFILE_PHASE(L, 2, t_prof);
  // tau - nle, then the LDL^T factor of M by rows (`_ldl_factor_components`)
#pragma unroll 1
  for (int i = lane; i < nv; i += G) {
    const T damp = M.damping(i);
    T tc = (damp != T(0)) ? w.tc[i] - damp * v[i] : w.tc[i];
    if constexpr (kExt) tc = penalty_torque(M, i, q, v, tc);
    w.tau[i] = tc - w.tau[i];
  }
  T* Mm = w.Mm;
#pragma unroll 1
  for (int j = 0; j < nv; ++j) {
    const T* lj = Mm + lower_at(j, 0);
    T dj = lj[j];
    for (int k = 0; k < j; ++k) dj = dj - lj[k] * lj[k] * w.d[k];
    const T inv = T(1) / dj;
#pragma unroll 1
    for (int i = j + 1 + lane; i < nv; i += G) {
      T* li = Mm + lower_at(i, 0);
      T s = li[j];
      for (int k = 0; k < j; ++k) s = s - li[k] * lj[k] * w.d[k];
      li[j] = s * inv;
    }
    if (L.leader()) {  // read from the next column on
      w.d[j] = dj;
      w.dinv[j] = inv;
    }
    L.sync();
  }
  CM_PROFILE_PHASE(L, 3, t_prof);
  // tau_res = M^-1 (tau - nle) and the rows of M^-1 J^T, a right-hand side per lane
#pragma unroll 1
  for (int t = lane; t <= na; t += G) {
    if (t == 0) {
      ldl_solve(nv, Mm, w.dinv, w.tau, 0);
    } else {
      const int p = t - 1;
      T* y = w.W + nv * p;
      const T* jr = w.J + C.ns * p;
      const int* sd = C.si + w.soff[p];
      for (int dd = 0; dd < nv; ++dd) y[dd] = T(0);
      for (int m = 0; m < w.scnt[p]; ++m) y[sd[m]] = jr[m];
      ldl_solve(nv, Mm, w.dinv, y, sd[0]);
    }
  }
  L.sync();
  CM_PROFILE_PHASE(L, 4, t_prof);
  // A's upper triangle over the active rows (the smaller row index's J
  // against the other's M^-1 J^T, as the plain version fills its upper
  // triangle), b, warm start
#pragma unroll 1
  for (int p = lane; p < na; p += G) {
    const int* sp = C.si + w.soff[p];
    const T* jp = w.J + C.ns * p;
#pragma unroll 1
    for (int c = p; c < na; ++c) {
      T s;
      if (w.rows[p] <= w.rows[c]) {
        s = support_dot(sp, w.scnt[p], jp, w.W + nv * c);
      } else {
        s = support_dot(C.si + w.soff[c], w.scnt[c], w.J + C.ns * c, w.W + nv * p);
      }
      if (c == p) s = s + tmax(s * C.reg(), C.min_reg());
      w.A[upper_at(na, p, c)] = s;
    }
    w.b[p] = -w.drift[p] - support_dot(sp, w.scnt[p], jp, w.tau);
    w.x[p] = in.lam[w.rows[p]];
  }
  L.sync();
  CM_PROFILE_PHASE(L, 5, t_prof);
  if (na > CM_SLOTS * CM_LANES)  // rows past the registers' (the Atlas's)
    pgs_sweeps<kExt, true>(L, C, na, nu, nba, nca, w.A, w.b, w.x);
  else
    pgs_sweeps<kExt, false>(L, C, na, nu, nba, nca, w.A, w.b, w.x);
  CM_PROFILE_PHASE(L, 6, t_prof);
  // qdd = tau_res + sum over the active rows, in row order, of lam_r (M^-1 J^T)_r
#pragma unroll 1
  for (int k = lane; k < nv; k += G) {
    T s = T(0);
    bool first = true;
    for (int r = 0; r < n; ++r) {
      const int p = w.pos[r];
      if (p < 0) continue;
      const T t = w.x[p] * w.W[nv * p + k];
      s = first ? t : s + t;
      first = false;
    }
    w.qdd[k] = w.tau[k] + s;
  }
#pragma unroll 1
  for (int r = lane; r < n; r += G) out.lam[r] = (w.pos[r] >= 0) ? w.x[w.pos[r]] : T(0);
  L.sync();
  CM_PROFILE_PHASE(L, 7, t_prof);
}

// One stage: lane 0 publishes the motor torques of the stage state (w.qs,
// w.vs, which it wrote), the group solves into w.qdd.
template <bool kTerrain, bool kExt, typename T>
__device__ __forceinline__ void stage(const Lanes& L, const Model<T>& M, const CModel<T>& C,
                                      const Work<T>& w, int s_in, int s_out) {
  if (L.leader()) tau_c(M, w.vs, w.cmd, w.tc);
  constrained_accel<kTerrain, kExt>(M, C, s_in, s_out);
}

// A solve at the env's state (w.q, w.v): the accelerations into w.qdd.
template <bool kTerrain, bool kExt, typename T>
__device__ __forceinline__ void solve(const Lanes& L, const Model<T>& M, const CModel<T>& C,
                                      const Work<T>& w, int s_in, int s_out) {
  if (L.leader()) {
    for (int i = 0; i < M.nq; ++i) w.qs[i] = w.q[i];
    for (int i = 0; i < M.nv; ++i) w.vs[i] = w.v[i];
  }
  stage<kTerrain, kExt>(L, M, C, w, s_in, s_out);
}

// One substep (`_ConstrainedCore.substep`) of the env's state (w.q, w.v, lane
// 0's) in place, the solver state `s` too when stages are chained (else the
// stage outputs go to ST_TMP). Lane 0 writes each stage's state into the
// solve's inputs (w.qs, w.vs) and reads its accelerations from w.qdd; the
// RK4 sums run in the plain version's order ((k1 + 2 k2) + 2 k3) + k4. The
// retraction's increment takes w.tc, free between two solves.
template <bool kTerrain, bool kExt, typename T>
__device__ __noinline__ void substep_cm(const Model<T>& M_in, const CModel<T>& C_in, int s,
                                        int integrator) {
  const Lanes L;
  const Model<T> M = M_in;
  const CModel<T> C = C_in;
  const Work<T> w = env_work<kExt>(M, C);
  const int out = C.stage_warm ? s : ST_TMP;
  const int nv = M.nv;
  const bool lead = L.leader();
  const T dt = M.dt(), hdt = M.half_dt();
  T* q = w.q;
  T* v = w.v;
  T* dq = w.tc;
  T* vt = w.vs;
  const T* acc = w.qdd;
  solve<kTerrain, kExt>(L, M, C, w, s, out);
  if (integrator == EULER) {
    if (lead) {
      for (int k = 0; k < nv; ++k) dq[k] = dt * v[k];
      integrate(M, q, dq, w.qs);
      for (int k = 0; k < M.nq; ++k) q[k] = w.qs[k];
      for (int k = 0; k < nv; ++k) v[k] = v[k] + dt * acc[k];
    }
    return;
  }
  if (lead) {
    for (int k = 0; k < nv; ++k) {
      w.ksum[k] = acc[k];
      dq[k] = hdt * v[k];
    }
    integrate(M, q, dq, w.qs);
    for (int k = 0; k < nv; ++k) vt[k] = v[k] + hdt * acc[k];
  }
  stage<kTerrain, kExt>(L, M, C, w, s, out);
  if (lead) {
    for (int k = 0; k < nv; ++k) {
      w.ksum[k] = w.ksum[k] + T(2) * acc[k];
      w.vsum[k] = v[k] + T(2) * vt[k];
      dq[k] = hdt * vt[k];
    }
    integrate(M, q, dq, w.qs);
    for (int k = 0; k < nv; ++k) vt[k] = v[k] + hdt * acc[k];
  }
  stage<kTerrain, kExt>(L, M, C, w, s, out);
  if (lead) {
    for (int k = 0; k < nv; ++k) {
      w.ksum[k] = w.ksum[k] + T(2) * acc[k];
      w.vsum[k] = w.vsum[k] + T(2) * vt[k];
      dq[k] = dt * vt[k];
    }
    integrate(M, q, dq, w.qs);
    for (int k = 0; k < nv; ++k) vt[k] = v[k] + dt * acc[k];
  }
  stage<kTerrain, kExt>(L, M, C, w, s, out);
  if (lead) {
    const T dt6 = M.dt6();
    for (int k = 0; k < nv; ++k) dq[k] = dt6 * (w.vsum[k] + vt[k]);
    integrate(M, q, dq, w.qs);
    for (int k = 0; k < M.nq; ++k) q[k] = w.qs[k];
    for (int k = 0; k < nv; ++k) v[k] = v[k] + dt6 * (w.ksum[k] + acc[k]);
  }
}

// End-of-period outputs `[a | f_world | w_local | depth | imu | lam | cact |
// bact]` (`_ConstrainedCore.final_outputs`) of the env's state, rows of the
// (n_extra, B) array, written by lane 0; the solve's state outputs go to
// solver state `s_out`. The contact block holds the constraint contacts'
// forces from the multipliers, then with kExt the spring contacts' (one of
// them is empty).
template <bool kTerrain, bool kExt, typename T>
__device__ __noinline__ void final_outputs_cm(const Model<T>& M_in, const CModel<T>& C_in, int s,
                                              int s_out, T* eo, int B, int b) {
  const Lanes L;
  const Model<T> M = M_in;
  const CModel<T> C = C_in;
  const Work<T> w = env_work<kExt>(M, C);
  const SolverState<T> out = w.state(s_out);
  solve<kTerrain, kExt>(L, M, C, w, s, s_out);
  if (!L.leader()) return;
  const T* q = w.q;
  const T* v = w.v;
  const T* a = w.qdd;
  // The tree arrays are free again once the solve is done
  joint_x(M, q, w.R, w.P);
  world_placements(M, w.R, w.P, w.RW, w.PW);
  fk_vel_acc(M, w.R, w.P, v, a, w.VEL, w.ACC);
  const T (*RW)[9] = w.RW;
  const T (*VEL)[6] = w.VEL;
  const T (*ACC)[6] = w.ACC;
  const int nv = M.nv, nc = C.nc, nco = nc + (kExt ? M.nc : 0);
  for (int k = 0; k < nv; ++k) eo[(size_t)k * B + b] = a[k];
  const int o_fw = nv, o_wl = nv + 3 * nco, o_d = nv + 9 * nco, o_imu = nv + 10 * nco;
#pragma unroll 1
  for (int k = 0; k < nc; ++k) {
    T n[3] = {T(0), T(0), T(1)};
    if constexpr (kTerrain) {  // the final solve's normal, from the same placements
      T pc[3];
      contact_point<kTerrain>(M, C, k, w.RW, w.PW, pc, n);
    }
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
    eo[(size_t)(o_d + k) * B + b] = w.depth[k];
  }
  if constexpr (kExt) {
#pragma unroll 1
    for (int k = 0; k < M.nc; ++k) {
      const int parent = M.cparent(k);
      T fw[3], fj[3], nj[3], depth, wl[6];
      contact_eval_at<kTerrain>(M, k, RW[parent], w.PW[parent], VEL[parent], fw, fj, nj, &depth,
                                wl);
      for (int i = 0; i < 3; ++i) eo[(size_t)(o_fw + 3 * (nc + k) + i) * B + b] = fw[i];
      for (int i = 0; i < 6; ++i) eo[(size_t)(o_wl + 6 * (nc + k) + i) * B + b] = wl[i];
      eo[(size_t)(o_d + nc + k) * B + b] = depth;
    }
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
// row `off` of an (n, B) array (lane 0).
template <typename T>
__device__ void load_solver_state(const CModel<T>& C, const T* src, int off, int B, int b,
                                  const SolverState<T>& s) {
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

template <typename T>
__device__ void copy_solver_state(const CModel<T>& C, const SolverState<T>& src,
                                  const SolverState<T>& dst) {
  for (int r = 0; r < C.n; ++r) dst.lam[r] = src.lam[r];
  for (int k = 0; k < C.nc; ++k) dst.cact[k] = src.cact[k];
  for (int k = 0; k < C.nb; ++k) dst.bact[k] = src.bact[k];
}

// --------------------------------------------------------------------------
// The two entry kernels: CM_LANES lanes per env, blockDim.x / CM_LANES envs
// per block (the launcher's pick, at most CM_ENVS), one CmLayout slice of
// dynamic shared memory per env.
// --------------------------------------------------------------------------

// One controller period: cc = [cmd (n_cmd) | dref (nd, kExt) | lam | cact |
// bact | rref (nr, kExt)]. An instance on flat ground and one on the model's terrain
// (kTerrain), each with the bound and contact rows or the extended body
// (kExt).
template <typename T, bool kTerrain, bool kExt>
__global__ void __launch_bounds__(CM_LANES * CM_ENVS, CmPeriodBlocks<T, kExt>::value)
cdyn_period_cm_kernel(const int* ci, const T* cf, const int* si, const T* sf,
                      const T* __restrict__ q_g, const T* __restrict__ v_g,
                      const T* __restrict__ cc_g, T* __restrict__ qo, T* __restrict__ vo,
                      T* __restrict__ eo, int B, int n_cmd, int n_substeps, int integrator) {
  const Lanes L;
  const int slot = threadIdx.x / CM_LANES;
  const int b = blockIdx.x * (blockDim.x / CM_LANES) + slot;
  if (b >= B) return;  // the whole group
  const Model<T> M(ci, cf);
  const CModel<T> C(si, sf, n_cmd, 0, 0);
  const Work<T> w = env_work<kExt>(M, C);
  if (L.leader()) {
    const int nd = kExt ? C.nd() : 0, nr = kExt ? C.nr() : 0;
    tree_levels(M, w.jorder, w.lstart, w.cnt + 3);
    for (int i = 0; i < M.nq; ++i) w.q[i] = q_g[(size_t)i * B + b];
    for (int i = 0; i < M.nv; ++i) w.v[i] = v_g[(size_t)i * B + b];
    for (int i = 0; i < n_cmd; ++i) w.cmd[i] = cc_g[(size_t)i * B + b];
    for (int k = 0; k < nd; ++k) w.dref[k] = cc_g[(size_t)(n_cmd + k) * B + b];
    load_solver_state(C, cc_g, n_cmd + nd, B, b, w.state(ST_CARRY));
    const int o_r = n_cmd + nd + C.n + C.nc + C.nb;
    for (int k = 0; k < nr; ++k) w.rref[k] = cc_g[(size_t)(o_r + k) * B + b];
  }
#pragma unroll 1
  for (int k = 0; k < n_substeps; ++k) substep_cm<kTerrain, kExt>(M, C, ST_CARRY, integrator);
  if (L.leader()) {
    for (int i = 0; i < M.nq; ++i) qo[(size_t)i * B + b] = w.q[i];
    for (int i = 0; i < M.nv; ++i) vo[(size_t)i * B + b] = w.v[i];
  }
  final_outputs_cm<kTerrain, kExt>(M, C, ST_CARRY, ST_TMP, eo, B, b);
}

// One env step: action = [env action | dref (nd, kExt) | rref (nr, kExt)],
// carry = [block carry (n_block) | lam | cact | bact]; extras = period
// extras + [cc_last | carry'].
template <typename T, bool kTerrain, bool kExt>
__global__ void cdyn_rollout_cm_kernel(const int* ci, const T* cf, const int* si, const T* sf,
                                       const int* pi, const T* pf, int controller,
                                       const T* __restrict__ q_g, const T* __restrict__ v_g,
                                       const T* __restrict__ a_g, const T* __restrict__ c_g,
                                       T* __restrict__ qo, T* __restrict__ vo, T* __restrict__ eo,
                                       int B, int n_action, int n_block, int n_cmd, int n_ticks,
                                       int n_substeps, int integrator) {
  const Lanes L;
  const int slot = threadIdx.x / CM_LANES;
  const int b = blockIdx.x * (blockDim.x / CM_LANES) + slot;
  if (b >= B) return;  // the whole group
  const Model<T> M(ci, cf);
  const CModel<T> C(si, sf, n_cmd, n_action, n_block);
  const Work<T> w = env_work<kExt>(M, C);
  // the carry's solver channels and the command row's (ST_TMP for the stages)
  const SolverState<T> carry = w.state(ST_CARRY), cc = w.state(ST_CC);
  const bool lead = L.leader();
  const int nd = kExt ? C.nd() : 0, nr = kExt ? C.nr() : 0;
  if (lead) {
    tree_levels(M, w.jorder, w.lstart, w.cnt + 3);
    for (int k = 0; k < nd; ++k) w.dref[k] = a_g[(size_t)(n_action - nd - nr + k) * B + b];
    for (int k = 0; k < nr; ++k) w.rref[k] = a_g[(size_t)(n_action - nr + k) * B + b];
    for (int i = 0; i < M.nq; ++i) w.q[i] = q_g[(size_t)i * B + b];
    for (int i = 0; i < M.nv; ++i) w.v[i] = v_g[(size_t)i * B + b];
    for (int i = 0; i < n_action; ++i) w.act[i] = a_g[(size_t)i * B + b];
    for (int i = 0; i < n_block; ++i) w.blk[i] = c_g[(size_t)i * B + b];
    load_solver_state(C, c_g, n_block, B, b, carry);
    for (int i = 0; i < n_cmd; ++i) w.cmd[i] = T(0);
  }
#pragma unroll 1
  for (int t = 0; t < n_ticks; ++t) {
    if (lead) {
      if (controller == CONTROLLER_PD) {  // the block carry updated in place
        pd_controller(pi, pf, w.q, w.v, w.blk, w.act, w.cmd, w.blk);
      } else {  // zero-order hold of the action, block carry unchanged
        for (int i = 0; i < n_cmd; ++i) w.cmd[i] = w.act[i];
      }
      copy_solver_state(C, carry, cc);
    }
#pragma unroll 1
    for (int k = 0; k < n_substeps; ++k) substep_cm<kTerrain, kExt>(M, C, ST_CC, integrator);
    if (t < n_ticks - 1)  // end-of-tick refresh of the carried warm start
      solve<kTerrain, kExt>(L, M, C, w, ST_CC, ST_CARRY);
  }
  if (lead) {
    for (int i = 0; i < M.nq; ++i) qo[(size_t)i * B + b] = w.q[i];
    for (int i = 0; i < M.nv; ++i) vo[(size_t)i * B + b] = w.v[i];
  }
  final_outputs_cm<kTerrain, kExt>(M, C, ST_CC, ST_TMP, eo, B, b);
  if (!lead) return;
  const int nco = C.nc + (kExt ? M.nc : 0);
  const int n_std = M.nv + 10 * nco + 6 * M.ni + C.n + C.nc + C.nb;
  const int n_ccrow = n_cmd + nd + C.n + C.nc + C.nb + nr;
  for (int i = 0; i < n_cmd; ++i) eo[(size_t)(n_std + i) * B + b] = w.cmd[i];
  for (int k = 0; k < nd; ++k) eo[(size_t)(n_std + n_cmd + k) * B + b] = w.dref[k];
  store_solver_state(C, cc, eo, n_std + n_cmd + nd, B, b);
  for (int k = 0; k < nr; ++k) eo[(size_t)(n_std + n_ccrow - nr + k) * B + b] = w.rref[k];
  for (int i = 0; i < n_block; ++i) eo[(size_t)(n_std + n_ccrow + i) * B + b] = w.blk[i];
  store_solver_state(C, carry, eo, n_std + n_ccrow + n_block, B, b);
}

}  // namespace cdyn
