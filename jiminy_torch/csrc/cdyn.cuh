// The packed-constant layout shared by the cdyn kernels.
//
// The layout must match `pack_model` in jiminy_torch/ops/cdyn.py (int buffer
// `ci`, float buffer `cf`) and `PDComponents.pack` / `ZOHPassThrough.pack`
// (controller buffers `pi`, `pf`). No kernel keeps an array sized at compile
// time: the spring kernels (spring.cuh) and the constrained kernels
// (pgs.cuh) keep their working set in a shared-memory slice sized from the
// model at launch, and take any model whose slice the card grants.
#pragma once

namespace cdyn {

// Int buffer: header [nj nq nv nc ni nm nb has_contacts blend ...], then
// per joint (parent, type, idx_q, idx_v), per contact (parent, has_radius),
// per IMU (parent), per motor (v index, mode, friction), per bound (vi, qi).
constexpr int CI_HEADER = 16, CI_JOINT = 4, CI_CONTACT = 2, CI_IMU = 1, CI_MOTOR = 3, CI_BOUND = 2;
// Float buffer: header [g(3) stiffness damping friction v_trans eps_trans dt
// dt/2 dt/6 ...], then per joint rot(9) pos(3) axis(3) axis products(6)
// body inertia(36), armature(nv), damping(nv), per contact fpos(3) frot(9)
// radius, per IMU frot(9) fpos(3), per motor (red el vl denom fvp fvn fdp fdn
// fds), per bound (lo hi kp kd).
constexpr int CF_HEADER = 16, CF_JOINT = 57, CF_CONTACT = 13, CF_IMU = 12, CF_MOTOR = 9, CF_BOUND = 4;

enum JointType { FREE = 0, REVOLUTE = 1, REVOLUTE_UNBOUNDED = 2, PRISMATIC = 3, SPHERICAL = 4 };
enum MotorMode { MOTOR_NONE = 0, MOTOR_CLIP = 1, MOTOR_ENVELOPE = 2 };
enum Controller { CONTROLLER_ZOH = 0, CONTROLLER_PD = 1 };
enum Integrator { EULER = 0, RK4 = 1 };

// PD controller buffers: pi = [nm | (q index, v index, joint side) per motor],
// pf = [dt | (kp kd smin0 smin1 smin2 smax0 smax1 smax2 eff red) per motor].
constexpr int PI_MOTOR = 3, PF_MOTOR = 10;

}  // namespace cdyn
