"""Multi-robot simulation: one merged-model engine over all robots (port of
`jiminy_tpu.engine.multi`).

The robots are merged into one forest-rooted model (`engine.merge`) stepped
by one `Engine`, the reference's one stepper over all robots
(`engine.cc:3497-3535`). With no coupling registered the merged engine takes
the component core like any robot (on the card a forest through the
kernels: the ANYmal and the acrobot side by side, two joints at depth 0).
Couplings (`register_viscoelastic_coupling_force`, `register_coupling_force`,
`register_collision_pair`, reference `engine.h:490-550`) are state forces on
the merged engine, evaluated from its one kinematics pass with action and
reaction equal and opposite; like any registered force they send it to the
generic path, which runs eagerly (no CUDA graph) while a force is
registered.

The API keeps per-robot states: `reset` and `step` take and return dicts
name -> SimState, views split out of the merged state.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from jiminy_torch.engine.config import EngineOptions
from jiminy_torch.engine.contact import add_pair_wrenches, pair_narrowphase_force
from jiminy_torch.engine.engine import Engine
from jiminy_torch.engine.merge import merge_robots
from jiminy_torch.engine.robot import Robot, _pair_geometries
from jiminy_torch.engine.state import SimState
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import frame_placement, frame_velocity_local


def _frame_world(model, kin, fidx):
    """((rot, pos), linear velocity, angular velocity) of a frame, world axes."""
    rot, pos = frame_placement(model, kin, fidx)
    vl = frame_velocity_local(model, kin, fidx)
    return (rot, pos), lie.mv(rot, vl[..., 3:6]), lie.mv(rot, vl[..., 0:3])


def _apply_world_wrench(model, kin, fext, fidx, wrench):
    """`fext` with a world-aligned wrench (ang, lin) at a frame added onto its
    parent joint (LOCAL joint coordinates)."""
    parent = model.frame_parents[fidx]
    pos_f = frame_placement(model, kin, fidx)[1]
    rot_j = kin.rot[..., parent, :, :]
    f_w = wrench[..., 3:6]
    n_w = wrench[..., 0:3] + lie.cross(pos_f - kin.pos[..., parent, :], f_w)
    rt = rot_j.transpose(-1, -2)
    fext[..., parent, 0:3] += lie.mv(rt, n_w)
    fext[..., parent, 3:6] += lie.mv(rt, f_w)
    return fext


class MultiRobotEngine:
    """Merged-model multi-robot engine: one shared stepper, every
    single-robot integrator (DOPRI included) over the merged state."""

    def __init__(self, robots: Dict[str, Robot], options: Optional[EngineOptions] = None,
                 device=None, dtype=None):
        self.names = tuple(robots)
        self.robots = dict(robots)
        self.options = options or EngineOptions()
        self.merged_robot, self.layout = merge_robots(self.robots)
        self.engine = Engine(self.merged_robot, self.options, device=device, dtype=dtype)
        self.device, self.dtype = self.engine.device, self.engine.dtype
        self.tick_period = self.engine.tick_period
        self.n_sensor_periods = self.engine.n_sensor_periods
        self.n_substeps = self.engine.n_substeps
        self.couplings: list = []  # the registered specs, for `replay_couplings`
        self._row_maps = self._build_row_maps()

    # ------------------------------------------------------------------ #
    def _build_row_maps(self) -> dict:
        """Each robot's rows, bounds, contacts, loops and rolling specs in
        the merged constraint set."""
        cset = self.engine.cset
        _, off_c, off_d, off_r = cset.row_offsets()
        r_specs = list(cset.sphere_specs) + list(cset.wheel_specs)
        maps = {}
        for name in self.names:
            sl = self.layout[name]

            def of(frame):
                return sl.frames.start <= frame < sl.frames.stop

            b_idx = [i for i, j in enumerate(cset.bound_joint_indices)
                     if sl.joints.start <= j < sl.joints.stop]
            c_idx = [i for i, f in enumerate(cset.contact_frame_indices) if of(f)]
            d_idx = [i for i, (fa, _) in enumerate(cset.distance_pairs) if of(fa)]
            r_idx = [i for i, spec in enumerate(r_specs) if of(spec[0])]
            rows = list(b_idx)
            for i in c_idx:
                rows += range(off_c + 4 * i, off_c + 4 * i + 4)
            rows += [off_d + i for i in d_idx]
            for i in r_idx:
                rows += range(off_r + 3 * i, off_r + 3 * i + 3)
            maps[name] = {k: torch.as_tensor(np.asarray(x, np.int64), device=self.device)
                          for k, x in (("rows", rows), ("bounds", b_idx), ("contacts", c_idx),
                                       ("distance", d_idx), ("rolling", r_idx))}
        return maps

    # ------------------------------------------------------------------ #
    # Couplings (reference `engine.h:490-550`)
    # ------------------------------------------------------------------ #
    def _frames(self, robot1, frame1, robot2, frame2):
        model = self.merged_robot.model
        return model.frame_index(f"{robot1}/{frame1}"), model.frame_index(f"{robot2}/{frame2}")

    def register_viscoelastic_coupling_force(self, robot1: str, frame1: str, robot2: str,
                                             frame2: str, stiffness, damping,
                                             rest_length: float = 0.0) -> None:
        """A spring-damper between two frames: the force k (d - rest) along
        the frames' offset (k d without a rest length) plus nu times their
        relative velocity, and the torque k log3(R1^T R2) plus nu times their
        relative angular velocity, on frame1, the opposite on frame2."""
        self.couplings.append(("viscoelastic", robot1, frame1, robot2, frame2, stiffness,
                               damping, rest_length))
        model = self.merged_robot.model
        f1, f2 = self._frames(robot1, frame1, robot2, frame2)
        k = torch.as_tensor(stiffness, dtype=self.dtype, device=self.device)
        nu = torch.as_tensor(damping, dtype=self.dtype, device=self.device)

        def force_fn(t, q, v, kin):
            fext = q.new_zeros(q.shape[:-1] + (model.njoints, 6))
            (r1, p1), v1, w1 = _frame_world(model, kin, f1)
            (r2, p2), v2, w2 = _frame_world(model, kin, f2)
            dp = p2 - p1
            if rest_length > 0.0:
                dist = torch.linalg.norm(dp, dim=-1, keepdim=True)
                f_lin = k * (dist - rest_length) * (dp / torch.clamp(dist, min=1e-9))
            else:
                f_lin = k * dp
            f_lin = f_lin + nu * (v2 - v1)
            ang_err = lie.mv(r1, lie.log3_mat(lie.mm(r1.transpose(-1, -2), r2)))
            f_ang = k * ang_err + nu * (w2 - w1)
            wrench1 = torch.cat([f_ang, f_lin], dim=-1)
            fext = _apply_world_wrench(model, kin, fext, f1, wrench1)
            return _apply_world_wrench(model, kin, fext, f2, -wrench1)

        self.engine.register_state_force(force_fn)

    def register_coupling_force(self, robot1: str, frame1: str, robot2: str, frame2: str,
                                force_fn: Callable) -> None:
        """A user coupling: `force_fn(t, (rot1, pos1), (w1, v1), (rot2, pos2),
        (w2, v2)) -> (..., 6)` world wrench (ang, lin) on robot1's frame, its
        reaction on robot2's."""
        self.couplings.append(("generic", robot1, frame1, robot2, frame2, force_fn))
        model = self.merged_robot.model
        f1, f2 = self._frames(robot1, frame1, robot2, frame2)

        def state_force(t, q, v, kin):
            fext = q.new_zeros(q.shape[:-1] + (model.njoints, 6))
            p1, v1, w1 = _frame_world(model, kin, f1)
            p2, v2, w2 = _frame_world(model, kin, f2)
            wrench1 = force_fn(t, p1, (w1, v1), p2, (w2, v2))
            fext = _apply_world_wrench(model, kin, fext, f1, wrench1)
            return _apply_world_wrench(model, kin, fext, f2, -wrench1)

        self.engine.register_state_force(state_force)

    def register_collision_pair(self, robot1: str, spec1: dict, robot2: str, spec2: dict) -> None:
        """Robot-to-robot contact between two collision-body specs
        (`Robot.build`'s `collision_bodies` entries, their frames named in
        their robots): every geometry of one against every geometry of the
        other, the spring-damper narrowphase
        (`contact.pair_narrowphase_force`)."""
        self.couplings.append(("collision", robot1, spec1, robot2, spec2))
        model = self.merged_robot.model

        def geoms(rname, spec):
            s = dict(spec, frame_name=f"{rname}/{spec['frame_name']}")
            return _pair_geometries(model, [s], ())[s["frame_name"]]

        pairs = tuple((g1, g2) for g1 in geoms(robot1, spec1) for g2 in geoms(robot2, spec2))
        opts = self.options.contacts

        def state_force(t, q, v, kin):
            fext = q.new_zeros(q.shape[:-1] + (model.njoints, 6))
            for ga, gb in pairs:
                c, f_b, _, body_a, body_b = pair_narrowphase_force(opts, kin, ga, kin, gb)
                fext = add_pair_wrenches(fext, c, f_b, body_a, body_b)
            return fext

        self.engine.register_state_force(state_force)

    def replay_couplings(self, specs) -> None:
        """Registers coupling specs (`self.couplings` of another instance)
        on this one."""
        register = {"viscoelastic": self.register_viscoelastic_coupling_force,
                    "generic": self.register_coupling_force,
                    "collision": self.register_collision_pair}
        for s in specs:
            register[s[0]](*s[1:])

    # ------------------------------------------------------------------ #
    # Per-robot views of the merged state
    # ------------------------------------------------------------------ #
    def split_state(self, sim: SimState) -> Dict[str, SimState]:
        out = {}
        for name in self.names:
            sl, rm = self.layout[name], self._row_maps[name]

            def take(x, key):
                return None if x is None else torch.index_select(x, -1, rm[key])

            out[name] = sim.replace(
                q=sim.q[..., sl.q],
                v=sim.v[..., sl.v],
                a=sim.a[..., sl.v],
                command=sim.command[..., sl.motors],
                u_motor=sim.u_motor[..., sl.motors],
                contact_forces=sim.contact_forces[..., sl.contacts, :],
                measurements={kind: sim.measurements[kind][..., ssl, :]
                              for kind, ssl in sl.sensors.items() if kind in sim.measurements},
                contact_active=take(sim.contact_active, "contacts"),
                bound_active=take(sim.bound_active, "bounds"),
                lam=take(sim.lam, "rows"),
                distance_ref=take(sim.distance_ref, "distance"),
                rolling_ref=take(sim.rolling_ref, "rolling"),
            )
        return out

    def merge_states(self, states: Dict[str, SimState]) -> SimState:
        first = states[self.names[0]]
        cset = self.engine.cset

        def cat(attr, dim=-1):
            return torch.cat([getattr(states[n], attr) for n in self.names], dim=dim)

        def scatter(attr, key, width, dtype):
            if first.lam is None:
                return None
            out = torch.zeros(getattr(first, attr).shape[:-1] + (width,), dtype=dtype,
                              device=self.device)
            for n in self.names:
                out[..., self._row_maps[n][key]] = getattr(states[n], attr)
            return out

        meas = {}
        for kind, _ in self.merged_robot.sensors.groups():
            parts = [states[n].measurements[kind] for n in self.names
                     if kind in states[n].measurements]
            if parts:
                meas[kind] = torch.cat(parts, dim=-2)
        return first.replace(
            q=cat("q"),
            v=cat("v"),
            a=cat("a"),
            command=cat("command"),
            u_motor=cat("u_motor"),
            contact_forces=cat("contact_forces", dim=-2),
            measurements=meas,
            contact_active=scatter("contact_active", "contacts", cset.n_contacts, torch.bool),
            bound_active=scatter("bound_active", "bounds", cset.n_bounds, torch.bool),
            lam=scatter("lam", "rows", cset.total_rows, self.dtype),
            distance_ref=scatter("distance_ref", "distance", cset.n_distance, self.dtype),
            rolling_ref=scatter("rolling_ref", "rolling", cset.n_rolling, self.dtype),
        )

    # ------------------------------------------------------------------ #
    def _cat_rows(self, rows: Dict[str, object], width_of) -> torch.Tensor:
        parts = [torch.as_tensor(rows[n], dtype=self.dtype, device=self.device) if n in rows
                 else torch.zeros(width_of(n), dtype=self.dtype, device=self.device)
                 for n in self.names]
        batch = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
        return torch.cat([p.expand(batch + p.shape[-1:]) for p in parts], dim=-1)

    def reset(self, q_inits: Dict[str, object], v_inits=None) -> Dict[str, SimState]:
        """Per-robot initial states from each robot's q (and v, at rest where
        not given), each (n,) or (B, n)."""
        q0 = self._cat_rows(q_inits, lambda n: self.robots[n].model.nq)
        v0 = None
        if v_inits is not None:
            v0 = self._cat_rows(v_inits, lambda n: self.robots[n].model.nv)
        return self.split_state(self.engine.reset(q0, v0))

    def step(self, states: Dict[str, SimState], commands=None) -> Dict[str, SimState]:
        """All robots one controller period through the merged engine (its
        component core while no coupling is registered)."""
        command = None
        if commands is not None:
            command = self._cat_rows({n: commands.get(n, states[n].command) for n in self.names},
                                     None)
        return self.split_state(self.engine.step(self.merge_states(states), command))


class MultiSimulator:
    """The reference's multi-robot `Simulator` facade: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MultiSimulator (simulator.py) is not ported yet (ROADMAP.md queue 1 item 14); "
            "MultiRobotEngine steps several robots")
