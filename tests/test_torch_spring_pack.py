"""The spring kernels' packed section (`cdyn.spring_section`, read by
csrc/spring.cuh's `SpTree`) against the model it was packed from, on the
CPU: the axis class of each joint against its axis, the joints listed depth
after depth with their parents' slots, and each parent's children chained
in descending joint index (the order in which the serial inward pass adds
their inertias). Checked on the ANYmal (all twelve joints turn about +-x)
and on a model with general, prismatic and negative coordinate axes and two
motors on one dof; and each joint's penalty bound."""

import numpy as np
import pytest
import torch

from jiminy_torch.envs import make
from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import build_model
from jiminy_torch.ops import cdyn


def _general_model():
    def body(m):
        return dict(mass=m, com=np.array([0.01, -0.02, 0.03]), inertia=np.diag([0.02, 0.03, 0.04]))

    joints = [
        dict(name="root", type=0, parent=-1, **body(5.0)),
        dict(name="a", type=1, parent=0, axis=np.array([0.6, 0.8, 0.0]), **body(1.0)),
        dict(name="b", type=3, parent=1, axis=np.array([0.0, 0.0, -1.0]), **body(0.8)),
        dict(name="c", type=1, parent=0, axis=np.array([0.0, 1.0, 0.0]), **body(1.2)),
        dict(name="d", type=1, parent=3, axis=np.array([0.0, 0.0, 1.0]), **body(0.7)),
        dict(name="e", type=1, parent=2, axis=np.array([1.0, 1.0, 1.0]) / np.sqrt(3), **body(0.5)),
        dict(name="f", type=3, parent=4, axis=np.array([0.6, 0.0, 0.8]), **body(0.4)),
        dict(name="g", type=1, parent=3, axis=np.array([-1.0, 0.0, 0.0]), **body(0.3)),
    ]
    model = build_model("general", joints, [])
    bounds = {7: (-0.1, 0.1, 100.0, 1.0, 8), 10: (-1.0, 1.0, 50.0, 0.5, 11)}  # joints b and e
    cd = cdyn.ComponentDynamics(model, (0.0, 0.0, -9.81), bound_gains=bounds)
    ones = (1.0,) * 3
    tau_c = cdyn.MotorTransmission(nv=model.nv, v_indices=(6, 7, 7), mode=(0, 0, 0),
                                   friction=(False,) * 3, red=ones, el=ones, vl=ones, denom=ones,
                                   fvp=ones, fvn=ones, fdp=ones, fdn=ones, fds=ones)
    return cd, tau_c


def _anymal():
    eng = make("anymal-pid", device="cpu", dtype=torch.float64).env.engine
    return eng._cdyn, eng._tau_c


MODELS = {"anymal": _anymal, "general": _general_model}


def _section(cd, tau_c):
    """The packed section, read back from the int buffer as the kernel reads it."""
    packed = cdyn.pack_model(cd, tau_c, 1e-3, (), "cpu", torch.float64)
    ci = packed.ci.tolist()
    t = ci[ci[cdyn.CI_SPRING]:]
    nj, nlev = cd.c.nj, t[0]
    o = 3 + nlev
    per = [t[o + k * nj:o + (k + 1) * nj] for k in range(7)]
    assert len(t) == o + 7 * nj  # the section ends the buffer
    return dict(nlev=nlev, distinct=t[1], lstart=t[2:o], joint=per[0], slot=per[1],
                pslot=per[2], fchild=per[3], nsib=per[4], axis=per[5], bound=per[6])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_axis_classes_match_the_model_axes(name):
    cd, tau_c = MODELS[name]()
    sec = _section(cd, tau_c)
    model = cd.model
    for j in range(model.njoints):
        axis = np.asarray(model.joint_axes[j], np.float64)
        cls = sec["axis"][j]
        assert cls == cdyn.axis_class(model.joint_types[j], axis)
        if jt.JointType(model.joint_types[j]) == jt.JointType.FREE:
            assert cls == -1
        elif cls == cdyn.AX_GENERAL:
            assert np.count_nonzero(axis) >= 2
        else:
            assert axis[cls] != 0.0 and np.count_nonzero(axis) == 1
    if name == "anymal":  # six "1 0 0" and six "-1 0 0" joint axes in the URDF
        assert sec["axis"] == [-1] + [cdyn.AX_X] * 12
    else:
        assert sec["axis"] == [-1, cdyn.AX_GENERAL, cdyn.AX_Z, cdyn.AX_Y, cdyn.AX_Z,
                               cdyn.AX_GENERAL, cdyn.AX_GENERAL, cdyn.AX_X]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_spring_section_lists_joints_by_depth(name):
    cd, tau_c = MODELS[name]()
    sec = _section(cd, tau_c)
    parents = cd.model.parents
    nj = len(parents)
    depth = [0] * nj
    for j in range(nj):
        depth[j] = 0 if parents[j] < 0 else depth[parents[j]] + 1
    assert sec["nlev"] == max(depth) + 1
    assert sec["lstart"][0] == 0 and sec["lstart"][-1] == nj
    for d in range(sec["nlev"]):  # the slots of depth d, in joint order
        level = sec["joint"][sec["lstart"][d]:sec["lstart"][d + 1]]
        assert level == sorted(j for j in range(nj) if depth[j] == d)
    assert [sec["slot"][j] for j in sec["joint"]] == list(range(nj))
    for s, j in enumerate(sec["joint"]):
        p = parents[j]
        assert sec["pslot"][s] == (sec["slot"][p] if p >= 0 else -1)
        chain, c = [], sec["fchild"][s]
        while c >= 0:
            chain.append(sec["joint"][c])
            c = sec["nsib"][c]
        assert chain == sorted((i for i in range(nj) if parents[i] == j), reverse=True)
    assert sec["distinct"] == (1 if name == "anymal" else 0)  # two motors on dof 7
    if name == "anymal":  # the root, then the four legs' three joints, a lane each
        assert sec["lstart"] == [0, 1, 5, 9, 13]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_each_joint_points_at_the_bound_on_its_dof(name):
    cd, tau_c = MODELS[name]()
    sec = _section(cd, tau_c)
    model = cd.model
    packed = cdyn.pack_model(cd, tau_c, 1e-3, (), "cpu", torch.float64)
    ci, nb = packed.ci.tolist(), packed.counts["nb"]
    # the bounds (v index, q index) end the buffer before the section
    bound_dofs = ci[ci[cdyn.CI_SPRING] - cdyn.CI_BOUND * nb:ci[cdyn.CI_SPRING]:cdyn.CI_BOUND]
    for j in range(model.njoints):
        b = sec["bound"][j]
        if jt.JointType(model.joint_types[j]) == jt.JointType.FREE or model.idx_v[j] not in cd.bound_gains:
            assert b == -1
        else:
            assert bound_dofs[b] == model.idx_v[j]
    expected = 12 if name == "anymal" else 2
    assert sum(b >= 0 for b in sec["bound"]) == expected
