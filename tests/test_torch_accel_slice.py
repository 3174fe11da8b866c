"""The shared-memory slice of `cdyn_accel` (csrc/spring.cuh, `SpAccelLayout`
and `sp_env_stride`), derived here from its layout on the CPU: what one
evaluation keeps in it, how large it is for the ANYmal and for a model with
general, prismatic and negative axes, that the groups of a warp start in
distinct banks, and that it is smaller than the period and rollout kernels'
slices (`SpLayout`), so more envs fit an SM; with SPHERICAL joints (the
flexible ANYmal) a block of `SPH_REC` values each at its end. The card test
`test_accel_slice_size_matches_its_layout` holds the library to these sizes.
"""

import pytest
import torch

from jiminy_torch.envs import make

JREC = 43  # elements of a joint's record (spring.cuh, `JREC`)
SPH_REC = 27  # a SPHERICAL joint's block: U (18), its D's factor (6), u (3)
ROOT = 12  # the FREE root's placement (R 9, P 3)
SP_LANES, SP_ENVS, SPA_ENVS = 4, 8, 16  # the default build's geometry
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 228 * 1024, 1024  # H100: an SM's shared memory


def accel_slice_fields(nj, nq, nv, nc, nsph=0):
    """Element offsets of one env's accel slice: the joint records, the
    root's placement, q, v, the contact wrenches and the SPHERICAL joints'
    blocks, in that order."""
    sizes = {"rec": JREC * nj, "root": ROOT, "q": nq, "v": nv, "fext": 6 * nc,
             "sph": SPH_REC * nsph}
    out, off = {}, 0
    for name, n in sizes.items():
        out[name] = (off, n)
        off += n
    return out, off


def env_stride(elems, elt, lanes=SP_LANES):
    """Bytes between two envs' slices (`sp_env_stride`): 16-byte rows, padded
    so that the groups of a warp start `lanes` element widths apart in the
    32 four-byte banks."""
    words = (elems * elt + 15) // 16 * 4
    want = (lanes * elt // 4) % 32
    return 4 * (words + (want - words % 32 + 32) % 32)


def accel_slice_bytes(nj, nq, nv, nc, elt, lanes=SP_LANES, nsph=0):
    return env_stride(accel_slice_fields(nj, nq, nv, nc, nsph)[1], elt, lanes)


def spring_slice_bytes(nj, nq, nv, nc, n_cmd, n_act, n_carry, elt):
    """The period and rollout kernels' slice (`SpLayout`): the accel slice's
    fields plus the stage state, the integrator sums, the torques and the
    command, action and carry."""
    elems = JREC * nj + ROOT + 2 * nq + 6 * nv + 6 * nc + n_cmd + n_carry + n_act
    return env_stride(elems, elt)


def envs_per_sm(per_env, envs_per_block):
    blocks = SMEM_PER_SM // (per_env * envs_per_block + SMEM_PER_BLOCK_RESERVED)
    return blocks * envs_per_block


def _counts(cd):
    return cd.pack(None, 0.0, (), "cpu", torch.float64).counts


@pytest.fixture(scope="module")
def anymal_counts():
    return _counts(make("anymal-pid", device="cpu", dtype=torch.float64).engine._cdyn)


def test_accel_slice_holds_one_evaluation(anymal_counts):
    c = anymal_counts
    fields, elems = accel_slice_fields(c["nj"], c["nq"], c["nv"], c["nc"])
    assert list(fields) == ["rec", "root", "q", "v", "fext", "sph"]
    ends = [off + n for off, n in fields.values()]
    assert [off for off, _ in fields.values()] == [0] + ends[:-1]  # packed, no overlap
    assert elems == 43 * 13 + 12 + 19 + 18 + 24


@pytest.mark.parametrize("elt, want", [(4, 2576), (8, 5152)])
def test_accel_slice_size_on_the_anymal(anymal_counts, elt, want):
    c = anymal_counts
    per_env = accel_slice_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt)
    assert per_env == want
    period = spring_slice_bytes(c["nj"], c["nq"], c["nv"], c["nc"], 12, 0, 0, elt)
    rollout = spring_slice_bytes(c["nj"], c["nq"], c["nv"], c["nc"], 12, 12, 36, elt)
    assert (period, rollout) == ((3088, 3216) if elt == 4 else (6048, 6432))
    assert per_env < period < rollout
    if elt == 4:  # float32: 80 envs an SM against the period's 72 and the rollout's 64
        assert (envs_per_sm(per_env, SPA_ENVS), envs_per_sm(period, SP_ENVS),
                envs_per_sm(rollout, SP_ENVS)) == (80, 72, 64)


@pytest.mark.parametrize("elt", [4, 8])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_accel_slices_of_a_warp_start_in_distinct_banks(anymal_counts, elt, lanes):
    c = anymal_counts
    elems = accel_slice_fields(c["nj"], c["nq"], c["nv"], c["nc"])[1]
    stride = accel_slice_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt, lanes)
    assert stride % elt == 0 and elems * elt <= stride < elems * elt + 16 + 128
    starts = {(g * stride // 4) % 32 for g in range(32 // lanes)}
    assert len(starts) == min(32 // lanes, max(32 // (lanes * elt // 4), 1))


def test_accel_slice_follows_the_model():
    """A model without contacts and with general, prismatic and negative
    axes: the slice is sized from its own counts."""
    from test_torch_spring_pack import _general_model

    cd, _ = _general_model()
    c = _counts(cd)
    assert c["nc"] == 0
    fields, elems = accel_slice_fields(c["nj"], c["nq"], c["nv"], c["nc"])
    assert fields["fext"][1] == 0 and elems == 43 * c["nj"] + 12 + c["nq"] + c["nv"]
    assert accel_slice_bytes(c["nj"], c["nq"], c["nv"], c["nc"], 4) == env_stride(elems, 4)


@pytest.mark.parametrize("elt, want, per_sm", [(4, 3856, 48), (8, 7584, 16)])
def test_accel_slice_of_the_flexible_anymal(elt, want, per_sm):
    """Four SPHERICAL joints: their blocks at the slice's end, the records
    and the other fields as the rigid instance lays them out."""
    c = _counts(make("anymal-pid", flexible=True, device="cpu", dtype=torch.float64).engine._cdyn)
    assert (c["nj"], c["nq"], c["nv"], c["nc"], c["nsph"]) == (17, 35, 30, 4, 4)
    fields, elems = accel_slice_fields(c["nj"], c["nq"], c["nv"], c["nc"], c["nsph"])
    assert fields["sph"] == (43 * 17 + 12 + 35 + 30 + 24, 27 * 4)
    per_env = accel_slice_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt, nsph=c["nsph"])
    assert per_env == want and envs_per_sm(per_env, SPA_ENVS) == per_sm
