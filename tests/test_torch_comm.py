"""The port's device collectives (``repro_torch.comm.torchcoll``) over gloo
ranks on the CPU against the reference's ``repro.comm.jaxcoll`` on 8 fake
host devices, on the same numpy inputs.  The reference's ``run_on_axis``
runs under ``jax.jit`` (one compile per collective instead of one per
operation), except ``int8_ring_allreduce``, which runs eagerly as
``tests/test_comm.py`` runs it: compiled as one program, XLA quantises
differently in the last bit (its outputs differ from the eager ones).

Tolerances: every collective is compared with the reference's output bit
for bit (the same float32 additions in the same order, the same
quantisation; ``flood_bcast`` only copies); the plain sums are checked as
``tests/test_comm.py`` checks them (1e-5 absolute, int8 a relative 0.05).
Two spawned groups: 8 ranks, and 1 rank for the degenerate world size."""

import numpy as np
import pytest

from repro_torch.comm import torchcoll as tc
from repro_torch.core import collectives as C
from repro_torch.core import graphs
from repro_torch.core.hamiltonian import hamiltonian_cycle

ORDER = hamiltonian_cycle(graphs.torus([2, 4]))
# each collective of the 8-rank group, in the order _collectives returns them
NAMES = ("ring", "recdbl", "int8_pad", "flood0", "flood5", "ham", "ring_pad",
         "reduce_scatter", "allgather", "zero_d_refused")


def _inputs(n: int = 8):
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(n, 16, 5)).astype(np.float32),
        "xi8": rng.normal(size=(n, 61, 3)).astype(np.float32),  # 61 rows: padded
        "xf": rng.normal(size=(n, 6)).astype(np.float32),
        "xb": rng.normal(size=(n, 16, 2)).astype(np.float32),
        "xp": rng.normal(size=(n, 13, 3)).astype(np.float32),
        "x0": rng.normal(size=(n,)).astype(np.float32),
    }


def _collectives(x, xi8, xf, xb, xp, x0, group=None):
    """Every collective of ``torchcoll`` on one rank of an 8-rank group."""
    import torch

    g = graphs.wagner(8)
    try:
        tc.ring_allreduce(x0, group)
        refused = torch.zeros(1)
    except AssertionError:  # a 1-row input cannot be cut into 8 chunks
        refused = torch.ones(1)
    return (tc.ring_allreduce(x, group),
            tc.recursive_doubling_allreduce(x, group),
            tc.int8_ring_allreduce(xi8, group),
            tc.flood_bcast(xf, group, g, root=0),
            tc.flood_bcast(xf, group, g, root=5),
            tc.ring_allreduce(xb, group, order=ORDER),
            tc.ring_allreduce(xp, group),
            tc.ring_reduce_scatter(x, group),
            tc.ring_allgather(x[:3], group),
            refused)


def _world_of_one(x, x0, group=None):
    """World size 1: every collective returns its input."""
    g = graphs.from_edges(1, [], "one")
    return (tc.ring_allreduce(x, group), tc.ring_allreduce(x0, group),
            tc.recursive_doubling_allreduce(x, group), tc.int8_ring_allreduce(x, group),
            tc.flood_bcast(x, group, g), tc.ring_reduce_scatter(x, group),
            tc.ring_allgather(x, group))


REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.comm import jaxcoll as jc
from repro.core import graphs
from repro.core.hamiltonian import hamiltonian_cycle
from repro.launch.mesh import make_test_mesh
d = dict(np.load({inp!r}))
mesh = make_test_mesh((8,), ("x",))
g = graphs.wagner(8)
order = hamiltonian_cycle(graphs.torus([2, 4]))
run = lambda f, *a: np.asarray(jax.jit(lambda *v: jc.run_on_axis(f, mesh, "x", *v))(
    *map(jnp.asarray, a)))
try:
    run(jc.ring_allreduce, d["x0"])
    refused = np.zeros((8, 1), np.float32)
except AssertionError:
    refused = np.ones((8, 1), np.float32)
out = dict(
    ring=run(jc.ring_allreduce, d["x"]),
    recdbl=run(jc.recursive_doubling_allreduce, d["x"]),
    int8_pad=np.asarray(jc.run_on_axis(jc.int8_ring_allreduce, mesh, "x", jnp.asarray(d["xi8"]))),
    flood0=run(lambda v, axis_name: jc.flood_bcast(v, axis_name, g, root=0), d["xf"]),
    flood5=run(lambda v, axis_name: jc.flood_bcast(v, axis_name, g, root=5), d["xf"]),
    ham=run(lambda v, axis_name: jc.ring_allreduce(v, axis_name, order=order), d["xb"]),
    ring_pad=run(jc.ring_allreduce, d["xp"]),
    reduce_scatter=run(jc.ring_reduce_scatter, d["x"]),
    allgather=run(lambda v, axis_name: jc.ring_allgather(v[:3], axis_name), d["x"]),
    zero_d_refused=refused,
)
one = make_test_mesh((1,), ("x",))
run1 = lambda f, a: np.asarray(jax.jit(lambda v: jc.run_on_axis(f, one, "x", v))(jnp.asarray(a)))
out["one_ring"] = run1(jc.ring_allreduce, d["x"][:1])
out["one_ring0"] = run1(jc.ring_allreduce, d["x0"][:1])
out["one_int8"] = np.asarray(jc.run_on_axis(jc.int8_ring_allreduce, one, "x",
                                            jnp.asarray(d["x"][:1])))
np.savez({out_path!r}, **out)
print("PASS", list(order))
"""


@pytest.fixture(scope="module")
def both(devices8, tmp_path_factory):
    """The reference's outputs (8 fake host devices) and the port's (8 gloo
    ranks, then 1), on the same inputs."""
    tmp = tmp_path_factory.mktemp("comm")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    out = devices8(REFERENCE.format(inp=str(tmp / "in.npz"), out_path=str(tmp / "ref.npz")))
    assert "PASS" in out and str(ORDER) in out  # the same Hamiltonian order
    ref = dict(np.load(tmp / "ref.npz"))
    port = tc.run_on_axis(_collectives, 8, d["x"], d["xi8"], d["xf"], d["xb"], d["xp"], d["x0"])
    got = {name: t.numpy() for name, t in zip(NAMES, port)}
    one = tc.run_on_axis(_world_of_one, 1, d["x"][:1], d["x0"][:1])
    got["one"] = [t.numpy() for t in one]
    return d, ref, got


@pytest.mark.parametrize("name", NAMES)
def test_torchcoll_equals_jaxcoll_bit_for_bit(both, name):
    _, ref, got = both
    assert got[name].shape == ref[name].shape and got[name].dtype == ref[name].dtype
    np.testing.assert_array_equal(got[name], ref[name])


def test_torchcoll_against_plain_sums(both):
    d, _, got = both
    for name, key in (("ring", "x"), ("recdbl", "x"), ("ring_pad", "xp"), ("ham", "xb")):
        assert np.abs(got[name] - d[key].sum(0)[None]).max() < 1e-5, name
    want = d["xi8"].sum(0)
    assert np.abs(got["int8_pad"] - want[None]).max() / np.abs(want).max() < 0.05
    for root in (0, 5):
        assert np.abs(got[f"flood{root}"] - d["xf"][root][None]).max() == 0.0
    full = d["x"].sum(0)
    for r in range(8):  # rank r owns the reduced chunk of its ring position r
        assert np.abs(got["reduce_scatter"][r] - full[2 * r:2 * r + 2]).max() < 1e-5
    assert np.array_equal(got["allgather"][0], d["x"][:, :3].reshape(24, 5))
    assert got["zero_d_refused"].tolist() == [[1.0]] * 8


def test_torchcoll_world_of_one_returns_its_input(both):
    d, ref, got = both
    x, x0 = d["x"][:1], d["x0"][:1]
    for t in got["one"][:1] + got["one"][2:]:
        np.testing.assert_array_equal(t, x)
    np.testing.assert_array_equal(got["one"][1], x0)
    for key in ("one_ring", "one_int8"):
        np.testing.assert_array_equal(ref[key], x)
    np.testing.assert_array_equal(ref["one_ring0"], x0)


def test_ring_perm_and_ring_index():
    from repro.comm import jaxcoll as jc

    for n, order in ((8, None), (8, ORDER), (5, [4, 2, 0, 1, 3])):
        for rev in (False, True):
            assert tc.ring_perm(n, order, rev) == jc.ring_perm(n, order, rev)
    inv = np.argsort(np.asarray(ORDER))
    assert [tc._my_ring_index(r, ORDER) for r in range(8)] == inv.tolist()
    assert tc._my_ring_index(3, None) == 3


def test_round_counts_match_the_schedules():
    """The simulator's round structure matches what the collectives execute
    (``tests/test_comm.py``'s round counts, through the port's copies)."""
    from repro_torch.core import metrics

    g = graphs.wagner(8)
    sched = C.bcast_flood(8, 1.0, g, root=0)
    assert len(sched.rounds) == metrics.eccentricities(g, device="cpu")[0]
    assert len(C.allreduce_ring(8, 1024.0).rounds) == 2 * (8 - 1)


def test_run_on_axis_checks_leading_dims():
    with pytest.raises(ValueError, match="leading dim"):
        tc.run_on_axis(tc.ring_allreduce, 8, np.zeros((4, 2)))



def test_a_group_refuses_a_tensor_on_the_other_kind_of_device():
    """gloo moves host memory and NCCL device memory: a tensor elsewhere is
    refused, never moved (phase 23 of ``chip_smoke.py`` checks it on the
    card with a real gloo group)."""
    import torch

    tc._check_backend("gloo", torch.device("cpu"))
    tc._check_backend("nccl", torch.device("cuda", 0))
    tc._check_backend("cpu:gloo,cuda:nccl", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="gloo group takes cpu tensors"):
        tc._check_backend("gloo", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="nccl group takes cuda tensors"):
        tc._check_backend("nccl", torch.device("cpu"))
