"""The port's batched circulant pricer (repro_torch.core.engines.torch_circulant,
``circulant_search(engine="torch")``) against the JAX package's jitted
pricer (``engine="jax"``) and its numpy pricer, on the CPU.

Hop counts are exact integers, so the priced values and the hillclimb's
trajectory (offsets, history, iterations) must be equal.
"""
import numpy as np
import pytest
import torch

from repro.core import search as ref_search
from repro.core.engines import jax_circulant
from repro_torch.core import search
from repro_torch.core.engines import torch_circulant

TRAJECTORY = ("mpl", "diameter", "iterations", "accepted", "history", "offsets")


@pytest.mark.parametrize("n,k,seed,n_iter", [(64, 4, 0, 120), (96, 6, 3, 80),
                                             (50, 5, 1, 40), (6, 4, 0, 10)])
def test_torch_pricer_follows_reference_trajectories(n, k, seed, n_iter):
    """(6, 4) has one candidate, already in the offsets: every batch is empty."""
    got = search.circulant_search(n, k, seed=seed, n_iter=n_iter, engine="torch",
                                  device="cpu")
    for engine in ("jax", "numpy"):
        want = ref_search.circulant_search(n, k, seed=seed, n_iter=n_iter, engine=engine)
        assert got.graph.edges == want.graph.edges, engine
        for f in TRAJECTORY:
            assert getattr(got, f) == getattr(want, f), (engine, f)
    numpy = search.circulant_search(n, k, seed=seed, n_iter=n_iter, engine="numpy")
    assert all(getattr(numpy, f) == getattr(got, f) for f in TRAJECTORY)


def test_profile_batch_values_equal_reference():
    """More than one chunk, a ragged last chunk, shift lists of several
    lengths (cyclic padding), a disconnected candidate and an antipodal
    offset."""
    rng = np.random.default_rng(0)
    n = 90
    lists = [[1] + sorted(rng.choice(range(2, 45), size=int(rng.integers(1, 4)),
                                     replace=False).tolist()) for _ in range(70)]
    lists[3] = [3, 6]  # gcd 3: disconnected
    lists[40] = [1, 20, 45]
    got = list(torch_circulant.profile_batch(n, lists, "cpu"))
    want = list(jax_circulant.profile_batch(n, lists, "jax", ref_search._circulant_profile))
    assert got == want
    assert got[3] == (float("inf"), float("inf"))
    assert got == [search._circulant_profile(n, offs) for offs in lists]
    assert list(torch_circulant.profile_batch(n, [], "cpu")) == []


def test_profile_batch_prices_lazily(monkeypatch):
    calls = []
    sweep = torch_circulant._sweep
    monkeypatch.setattr(torch_circulant, "_sweep",
                        lambda shifts, n: calls.append(len(shifts)) or sweep(shifts, n))
    vals = torch_circulant.profile_batch(64, [[1, 5, 9]] * 70, "cpu")
    assert calls == []
    next(vals)
    assert calls == [torch_circulant.CHUNK]
    assert len(list(vals)) == 69 and len(calls) == 3


def test_engine_resolution_and_validation(monkeypatch):
    assert search._resolve_circulant("auto", 4095) == "numpy"
    assert search._resolve_circulant("auto", 4096) == "torch"
    for bad in ("jax", "bogus", None):
        with pytest.raises(ValueError, match="engine"):
            search.circulant_search(64, 4, n_iter=10, engine=bad, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the host pricer never resolves the device; the torch pricer does
    assert search.circulant_search(64, 4, n_iter=10).offsets is not None
    with pytest.raises(RuntimeError, match="CUDA"):
        search.circulant_search(64, 4, n_iter=10, engine="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        search.circulant_search(4096, 4, n_iter=10)


def test_large_search_hillclimb_prices_on_its_device():
    """At n >= 4096 with no pinned offsets, ``large_search`` runs the
    hillclimb with the torch pricer on its device: the reference's
    trajectory.  The torch pricer runs on one intra-op thread here: its
    many small CPU ops take about 2 s on one, and minutes when the
    suite's parallel workers leave each op's thread pool waiting on
    cores."""
    kw = dict(seed=1, budget=20, polish=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = search.large_search(4096, 4, device="cpu", **kw)
    finally:
        torch.set_num_threads(threads)
    want = ref_search.large_search(4096, 4, **kw)
    assert got.graph.edges == want.graph.edges
    for f in TRAJECTORY:
        assert getattr(got, f) == getattr(want, f), f
