"""The port's certified table and independent certification path
(``repro_torch.core.certify``, ``repro_torch.core.known_optimal``) against
the JAX package's, on the CPU.

The table is a byte-equal copy; every entry's graph must rebuild to the
reference's edges (spec entries through the port's constructor registry,
where the reference goes through ``topologies``), and ``certify`` /
``verify_entry`` must return the reference's values on the paper's
<= 36-node entries and the circulants with n <= 512.
"""
import copy
import pathlib

import pytest

from repro.core import certify as ref_certify
from repro.core import known_optimal as ref_known
from repro_torch.core import certify, graphs, known_optimal

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENTRIES = certify.table_entries()
BY_NAME = {e["name"]: e for e in ENTRIES}
SMALL = [e["name"] for e in ENTRIES if e["family"] in ("optimal", "baseline")]
CIRC_FAST = [e["name"] for e in ENTRIES if e["family"] == "circulant" and e["n"] <= 512]


def test_table_is_a_byte_equal_copy():
    assert pathlib.Path(certify.TABLE_PATH).read_bytes() == \
        (ROOT / "src/repro/data/certified.json").read_bytes()
    assert certify.load_table() == ref_certify.load_table()
    assert len(ENTRIES) == 38 and len(SMALL) == 17 and len(CIRC_FAST) == 6


def test_known_optimal_equals_reference():
    assert known_optimal.KNOWN_EDGE_LISTS == ref_known.KNOWN_EDGE_LISTS
    assert known_optimal.KNOWN_CIRCULANT_OFFSETS == ref_known.KNOWN_CIRCULANT_OFFSETS
    for alias in ("OPTIMAL_16_4", "OPTIMAL_32_4", "OPTIMAL_32_3"):
        assert getattr(known_optimal, alias) == getattr(ref_known, alias)


@pytest.mark.parametrize("name", [e["name"] for e in ENTRIES])
def test_every_entry_rebuilds_to_the_reference_edges(name):
    e = BY_NAME[name]
    got, want = certify.build_entry_graph(e), ref_certify.build_entry_graph(e)
    assert (got.n, got.edges, got.name) == (want.n, want.edges, want.name)
    assert certify.edges_hash(got) == ref_certify.edges_hash(want) == e["edges_hash"]


@pytest.mark.parametrize("name", SMALL + CIRC_FAST)
def test_certify_and_verify_equal_reference(name):
    e = BY_NAME[name]
    g = certify.build_entry_graph(e)
    bis = e.get("bisection") is not None
    got = certify.certify(g, bisection=bis)
    want = ref_certify.certify(ref_certify.build_entry_graph(e), bisection=bis)
    assert got.as_dict() == want.as_dict()
    assert certify.verify_entry(e) == ref_certify.verify_entry(e) == []


def test_certify_flags_disconnection_as_the_reference():
    edges = [(0, 1), (2, 3)]
    got = certify.certify(graphs.from_edges(4, edges, "split"), bisection=True)
    want = ref_certify.certify(ref_certify.from_edges(4, edges, "split"), bisection=True)
    assert got.as_dict() == want.as_dict()
    assert not got.connected and got.mpl == float("inf") and got.bisection is None


@pytest.mark.parametrize("field,delta", [
    ("mpl", 0.01), ("diameter", 1), ("total_hops", 2), ("bisection", 1), ("k", 1)])
def test_corrupted_entry_is_flagged(field, delta):
    entry = copy.deepcopy(BY_NAME["(32,4)-Optimal"])
    entry[field] = entry[field] + delta
    errors = certify.verify_entry(entry, full=True)
    assert errors and errors == ref_certify.verify_entry(entry, full=True)
    assert any(field in msg and "(32,4)-Optimal" in msg for msg in errors)


def test_corrupted_build_info_breaks_the_hash():
    entry = copy.deepcopy(BY_NAME["(256,4)-Circulant"])
    entry["offsets"] = [1, 93]
    errors = certify.verify_entry(entry, full=False)
    assert errors == ref_certify.verify_entry(entry, full=False)
    assert any("edges_hash" in msg for msg in errors)
    entry = copy.deepcopy(BY_NAME["(20,4)-Dragonfly"])
    entry["spec"]["params"]["g"] = 6
    assert any("edges_hash" in msg for msg in certify.verify_entry(entry, full=False))


@pytest.mark.parametrize("spec", [
    {"family": "optimal", "params": {"n": 16, "k": 4}},
    {"family": "random_regular", "params": {"n": 16, "k": 3}, "seed": 2},
    {"family": "chvatal", "params": {"n": 32}},
    {"family": "ring", "params": {"n": 16, "max_tries": 3}},
])
def test_specs_beyond_the_registry_are_refused(spec):
    entry = {"name": "x", "n": 16, "k": 4, "edges_hash": "sha256:0", "spec": spec}
    with pytest.raises(NotImplementedError, match="item 6.7"):
        certify.build_entry_graph(entry)
    [msg] = certify.verify_entry(entry)
    assert "graph rebuild failed" in msg and "item 6.7" in msg


def test_warm_start_and_entry_lookup_equal_reference():
    for n, k in [(16, 4), (32, 3), (32, 4), (256, 6), (36, 5), (100, 4)]:
        assert certify.get_entry(n, k) == ref_certify.get_entry(n, k)
        got, want = certify.warm_start_graph(n, k), ref_certify.warm_start_graph(n, k)
        assert (got is None and want is None) or \
            (got.n, got.edges, got.name) == (want.n, want.edges, want.name)
    g = graphs.wagner(16)
    got = certify.make_entry(g, "baseline", bisection=True, fold=2,
                             spec={"family": "wagner", "params": {"n": 16}}, store_edges=True)
    want = ref_certify.make_entry(ref_certify.build_entry_graph({"n": 16, "edges": g.edges}),
                                  "baseline", name=g.name, bisection=True, fold=2,
                                  spec={"family": "wagner", "params": {"n": 16}},
                                  store_edges=True)
    assert got == want
    assert certify.verify_entry(got) == []
