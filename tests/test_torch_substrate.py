"""The port's host substrate against the reference: generators, datasets,
formats, partitioning, oracles, MapReduce operands and the graph converter.

Same seeds in, equal arrays out; every count is compared as an exact
integer."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import partition as ref_partition  # noqa: E402
from repro.core import triangle_mapreduce as ref_mr  # noqa: E402
from repro.core import triangle_ref as ref_oracle  # noqa: E402
from repro.graphs import datasets as ref_datasets  # noqa: E402
from repro.graphs import formats as ref_formats  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.core import triangle_mapreduce as mr  # noqa: E402
from repro_torch.core import triangle_ref as oracle  # noqa: E402
from repro_torch.graphs import datasets, formats  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402


def _same_graph(g, ref_g):
    assert g.n_nodes == ref_g.n_nodes
    assert g.edges.dtype == ref_g.edges.dtype
    np.testing.assert_array_equal(g.edges, ref_g.edges)


@pytest.mark.parametrize("name,args", [
    ("gnp", (60, 0.3, 0)),
    ("gnp", (150, 0.7, 5)),
    ("powerlaw", (120, 4, 1)),
    ("road_grid", (9, 13, 2)),
    ("fixed_arcs", (80, 300, 3)),     # sparse regime: rejection sampling
    ("fixed_arcs", (50, 1000, 4)),    # dense regime: sampling the index space
])
def test_generators_equal_reference(name, args):
    _same_graph(getattr(gen, name)(*args), getattr(ref_gen, name)(*args))


def test_gnp_edge_blocks_equal_reference():
    got = list(gen.gnp_edge_blocks(90, 0.4, seed=7))
    want = list(ref_gen.gnp_edge_blocks(90, 0.4, seed=7))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ref_datasets.TABLE1))
def test_table1_datasets_equal_reference(name):
    spec, ref_spec = datasets.TABLE1[name], ref_datasets.TABLE1[name]
    assert (spec.n_vertices, spec.n_arcs, spec.density) == \
        (ref_spec.n_vertices, ref_spec.n_arcs, ref_spec.density)
    _same_graph(datasets.load(name, scale=0.03, seed=1),
                ref_datasets.load(name, scale=0.03, seed=1))


def test_formats_equal_reference():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 70, size=(400, 2))  # self loops and duplicates included
    g, ref_g = formats.canonical_edges(raw), ref_formats.canonical_edges(raw)
    _same_graph(g, ref_g)
    np.testing.assert_array_equal(g.degrees(), ref_g.degrees())
    assert g.density == ref_g.density
    for mode in ("degree", "arrival"):
        np.testing.assert_array_equal(formats.degree_order(g, mode=mode),
                                      ref_formats.degree_order(ref_g, mode=mode))
    np.testing.assert_array_equal(formats.dense_adjacency(g),
                                  ref_formats.dense_adjacency(ref_g))
    np.testing.assert_array_equal(formats.forward_adjacency_dense(g, dtype=np.uint8),
                                  ref_formats.forward_adjacency_dense(ref_g, dtype=np.uint8))
    for got, want in zip(formats.forward_adjacency_padded(g),
                         ref_formats.forward_adjacency_padded(ref_g)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(formats.to_csr(g), ref_formats.to_csr(ref_g)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_stages,balance,pad_to", [(1, True, 1), (3, True, 8),
                                                      (4, False, 1), (4, True, 64)])
def test_ring_partition_equal_reference(n_stages, balance, pad_to):
    g = gen.powerlaw(130, 5, seed=2)
    ref_g = ref_gen.powerlaw(130, 5, seed=2)
    part = partition.ring_partition(g, n_stages, balance=balance, pad_to=pad_to)
    want = ref_partition.ring_partition(ref_g, n_stages, balance=balance, pad_to=pad_to)
    np.testing.assert_array_equal(part.rank, want.rank)
    assert (part.n_stages, part.rows_per_stage, part.n_pad) == \
        (want.n_stages, want.rows_per_stage, want.n_pad)
    np.testing.assert_array_equal(partition.stage_costs(g, part),
                                  ref_partition.stage_costs(ref_g, want))
    np.testing.assert_array_equal(partition.forward_degrees(g, part.rank),
                                  ref_partition.forward_degrees(ref_g, want.rank))
    assert partition.choose_n_stages(g, 16) == ref_partition.choose_n_stages(ref_g, 16)


def test_snake_assign_equal_reference():
    cost = np.random.default_rng(3).random(37)
    np.testing.assert_array_equal(partition.snake_assign(cost, 5),
                                  ref_partition.snake_assign(cost, 5))


@pytest.mark.parametrize("n,p,seed", [(40, 0.3, 0), (90, 0.6, 1)])
def test_oracles_and_replication_factor_equal_reference(n, p, seed):
    g, ref_g = gen.gnp(n, p, seed=seed), ref_gen.gnp(n, p, seed=seed)
    want = ref_oracle.count_triangles_brute(ref_g)
    assert oracle.count_triangles_brute(g) == want  # exact integers
    u = formats.forward_adjacency_dense(g)
    assert oracle.count_triangles_dense_ref(u) == want
    assert mr.mapreduce_replication_factor(g) == ref_mr.mapreduce_replication_factor(ref_g)


def test_mapreduce_operands_equal_reference():
    g, ref_g = gen.powerlaw(80, 3, seed=4), ref_gen.powerlaw(80, 3, seed=4)
    for kw in ({}, {"max_deg": 40, "key_base": 128}):
        got, want = mr.build_mapreduce_operands(g, **kw), \
            ref_mr.build_mapreduce_operands(ref_g, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_graph_from_arrays_carries_reference_graph():
    ref_g = ref_gen.gnp(70, 0.4, seed=9)
    g = convert.graph_from_arrays(ref_g.n_nodes, ref_g.edges)
    _same_graph(g, ref_g)
    assert g.edges is not ref_g.edges  # a copy: the port never aliases reference arrays
    assert oracle.count_triangles_brute(g) == ref_oracle.count_triangles_brute(ref_g)
    with pytest.raises(ValueError):
        convert.graph_from_arrays(5, np.array([[0, 5]]))
    with pytest.raises(ValueError):
        convert.graph_from_arrays(5, np.array([[-1, 2]]))
