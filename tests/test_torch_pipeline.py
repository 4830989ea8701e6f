"""The port's counting paths against the reference's: ring operands, the
stage-chain runtime, and the dense, sparse, ring, bitset-ring and MapReduce
counts. Same graphs in (numpy-seeded), exact integer counts out."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import triangle_mapreduce as ref_mr  # noqa: E402
from repro.core import triangle_pipeline as ref_tp  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.formats import Graph as RefGraph  # noqa: E402
from repro.graphs.formats import degree_order, forward_adjacency_padded  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import dynamic_pipeline as dp  # noqa: E402
from repro_torch.core import triangle_mapreduce as mr  # noqa: E402
from repro_torch.core import triangle_pipeline as tp  # noqa: E402

GRAPHS = {
    "gnp_sparse": lambda: ref_gen.gnp(120, 0.08, seed=1),
    "gnp_dense": lambda: ref_gen.gnp(90, 0.7, seed=2),
    "powerlaw": lambda: ref_gen.powerlaw(150, 6, seed=3),
    "road": lambda: ref_gen.road_grid(10, 12, seed=4),
}


def _pair(name):
    ref_g = GRAPHS[name]()
    return graph_from_arrays(ref_g.n_nodes, ref_g.edges), ref_g


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("n_stages", [2, 4])
def test_ring_operands_equal_reference(name, n_stages):
    g, ref_g = _pair(name)
    part, blocks = tp.build_dense_ring_operands(g, n_stages, pad_to=16, device="cpu")
    ref_part, ref_blocks = ref_tp.build_dense_ring_operands(ref_g, n_stages, pad_to=16)
    np.testing.assert_array_equal(part.rank, ref_part.rank)
    assert blocks.dtype == torch.uint8
    np.testing.assert_array_equal(blocks.numpy(), ref_blocks)
    eb = -(-g.n_edges // n_stages) + 5  # room for phantom padding in every block
    part, masks, edges = tp.build_bitset_ring_operands(g, n_stages, pad_to=8,
                                                       edge_block=eb, device="cpu")
    ref_part, ref_masks, ref_edges = ref_tp.build_bitset_ring_operands(
        ref_g, n_stages, pad_to=8, edge_block=eb)
    assert masks.dtype == torch.int32
    # int32 words carry the reference's uint32 bit patterns
    np.testing.assert_array_equal(masks.numpy().view(np.uint32), ref_masks)
    np.testing.assert_array_equal(edges.numpy(), ref_edges)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_every_path_counts_like_the_reference(name):
    g, ref_g = _pair(name)
    want = count_triangles_brute(ref_g)
    for s in (1, 3, 4):
        assert tp.count_triangles_ring(g, n_stages=s, device="cpu") == want \
            == ref_tp.count_triangles_ring(ref_g, n_stages=s, sequential=True)
        assert tp.count_triangles_bitset_ring(g, n_stages=s, device="cpu") == want \
            == ref_tp.count_triangles_bitset_ring(ref_g, n_stages=s, sequential=True)
    for streaming in (True, False):
        assert mr.count_triangles_mapreduce(g, node_batch=32, streaming=streaming,
                                            device="cpu") == want \
            == ref_mr.count_triangles_mapreduce(ref_g, node_batch=32, streaming=streaming)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dense_and_sparse_kernels_of_the_path_count_like_the_reference(name):
    _, ref_g = _pair(name)
    rank = degree_order(ref_g)
    nbrs, _ = forward_adjacency_padded(ref_g, rank)
    ru, rv = rank[ref_g.edges[:, 0]], rank[ref_g.edges[:, 1]]
    edges = np.stack([np.minimum(ru, rv), np.maximum(ru, rv)], 1).astype(np.int32)
    edges = np.concatenate([edges, np.full((37, 2), nbrs.shape[0], np.int32)])  # phantoms
    want = int(ref_tp.count_triangles_sparse(jnp.asarray(nbrs), jnp.asarray(edges),
                                             edge_batch=64))
    got = tp.count_triangles_sparse(torch.from_numpy(nbrs), torch.from_numpy(edges),
                                    edge_batch=64)
    assert got.dtype == torch.int64 and int(got) == want == count_triangles_brute(ref_g)
    from repro.graphs.formats import forward_adjacency_dense

    u = forward_adjacency_dense(ref_g, dtype=np.uint8)
    assert int(tp.count_triangles_dense(torch.from_numpy(u))) == \
        int(ref_tp.count_triangles_dense(jnp.asarray(u, jnp.float32))) == want


def test_mapreduce_kernels_count_like_the_reference():
    _, ref_g = _pair("powerlaw")
    nbrs, keys, n = ref_mr.build_mapreduce_operands(ref_g)
    want = int(ref_mr._mapreduce_count(jnp.asarray(nbrs), jnp.asarray(keys), n=n,
                                       node_batch=16))
    got = mr._mapreduce_count(torch.from_numpy(nbrs), torch.from_numpy(keys), n=n,
                              node_batch=16)
    assert got.dtype == torch.int64 and int(got) == want
    assert int(mr._mapreduce_two_round(torch.from_numpy(nbrs), torch.from_numpy(keys),
                                       n=n)) == want


def test_exact_count_beyond_f32_mantissa():
    """A complete graph with C(600, 3) = 35,820,200 > 2²⁴ triangles: the
    dense, ring and bitset-ring counts stay exact (int64 reductions)."""
    n = 600
    iu = np.triu_indices(n, k=1)
    edges = np.stack(iu, 1).astype(np.int32)
    g = graph_from_arrays(n, edges)
    want = n * (n - 1) * (n - 2) // 6
    assert tp.count_triangles_ring(g, n_stages=4, device="cpu") == want
    assert tp.count_triangles_bitset_ring(g, n_stages=4, device="cpu") == want
    assert ref_tp.count_triangles_ring(RefGraph(edges=edges, n_nodes=n), n_stages=4,
                                       sequential=True) == want


def test_run_sequential_visits_every_block_once_per_stage():
    seen = []

    def process(state, block, src):
        seen.append((state[0], src))
        return (state[0], state[1] + int(block) * 10 ** src)

    spec = dp.FilterSpec(init=lambda r: (int(r), 0), process=process,
                         finalize=lambda st: torch.tensor(st[1]))
    total = dp.run_sequential(spec, torch.tensor([1, 2, 3]), torch.tensor([4, 5, 6]), 3)
    assert seen == [(s, t) for s in (1, 2, 3) for t in range(3)]
    assert int(total) == 3 * (4 + 50 + 600)
