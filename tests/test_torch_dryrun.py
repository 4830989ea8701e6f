"""The dry run's port (``repro_torch.launch.dryrun``, ``hlo_analysis``,
``analytic``; ROADMAP.md item 6f) against the reference's.

- ``analytic_cell`` equals the reference's float for float on all 43
  (architecture, shape) pairs;
- each collective rule equals the reference's ``parse_collectives`` on the
  compiled HLO of a minimal JAX program performing exactly that collective
  (groups of 2, 4 and 8; one subprocess with 8 forced host devices, which
  also compiles the reference's own dry-run cells at the smoke configs);
- the per-device argument bytes of each family's smoke cell on a (2, 4)
  mesh equal the sum of the reference's ``NamedSharding.shard_shape``
  bytes under the input shardings its own builder gives ``jax.jit`` (on
  the LM cells XLA's ``argument_size_in_bytes`` is the same sum; XLA
  leaves out the inputs a step does not use, as AutoInt's serve step's
  candidate head);
- each smoke cell counted on meta gives the FLOPs of the same step run on
  CPU tensors (the partitioned GNN and the triangle ring: one coordinate's
  count times the coordinates against the loop over every coordinate), and
  the matmul FLOPs of the reference's own step: its jaxpr's
  ``dot_general`` and ``ragged_dot_general`` products, a scan's body times
  its length, a ``shard_map`` body times its devices;
- ``run_cell`` writes what ``benchmarks/roofline.py`` reads, and records a
  failing cell without raising;
- K2's custom op: its fake, its flop formula and its CPU result;
  ``moe_apply``'s meta route counts what its CPU route counts.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.shapes import shapes_for as ref_shapes_for  # noqa: E402
from repro.launch import analytic as ref_analytic  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.shapes import GraphShape, LMShape, RecsysShape, TriangleShape  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.triangle_count.ops import masked_matmul_sum, masked_matmul_sum_ops  # noqa: E402
from repro_torch.kernels.triangle_count.ref import masked_matmul_sum_ref  # noqa: E402
from repro_torch.launch import analytic, dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.sharding import P  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

ALL_CELLS = [(arch, s.name) for arch in REF_ARCHS for s in ref_shapes_for(arch)]

# the smoke cells: (builder, arch, shape or the partitioned GNN's (n, e, d_feat))
SMOKE_CELLS = {
    "yi_6b/train": ("lm", "yi_6b", LMShape("train", 32, 8, "train")),
    "yi_6b/prefill": ("lm", "yi_6b", LMShape("prefill", 32, 8, "prefill")),
    "yi_6b/decode": ("lm", "yi_6b", LMShape("decode", 32, 8, "decode")),
    "deepseek/train": ("lm", "deepseek_v2_lite_16b", LMShape("train", 32, 8, "train")),
    "deepseek/prefill": ("lm", "deepseek_v2_lite_16b", LMShape("prefill", 32, 8, "prefill")),
    "deepseek/decode": ("lm", "deepseek_v2_lite_16b", LMShape("decode", 32, 8, "decode")),
    "gin/full": ("gnn", "gin_tu", GraphShape("full", 60, 100, d_feat=12)),
    "gin/minibatch": ("gnn", "gin_tu", GraphShape("mb", 500, 2000, batch_nodes=8,
                                                   fanout=(3, 2), kind="minibatch")),
    "graphcast/full": ("gnn", "graphcast", GraphShape("full", 40, 60)),
    "mace/molecule": ("gnn", "mace", GraphShape("mol", 6, 8, batch_graphs=4,
                                                 kind="batched_small")),
    "dimenet/full": ("gnn", "dimenet", GraphShape("full", 24, 30)),
    "gin/partitioned": ("gnn_dist", "gin_tu", (64, 128, 12)),
    "dimenet/partitioned": ("gnn_dist", "dimenet", (64, 128, 16)),
    "graphcast/partitioned": ("gnn_dist", "graphcast", (64, 128, 16)),
    "mace/partitioned": ("gnn_dist", "mace", (32, 40, 8)),  # MACE's meta ops are slow
    "autoint/train": ("recsys", "autoint", RecsysShape("train", 16, kind="train")),
    "autoint/serve": ("recsys", "autoint", RecsysShape("serve", 16, kind="serve")),
    "autoint/retrieval": ("recsys", "autoint", RecsysShape("ret", 1, n_candidates=60,
                                                            kind="retrieval")),
    "triangle/ring": ("triangle", "triangle", TriangleShape("t", 200, 0.5)),
}

# The LM train cells have no reference matmul count to meet: the reference
# pads its chunked cross-entropy to a 512-token chunk (16 times the smoke
# cells' 32 tokens) and recomputes each attention chunk again inside the
# layer's remat, where the port recomputes the layer once.
REF_MATMUL_CELLS = [k for k, (kind, _, shape) in SMOKE_CELLS.items()
                    if kind != "lm" or shape.kind != "train"]
# |port − reference| ≤ this share of the reference's matmul FLOPs: every
# cell is exact but the partitioned DimeNet and MACE, whose checkpoints
# recompute the energy readout's last (rows, d)·(d, 1) product, which the
# backward does not need and JAX's remat leaves out (4,096 of 21,475,328
# and 2,048 of 16,422,912 FLOPs)
REF_MATMUL_REL = 1e-3

COLLECTIVES = [(kind, g) for kind in ("all-reduce", "all-gather", "collective-permute")
               for g in (2, 4, 8)]
_ROWS, _COLS = 16, 32  # each device's block in the minimal programs (f32)


# --------------------------------------------------------------------------
# the reference, in a subprocess with 8 forced host devices
# --------------------------------------------------------------------------
def _ref_collectives() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh
    from jax.sharding import PartitionSpec as RP

    from repro.launch.hlo_analysis import parse_collectives
    from repro.utils import shard_map_compat

    out = {}
    for kind, g in COLLECTIVES:
        mesh = Mesh(np.asarray(jax.devices()[:g]), ("x",), axis_types=(AxisType.Auto,))
        perm = [(i, (i + 1) % g) for i in range(g)]
        # each collective feeds a multiply: the reference's parser reads no ROOT line
        f, out_spec = {
            "all-reduce": (lambda a: jax.lax.psum(a, "x") * 2, RP()),
            "all-gather": (lambda a: jax.lax.all_gather(a, "x", tiled=True) * 2, RP()),
            "collective-permute": (lambda a: jax.lax.ppermute(a, "x", perm) * 2, RP("x")),
        }[kind]
        fn = jax.jit(shard_map_compat(f, mesh=mesh, in_specs=RP("x"), out_specs=out_spec))
        text = fn.lower(jnp.ones((g * _ROWS, _COLS), jnp.float32)).compile().as_text()
        st = parse_collectives(text, g)
        out[f"{kind}/{g}"] = {"counts": st.counts, "operand": st.operand_bytes,
                              "wire": st.wire_bytes}
    return out


def _matmul_flops(jaxpr, mult: int = 1) -> int:
    """2·(output elements)·(contracted elements) of every ``dot_general``
    and ``ragged_dot_general`` in ``jaxpr`` and the jaxprs it holds; a
    scan's body times its length, a ``shard_map`` body times the devices
    of its manual axes. A loop of unknown length or a branch fails."""
    import jax.extend as jex

    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("dot_general", "ragged_dot_general"):
            dims = eqn.params.get("dimension_numbers") or \
                eqn.params["ragged_dot_dimension_numbers"].dot_dimension_numbers
            (contract, _), _ = dims
            lhs = eqn.invars[0].aval.shape
            total += 2 * mult * int(np.prod(eqn.outvars[0].aval.shape)) \
                * int(np.prod([lhs[i] for i in contract]))
            continue
        assert name not in ("while", "cond", "pallas_call"), name
        inner = mult
        if name == "scan":
            inner *= eqn.params["length"]
        elif name == "shard_map":
            mesh = eqn.params["mesh"]
            inner *= int(np.prod([mesh.shape[a] for a in eqn.params["manual_axes"]]))
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                if isinstance(sub, jex.core.ClosedJaxpr):
                    total += _matmul_flops(sub.jaxpr, inner)
                elif isinstance(sub, jex.core.Jaxpr):
                    total += _matmul_flops(sub, inner)
    return total


def _ref_cells() -> dict:
    """Each smoke cell of the reference's builders: its argument bytes
    under the shardings it gives ``jax.jit``, and its step's matmul
    FLOPs."""
    import jax
    from jax.sharding import AxisType, Mesh, NamedSharding

    from repro.configs import get_smoke as ref_get_smoke

    jax.devices()  # the backend holds 8 devices before the dry run's module sets 512
    import repro.launch.dryrun as rd

    class _Jit:
        """``jax`` as the builders see it, recording each ``jit``'s input
        shardings (XLA's compiled shardings leave out the unused inputs)."""

        def __init__(self):
            self.in_shardings = None

        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fun, **kw):
            self.in_shardings = kw["in_shardings"]
            return jax.jit(fun, **kw)

    rd.jax = recorder = _Jit()
    rd.get_config = ref_get_smoke  # the builders' configs: the smoke ones
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)

    def nbytes(sharding, sub):
        return sum(int(np.prod(sharding.shard_shape(x.shape))) * np.dtype(x.dtype).itemsize
                   for x in jax.tree.leaves(sub))

    arguments, matmul = {}, {}
    for key, (kind, arch, shape) in SMOKE_CELLS.items():
        if kind == "gnn_dist":
            fn, args = rd._gnn_distributed_cell(arch, ref_get_smoke(arch), *shape, mesh)
        else:
            fn, args = {"lm": rd.lm_cell, "gnn": rd.gnn_cell, "recsys": rd.recsys_cell,
                        "triangle": rd.triangle_cell}[kind](arch, shape, mesh)
        per_arg = jax.tree.map(nbytes, tuple(recorder.in_shardings), tuple(args),
                               is_leaf=lambda x: isinstance(x, NamedSharding))
        arguments[key] = sum(jax.tree.leaves(per_arg))
        if key in REF_MATMUL_CELLS:
            matmul[key] = _matmul_flops(jax.make_jaxpr(fn)(*args).jaxpr)
    return {"arguments": arguments, "matmul_flops": matmul}


def dump_reference(path: str) -> None:
    """Entry point of the subprocess: the reference's values to ``path``."""
    import jax

    assert jax.device_count() >= 8, jax.devices()
    with open(path, "w") as f:
        json.dump({"collectives": _ref_collectives(), **_ref_cells()}, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun_ref") / "ref.json")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), HERE]))
    code = f"import test_torch_dryrun as t\nt.dump_reference({path!r})\n"
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# the port's smoke cells
# --------------------------------------------------------------------------
def _mesh(device: str, data: int = 2, model: int = 4):
    return make_local_mesh(data=data, model=model, devices=[device] * (data * model))


def _port_cell(key: str, mesh, generator=None):
    kind, arch, shape = SMOKE_CELLS[key]
    if kind == "gnn_dist":
        return dryrun._gnn_distributed_cell(arch, get_smoke(arch), *shape, mesh,
                                            generator=generator)
    if kind == "triangle":
        return dryrun.triangle_cell(arch, shape, mesh, generator=generator)
    builder = {"lm": dryrun.lm_cell, "gnn": dryrun.gnn_cell, "recsys": dryrun.recsys_cell}[kind]
    return builder(arch, shape, mesh, cfg=get_smoke(arch), generator=generator)


def _flops(cell) -> int:
    return dryrun.count_cell(cell).flops


@functools.cache
def _meta_flops(key: str) -> int:
    """The smoke cell's FLOPs counted on the meta (2, 4) mesh, times the
    coordinates its count stands for."""
    cell = _port_cell(key, _mesh("meta"))
    return _flops(cell) * cell.scale


# --------------------------------------------------------------------------
# analytic
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_analytic_cell_equals_the_reference(arch, shape):
    got, want = analytic.analytic_cell(arch, shape), ref_analytic.analytic_cell(arch, shape)
    assert want is not None and got == want
    assert analytic.REMAT_FACTOR == ref_analytic.REMAT_FACTOR


def test_the_sweep_has_the_references_43_cells():
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import shapes_for

    assert [(a, s.name) for a in ARCHS for s in shapes_for(a)] == sorted(
        ALL_CELLS, key=lambda c: ARCHS.index(c[0]))
    assert len(ALL_CELLS) == 43


# --------------------------------------------------------------------------
# hlo_analysis: the collective rules and the card's constants
# --------------------------------------------------------------------------
DENSE_DECODE_CELLS = [(arch, shape) for arch in ("yi_6b", "granite_8b", "nemotron_4_15b")
                      for shape in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape", DENSE_DECODE_CELLS)
def test_dense_decode_flops_are_every_weight_and_every_layers_attention(arch, shape):
    """A dense LM's decode cell, full config on the meta production mesh,
    counts 2 FLOPs a token for every weight but the embedding and the
    norms', and every layer's attention over the whole cache with every
    query head (4·H·hd·S a token): where ``analytic`` charges one layer's
    attention over the kv heads, its count runs 2–22× ``analytic``'s."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    sh = next(s for s in shapes_for(arch) if s.name == shape)
    cell = dryrun.lm_cell(arch, sh, make_production_mesh(devices=["meta"] * 256))
    b, s = sh.global_batch, sh.seq_len
    weights = cfg.n_params() - cfg.vocab * cfg.d_model - (2 * cfg.n_layers + 1) * cfg.d_model
    want = 2 * weights * b + cfg.n_layers * b * 4 * cfg.n_heads * cfg.hd * s
    assert _flops(cell) == want > analytic.analytic_cell(arch, shape)["flops"]


@pytest.mark.parametrize("kind,group", COLLECTIVES)
def test_collective_rule_equals_parse_collectives(ref, kind, group):
    """One collective of each kind the port's program performs, its
    per-device result r (an all-gather's is the group's blocks): the rule's
    count, operand and wire bytes are the reference parser's on the
    compiled program that performs exactly it."""
    block = _ROWS * _COLS * 4
    result = block * group if kind == "all-gather" else block
    got = hlo_analysis.collective_stats([(kind, result, group, 1)])
    want = ref["collectives"][f"{kind}/{group}"]
    for name, ours, theirs in (("counts", got.counts, want["counts"]),
                               ("operand", got.operand_bytes, want["operand"]),
                               ("wire", got.wire_bytes, want["wire"])):
        assert {k: v for k, v in ours.items() if v} == {k: v for k, v in theirs.items() if v} \
            == {kind: theirs[kind]}, name


def test_the_triangle_cell_is_charged_at_the_int8_peak(tmp_path):
    """The ring's uint8 operations meet the int8 peak, in the roofline and
    in ``analytic``'s compute term; every other cell the bf16 peak."""
    from repro_torch.configs.shapes import shapes_for

    assert hlo_analysis.peak_ops(torch.uint8) == hlo_analysis.PEAK_INT8_OPS
    assert hlo_analysis.peak_ops(torch.bfloat16) == hlo_analysis.PEAK_FLOPS
    rec = dryrun.run_cell("triangle", shapes_for("triangle")[0], out_dir=str(tmp_path),
                          verbose=False)
    assert rec["ok"], rec.get("traceback")
    rl, ana = rec["roofline"], rec["analytic"]
    assert rl["peak_flops"] == hlo_analysis.PEAK_INT8_OPS
    assert rl["compute_s"] == rl["flops"] / hlo_analysis.PEAK_INT8_OPS
    assert ana["compute_s"] == ana["flops"] / (256 * hlo_analysis.PEAK_INT8_OPS)
    assert _port_cell("yi_6b/prefill", _mesh("meta")).ops_dtype == torch.bfloat16


def test_collective_stats_scales_by_count_and_skips_none():
    st = hlo_analysis.collective_stats([("all-reduce", 1000, 4, 3), ("all-gather", 800, 8, 0)])
    assert st.counts["all-reduce"] == 3 and st.counts["all-gather"] == 0
    assert st.total_operand_bytes == 3000 and st.total_wire_bytes == 3 * 2 * 1000 * 3 / 4


def test_the_constants_are_the_h100s_and_no_tpu_constant_is_left():
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW, hlo_analysis.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    launch = os.path.join(ROOT, "src", "repro_torch", "launch")
    for name in os.listdir(launch):
        if name.endswith(".py"):
            text = open(os.path.join(launch, name)).read()
            for tpu in (r"\b197e12", r"\b819e9", r"\b50e9", "v5e", "ICI"):
                assert not re.search(tpu, text), (name, tpu)


def test_roofline_divides_the_global_counts_by_the_devices():
    st = hlo_analysis.collective_stats([("collective-permute", 4096, 8, 7)])
    rl = hlo_analysis.roofline_from_counts(8e12, 8e9, st, 8)
    assert (rl.flops, rl.bytes_accessed, rl.global_flops) == (1e12, 1e9, 8e12)
    assert rl.compute_s == 1e12 / hlo_analysis.PEAK_FLOPS
    int8 = hlo_analysis.roofline_from_counts(8e12, 8e9, st, 8, hlo_analysis.PEAK_INT8_OPS)
    assert int8.compute_s == 1e12 / hlo_analysis.PEAK_INT8_OPS
    assert int8.as_dict()["peak_flops"] == hlo_analysis.PEAK_INT8_OPS
    assert rl.collective_s == 7 * 4096 / hlo_analysis.LINK_BW
    assert rl.dominant == "compute"
    assert {"flops", "bytes_accessed", "collective_operand_bytes", "collective_wire_bytes",
            "compute_s", "memory_s", "collective_s", "dominant", "n_devices"} <= set(rl.as_dict())


# --------------------------------------------------------------------------
# the cells
# --------------------------------------------------------------------------
@pytest.mark.parametrize("key", list(SMOKE_CELLS))
def test_smoke_cell_argument_bytes_equal_the_references_shard_shapes(ref, key):
    assert _port_cell(key, _mesh("meta")).argument_bytes == ref["arguments"][key]


@pytest.mark.parametrize("key", list(SMOKE_CELLS))
def test_smoke_cell_meta_flops_equal_the_cpu_steps(key):
    """The step counted on meta tensors has the FLOPs of the same step run
    on CPU tensors. The partitioned GNN and the triangle ring count one
    coordinate's shapes on meta: times the coordinates, that is the loop
    over all 8 that the CPU mesh runs."""
    meta = _port_cell(key, _mesh("meta"))
    cpu = _port_cell(key, _mesh("cpu"), torch.Generator().manual_seed(0))
    assert cpu.scale == 1 and meta.argument_bytes == cpu.argument_bytes
    assert meta.scale == (8 if SMOKE_CELLS[key][0] in ("gnn_dist", "triangle") else 1)
    assert _meta_flops(key) > 0 and _meta_flops(key) == _flops(cpu)


@pytest.mark.parametrize("key", REF_MATMUL_CELLS)
def test_smoke_cell_flops_equal_the_references_matmul_flops(ref, key):
    """The port's count of a smoke cell is the reference's own step's matmul
    FLOPs (its jaxpr's products, scans and ``shard_map`` bodies multiplied
    out), within ``REF_MATMUL_REL``: a cell that leaves out or repeats a
    layer, a pass or a stage's work is off by far more."""
    want = ref["matmul_flops"][key]
    assert want > 0 and abs(_meta_flops(key) - want) <= REF_MATMUL_REL * want


@pytest.mark.parametrize("arch", ["gin_tu", "graphcast", "mace", "dimenet"])
def test_replicate_rows_gathers_are_the_loops_calls(arch, monkeypatch):
    """The all-gathers the partitioned cell reckons are the calls of
    ``replicate_rows`` one train step makes (the backward's recomputations
    included), each with its gathered bytes and group."""
    from repro_torch.models.gnn import distributed

    calls, real = [], distributed.replicate_rows

    def recording(shards, mesh):
        calls.append((sum(s.numel() * s.element_size() for s in shards), len(shards)))
        return real(shards, mesh)

    monkeypatch.setattr(distributed, "replicate_rows", recording)
    mesh = _mesh("cpu", 1, 4)
    cell = dryrun._gnn_distributed_cell(arch, get_smoke(arch), 32, 40, 8, mesh,
                                        generator=torch.Generator().manual_seed(0))
    cell.run()
    want = [c for c in cell.collectives if c[0] == "all-gather"]
    got: dict = {}
    for nbytes, group in calls:
        got[(nbytes, group)] = got.get((nbytes, group), 0) + 1
    merged: dict = {}
    for _, nbytes, group, count in want:
        merged[(nbytes, group)] = merged.get((nbytes, group), 0) + count
    assert got == merged


@pytest.mark.parametrize("kind,passes", [("train", 2), ("prefill", 1)])
def test_ep_sums_are_the_expert_parallel_calls(kind, passes, monkeypatch):
    """An MoE cell on a mesh reckons one all-reduce over ``"model"`` a
    ``moe_apply_ep`` call: every MoE layer's forward, and in a train step
    its remat recomputation; each of a data row's (t_loc, D) part."""
    from repro_torch.models import transformer as tf

    calls, real = [], tf.moe_apply_ep

    def recording(p, cfg, x, **kw):
        calls.append(tuple(x.shape))
        return real(p, cfg, x, **kw)

    monkeypatch.setattr(tf, "moe_apply_ep", recording)
    cell = _port_cell(f"deepseek/{kind}", _mesh("meta"))
    cell.run()
    cfg = get_smoke("deepseek_v2_lite_16b")
    (entry,) = [c for c in cell.collectives if c[2] == 4]
    assert entry[3] == len(calls) == (cfg.n_layers - cfg.moe.n_dense_layers) * passes
    t, d = calls[0]
    assert entry[:3] == ("all-reduce", t // 2 * d * 2, 4)  # bf16 parts of a data row's tokens


def test_the_gradient_all_reduce_is_over_the_data_axes():
    cell = _port_cell("yi_6b/train", _mesh("meta"))
    (grad,) = [c for c in cell.collectives if c[2] == 2]
    model = cell.args[0]
    # every weight's gradient once per data row, split over "model" where its spec says
    assert grad[0] == "all-reduce" and grad[3] == 1
    full = sum(p.numel() * p.element_size() for p in model.parameters())
    assert full / 4 <= grad[1] < full
    assert cell.alias_bytes == cell.output_bytes - 4


def test_shard_bytes_pads_a_dim_that_does_not_divide():
    mesh = _mesh("meta")
    assert dryrun.shard_bytes((10, 3), torch.float32, P("data", None), mesh) == 5 * 3 * 4
    assert dryrun.shard_bytes((10, 3), torch.float32, P("model", None), mesh) == 3 * 3 * 4
    assert dryrun.shard_bytes((10, 3), torch.bfloat16, P(("data", "model")), mesh) == 2 * 3 * 2
    with pytest.raises(ValueError):
        dryrun.shard_bytes((10,), torch.float32, P("data", None), mesh)


def test_traffic_mode_counts_bytes_and_the_live_peak():
    x, two = torch.empty(100, device="meta"), torch.full((), 2.0, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with dryrun.TrafficMode() as tr:
        ys = [x * two for _ in range(3)]  # three live outputs of 400 bytes
        v = ys[0][:10]  # a view moves nothing
        del ys
        z = torch.empty(50, device="meta")  # an allocation writes nothing
        w = x[idx]  # a gather reads only its rows: 16 bytes of x, the 32 of idx
    assert tr.peak == 3 * 400
    assert tr.live == 400 + 200 + 16  # ys[0] lives on in v
    assert tr.bytes == 3 * (400 + 4 + 400) + (16 + 32 + 16)
    del v, z, w


def test_a_card_mesh_cell_draws_its_inputs():
    """Off a meta mesh the builders draw from the generator: the same seed,
    the same arguments."""
    a = _port_cell("triangle/ring", _mesh("cpu"), torch.Generator().manual_seed(3))
    b = _port_cell("triangle/ring", _mesh("cpu"), torch.Generator().manual_seed(3))
    u = a.args[0].reshape(-1, a.args[0].shape[-1])
    assert torch.equal(u, b.args[0].reshape(u.shape))
    assert not u.tril().any() and 0.4 < u[:200, :200].float().sum() / (200 * 199 / 2) < 0.6
    assert int(a.run()) == int(masked_matmul_sum_ref(u, u, u))


# --------------------------------------------------------------------------
# run_cell and benchmarks/roofline.py
# --------------------------------------------------------------------------
def _roofline_module():
    spec = importlib.util.spec_from_file_location(
        "roofline_bench", os.path.join(ROOT, "benchmarks", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_cell_writes_what_the_roofline_table_reads(tmp_path, monkeypatch, capsys):
    from repro_torch.configs.shapes import RECSYS_SHAPES

    shape = next(s for s in RECSYS_SHAPES if s.name == "serve_p99")
    rec = dryrun.run_cell("autoint", shape, out_dir=str(tmp_path), verbose=False)
    assert rec["ok"], rec.get("traceback")
    path = tmp_path / "pod_16x16" / "autoint__serve_p99.json"
    disk = json.loads(path.read_text())
    assert disk["n_devices"] == 256 and disk["mesh"] == "pod_16x16"
    for key in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                "peak_bytes_per_device"):
        assert disk["memory"][key] >= 0
    assert disk["memory"]["peak_bytes_per_device"] == (
        disk["memory"]["argument_bytes"] + disk["memory"]["output_bytes"]
        + disk["memory"]["temp_bytes"] - disk["memory"]["alias_bytes"])
    assert disk["analytic"]["flops"] == ref_analytic.analytic_cell("autoint", "serve_p99")["flops"]
    assert disk["roofline"]["flops"] == disk["roofline"]["global_flops"] / 256

    def broken(*a, **k):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    bad = dryrun.run_cell("autoint", dataclasses.replace(shape, name="broken"),
                          out_dir=str(tmp_path), verbose=False)
    assert not bad["ok"] and "no such cell" in bad["error"] and "traceback" in bad
    assert (tmp_path / "pod_16x16" / "autoint__broken.json").exists()

    roofline = _roofline_module()
    monkeypatch.setattr(roofline, "RESULTS", str(tmp_path))
    rows = roofline.print_table("pod_16x16")
    printed = capsys.readouterr().out
    assert [r["shape"] for r in rows] == ["broken", "serve_p99"]
    assert "FAIL" in printed and "serve_p99" in printed
    assert rows[1]["roofline_fraction_pct"] > 0


# --------------------------------------------------------------------------
# K2 as a custom op, and moe_apply on meta
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,upper", [((64, 64, 64), False), ((300, 513, 129), False),
                                         ((300, 513, 129), True), ((129, 400, 700), True),
                                         ((256, 256, 256), True)])
def test_k2_custom_op_fake_flops_and_cpu_result(shape, upper):
    """On the CPU the op returns the plain version's count; on meta its
    fake, an int64 scalar; FlopCounterMode counts it by
    ``masked_matmul_sum_ops``: 2·R·K·N, or under the skip twice the live
    terms, which are Σ (A·B)⊙M of all-ones operands under the same skip."""
    R, K, N = shape
    g = torch.Generator().manual_seed(R + K + N)
    a, b, m = ((torch.rand(s, generator=g) < 0.5).to(torch.uint8)
               for s in ((R, K), (K, N), (R, N)))
    before = launch_counts()
    with FlopCounterMode(display=False) as fc:
        got = masked_matmul_sum(a, b, m, upper_triangular=upper)
    assert int(got) == int(masked_matmul_sum_ref(a, b, m, upper_triangular=upper))
    assert launch_counts() == before
    ones = [torch.ones_like(x) for x in (a, b, m)]
    live = int(masked_matmul_sum_ref(*ones, upper_triangular=upper))
    assert fc.get_total_flops() == masked_matmul_sum_ops(R, K, N, upper) == 2 * live
    if not upper:
        assert live == R * K * N
    with FlopCounterMode(display=False) as fc:
        fake = masked_matmul_sum(a.to("meta"), b.to("meta"), m.to("meta"),
                                 upper_triangular=upper)
    assert (fake.device.type, fake.dtype, fake.shape) == ("meta", torch.int64, ())
    assert fc.get_total_flops() == 2 * live


def test_k2_custom_op_passes_opcheck():
    a = torch.ones(40, 50, dtype=torch.uint8)
    b, m = torch.ones(50, 30, dtype=torch.uint8), torch.ones(40, 30, dtype=torch.uint8)
    torch.library.opcheck(torch.ops.repro_torch.masked_matmul_sum.default, (a, b, m, False),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("grad", [False, True])
def test_moe_apply_meta_route_counts_what_the_cpu_route_counts(grad):
    from repro_torch.models import moe

    cfg = get_smoke("deepseek_v2_lite_16b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(37, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pm = moe.MoE(cfg, device="meta")
    counts = []
    for model, inp in ((p, x), (pm, x.to("meta"))):
        for w in model.parameters():
            w.requires_grad_(grad)
        with FlopCounterMode(display=False) as fc, torch.set_grad_enabled(grad):
            y, aux = moe.moe_apply(model, cfg, inp)
            if grad:
                torch.autograd.grad(y.sum() + aux, list(model.parameters()), allow_unused=True)
        counts.append(fc.get_total_flops())
        assert y.shape == x.shape and y.device == inp.device
    assert counts[0] == counts[1] > 0
