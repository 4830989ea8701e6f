"""GraphCast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN,
16 processor layers, d_hidden=512, mesh_refinement=6, sum aggregator,
n_vars=227."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="graphcast", family="graphcast", n_layers=16, d_hidden=512,
    mesh_refinement=6, n_vars=227, aggregator="sum",
)


def smoke_config() -> GNNConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_hidden=32, n_vars=11, name="graphcast-smoke")
