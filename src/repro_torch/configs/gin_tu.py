"""GIN [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator, learnable ε
(TU-dataset graph classification setting)."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu", family="gin", n_layers=5, d_hidden=64, aggregator="sum",
)


def smoke_config() -> GNNConfig:
    return dataclasses.replace(CONFIG, n_layers=3, d_hidden=16, name="gin-tu-smoke")
