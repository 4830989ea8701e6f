"""MACE [arXiv:2206.07697]: 2 layers, d_hidden=128, l_max=2, correlation 3,
n_rbf=8, E(3)-equivariant ACE message passing."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="mace", family="mace", n_layers=2, d_hidden=128, l_max=2,
    correlation_order=3, n_rbf=8,
)


def smoke_config() -> GNNConfig:
    return dataclasses.replace(CONFIG, d_hidden=16, name="mace-smoke")
