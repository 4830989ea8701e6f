"""DimeNet [arXiv:2003.03123]: 6 blocks, d_hidden=128, n_bilinear=8,
n_spherical=7, n_radial=6."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="dimenet", family="dimenet", n_layers=6, d_hidden=128, n_bilinear=8,
    n_spherical=7, n_radial=6,
)


def smoke_config() -> GNNConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, name="dimenet-smoke")
