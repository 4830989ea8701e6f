"""The paper's own workload: dynamic-pipeline triangle counting config."""
import dataclasses

from repro_torch.configs.base import TriangleConfig

CONFIG = TriangleConfig()


def smoke_config() -> TriangleConfig:
    return dataclasses.replace(CONFIG, n_nodes=128, block=32, name="triangle-smoke")
