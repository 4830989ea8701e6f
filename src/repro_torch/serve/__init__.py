from repro_torch.serve.serve_loop import TriangleServeConfig, TriangleServer

__all__ = ["TriangleServeConfig", "TriangleServer"]
