from repro_torch.serve.serve_loop import LMServer, ServeConfig, TriangleServeConfig, TriangleServer

__all__ = ["LMServer", "ServeConfig", "TriangleServeConfig", "TriangleServer"]
