"""Set-up time: from the start of the process's run to the window's start
(imports, the kernels' build or load, the data, the server, the warm-up)."""


def read(ctx):
    return ctx.setup_s
