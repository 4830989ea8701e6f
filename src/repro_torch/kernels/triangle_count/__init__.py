from repro_torch.kernels.triangle_count.ops import (
    live_grid_size,
    masked_matmul_sum,
    triangle_count,
    triangle_count_grid_steps,
)
