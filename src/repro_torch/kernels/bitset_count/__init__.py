from repro_torch.kernels.bitset_count.ops import (
    bitset_edge_count,
    bitset_grid_steps,
    bitset_pair_count,
)
