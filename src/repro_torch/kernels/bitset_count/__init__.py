from repro_torch.kernels.bitset_count.ops import bitset_edge_count, bitset_pair_count
