"""Plain PyTorch version of K7: sum-mode EmbeddingBag, as the reference's
oracle (``repro/kernels/embedding_bag/ref.py``) computes it: gather, mask
the padding, sum in float32, cast to the table's dtype. The sum runs over
a bag's ids in order, as the reference's Pallas kernel and the CUDA kernel
accumulate, so the three round alike."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table: (V, D); indices: (N, L) integer ids, where an id ≥ V (or < 0)
    is padding. Returns (N, D) sums of the looked-up rows."""
    v = table.shape[0]
    rows = table[indices.long().clamp(0, max(v - 1, 0))]  # (N, L, D)
    mask = ((indices >= 0) & (indices < v)).unsqueeze(-1)
    out = torch.zeros((indices.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(indices.shape[1]):
        out += (rows[:, j] * mask[:, j]).float()
    return out.to(table.dtype)
