"""Plain PyTorch version of the expert-assignment histogram.

Mirrors the JAX package's ``kernels/moe_histogram/ref.py``: over (T, K)
expert assignments, per expert the number of assignments and the sum of
their gates, both float32; ids outside [0, E) (the −1 padding) match
nothing.  Counts and load come from ``index_add_`` (of ones, of the
gates) into E + 1 slots, the last one taking the padding: static shapes,
so the version also traces under ``FakeTensorMode``; the counts are
exact (integers below 2**24).
"""
import torch


def moe_histogram_ref(idx, gates, num_experts: int):
    """idx (T, K) int, gates (T, K) float32 → (counts (E,), load (E,))."""
    idx = idx.reshape(-1).long()
    gates = gates.reshape(-1).float()
    keep = (idx >= 0) & (idx < num_experts)
    slot = torch.where(keep, idx, torch.full_like(idx, num_experts))
    counts = torch.zeros(num_experts + 1, dtype=torch.float32,
                         device=gates.device).index_add_(
        0, slot, torch.ones_like(gates))
    load = torch.zeros(num_experts + 1, dtype=torch.float32,
                       device=gates.device).index_add_(0, slot, gates)
    return counts[:num_experts], load[:num_experts]
