"""Plain PyTorch version of the Algorithm-2 round close (``torch.cumsum``
per collector channel).

Mirrors ``core.statistics.close_round`` for one (NUM_CH, P, G1) bank
(rows or cols): fold the collectors into the maintained statistics via
prefix sums and reset the collectors.  The CPU path of the port runs
these; on the card they are what the CUDA kernel is held against.
"""
import torch

# channel order must match core.statistics
N, Q, R, SPANQ, PRESPANQ, C_N, C_Q, C_SPAN = range(8)
NUM_CH = 8


def close_round_ref(bank, decay: float = 0.5):
    """bank: (NUM_CH, P, G1) float32 → updated bank (same shape)."""
    cum_n = torch.cumsum(bank[C_N], dim=-1)
    cum_q = torch.cumsum(bank[C_Q], dim=-1)
    span_new = torch.cumsum(bank[C_SPAN], dim=-1)
    zeros = torch.zeros_like(cum_n)
    return torch.stack([
        bank[N] * decay + cum_n,
        bank[Q] + cum_q,
        cum_n + cum_q,
        bank[SPANQ] + span_new,
        span_new,
        zeros, zeros, zeros,
    ])


def close_round_inputs_ref(bank6, decay: float = 0.5):
    """Transfer-minimal form: ``bank6`` is (6, P, G1) in ``ops.IN_CH``
    order (N, Q, SPANQ, C_N, C_Q, C_SPAN); returns (5, P, G1) in
    ``ops.OUT_CH`` order (N, Q, R, SPANQ, PRESPANQ)."""
    n_in, q_in, spanq_in, c_n, c_q, c_span = bank6
    cum_n = torch.cumsum(c_n, dim=-1)
    cum_q = torch.cumsum(c_q, dim=-1)
    span_new = torch.cumsum(c_span, dim=-1)
    return torch.stack([n_in * decay + cum_n, q_in + cum_q, cum_n + cum_q,
                        spanq_in + span_new, span_new])
