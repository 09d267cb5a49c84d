"""The H100's host link, from NVIDIA's data sheet, and the bytes
a per-layer metric counts against them."""

# the card's host link: PCIe Gen5 x16, 32 GT/s a lane with 128b/130b
# coding, each way.  The machines that run the benchmark hide the link's
# fields from nvidia-smi ([N/A]), so the data sheet's link stands in.
HOST_LINK_BYTES_PER_S = 32e9 * 128 / 130 * 16 / 8     # ≈ 63.0e9

# statistics channels of one bank row: 8, of which K1's in-place round
# close reads 6 (N, Q, spanQ and the three collectors) and writes all 8
# (the five maintained channels, the three collectors cleared)
K1_READ_CHANNELS, K1_WRITE_CHANNELS = 6, 8
BANK_BYTES = 4                                         # float32


def k1_link_bound_s(live: int, grid: int) -> float:
    """Least time of one in-place round close over ``live`` partitions:
    their rows of both banks cross the host link once each way, reads
    and writes at once, so the larger of the two sets the bound."""
    row = 2 * live * (grid + 1) * BANK_BYTES
    return max(K1_READ_CHANNELS, K1_WRITE_CHANNELS) * row / HOST_LINK_BYTES_PER_S
