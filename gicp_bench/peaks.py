"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet,
H100 SXM, dense rates at the full 700 W power limit). The card's power
limit is read beside every run (``nvidia-smi``); a card set lower runs
below these peaks under load."""

# float32 operations a second on the CUDA cores (outside the tensor cores).
F32_FLOPS = 67e12
# HBM3 bytes a second.
HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of work of ``flops`` operations and ``nbytes`` bytes:
    the larger of its compute time and its memory time at the peaks."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
