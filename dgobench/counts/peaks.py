"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its full 700 W power limit): float32 outside the tensor cores and the
HBM3 rate.  A share of a peak is stated with the card's power limit
beside it (the run prints it)."""
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def step_rows(population: int, virtual_block: int = 256) -> tuple[int, int]:
    """(rows, virtual blocks) of one engine step over the whole
    population on one shard: the blocks are ``ceil(pop / vb)`` equal runs
    of ``ceil(pop / blocks)`` rows, the rows past the population masked."""
    n_blocks = -(-population // virtual_block)
    block = -(-population // n_blocks)
    return n_blocks * block, n_blocks


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs for ``ops`` float32 operations and
    ``nbytes`` bytes of HBM traffic: the larger of the two bounds."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
