"""Host side of the in-order scatter-add of K18, K30, K21 and K28
(`csrc/in_order_scatter.cuh`): the radix passes a grid's cell count needs,
and the launches a call of n returns takes. The constants are the
header's."""

TILE = 8192  # returns a block holds (kTile)
MAX_CLUSTER = 16  # blocks per thread-block cluster (kMaxCluster)
CHUNK = TILE * MAX_CLUSTER  # returns per launch (kChunk)


def radix_passes(num_cells: int) -> int:
    """8-bit digit passes that cover the cell indices [0, num_cells), at
    least one: 3 for the default pool (2^23 cells) and a 256^3 window."""
    if num_cells < 1:
        raise ValueError(f"a grid of {num_cells} cells")
    return max(1, -(-(num_cells - 1).bit_length() // 8))


def launches(n: int) -> int:
    """Kernel launches of one call on n returns (of each group, where a
    launch holds several): one per CHUNK returns."""
    return -(-n // CHUNK)

