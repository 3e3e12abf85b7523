"""K1 (``csrc/masked_fill.cu``): a masked fill of ``rows`` rows of ``L``
samples. Each call reads the f32 TOD and the f32 mask once and writes
the f32 result once; one select per sample."""


def bytes_moved(rows: int, L: int) -> int:
    return 12 * rows * L


def ops(rows: int, L: int) -> int:
    return rows * L
