"""The Level-1 -> Level-2 reduction of one observation: F feeds of
(B, C, T) f32 raw counts read once, the (B, C, V) vane block read once,
and the (B, T) f32 Level-2 TOD and weights of each feed written once.
The count is the same whatever implements the chain."""


def bytes_moved(F: int, B: int, C: int, T: int, V: int) -> int:
    return 4 * F * (B * C * T + B * C * V + 2 * B * T)
