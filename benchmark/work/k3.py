"""K3 (``csrc/binned_window_sum.cu``): ``R`` rows of ``M`` f32 values
summed into ``out`` bins by one shared i32 id per element. A call reads
the values, the ids and one i32 window base per ``chunk`` once, and
writes ``R x out`` f32 sums once; one add per value."""


def bytes_moved(R: int, M: int, chunk: int, out: int) -> int:
    return 4 * (R * M + M + M // max(chunk, 1) + R * out)


def ops(R: int, M: int) -> int:
    return R * M
