"""One reader per per-layer metric, found by the metric's name
(``metrics/<name>.py``). A reader has ``read(ctx)``, which returns the
value or ``None`` when it finds nothing to read; one that needs per-call
shapes also has ``probe()`` (a :class:`benchmark.probe.CallShapes`),
installed around the traced window. ``ctx`` is a
:class:`benchmark.harness.Context`. The helpers below are what several
readers share."""

from benchmark.probe import CallShapes
from benchmark.work import k1, k3, peaks


def mean_of(ctx, key: str):
    """Mean of ``key`` over the window's units that report it."""
    vals = [r[key] for r in ctx.records if key in r]
    return sum(vals) / len(vals) if vals else None


def idle_percent(ctx):
    """The device's idle share of the traced window: 1 - (union of the
    device operations' intervals) / window, in percent."""
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share


def kernel_roofline(ctx, metric: str, kernels, work):
    """A kernel's share of its roofline over the window: the sum over the
    calls ``metric``'s probe recorded of ``max(bytes / HBM bandwidth,
    operations / f32 rate)`` (``work(call)`` gives ``(bytes, ops)``), over
    the device time of the trace's operations named by ``kernels``, in
    percent."""
    calls = ctx.probes.get(metric)
    if ctx.trace is None or not calls:
        return None
    n, secs = ctx.trace.kernel_seconds(kernels)
    if n == 0 or secs <= 0:
        return None
    return 100.0 * sum(peaks.bound_s(*work(c)) for c in calls) / secs


def _k1_shape(tod, mask, *args, **kwargs):
    if tod.device.type != "cuda" or tod.numel() == 0:
        return None
    L = int(tod.shape[-1])
    return (tod.numel() // L, L)


def _k3_shape(values, ids, base, window, chunk, out_size, *args, **kwargs):
    if values.device.type != "cuda" or values.numel() == 0:
        return None
    M = int(values.shape[-1])
    return (values.numel() // M, M, int(chunk), int(out_size))


def k1_probe():
    """K1's calls (``csrc/masked_fill.cu``) as ``(rows, L)``."""
    return CallShapes("comapreduce_tpu_torch.ops.cuda_median",
                      "masked_fill", _k1_shape)


def k3_probe():
    """K3's calls (``csrc/binned_window_sum.cu``) as ``(R, M, chunk,
    out)``."""
    return CallShapes("comapreduce_tpu_torch.mapmaking.cuda_binning",
                      "binned_window_sum", _k3_shape)


def k1_roofline(ctx, metric: str):
    """K1's share of its roofline over the window's calls."""
    return kernel_roofline(ctx, metric, ("masked_fill_kernel",),
                           lambda c: (k1.bytes_moved(*c), k1.ops(*c)))


def k3_roofline(ctx, metric: str):
    """K3's share of its roofline over the window's calls (either
    body)."""
    return kernel_roofline(ctx, metric, ("binned_window_",),
                           lambda c: (k3.bytes_moved(*c), k3.ops(*c[:2])))
