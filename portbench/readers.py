"""What the per-layer metrics' readers share: which kernels are B4 and B5,
and the arithmetic over a traced window. Each reader gets ``ctx``: the
``Trace`` of the window, the configuration, and the window's
``steps`` (trainer steps, evaluation calls or leapfrog steps), its
``rows_per_step`` and the conditioner ``flops`` its work needs. A reader
returns None when the trace holds nothing for it to read."""
from __future__ import annotations

from .yardstick import (b4_bytes, b4_flops, b5_bytes, b5_flops, mfu_pct,
                        roofline_pct)

B4 = ("coupling_fwd_kernel",)
B5 = ("coupling_bwd_kernel", "coupling_dw_kernel")
COUPLING_RANGES = ("enflows.cuda.fused_coupling_fwd",
                   "enflows.cuda.fused_coupling_bwd")


def b4_roofline(ctx):
    """B4's bound over its device time a launch, in %."""
    n = ctx.trace.count(*B4)
    if not n:
        return None
    rows = ctx.rows_per_step
    return roofline_pct(b4_flops(ctx.cfg, rows), b4_bytes(ctx.cfg, rows),
                        ctx.trace.kernel_s(*B4) / n)


def b5_roofline(ctx):
    """B5's bound over the device time of its sweep and weight-gradient
    kernels a launch of the sweep, in %."""
    n = ctx.trace.count(B5[0])
    if not n:
        return None
    rows = ctx.rows_per_step
    return roofline_pct(b5_flops(ctx.cfg, rows), b5_bytes(ctx.cfg, rows),
                        ctx.trace.kernel_s(*B5) / n)


def coupling_host_ms(ctx):
    """Host ms a step inside the program's B4/B5 launch ranges."""
    s = ctx.trace.host_s(*COUPLING_RANGES)
    return 1e3 * s / ctx.steps if s and ctx.steps else None


def other_device_ms(ctx):
    """Device ms a step in operations other than B4 and B5."""
    total = ctx.trace.kernel_s("")
    if not total or not ctx.steps:
        return None
    return 1e3 * (total - ctx.trace.kernel_s(*B4, *B5)) / ctx.steps


def busy_ms_per_step(ctx):
    """Device busy ms a step (overlaps counted once)."""
    s = ctx.trace.busy_s()
    return 1e3 * s / ctx.steps if s and ctx.steps else None


def mfu(ctx):
    """The window's conditioner FLOPs over the TF32 peak, in %."""
    return mfu_pct(ctx.flops, ctx.trace.window_s) if ctx.flops else None


def idle_pct(ctx):
    """Share of the traced window with no device operation running, in %."""
    return 100.0 * ctx.trace.idle_share() if ctx.trace.busy_s() else None
