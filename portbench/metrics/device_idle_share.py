"""The share of the traced window in which no kernel or copy ran."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device: H100"
MOVES = "audio_x_realtime"


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() * 1e-9 / ctx.trace.window_s)
