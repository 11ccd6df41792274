"""Host launch calls (kernels and CUDA graphs) per device step, from the
profiler's host events."""
UNIT, BETTER, SOURCE = "launches", "lower", "device_trace"
LAYER = "LLM step: models/llm.py"
MOVES = "audio_x_realtime"


def read(ctx):
    steps = ctx.stage.get("device_steps", 0) if ctx.stage else 0
    if ctx.trace is None or not steps or not ctx.trace.launches:
        return None
    return len(ctx.trace.launches) / steps
