"""Codes kept over the slot-steps the device ran: how full the batch is."""
UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER = "scheduler: runtime/batching.py"
MOVES = "audio_x_realtime"


def read(ctx):
    steps = len(ctx.chunks) * ctx.chunk_steps * ctx.n_slots
    if not steps:
        return None
    return 100.0 * sum(c.kept_codes for c in ctx.chunks) / steps
