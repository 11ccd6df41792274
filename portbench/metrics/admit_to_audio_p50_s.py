"""Median time from the end of a request's admission wave to its first
callback with samples, over the requests admitted inside the window, one
without audio by the window's end counted at the time it had waited:
the program's `req.prefill` and `req.first_audio` spans
(runtime/batching.py; portbench/spans.py).  With the queue wait and the
wave, it is TTFA."""
from portbench import spans, stats

UNIT, BETTER, SOURCE = "s", "lower", "program_span"
LAYER = "scheduler: runtime/batching.py"
MOVES = "ttfa_p50_s"


def read(ctx):
    got = spans.window(ctx)
    waits = spans.first_audio_waits_s(got)[0] if got else []
    return stats.percentile(waits, 50) if waits else None
