"""95th percentile (nearest rank) of the wait from submit to the start of
the admission wave, over the requests submitted inside the window: the
program's `req.queue` spans (runtime/batching.py; portbench/spans.py)."""
from portbench import spans, stats

UNIT, BETTER, SOURCE = "s", "lower", "program_span"
LAYER = "scheduler: runtime/batching.py"
MOVES = "ttfa_p95_s"


def read(ctx):
    got = spans.window(ctx)
    waits = spans.queue_waits_s(got) if got else []
    return stats.percentile(waits, 95) if waits else None
