"""Host time of one admission wave (a batched slot prefill and its
bookkeeping): ContinuousBatcher.stage's admit_sec over its prefills."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_counter"
LAYER = "scheduler: runtime/batching.py"
MOVES = "ttfa_p95_s"


def read(ctx):
    st = ctx.stage
    if not st or not st.get("prefills"):
        return None
    return 1000.0 * st["admit_sec"] / st["prefills"]
