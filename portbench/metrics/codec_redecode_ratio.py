"""Codes fed to codec decodes over codes committed in the window: each
commit decodes a stream's whole code prefix, so every code is decoded
again at each later commit.  ContinuousBatcher.stage's codes_decoded and
codes_committed counters (runtime/batching.py)."""
UNIT, BETTER, SOURCE = "x", "lower", "program_counter"
LAYER = "codec and vocoder: models/codec.py, ops/istft.py"
MOVES = "audio_x_realtime"


def read(ctx):
    st = ctx.stage or {}
    if not st.get("codes_committed"):
        return None
    return st["codes_decoded"] / st["codes_committed"]
