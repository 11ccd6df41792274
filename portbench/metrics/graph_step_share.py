"""Device steps run by the replay of a CUDA graph over all device steps in
the window: how often the batcher's chunk graphs engage
(ContinuousBatcher.stage's graph_steps and device_steps counters,
runtime/batching.py).  A program without the graph_steps counter gives
None."""
UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER = "LLM step: models/llm.py"
MOVES = "audio_x_realtime"


def read(ctx):
    st = ctx.stage or {}
    if "graph_steps" not in st or not st.get("device_steps"):
        return None
    return 100.0 * st["graph_steps"] / st["device_steps"]
