"""Host time to enqueue one device step for every slot: the mean
duration of the program's `llm.step` spans in the window
(models/llm.llm_generate_chunk_batched; portbench/spans.py)."""
from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "LLM step: models/llm.py"
MOVES = "audio_x_realtime"


def read(ctx):
    got = spans.window(ctx)
    steps = spans.durations_s(got, spans.STEP) if got else []
    if not steps:
        return None
    return 1000.0 * sum(steps) / len(steps)
