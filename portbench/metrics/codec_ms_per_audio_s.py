"""Device time of the codec and the iSTFT per second of audio emitted:
the kernels launched inside the portbench.codec ranges around the
engine's batched sliced decode."""
UNIT, BETTER, SOURCE = "ms/s", "lower", "device_trace"
LAYER = "codec and vocoder: models/codec.py, ops/istft.py"
MOVES = "audio_x_realtime"


def read(ctx):
    if ctx.trace is None or ctx.audio_s <= 0:
        return None
    ns, n = ctx.trace.device_ns_in("portbench.codec")
    if not n:
        return None
    return ns * 1e-6 / ctx.audio_s
