"""Plain float32 references of the port's models, each in a file of its own
that imports nothing of the port and no kernel: what the CPU tests and
chip_smoke.py hold the port against."""
