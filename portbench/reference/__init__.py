"""The plain reference: float32 PyTorch and NumPy that imports nothing of
the program, reads only what the benchmark made (the model files' bytes,
the prompts, the seeds) and judges what the program served."""
