"""Plain references of the benchmark's model families: float32 PyTorch,
no kernel, no cache, no import of the program."""
