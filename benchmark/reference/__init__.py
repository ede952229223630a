"""The benchmark's plain reference of AKI-4B: float32 PyTorch, no kernel,
no cache, no batching, and nothing of the program imported."""
