"""The plain reference: float32 PyTorch, no kernel, no batching trick.

Imports nothing of the port and nothing of the JAX package; the benchmark
hands it the same seeded inputs and weights it hands the port."""
