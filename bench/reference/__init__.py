"""Plain float32 references of the benchmark's configurations: plain
PyTorch, no code of the served program."""
