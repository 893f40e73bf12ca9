"""The benchmark's plain reference: PyTorch only, nothing of the program."""
