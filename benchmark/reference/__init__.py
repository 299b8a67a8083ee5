"""The plain reference of the benchmark: NumPy, SciPy and plain PyTorch
only. Nothing here imports the program."""
