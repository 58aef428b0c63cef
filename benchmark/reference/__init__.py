"""The plain reference: PyTorch and NumPy in float32, written from the
published description of each model (and, where the port's plain code
already writes it so, a frozen copy of that code). It imports nothing of
the program, of JAX or of the JAX package, and takes none of the
program's weights or derived tables: the benchmark hands it the same raw
inputs and weights that it hands the program."""
