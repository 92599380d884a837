"""Plain NumPy references: the semantics the program's outputs are held
to. Nothing here imports the program, the JAX package or their tests."""
