"""The plain reference: GotenNet's forward pass, forces, losses and the
optimizer step in plain float32 PyTorch, written from the published
equations for the benchmark alone.  It imports nothing of the program and
nothing of the JAX package."""
