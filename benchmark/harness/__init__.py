"""The benchmark's own code: file lookup by name, traffic generators, the
FLOP count, seeded weights, spans, trace reading and the comparison that
decides ``correct``.  Nothing here imports the JAX package."""
