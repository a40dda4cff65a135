"""Plain PyTorch reference of the measured paths, frozen with the
benchmark.

Functions over a state dict whose keys are those of the port's modules, so
that one set of seeded weights feeds both sides.  Nothing here imports the
port, the JAX package or JAX; every kernel of the port is replaced by the
plain operation it stands for (a brute-force nearest neighbour, a ball
query over the full distance matrix).  ``precision`` in the callers is
"f32" (TF32 off, the configurations' precision) or "tf32" (the control).
"""
