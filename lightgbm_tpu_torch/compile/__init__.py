"""Compile and warm-up (the JAX package's compile/, in torch terms):
the digest that fingerprints a training configuration, which a
checkpoint carries (signature.py), the kernel build counters
(manager.py) and the warm-up of the nvcc libraries (warmup.py). The
JAX package's AOT executable store has no counterpart: the port's is
ops/cuda.py's build directory, keyed on a hash of the sources."""
