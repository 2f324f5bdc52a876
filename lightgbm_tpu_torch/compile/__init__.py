"""Configuration signatures (the JAX package's compile/): so far only
the digest that fingerprints a training configuration, which a
checkpoint carries. The kernel build cache, row buckets and warm-up
come with ROADMAP A15."""
