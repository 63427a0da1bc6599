"""The plain float32 reference the benchmark holds the port to. It imports
neither JAX, the JAX package nor anything of the port."""
