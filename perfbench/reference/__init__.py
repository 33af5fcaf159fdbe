"""Plain PyTorch references of the benchmark's models: their forward, loss,
gradients and Adam, from the benchmark's own inputs.  Nothing here imports
the measured package, JAX or the JAX package."""
