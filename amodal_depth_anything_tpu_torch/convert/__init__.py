"""Reference-layout checkpoints and the JAX-pytree weight bridge."""
