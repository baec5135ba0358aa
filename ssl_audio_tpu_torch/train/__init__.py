"""Training of the port: optimizers, the state a step carries, the step, the loop."""
