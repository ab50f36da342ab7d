"""Training of the port: solver, host hooks, checkpoints and the trainer."""
