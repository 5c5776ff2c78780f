"""Training: steps, checkpoints, logging and the solver loop."""
