"""Training: config-driven loop, step, checkpoints and metrics."""
