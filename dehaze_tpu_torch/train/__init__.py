"""Training: schedule, trainer, checkpoints and the loop."""
