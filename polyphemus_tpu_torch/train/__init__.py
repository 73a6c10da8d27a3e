"""Training: losses, metrics, schedules, checkpoints and the trainer."""
