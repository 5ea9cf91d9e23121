"""Training: model construction, the optimizer and schedules, the steps,
checkpoints and the loop."""
