"""Training: the tasks, the trainer (on one card, or one card a rank), the
losses, the optimizer and the checkpoints."""
