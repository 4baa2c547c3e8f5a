"""Training: the optimizer and learning-rate schedule, and the train step."""
