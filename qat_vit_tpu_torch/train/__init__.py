"""KD + QAT training: losses, the optimizer and train / eval steps, the trainer."""
