"""Training: AdamW, gradient compression, the train step, data, checkpoints and the trainer."""
