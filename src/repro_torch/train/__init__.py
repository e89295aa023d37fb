"""Training substrate of the port: AdamW and its LR schedule, int8
gradient compression, checkpointing, and the training loop."""
