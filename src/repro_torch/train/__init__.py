"""Training: optimizer, train step and checkpoints, the torch twins of
``repro.train``."""
