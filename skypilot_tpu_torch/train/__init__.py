"""The ported training path: trainer, checkpoints, FLOP accounting."""
