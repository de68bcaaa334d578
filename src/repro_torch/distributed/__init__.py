"""Checkpointing of training state, and the multi-device partitions."""
