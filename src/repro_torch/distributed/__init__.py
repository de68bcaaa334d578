"""Checkpointing of training state (single device in this slice)."""
