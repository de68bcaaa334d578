"""Runtime sanitizers."""
