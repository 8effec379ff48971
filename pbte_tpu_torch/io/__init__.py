"""I/O: checkpoints of the outer iteration (this package's own)."""
