"""I/O: checkpoints of the outer iteration, the run configuration's YAML,
the golden-format dumps, slices and ParaView output, and the comparison of
two runs' outputs (this package's own)."""
