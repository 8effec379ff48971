"""angular layer (this package's own copy; see its modules)."""
