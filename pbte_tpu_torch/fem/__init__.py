"""fem layer of the lattice path (this package's own copy; see its modules)."""
