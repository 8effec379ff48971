"""Validation: the sequential numpy oracle (this package's own copy)."""
