"""Counterpart of the reference package's optim subpackage."""
