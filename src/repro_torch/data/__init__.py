"""Counterpart of the reference package's data subpackage."""
