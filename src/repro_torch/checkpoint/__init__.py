"""Counterpart of the reference package's checkpoint subpackage."""
