"""Counterpart of the reference package's configs subpackage."""
