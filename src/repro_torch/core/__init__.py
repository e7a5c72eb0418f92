"""Counterpart of the reference package's core subpackage."""
