"""Counterpart of the reference package's models subpackage."""
