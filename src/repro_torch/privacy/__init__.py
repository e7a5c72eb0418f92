"""Counterpart of the reference package's privacy subpackage."""
