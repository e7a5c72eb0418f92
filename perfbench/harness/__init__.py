"""Driving the program under test: cells, traffic, traces, checks."""
