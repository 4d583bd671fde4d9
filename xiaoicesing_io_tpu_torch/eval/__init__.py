"""Objective evaluation (host numpy/scipy)."""
