"""Inference runners."""
