"""Rectified-flow core, spec normaliser and samplers."""
