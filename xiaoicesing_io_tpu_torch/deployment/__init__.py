"""Deployment tools: speaker scrubbing and latency micro-benchmarks."""
