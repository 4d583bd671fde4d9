"""Deployment tools: ONNX export, speaker scrubbing and latency micro-benchmarks."""
