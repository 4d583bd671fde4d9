"""Profiling and timing utilities.

Counterpart of the JAX package's ``utils/profiling.py``: the reference's
accumulating ``Timer`` context manager, a ``torch.profiler`` trace in place
of its ``xla_trace`` (a Perfetto / TensorBoard trace written to a
directory), and a throughput meter in the north-star unit, audio seconds
synthesised (or trained) per second per card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class Timer:
    """Accumulating named timer (``with Timer('x'):`` blocks sum up)."""

    timer_map: Dict[str, float] = defaultdict(float)

    def __init__(self, name: str, enable: bool = True, print_time: bool = False):
        self.name = name
        self.enable = enable
        self.print_time = print_time

    def __enter__(self):
        if self.enable:
            self.t = time.time()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self.enable:
            Timer.timer_map[self.name] += time.time() - self.t
            if self.print_time:
                print(self.name, Timer.timer_map[self.name])

    @staticmethod
    def report():
        return dict(Timer.timer_map)


@contextlib.contextmanager
def torch_trace(log_dir: str = "torch-trace"):
    """Trace the block with ``torch.profiler`` (the host, and the card when
    there is one) and write a trace that Perfetto and TensorBoard read into
    ``log_dir``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
    print(f"| profiler trace written to {log_dir}")


class ThroughputMeter:
    """Audio seconds synthesised (or trained) per second per card."""

    def __init__(self, sample_rate: int = 44100, hop_size: int = 512, num_chips: int = 1):
        self.frames = 0
        self.t0: Optional[float] = None
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.num_chips = num_chips

    def start(self):
        self.t0 = time.perf_counter()
        self.frames = 0

    def add_frames(self, n: int):
        self.frames += n

    def rate(self) -> float:
        dt = time.perf_counter() - (self.t0 or time.perf_counter())
        audio_s = self.frames * self.hop_size / self.sample_rate
        return audio_s / max(dt, 1e-9) / self.num_chips
