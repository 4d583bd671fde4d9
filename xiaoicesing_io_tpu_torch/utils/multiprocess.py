"""Ordered multiprocessing runner (a copy of the JAX package's
``utils/multiprocess.py``): a ``spawn`` worker pool, round-robin argument
striping, results yielded in submission order.

``spawn`` starts each worker as a fresh interpreter, so no worker inherits
the parent's CUDA context.  Each worker gives torch its share of the CPU
cores (``cpu_count // num_workers`` threads), so that nets run on the CPU
do not oversubscribe it.  A callable whose object holds a model on the
card (RMVPE, the vocal-remover net) drops it when pickled and loads it
again, on the device it was given, at its first use in the worker.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
import traceback
from typing import Callable, List


def _worker(fn, args_queue, results_queue, init_ctx_func, threads):
    import torch

    torch.set_num_threads(threads)
    ctx = init_ctx_func() if init_ctx_func is not None else None
    while True:
        item = args_queue.get()
        if item is None:
            return
        job_idx, args = item
        try:
            res = fn(*args, ctx=ctx) if ctx is not None else fn(*args)
            results_queue.put((job_idx, res))
        except KeyboardInterrupt:
            return
        except Exception:  # noqa: BLE001 - report, keep the pool alive
            traceback.print_exc()
            results_queue.put((job_idx, None))


def chunked_multiprocess_run(fn: Callable, args: List, num_workers: int,
                             q_max_size: int = 1000, init_ctx_func=None):
    """Run ``fn(*args[i])`` across workers, yielding results in order."""
    num_jobs = len(args)
    if num_jobs == 0:
        return
    ctx = mp.get_context("spawn")
    args_queues = [ctx.Queue(maxsize=q_max_size // num_workers) for _ in range(num_workers)]
    results_queue = ctx.Queue(maxsize=q_max_size)
    threads = max(1, (os.cpu_count() or 1) // num_workers)
    workers = []
    for i in range(num_workers):
        p = ctx.Process(target=_worker,
                        args=(fn, args_queues[i], results_queue, init_ctx_func, threads),
                        daemon=True)
        p.start()
        workers.append(p)

    def feed():
        for job_idx, a in enumerate(args):
            args_queues[job_idx % num_workers].put((job_idx, a))
        for q in args_queues:
            q.put(None)

    threading.Thread(target=feed, daemon=True).start()

    buffer = {}
    next_idx = 0
    for _ in range(num_jobs):
        job_idx, res = results_queue.get()
        buffer[job_idx] = res
        while next_idx in buffer:
            yield buffer.pop(next_idx)
            next_idx += 1
    for p in workers:
        p.join()
