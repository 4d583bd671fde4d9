"""Bucket-batched synthesis and vocoding of many ``.ds`` segments, over one
device or several.

Counterpart of the JAX package's ``inference/serving.py``
(``DataParallelSynthesizer``), whose batch axis is sharded over a ``dp``
mesh.  Segments are grouped by their 256-frame bucket, each group is cut
into chunks of at most ``min(64, max(n_dev, 49152 // bucket))`` rows (about
48k frames a call), and each chunk is stacked into one batch, padded with
all-zero rows to a multiple of the ``n_dev`` devices and cut into ``n_dev``
equal slices, one a device.  Each slice runs through the ``synthesize`` of a
runner on its device: the runner itself on its own device, and on every
further device a replica with its own copy of the model and its own
prepared kernel weights (their tensor maps encode buffer addresses, so they
are prepared on each device, never copied).  That is the kernel path on a
card (K1 for a LYNXNet denoiser with PReLU, K4 for WaveNet), its plain
version on the CPU.  The vocoder takes the mels in groups of equal length on
the runner's device, as JAX's ``vocode`` is not sharded.

The stacking follows the JAX rules: the time axis is padded to the bucket
(edge padding for a dynamic speaker mix, zeros elsewhere); axes of length 1
are broadcast axes and are not padded; ragged token and speaker-mix axes are
padded to the widest with id 0 and weight 0; a static mix ``[1, 1, N]`` in a
chunk with a dynamic one is repeated over time.  Padded tokens are id 0,
which the encoder masks, so each row equals its segment run alone through
``forward_model`` with the same noise row.

Per-segment seeds are not kept: each chunk draws the start noise of its
real rows from one stream, seeded from ``(seed, bucket * 4099 + chunk
number)``, on the first device, then pads it with zeros and slices it, so a
row's mel does not depend on the device count; each vocoder group draws its
source noise from ``(seed, length)``.  The ancestral DDPM sampler (speedup
1) also draws noise at every step: slice 0 from the chunk's stream, slice
``j`` from the stream of ``(seed + j, bucket * 4099 + chunk number)`` on its
device, so its rows depend on the device count.

Up to :data:`MAX_IN_FLIGHT` chunks are in flight: chunk ``c + 1`` is stacked
and enqueued on every device before chunk ``c`` is fetched.  The inputs go
to each card from pinned host memory without blocking, and each slice's
result comes back the same way behind a CUDA event of its own device, which
the host waits on only when it drains the chunk.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import generator_from_seed
from .acoustic import DiffSingerAcousticInfer, _bucket

MAX_IN_FLIGHT = 4       # chunks enqueued and not yet fetched
FRAMES_PER_CALL = 49152
MAX_ROWS = 64


def plan_chunks(lengths: Sequence[int], max_group_size: Optional[int] = None,
                n_dev: int = 1) -> List[Tuple[int, int, List[int]]]:
    """``(bucket, chunk number, segment indices)`` of every chunk, in the
    order they run: by bucket, each bucket's segments in input order, cut at
    ``max_group_size`` rows (default ``min(64, max(n_dev, 49152 //
    bucket))``)."""
    groups: Dict[int, List[int]] = defaultdict(list)
    for i, n in enumerate(lengths):
        groups[_bucket(n)].append(i)
    plan = []
    for padded_len, idxs in sorted(groups.items()):
        cap = max_group_size or min(MAX_ROWS, max(n_dev, FRAMES_PER_CALL // padded_len))
        plan += [(padded_len, chunk_no, idxs[lo:lo + cap])
                 for chunk_no, lo in enumerate(range(0, len(idxs), cap))]
    return plan


def _pad_time(v: np.ndarray, target_len: int, mode: str = "constant") -> np.ndarray:
    """Pad the time axis (1) of ``[1, T, ...]`` to ``target_len``."""
    if v.ndim >= 2 and v.shape[1] != target_len:
        pad = [(0, 0), (0, target_len - v.shape[1])] + [(0, 0)] * (v.ndim - 2)
        return np.pad(v, pad, mode=mode)
    return v


def stack_chunk(batches: Sequence[Dict[str, np.ndarray]], padded_len: int
                ) -> Dict[str, np.ndarray]:
    """The preprocessed inputs of one chunk's segments stacked into one
    batch under the JAX rules (``serving.py:113-159``)."""
    stacked = {}
    for k in batches[0]:
        rows = []
        for b in batches:
            v = np.asarray(b[k])
            if k not in ("tokens", "spk_mix_id") and v.ndim >= 2 and v.shape[1] != 1:
                v = _pad_time(v, padded_len, "edge" if k == "spk_mix_value" else "constant")
            rows.append(v)
        if rows[0].ndim > 1:
            wid = tuple(max(r.shape[d] for r in rows) for d in range(1, rows[0].ndim))
            if k == "spk_mix_value":  # a static mix broadcasts over time
                rows = [np.repeat(r, wid[0], axis=1) if r.shape[1] == 1 and wid[0] > 1 else r
                        for r in rows]
            rows = [np.pad(r, [(0, 0)] + [(0, w - s) for w, s in zip(wid, r.shape[1:])])
                    if tuple(r.shape[1:]) != wid else r for r in rows]
        stacked[k] = np.concatenate(rows, axis=0)
    return stacked


def _indexed(device) -> torch.device:
    """``device`` with its index (a bare ``cuda`` is the current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _to_device(v: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    t = torch.tensor(np.asarray(v), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    # pinned, so the copy leaves the host free to stack the next slice
    return t.pin_memory().to(device, non_blocking=True)


def _fetch_into(host: torch.Tensor, mel: torch.Tensor) -> Optional[torch.cuda.Event]:
    """Start the copy of a slice's mel into its rows of ``host``; on a card,
    an event of the mel's device marks its end."""
    if mel.device.type != "cuda":
        host.copy_(mel)
        return None
    with torch.cuda.device(mel.device):
        host.copy_(mel, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return done


class DataParallelSynthesizer:
    """Run many ``.ds`` segments through the acoustic model in bucket
    batches, sliced over ``devices``.

    >>> infer = DiffSingerAcousticInfer(cfg)
    >>> dp = DataParallelSynthesizer(infer)           # every visible card
    >>> mels, f0s = dp.synthesize_mels(segments)
    >>> wavs = dp.vocode(mels, f0s)

    ``devices`` defaults to every visible card when the runner is on CUDA,
    else to the runner's device; a device may be named more than once (its
    slices then run one after another on it).
    """

    def __init__(self, infer: DiffSingerAcousticInfer, devices: Optional[Sequence] = None):
        self.infer = infer
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if infer.device.type == "cuda" else [infer.device])
        self.devices = [_indexed(d) for d in devices]
        if not self.devices:
            raise ValueError("DataParallelSynthesizer needs at least one device")
        self.runners: Dict[torch.device, DiffSingerAcousticInfer] = {infer.device: infer}
        for d in self.devices:
            if d not in self.runners:
                self.runners[d] = DiffSingerAcousticInfer.from_model(
                    infer.cfg, copy.deepcopy(infer.model).to(d), infer.core, infer.normalizer)

    def _inputs(self, stacked: Dict[str, np.ndarray], device: torch.device) -> dict:
        """``synthesize``'s keyword inputs of a stacked slice on ``device``,
        as ``forward_model`` builds them for one segment."""
        long, f32 = torch.long, torch.float32
        out = {"tokens": _to_device(stacked["tokens"], long, device),
               "mel2ph": _to_device(stacked["mel2ph"], long, device),
               "f0": _to_device(stacked["f0"], f32, device)}
        for k in ("key_shift", "speed"):
            if k in stacked:
                out[k] = _to_device(stacked[k], f32, device)
        if self.infer.variances_to_embed:
            out["variances"] = {v: _to_device(stacked[v], f32, device)
                                for v in self.infer.variances_to_embed}
        if "spk_mix_id" in stacked:
            out["spk_mix_id"] = _to_device(stacked["spk_mix_id"], long, device)
            out["spk_mix_value"] = _to_device(stacked["spk_mix_value"], f32, device)
        return out

    def synthesize_mels(self, segments: Sequence[dict], seed: int = 0,
                        max_group_size: Optional[int] = None,
                        batches: Optional[List[dict]] = None,
                        noise: Optional[Dict[Tuple[int, int], np.ndarray]] = None):
        """``segments``: ``.ds`` segment dicts.  Returns ``(mels, f0s)`` in
        input order: ``mels[i]`` ``[T_i, M]``, ``f0s[i]`` ``[T_i]``.  Pass
        ``batches`` to reuse preprocessed inputs.  ``noise``, keyed by
        ``(bucket, chunk number)``, replaces the start noise of a chunk's
        real rows (its first ``rows`` of ``[>= rows, 1, bucket, M]``)."""
        infer = self.infer
        n_dev, first = len(self.devices), self.devices[0]
        if batches is None:
            batches = [infer.preprocess_input(p, idx=i) for i, p in enumerate(segments)]
        lengths = [int(b["mel2ph"].shape[1]) for b in batches]
        mels: List[Optional[np.ndarray]] = [None] * len(batches)
        f0s: List[Optional[np.ndarray]] = [None] * len(batches)
        n_mel = infer.cfg["audio_num_mel_bins"]

        def drain(chunk, host, events):
            for done in events:
                done.synchronize()
            out = host.numpy()
            for row, i in enumerate(chunk):
                mels[i] = out[row, :lengths[i]].copy()
                f0s[i] = np.asarray(batches[i]["f0"])[0, :lengths[i]]

        pending = []
        for padded_len, chunk_no, chunk in plan_chunks(lengths, max_group_size, n_dev):
            rows = len(chunk)
            stacked = stack_chunk([batches[i] for i in chunk], padded_len)
            pad_b = (-rows) % n_dev
            if pad_b:  # all-zero rows: token 0 and mel2ph 0, which the model masks
                stacked = {k: np.concatenate([v, np.zeros((pad_b,) + v.shape[1:], v.dtype)])
                           for k, v in stacked.items()}
            salt = padded_len * 4099 + chunk_no
            generator = None
            if noise is not None and (padded_len, chunk_no) in noise:
                start = _to_device(np.asarray(noise[padded_len, chunk_no])[:rows],
                                   torch.float32, first)
            else:
                generator = generator_from_seed(seed, first, salt=salt)
                start = torch.randn((rows, 1, padded_len, n_mel), generator=generator,
                                    device=first, dtype=torch.float32)
            if pad_b:
                start = torch.cat([start, start.new_zeros((pad_b,) + start.shape[1:])])
            per = (rows + pad_b) // n_dev
            host, events = None, []
            for j, dev in enumerate(self.devices):
                lo, hi = j * per, (j + 1) * per
                inputs = self._inputs({k: v[lo:hi] for k, v in stacked.items()}, dev)
                inputs["noise"] = start[lo:hi].to(dev, non_blocking=True)
                if generator is not None:  # the ancestral sampler's per-step noise
                    inputs["generator"] = generator if j == 0 else \
                        generator_from_seed(seed + j, dev, salt=salt)
                mel = self.runners[dev].synthesize(**inputs)
                if host is None:
                    host = torch.empty((rows + pad_b,) + tuple(mel.shape[1:]), dtype=mel.dtype,
                                       pin_memory=dev.type == "cuda")
                events.append(_fetch_into(host[lo:hi], mel))
            # enqueue chunk c + 1 on every device before fetching chunk c
            pending.append((chunk, host, [e for e in events if e is not None]))
            if len(pending) >= MAX_IN_FLIGHT:
                drain(*pending.pop(0))
        for item in pending:
            drain(*item)
        return mels, f0s

    def vocode(self, mels: Sequence[np.ndarray], f0s: Sequence[np.ndarray],
               seed: Optional[int] = None) -> List[np.ndarray]:
        """Vocode the mels in groups of equal length, by length; returns the
        wavs in input order.  ``seed`` drives each group's NSF source noise
        (salted with the length); ``None`` gives the deterministic source."""
        vocoder = self.infer.vocoder
        if vocoder is None:
            raise ValueError("the runner was built with load_vocoder=False")
        groups: Dict[int, List[int]] = defaultdict(list)
        for i, m in enumerate(mels):
            groups[m.shape[0]].append(i)
        wavs: List[Optional[np.ndarray]] = [None] * len(mels)
        for n, idxs in sorted(groups.items()):
            out = vocoder.spec2wav(np.stack([mels[i] for i in idxs]),
                                   np.stack([f0s[i] for i in idxs]),
                                   generator=generator_from_seed(seed, self.infer.device, salt=n))
            for row, i in enumerate(idxs):
                wavs[i] = out[row]
        return wavs
