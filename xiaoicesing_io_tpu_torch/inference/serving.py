"""Bucket-batched synthesis and vocoding of many ``.ds`` segments.

Counterpart of the JAX package's ``inference/serving.py``
(``DataParallelSynthesizer``), on the runner's one device.  Segments are
grouped by their 256-frame bucket, each group is cut into chunks of at most
``min(64, 49152 // bucket)`` rows (about 48k frames a call), and each chunk
is stacked into one batch and run through the runner's ``synthesize``: the
kernel path on the card (K1 for a LYNXNet denoiser with PReLU, K4 for
WaveNet), its plain version on the CPU.  The vocoder takes the mels in groups
of equal length.

The stacking follows the JAX rules: the time axis is padded to the bucket
(edge padding for a dynamic speaker mix, zeros elsewhere); axes of length 1
are broadcast axes and are not padded; ragged token and speaker-mix axes are
padded to the widest with id 0 and weight 0; a static mix ``[1, 1, N]`` in a
chunk with a dynamic one is repeated over time.  Padded tokens are id 0,
which the encoder masks, so each row equals its segment run alone through
``forward_model`` with the same noise row.

Per-segment seeds are not kept: each chunk draws its start noise from one
stream, seeded from ``(seed, bucket * 4099 + chunk number)``, and each
vocoder group its source noise from ``(seed, length)``.

Up to :data:`MAX_IN_FLIGHT` chunks are in flight: chunk ``c + 1`` is stacked
and enqueued before chunk ``c`` is fetched.  The inputs go to the card from
pinned host memory without blocking, and each result comes back the same way
behind a CUDA event, which the host waits on only when it drains a chunk.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import generator_from_seed
from .acoustic import DiffSingerAcousticInfer, _bucket

MAX_IN_FLIGHT = 4       # chunks enqueued and not yet fetched
FRAMES_PER_CALL = 49152
MAX_ROWS = 64


def plan_chunks(lengths: Sequence[int], max_group_size: Optional[int] = None
                ) -> List[Tuple[int, int, List[int]]]:
    """``(bucket, chunk number, segment indices)`` of every chunk, in the
    order they run: by bucket, each bucket's segments in input order, cut at
    ``max_group_size`` rows (default ``min(64, 49152 // bucket)``)."""
    groups: Dict[int, List[int]] = defaultdict(list)
    for i, n in enumerate(lengths):
        groups[_bucket(n)].append(i)
    plan = []
    for padded_len, idxs in sorted(groups.items()):
        cap = max_group_size or min(MAX_ROWS, max(1, FRAMES_PER_CALL // padded_len))
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


class DataParallelSynthesizer:
    """Run many ``.ds`` segments through the acoustic model in bucket batches.

    >>> infer = DiffSingerAcousticInfer(cfg)
    >>> dp = DataParallelSynthesizer(infer)
    >>> mels, f0s = dp.synthesize_mels(segments)
    >>> wavs = dp.vocode(mels, f0s)
    """

    def __init__(self, infer: DiffSingerAcousticInfer):
        self.infer = infer

    def _to_device(self, v: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        t = torch.tensor(np.asarray(v), dtype=dtype)
        if self.infer.device.type != "cuda":
            return t.to(self.infer.device)
        # pinned, so the copy leaves the host free to stack the next chunk
        return t.pin_memory().to(self.infer.device, non_blocking=True)

    def _inputs(self, stacked: Dict[str, np.ndarray]) -> dict:
        """``synthesize``'s keyword inputs of a stacked chunk, as
        ``forward_model`` builds them for one segment."""
        long, f32 = torch.long, torch.float32
        out = {"tokens": self._to_device(stacked["tokens"], long),
               "mel2ph": self._to_device(stacked["mel2ph"], long),
               "f0": self._to_device(stacked["f0"], f32)}
        for k in ("key_shift", "speed"):
            if k in stacked:
                out[k] = self._to_device(stacked[k], f32)
        if self.infer.variances_to_embed:
            out["variances"] = {v: self._to_device(stacked[v], f32)
                                for v in self.infer.variances_to_embed}
        if "spk_mix_id" in stacked:
            out["spk_mix_id"] = self._to_device(stacked["spk_mix_id"], long)
            out["spk_mix_value"] = self._to_device(stacked["spk_mix_value"], f32)
        return out

    def _fetch(self, mel: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start the copy of a chunk's mel to the host; the event marks its end."""
        if mel.device.type != "cuda":
            return mel, None
        host = torch.empty(mel.shape, dtype=mel.dtype, pin_memory=True)
        host.copy_(mel, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def synthesize_mels(self, segments: Sequence[dict], seed: int = 0,
                        max_group_size: Optional[int] = None,
                        batches: Optional[List[dict]] = None,
                        noise: Optional[Dict[Tuple[int, int], np.ndarray]] = None):
        """``segments``: ``.ds`` segment dicts.  Returns ``(mels, f0s)`` in
        input order: ``mels[i]`` ``[T_i, M]``, ``f0s[i]`` ``[T_i]``.  Pass
        ``batches`` to reuse preprocessed inputs.  ``noise``, keyed by
        ``(bucket, chunk number)``, replaces a chunk's start noise ``[rows,
        1, bucket, M]``."""
        infer = self.infer
        if batches is None:
            batches = [infer.preprocess_input(p, idx=i) for i, p in enumerate(segments)]
        lengths = [int(b["mel2ph"].shape[1]) for b in batches]
        mels: List[Optional[np.ndarray]] = [None] * len(batches)
        f0s: List[Optional[np.ndarray]] = [None] * len(batches)

        def drain(chunk, host, done):
            if done is not None:
                done.synchronize()
            out = host.numpy()
            for row, i in enumerate(chunk):
                mels[i] = out[row, :lengths[i]].copy()
                f0s[i] = np.asarray(batches[i]["f0"])[0, :lengths[i]]

        pending = []
        for padded_len, chunk_no, chunk in plan_chunks(lengths, max_group_size):
            inputs = self._inputs(stack_chunk([batches[i] for i in chunk], padded_len))
            if noise is not None and (padded_len, chunk_no) in noise:
                inputs["noise"] = self._to_device(noise[padded_len, chunk_no], torch.float32)
            else:
                inputs["generator"] = generator_from_seed(
                    seed, infer.device, salt=padded_len * 4099 + chunk_no)
            # enqueue chunk c + 1 before fetching chunk c; drain the oldest at the limit
            pending.append((chunk, *self._fetch(infer.synthesize(**inputs))))
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
