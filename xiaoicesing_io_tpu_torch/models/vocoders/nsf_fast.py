"""Time-folded NSF-HiFiGAN apply: the JAX package's default vocoder layout.

Counterpart of ``xiaoicesing_io_tpu/models/vocoders/nsf_fast.py``.  The stock
generator's late stages run ``[B, T, C]`` with ``T`` up to a million samples
and ``C`` 64, 32, 16.  This layout runs the same parameters on ``[B, T/F,
F*C]``, with ``F`` chosen so that ``F*C >= min_lanes``: every convolution's
weights are folded once (numpy, exact copies of the taps) into an equivalent
convolution over the folded rows,

    out[t, co] = sum_tau x[t + tau*d - p, ci] W[tau, ci, co],  t = r*F + f
    -> a stride-1 conv with taps [k', F*C_in, F*C_out] and a left pad in rows.

Transposed convs become k=2 sub-pixel convs whose output fold is ``u *
F_in``; a change of fold is a contiguous reshape (:func:`refold`); the
sample-rate source convs fold by ``stride * F``.  Zero padding in folded rows
equals zero padding in samples, so the f32 result is the stock generator's
up to summation order.

The activations stay channels-last, ``[B, R, F*C]``, around every
:func:`refold` and every resblock kernel call, and are transposed to ``[B,
F*C, R]`` only for ``F.conv1d``.  ResBlock1 stages listed in
``pallas_stages`` run ``ops/cuda/hifigan_stage.py:fused_resblock_stage``
(K2) on stacked folded taps; every other ResBlock1 unit runs
``ops/cuda/hifigan_resblock.py:resblock_unit`` (K6).  Both are their CUDA
kernels on the card and their plain versions on the CPU; their weights are
made once here, and each kernel keeps the K-major copies of the taps that
are not all zero, built at its first launch, on those weight tensors
(``ops/cuda/sm90.py:kept_on``).  ResBlock2 units,
for which the JAX package has no kernel, are ``F.conv1d`` on either device.

The weights come from the port's stock :class:`Generator` (the reference
state-dict names); :func:`conv_taps` and :func:`conv_transpose_taps` turn
its torch layouts into the ``[k, C_in, C_out]`` taps the folding takes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.cuda.hifigan_resblock import prepare_unit_weights, resblock_unit
from ...ops.cuda.hifigan_stage import ConvSpec, fused_resblock_stage, stack_taps
from .nsf_hifigan import Generator, fast_sine_gen, leaky_relu

# ---------------------------------------------------------------------------
# weight folding (numpy)
# ---------------------------------------------------------------------------


def conv_taps(weight) -> np.ndarray:
    """torch ``Conv1d`` weight ``[C_out, C_in, k]`` -> taps ``[k, C_in, C_out]``."""
    w = weight.detach().float().cpu().numpy() if torch.is_tensor(weight) else np.asarray(weight)
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def conv_transpose_taps(weight) -> np.ndarray:
    """torch ``ConvTranspose1d`` weight ``[C_in, C_out, k]`` -> taps ``[k, C_in,
    C_out]`` in plain-conv orientation: ``W[j] = w[:, :, k - 1 - j]``."""
    w = weight.detach().float().cpu().numpy() if torch.is_tensor(weight) else np.asarray(weight)
    return np.ascontiguousarray(w.transpose(2, 0, 1)[::-1])


def _fold_generic(W: np.ndarray, b: Optional[np.ndarray], F_in: int, F_out: int,
                  s_logical: Callable[[int, int], Optional[int]]):
    """``W`` ``[k, C_in, C_out]``; ``s_logical(f_out, tau)`` is the logical
    input offset of tap ``tau`` for output phase ``f_out``, relative to
    ``r * F_in`` (None: the tap does not apply).  Returns ``(W2 [k2,
    F_in*C_in, F_out*C_out], b2 [F_out*C_out], pad_left_rows)``."""
    k, C_in, C_out = W.shape
    entries = []
    for f in range(F_out):
        for tau in range(k):
            o = s_logical(f, tau)
            if o is not None:
                q, g = divmod(o, F_in)
                entries.append((q, g, tau, f))
    qmin = min(e[0] for e in entries)
    k2 = max(e[0] for e in entries) - qmin + 1
    W2 = np.zeros((k2, F_in * C_in, F_out * C_out), W.dtype)
    for q, g, tau, f in entries:
        W2[q - qmin, g * C_in:(g + 1) * C_in, f * C_out:(f + 1) * C_out] += W[tau]
    b2 = np.tile(b, F_out) if b is not None else np.zeros(F_out * C_out, W.dtype)
    return W2, b2, -qmin


def fold_conv(W: np.ndarray, b: Optional[np.ndarray], F: int, dilation: int = 1,
              stride: int = 1, pad_l: Optional[int] = None):
    """A (strided, dilated) conv folded to ``F`` output phases; its input fold
    is ``F * stride``, so the folded conv has stride 1.  ``pad_l`` defaults to
    torch SAME, ``(k - 1) * dilation // 2``.  Returns ``(W2, b2, pad_left_rows,
    dilation)``; with ``F == stride == 1`` the native (dilated) conv is kept."""
    k = W.shape[0]
    if pad_l is None:
        pad_l = (k - 1) * dilation // 2
    if F == 1 and stride == 1:
        b2 = np.array(b) if b is not None else np.zeros(W.shape[2], W.dtype)
        return W, b2, pad_l, dilation

    def s_logical(f, tau):
        return f * stride + tau * dilation - pad_l

    W2, b2, pad_rows = _fold_generic(W, b, F * stride, F, s_logical)
    return W2, b2, pad_rows, 1


def fold_conv_transpose(W: np.ndarray, b: Optional[np.ndarray], u: int, F_in: int):
    """``ConvTranspose1d(k=2u, stride=u, padding=(k-u)//2)`` with plain-conv
    taps ``W`` (:func:`conv_transpose_taps`) folded to ``F_out = u * F_in``
    output phases: ``out[t] = W[j] x[s]`` with ``s*u = t + j - (k-1-p)``.
    Returns ``(W2, b2, pad_left_rows, 1)``."""
    k = W.shape[0]
    off = k - 1 - (k - u) // 2

    def s_logical(f, j):
        num = f + j - off
        return None if num % u else num // u

    W2, b2, pad_rows = _fold_generic(W, b, F_in, u * F_in, s_logical)
    return W2, b2, pad_rows, 1


def refold(x: torch.Tensor, F_from: int, F_to: int) -> torch.Tensor:
    """``[B, R, F_from*C]`` -> ``[B, R*F_from/F_to, F_to*C]`` (a contiguous reshape)."""
    if F_from == F_to:
        return x
    B, R, FC = x.shape
    C = FC // F_from
    total = R * F_from
    assert total % F_to == 0
    return x.reshape(B, total // F_to, F_to * C)


# ---------------------------------------------------------------------------
# the folded generator
# ---------------------------------------------------------------------------

class _Conv:
    """One folded conv in ``F.conv1d``'s layout: weight ``[C_out', C_in', k']``
    and bias in the compute dtype, the left pad and the dilation."""

    def __init__(self, folded, dtype, device):
        W2, b2, self.pad_l, self.dilation = folded
        self.span = (W2.shape[0] - 1) * self.dilation
        self.weight = torch.from_numpy(np.ascontiguousarray(W2.transpose(2, 1, 0))).to(
            device=device, dtype=dtype)
        self.bias = torch.from_numpy(np.asarray(b2)).to(device=device, dtype=dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[B, R, C_in']`` -> ``[B, R, C_out']`` in the weight's dtype."""
        x = F.pad(x.to(self.weight.dtype).transpose(1, 2), (self.pad_l, self.span - self.pad_l))
        return F.conv1d(x, self.weight, dilation=self.dilation).transpose(1, 2) + self.bias


class FastNsfHifigan:
    """Folded-layout apply over a port :class:`Generator`'s weights, folded
    once in ``dtype`` on ``device``.

    ``pallas_stages`` lists the ResBlock1 stages whose resblock group runs as
    one K2 call (the name is the JAX package's); every other ResBlock1 unit
    is one K6 call.  ``min_lanes`` is the least folded width ``F*C``."""

    def __init__(self, generator: Generator, dtype=torch.bfloat16, min_lanes: int = 128,
                 pallas_stages: Sequence[int] = (), device=None):
        h = self.h = generator.config
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else \
            next(generator.parameters()).device
        self.pallas_stages = tuple(pallas_stages)
        num_stages = len(h.upsample_rates)
        if self.pallas_stages and h.resblock != "1":
            raise ValueError("pallas_stages: the fused stage kernel takes ResBlock1 stages only")
        if any(not 0 <= i < num_stages for i in self.pallas_stages):
            raise ValueError(f"pallas_stages {self.pallas_stages}: the generator has "
                             f"{num_stages} stages")
        self.num_k = len(h.resblock_kernel_sizes)
        dev = self.device

        def conv(folded):
            return _Conv(folded, dtype, dev)

        def wb(module):
            b = module.bias.detach().float().cpu().numpy() if module.bias is not None else None
            return conv_taps(module.weight), b

        self.conv_pre = conv(fold_conv(*wb(generator.conv_pre), 1))
        self.ups, self.noise_convs, self.stages = [], [], []
        self.source_conv = None
        ch = h.upsample_initial_channel
        F_prev = 1
        for i, u in enumerate(h.upsample_rates):
            ch //= 2
            F_stage = max(1, min_lanes // ch)
            up = generator.ups[i]
            self.ups.append(conv(fold_conv_transpose(
                conv_transpose_taps(up.weight), up.bias.detach().float().cpu().numpy(), u,
                F_prev)))
            if not h.mini_nsf:
                if i + 1 < num_stages:
                    sf = int(np.prod(h.upsample_rates[i + 1:]))
                    # strided conv k=2sf, stride sf, pad sf//2, from the sample rate
                    folded = fold_conv(*wb(generator.noise_convs[i]), F_stage, stride=sf,
                                       pad_l=sf // 2)
                else:
                    sf = 1
                    folded = fold_conv(*wb(generator.noise_convs[i]), F_stage, pad_l=0)
                self.noise_convs.append((conv(folded), F_stage * sf))
            elif i == 1:
                self.source_conv = (conv(fold_conv(*wb(generator.source_conv), F_stage,
                                                   pad_l=0)), F_stage)
            units = []
            for j in range(self.num_k):
                block = generator.resblocks[i * self.num_k + j]
                if h.resblock == "1":
                    branch = []
                    for c1, c2 in zip(block.convs1, block.convs2):
                        f1 = fold_conv(*wb(c1), F_stage, dilation=c1.dilation[0])
                        f2 = fold_conv(*wb(c2), F_stage)
                        branch.append((f1, f2))
                else:
                    branch = [conv(fold_conv(*wb(c), F_stage, dilation=c.dilation[0]))
                              for c in block.convs]
                units.append(branch)
            self.stages.append(self._stage(i, units, u * F_prev, F_stage))
            F_prev = F_stage
        self.F_out = F_prev
        self.conv_post = conv(fold_conv(*wb(generator.conv_post), F_prev))
        if not h.mini_nsf:
            lin = generator.m_source.l_linear
            self.source_w = [float(v) for v in lin.weight.detach().cpu().double()[0]]
            self.source_b = float(lin.bias.detach().cpu()[0])

    def _stage(self, i: int, units, F_after_up: int, F_stage: int) -> dict:
        """Stage ``i``'s folds and its resblock weights in the form its
        implementation takes: K2's stacked taps, K6's unit taps, or convs."""
        stage = {"F_after_up": F_after_up, "F": F_stage}
        if self.h.resblock != "1":
            stage["convs"] = units
        elif i in self.pallas_stages:
            weights, biases, specs = [], [], []
            for branch in units:
                pairs = []
                for f1, f2 in branch:
                    for W2, b2, _, _ in (f1, f2):
                        weights.append(stack_taps(W2).to(self.device, self.dtype).contiguous())
                        biases.append(torch.from_numpy(np.asarray(b2)).to(
                            self.device, torch.float32).contiguous())
                    pairs.append(tuple(ConvSpec(k=f[0].shape[0], d=f[3], pad_l=f[2])
                                       for f in (f1, f2)))
                specs.append(tuple(pairs))
            stage["fused"] = (tuple(weights), tuple(biases), tuple(specs))
        else:
            stage["units"] = [
                [(prepare_unit_weights(f1[0], f1[1], f2[0], f2[1], self.dtype, self.device),
                  dict(d1=f1[3], pad1_l=f1[2], d2=f2[3], pad2_l=f2[2])) for f1, f2 in branch]
                for branch in units
            ]
        return stage

    # -- forward -------------------------------------------------------------

    def source(self, f0: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The harmonic source at the sample rate, ``[B, T*upp, 1]`` f32.  The
        full NSF source is built lane-packed as ``[B, T, upp]``: initial phases
        (harmonic 0 fixed) and then the noise are drawn from ``generator``;
        the per-harmonic noise, merged by the source linear, is one draw
        scaled by the weights' 2-norm (the same distribution).  No generator:
        no noise, deterministic."""
        h = self.h
        f0 = f0.float()
        if h.mini_nsf:
            # the reference's mini-NSF source is deterministic
            source_sr = h.sampling_rate / int(np.prod(h.upsample_rates[2:]))
            return fast_sine_gen(f0, int(np.prod(h.upsample_rates[:2])), source_sr)
        upp = int(np.prod(h.upsample_rates))
        dev = f0.device
        n = torch.arange(1, upp + 1, dtype=torch.float32, device=dev)
        rad = f0[..., None] / h.sampling_rate * n  # [B, T, upp]
        rad2 = torch.fmod(rad[..., -1:] + 0.5, 1.0) - 0.5
        rad_acc = torch.fmod(torch.cumsum(rad2, dim=1), 1.0)
        rad = rad + F.pad(rad_acc[:, :-1, :], (0, 0, 1, 0))
        uv = (f0 > 0).float()[..., None]
        harmonics = len(self.source_w)
        if generator is not None:
            rand_ini = torch.rand(harmonics, generator=generator, device=dev)
            rand_ini[0] = 0.0
        else:
            rand_ini = torch.zeros(harmonics, device=dev)
        merged = torch.zeros_like(rad)
        for hm, w in enumerate(self.source_w):
            merged = merged + w * torch.sin(2 * np.pi * ((hm + 1) * rad + rand_ini[hm]))
        merged = 0.1 * uv * merged
        if generator is not None:
            noise_amp = uv * 0.003 + (1.0 - uv) * (0.1 / 3.0)
            w_norm = float(np.linalg.norm(self.source_w))
            merged = merged + w_norm * noise_amp * torch.randn(rad.shape, generator=generator,
                                                               device=dev)
        har = torch.tanh(merged + self.source_b)
        return har.reshape(har.shape[0], -1, 1)

    def _resblocks(self, stage: dict, x: torch.Tensor) -> torch.Tensor:
        if "fused" in stage:
            return fused_resblock_stage(x.contiguous(), *stage["fused"])
        acc = None
        if "units" in stage:
            x = x.contiguous()
            for branch in stage["units"]:
                hblk = x
                for weights, geometry in branch:
                    hblk = resblock_unit(hblk, *weights, **geometry)
                acc = hblk if acc is None else acc + hblk
        else:
            for branch in stage["convs"]:
                hblk = x
                for c in branch:
                    hblk = hblk + c(leaky_relu(hblk))
                acc = hblk if acc is None else acc + hblk
        return acc / self.num_k

    @torch.no_grad()
    def __call__(self, mel: torch.Tensor, f0: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel ``[B, T, M]`` (natural-log), f0 ``[B, T]`` Hz on the vocoder's
        device -> wav ``[B, T*hop]`` f32."""
        h = self.h
        har = self.source(f0, generator)
        B, Ts, _ = har.shape
        x = self.conv_pre(mel)  # F = 1
        for i, stage in enumerate(self.stages):
            x = self.ups[i](leaky_relu(x))  # fold F_after_up
            x = refold(x, stage["F_after_up"], stage["F"])
            if not h.mini_nsf:
                conv, fold = self.noise_convs[i]
                x = x + conv(har.reshape(B, Ts // fold, fold))[:, :x.shape[1]]
            elif i == 1:
                conv, fold = self.source_conv
                x = x + conv(har.reshape(B, Ts // fold, fold))[:, :x.shape[1]]
            x = self._resblocks(stage, x)
        x = self.conv_post(leaky_relu(x, 0.01))  # [B, R, F_out]
        x = torch.tanh(x.float())
        return x.reshape(B, -1)
