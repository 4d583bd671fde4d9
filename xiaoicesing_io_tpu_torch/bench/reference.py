"""The bench's plain f32 reference: a cell's whole computation, written apart
from the program.

It reads the experiment's checkpoint files (the acoustic
``model_ckpt_steps_*.ckpt`` and the vocoder ``model.ckpt`` with its
``config.json``) and computes with plain ``torch`` functions on f32 tensors,
using none of the port's modules, runner, cores or samplers:

* the condition: token and duration embeddings, the pre-LN transformer
  encoder with RoPE and conv FFNs, frames gathered by ``mel2ph``, the
  continuous f0 embedding;
* the ConvNeXt aux decoder's mel, the shallow-diffusion source;
* the sampler: rectified flow with Euler steps from ``T_start_infer``, or
  DDPM from ``K_step_infer`` on DiffSinger's linear schedule with DDIM steps
  of ``diff_speedup``, over the LYNXNet or the WaveNet denoiser;
* the NSF-HiFiGAN generator in its stock layout, its harmonic source drawn
  as the program draws it: the initial phases (harmonic 0 at 0), then one
  noise draw ``[B, T, hop]`` scaled by the merge weights' 2-norm.

It covers what the bench's cells configure and raises for anything else.
``bits`` rounds both operands of every product (linear, convolution,
attention) to that many stored mantissa bits, keeping f32's exponent range
and f32 accumulation: the lower-precision control that the bench's bars
must reject (``bits=3`` is the mantissa of fp8 e4m3).
"""

from __future__ import annotations

import contextlib
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

CONTROL_BITS = 3  # fp8 e4m3's mantissa


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"the bench's reference does not compute {what}")


def round_mantissa(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """f32 ``x`` with its mantissa rounded (half away from zero) to ``bits``
    stored bits; ``None`` (or 23, f32's own) leaves it as it is."""
    if bits is None or bits >= 23:
        return x
    shift = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    return ((i + (1 << (shift - 1))) & -(1 << shift)).view(torch.float32)


def segment_generator(seed: int, device, salt: int) -> torch.Generator:
    """The stream a song segment's seed names: salt 0 the sampler's start
    noise, salt 1 the vocoder's source (the runner's per-segment seeds).
    On the card the seed is ``(seed << 8) | salt``; on the CPU, whose
    generator keeps only the low 32 bits of its seed, splitmix64's finaliser
    of ``(seed << 32) | salt``."""
    seed = int(seed) & 0xFFFFFFFF
    if torch.device(device).type == "cuda":
        value = (seed << 8) | salt
    else:
        mask = (1 << 64) - 1
        value = (seed << 32) | salt
        value = (value ^ (value >> 30)) * 0xBF58476D1CE4E5B9 & mask
        value = (value ^ (value >> 27)) * 0x94D049BB133111EB & mask
        value ^= value >> 31
    g = torch.Generator(device=device)
    g.manual_seed(value)
    return g


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32 (no TF32) for the length of the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _leaky(x, slope):
    return torch.where(x >= 0, x, slope * x)


def _ln(x, w, name, eps):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"], w[name + ".bias"], eps)


def _step_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary positions on adjacent pairs of ``[B, heads, T, D]``."""
    D, T = x.shape[-1], x.shape[-2]
    inv = 10000.0 ** (-torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    pairs = x.reshape(*x.shape[:-1], D // 2, 2)
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).reshape(x.shape)


class Reference:
    """The reference of the experiment ``cfg`` names, on ``device``."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device, self.bits = cfg, torch.device(device), None
        ckpts = sorted(Path(cfg["work_dir"]).glob("model_ckpt_steps_*.ckpt"))
        _need(len(ckpts) == 1, f"a work_dir with {len(ckpts)} checkpoints")
        state = torch.load(ckpts[0], map_location="cpu", weights_only=True)
        self.w = {k.removeprefix("model.").replace(".in_proj_weight", ".in_proj.weight"):
                  v.float().to(self.device) for k, v in state["state_dict"].items()}
        voc = Path(cfg["vocoder_ckpt"])
        self.h = json.loads(voc.with_name("config.json").read_text())
        vstate = torch.load(voc, map_location="cpu", weights_only=True)
        vstate = vstate.get("generator", vstate)
        _need(not any(k.endswith("weight_g") for k in vstate), "weight-normed vocoder weights")
        self.v = {k: v.float().to(self.device) for k, v in vstate.items()}
        self._rounded = {}

    def at_bits(self, bits: Optional[int]) -> "Reference":
        """The same weights, with products at ``bits`` mantissa bits."""
        other = object.__new__(Reference)
        other.__dict__.update(self.__dict__, bits=bits, _rounded={})
        return other

    # -- products --------------------------------------------------------------

    def _r(self, x):
        return round_mantissa(x, self.bits)

    def _weight(self, d: dict, name: str) -> torch.Tensor:
        key = (id(d), name)
        if key not in self._rounded:
            self._rounded[key] = self._r(d[name])
        return self._rounded[key]

    def _linear(self, x, d, name):
        """A ``Linear`` or a 1x1 ``Conv1d`` on feature-last ``x``."""
        w = self._weight(d, name + ".weight")
        return F.linear(self._r(x), w[:, :, 0] if w.dim() == 3 else w, d.get(name + ".bias"))

    def _conv(self, x, d, name, **kw):
        """A ``Conv1d`` on ``[B, C, T]``."""
        return F.conv1d(self._r(x), self._weight(d, name + ".weight"), d.get(name + ".bias"),
                        **kw)

    def _conv_same(self, x, d, name, dilation=1, groups=1):
        k = d[name + ".weight"].shape[-1]
        total = (k - 1) * dilation
        return self._conv(F.pad(x, (total // 2, total - total // 2)), d, name,
                          dilation=dilation, groups=groups)

    # -- the condition -----------------------------------------------------------

    def condition(self, tokens, mel2ph, f0) -> torch.Tensor:
        cfg, w = self.cfg, self.w
        _need(cfg.get("use_pos_embed", True) and cfg.get("use_rope", False), "an encoder "
              "without RoPE")
        _need(not cfg.get("use_spk_id", False), "speaker embeddings")
        _need((cfg.get("f0_embed_type") or "continuous") == "continuous", "a discrete f0 embed")
        _need(cfg.get("ffn_act", "gelu") == "gelu", "an FFN activation other than GELU")
        H, heads = cfg["hidden_size"], cfg["num_heads"]
        B, n = tokens.shape
        pad = tokens == 0
        keep = (~pad).float()[..., None]
        dur = torch.zeros(B, n + 1, device=tokens.device).scatter_add_(
            1, mel2ph, torch.ones(mel2ph.shape, device=tokens.device))[:, 1:]
        x = w["fs2.txt_embed.weight"][tokens] * math.sqrt(H) \
            + self._linear(dur[..., None], w, "fs2.dur_embed")
        x = x * keep
        layers = sum(k.endswith(".layer_norm1.weight") for k in w if k.startswith("fs2."))
        for i in range(layers):
            p = f"fs2.encoder.layers.{i}.op."
            x = (x + self._attention(_ln(x, w, p + "layer_norm1", 1e-5), pad, p + "self_attn",
                                     heads)) * keep
            h = self._conv_same(_ln(x, w, p + "layer_norm2", 1e-5).transpose(1, 2), w,
                                p + "ffn.ffn_1").transpose(1, 2)
            h = F.gelu(h * w[p + "ffn.ffn_1.weight"].shape[-1] ** -0.5)
            x = (x + self._linear(h, w, p + "ffn.ffn_2")) * keep
        x = _ln(x, w, "fs2.encoder.layer_norm", 1e-5) * keep
        frames = torch.cat([torch.zeros_like(x[:, :1]), x], dim=1)
        frames = frames[torch.arange(B, device=x.device)[:, None], mel2ph]
        f0_mel = torch.log(1.0 + f0.float() / 700.0)
        return frames + self._linear(f0_mel[..., None], w, "fs2.pitch_embed")

    def _attention(self, x, pad, name, heads):
        B, T, C = x.shape
        D = C // heads
        q, k, v = (y.reshape(B, T, heads, D).transpose(1, 2)
                   for y in self._linear(x, self.w, name + ".in_proj").chunk(3, dim=-1))
        q, k = _rope(q), _rope(k)
        scores = self._r(q) @ self._r(k).transpose(-1, -2) / math.sqrt(D)
        scores = scores.masked_fill(pad[:, None, None, :], torch.finfo(torch.float32).min)
        out = self._r(torch.softmax(scores, dim=-1)) @ self._r(v)
        return self._linear(out.transpose(1, 2).reshape(B, T, C), self.w, name + ".out_proj")

    def aux(self, cond) -> torch.Tensor:
        """The ConvNeXt aux decoder's normalised-domain mel ``[B, T, M]``."""
        shallow = self.cfg.get("shallow_diffusion_args", {})
        _need(shallow.get("aux_decoder_arch", "convnext") == "convnext", "that aux decoder")
        w, p = self.w, "aux_decoder.decoder."
        x = self._conv_same(cond.transpose(1, 2), w, p + "inconv")
        blocks = sum(k.startswith(p + "conv.") and k.endswith(".dwconv.weight") for k in w)
        for i in range(blocks):
            q = f"{p}conv.{i}."
            h = self._conv_same(x, w, q + "dwconv", groups=x.shape[1]).transpose(1, 2)
            h = self._linear(F.gelu(self._linear(_ln(h, w, q + "norm", 1e-6), w, q + "pwconv1")),
                             w, q + "pwconv2")
            x = x + (w[q + "gamma"] * h).transpose(1, 2)
        return self._conv_same(x, w, p + "outconv").transpose(1, 2)

    # -- the denoisers -----------------------------------------------------------

    @property
    def _net(self) -> str:
        return "diffusion.denoise_fn." if self.cfg.get("diffusion_type", "ddpm") == "ddpm" \
            else "diffusion.velocity_fn."

    @property
    def _wavenet(self) -> bool:
        kind = self.cfg.get("backbone_type", "lynxnet")
        _need(kind in ("lynxnet", "wavenet"), f"a {kind} denoiser")
        return kind == "wavenet"

    def _layers(self) -> int:
        p = self._net + "residual_layers."
        return sum(k.startswith(p) and k.endswith(".diffusion_projection.weight")
                   for k in self.w)

    def cond_projections(self, cond):
        p = self._net + "residual_layers."
        return [self._linear(cond, self.w, f"{p}{i}.conditioner_projection")
                for i in range(self._layers())]

    def denoise(self, x, t, projs) -> torch.Tensor:
        """``x`` ``[B, T, M]``, steps ``t`` ``[B]`` -> ``[B, T, M]``."""
        w, p = self.w, self._net
        args = self.cfg.get("backbone_args", {})
        C = w[p + "input_projection.weight"].shape[0]
        h = self._linear(x, w, p + "input_projection")
        if self._wavenet:
            h = F.relu(h)
            step = self._linear(_step_embedding(t, C), w, p + "mlp.0")
            step = self._linear(step * torch.tanh(F.softplus(step)), w, p + "mlp.2")
            skip = 0.0
            cycle = args.get("dilation_cycle_length", 4)
            for i, proj in enumerate(projs):
                q = f"{p}residual_layers.{i}."
                d = 2 ** (i % cycle)
                y = h + self._linear(step, w, q + "diffusion_projection")[:, None]
                y = self._conv_same(y.transpose(1, 2), w, q + "dilated_conv",
                                    dilation=d).transpose(1, 2) + proj
                y = self._linear(torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:]), w,
                                 q + "output_projection")
                h = (h + y[..., :C]) / math.sqrt(2.0)
                skip = skip + y[..., C:]
            h = F.relu(self._linear(skip / math.sqrt(len(projs)), w, p + "skip_projection"))
            return self._linear(h, w, p + "output_projection")
        _need(args.get("activation", "PReLU") == "PReLU", "a LYNXNet without PReLU")
        strong = args.get("strong_cond", False)
        if not strong:
            h = F.gelu(h)
        step = self._linear(F.gelu(self._linear(_step_embedding(t, C), w,
                                                p + "diffusion_embedding.1")),
                            w, p + "diffusion_embedding.3")
        for i, proj in enumerate(projs):
            q = f"{p}residual_layers.{i}."
            res = h + proj if strong else h
            h = h + proj
            h = h + self._linear(step, w, q + "diffusion_projection")[:, None]
            m = q + "convmodule.net."
            y = self._linear(_ln(h, w, m + "0", 1e-5), w, m + "2")
            out, gate = y.chunk(2, dim=-1)
            y = (out * gate * torch.sigmoid(gate)).transpose(1, 2)
            k = w[m + "4.weight"].shape[-1]
            y = self._conv(F.pad(y, (k // 2, k // 2 - (k + 1) % 2)), w, m + "4",
                           groups=y.shape[1])
            y = torch.where(y >= 0, y, w[m + "5.weight"][:, None] * y).transpose(1, 2)
            h = self._linear(y, w, m + "6") + res
        return self._linear(_ln(h, w, p + "norm", 1e-5), w, p + "output_projection")

    # -- the sampler -------------------------------------------------------------

    @torch.no_grad()
    def mel(self, tokens, mel2ph, f0, noise) -> torch.Tensor:
        """Masked mel ``[B, T, M]`` from the start noise ``noise`` ``[B, 1, T, M]``."""
        cfg = self.cfg
        _need(cfg.get("use_shallow_diffusion", False), "a sampler without shallow diffusion")
        with exact_f32():
            cond = self.condition(tokens, mel2ph, f0)
            mask = (mel2ph > 0).float()[..., None]
            src = self.aux(cond) * mask
            projs = self.cond_projections(cond)
            B = tokens.shape[0]

            def steps_of(t):
                return torch.full((B,), float(t), dtype=torch.float32, device=src.device)

            x = noise[:, 0].float()
            if cfg.get("diffusion_type", "ddpm") == "reflow":
                _need(cfg.get("sampling_algorithm", "euler") == "euler", "that ODE solver")
                t0 = cfg.get("T_start_infer", cfg["T_start"])
                n = cfg.get("sampling_steps", 20)
                scale = cfg.get("time_scale_factor", 1000)
                dt = (1.0 - t0) / n
                x = t0 * src + (1.0 - t0) * x
                for i in range(n):
                    x = x + self.denoise(x, steps_of(np.float32(t0 + i * dt)) * scale,
                                         projs) * dt
            else:
                _need(cfg.get("schedule_type", "linear") == "linear", "that noise schedule")
                _need(cfg.get("diff_accelerator", "ddim") == "ddim", "that DDPM sampler")
                # DiffSinger builds its linear schedule without the configured
                # max_beta: betas run from 1e-4 to 0.01
                a = np.cumprod(1.0 - np.linspace(1e-4, 0.01, cfg.get("timesteps", 1000)))
                depth = min(cfg.get("K_step_infer", cfg["K_step"]), cfg["K_step"])
                _need(depth < len(a), "a sampler from pure noise")
                every = cfg.get("diff_speedup", 10)
                x = float(np.sqrt(a[depth - 1])) * src + float(np.sqrt(1 - a[depth - 1])) * x
                for t in range(depth - 1 - (depth - 1) % every, -1, -every):
                    a_t, a_prev = a[t], a[max(t - every, 0)]
                    eps = self.denoise(x, steps_of(t), projs)
                    x0 = (x - float(np.sqrt(1 - a_t)) * eps) / float(np.sqrt(a_t))
                    x = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(1 - a_prev)) * eps
            smin = torch.tensor(cfg.get("spec_min", [-12.0]), dtype=torch.float32,
                                device=x.device)
            smax = torch.tensor(cfg.get("spec_max", [0.0]), dtype=torch.float32,
                                device=x.device)
            return ((x + 1.0) / 2.0 * (smax - smin) + smin) * mask

    # -- the vocoder -------------------------------------------------------------

    def _source(self, f0, generator):
        h, v = self.h, self.v
        upp = int(np.prod(h["upsample_rates"]))
        f0 = f0.float()
        rad = f0[..., None] / h["sampling_rate"] \
            * torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
        wrap = torch.fmod(rad[..., -1:] + 0.5, 1.0) - 0.5
        rad = rad + F.pad(torch.fmod(torch.cumsum(wrap, dim=1), 1.0)[:, :-1], (0, 0, 1, 0))
        weights = v["m_source.l_linear.weight"][0]
        phase = torch.zeros(len(weights), device=f0.device)
        if generator is not None:
            phase = torch.rand(len(weights), generator=generator, device=f0.device)
            phase[0] = 0.0
        voiced = (f0 > 0).float()[..., None]
        merged = sum(weights[i] * torch.sin(2 * np.pi * ((i + 1) * rad + phase[i]))
                     for i in range(len(weights))) * 0.1 * voiced
        if generator is not None:
            amp = voiced * 0.003 + (1.0 - voiced) * (0.1 / 3.0)
            merged = merged + torch.linalg.vector_norm(weights) * amp \
                * torch.randn(rad.shape, generator=generator, device=f0.device)
        har = torch.tanh(merged + v["m_source.l_linear.bias"][0])
        return har.reshape(har.shape[0], 1, -1)

    @torch.no_grad()
    def wav(self, mel, f0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel ``[B, T, M]``, f0 ``[B, T]`` -> wav ``[B, T * hop]``; the source
        noise from ``generator`` (none without one)."""
        h, v = self.h, self.v
        _need(str(h["resblock"]) == "1" and not h.get("mini_nsf", False),
              "a ResBlock2 or mini-NSF vocoder")
        mel = mel.float()
        if self.cfg.get("mel_base", 10) != "e":
            mel = 2.30259 * mel
        rates, sizes = h["upsample_rates"], h["upsample_kernel_sizes"]
        blocks = list(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
        with exact_f32():
            har = self._source(f0, generator)
            x = self._conv(mel.transpose(1, 2), v, "conv_pre", padding=3)
            for i, (u, k) in enumerate(zip(rates, sizes)):
                x = F.conv_transpose1d(self._r(_leaky(x, 0.1)),
                                       self._weight(v, f"ups.{i}.weight"), v[f"ups.{i}.bias"],
                                       stride=u, padding=(k - u) // 2)
                sf = int(np.prod(rates[i + 1:]))
                noise = self._conv(har, v, f"noise_convs.{i}", stride=sf, padding=sf // 2) \
                    if i + 1 < len(rates) else self._conv(har, v, f"noise_convs.{i}")
                x = x + noise[..., :x.shape[-1]]
                acc = 0.0
                for j, (kr, dils) in enumerate(blocks):
                    r, p = x, f"resblocks.{i * len(blocks) + j}."
                    for n, d in enumerate(dils):
                        y = self._conv(_leaky(r, 0.1), v, f"{p}convs1.{n}", dilation=d,
                                       padding=(kr - 1) * d // 2)
                        r = r + self._conv(_leaky(y, 0.1), v, f"{p}convs2.{n}",
                                           padding=(kr - 1) // 2)
                    acc = acc + r
                x = acc / len(blocks)
            x = self._conv(_leaky(x, 0.01), v, "conv_post", padding=3)
            return torch.tanh(x)[:, 0]


def place(segments, offsets, sr: int) -> np.ndarray:
    """Segment wavs placed at their offsets (seconds): silence fills a gap,
    a linear crossfade covers an overlap."""
    song = np.zeros(0)
    for wav, offset in zip(segments, offsets):
        start = round(offset * sr)
        if start >= len(song):
            song = np.concatenate([song, np.zeros(start - len(song)), wav])
            continue
        overlap = len(song) - start
        fade = np.linspace(0.0, 1.0, num=overlap)
        mixed = (1 - fade) * song[start:] + fade * wav[:overlap]
        song = np.concatenate([song[:start], mixed, wav[overlap:]])
    return song
