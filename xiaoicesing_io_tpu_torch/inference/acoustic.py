"""Acoustic inference: ``.ds`` segments -> mel -> waveform.

Counterpart of the JAX package's ``DiffSingerAcousticInfer``:
``preprocess_input`` (tokens, ``mel2ph`` from the cumsum-rounded ``ph_dur``,
f0 resampled to the frame grid), per-segment seeds, 256-frame bucket padding,
the vocoder, and offset placement with zero fill or crossfade.

The segments are padded to 256-frame buckets exactly as the JAX runner pads
them: the depthwise convs of LYNXNet and of the ConvNeXt aux decoder and the
dilated convs of WaveNet reach into the padded frames, so the last frames of
a segment depend on the padding.

A LYNXNet denoiser with PReLU runs ``lynx_denoiser_apply`` and a WaveNet
denoiser ``wavenet_denoiser_apply``: in bf16 with the conv-module or the
residual-block kernel on the card, whatever the width (a kernel raises for a
width it does not take), and in f32 with the kernels' plain versions on the
CPU, where they match the f32 modules that the JAX package's CPU runner uses.
The JAX runner's ``wavenet_use_pallas`` key (a TPU tuning switch) is not
read: no config key switches a kernel off.  A DDPM core samples from depth
``K_step_infer`` with ``diff_accelerator`` (DDIM, PNDM, DPM-Solver++, UniPC)
at speedup ``diff_speedup``, a rectified-flow core with
``sampling_algorithm`` over ``sampling_steps``.

The encoder's optional inputs are read as the JAX runner reads them: with
``use_spk_id`` the segment's speaker mix (``inference/base.py``) summed over
the speaker embeddings; with ``use_{energy,breathiness,voicing,tension}_embed``
each curve resampled to the frame grid; with ``use_key_shift_embed`` the
``gender`` value or curve mapped onto ``augmentation_args.
random_pitch_shifting.range``; with ``use_speed_embed`` the ``velocity``
curve clipped to ``random_time_stretching.range`` (1 without one).  Frame
curves are zero-padded to the bucket, a dynamic speaker mix edge-padded.  A
config without these keys runs exactly the plain path.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..compat import get_backbone_type
from ..models.backbones.lynx_cuda import (
    lynx_cond_projections, lynx_denoiser_apply, lynx_kernel_weights,
)
from ..models.backbones.wavenet_cuda import (
    wavenet_cond_projections, wavenet_denoiser_apply, wavenet_kernel_weights,
)
from ..models.diffusion.core import GaussianDiffusion
from ..models.toplevel import VARIANCE_CHECKLIST, load_acoustic_state_dict
from ..ops.seq import length_regulator
from ..training.acoustic import build_acoustic
from ..training.checkpoint import load_model_state_dict
from ..utils import fresh_seed, generator_from_seed, resolve_device
from ..utils.curves import cross_fade, resample_align_curve
from ..utils.phonemes import PhonemeDictionary, locate_dictionary
from ..utils.text_encoder import TokenTextEncoder
from .base import BaseSVSInfer, speaker_mix_embed

BUCKET = 256  # frame bucket size for padding


def _bucket(n: int) -> int:
    return max(BUCKET, ((n + BUCKET - 1) // BUCKET) * BUCKET)


class DiffSingerAcousticInfer(BaseSVSInfer):
    def __init__(self, cfg, load_vocoder: bool = True, ckpt_steps=None, device=None):
        super().__init__(cfg)
        device = resolve_device(device)
        phdict = PhonemeDictionary.load(
            locate_dictionary(cfg.get("dictionary"), cfg.get("work_dir"))
        )
        self.ph_encoder = TokenTextEncoder(phdict.phoneme_list)
        model, core, normalizer = build_acoustic(cfg, self.ph_encoder.vocab_size)
        load_acoustic_state_dict(model, load_model_state_dict(cfg["work_dir"], cfg, "acoustic",
                                                              ckpt_steps))
        self._setup(model.to(device).eval(), core, normalizer)
        if load_vocoder:
            from ..models.vocoders import get_vocoder_cls

            self.vocoder = get_vocoder_cls(cfg.get("vocoder", "NsfHifiGAN"))(cfg, device=device)

    @classmethod
    def from_model(cls, cfg, model, core, normalizer) -> "DiffSingerAcousticInfer":
        """A runner over a model in memory, on the model's device, in the
        model's mode, without a phoneme encoder or vocoder (training's
        validation samples through it).  The kernels' weights are prepared
        from the model's parameters as they are now."""
        self = cls.__new__(cls)
        BaseSVSInfer.__init__(self, cfg)
        self.ph_encoder = None
        self._setup(model, core, normalizer)
        return self

    def _setup(self, model, core, normalizer) -> None:
        self.model, self.core, self.normalizer = model, core, normalizer
        self.device = next(model.parameters()).device
        self.variances_to_embed = [v for v in VARIANCE_CHECKLIST
                                   if self.cfg.get(f"use_{v}_embed", False)]
        self.compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.kernel_weights = None
        if self.use_kernels:
            prepare = wavenet_kernel_weights if self.backbone_type == "wavenet" \
                else lynx_kernel_weights
            self.kernel_weights = prepare(model.backbone, self.compute_dtype)
        self.vocoder = None

    @property
    def backbone_type(self) -> str:
        return get_backbone_type(self.cfg)

    @property
    def use_kernels(self) -> bool:
        """A WaveNet denoiser, and a LYNXNet denoiser with PReLU (the function
        the conv-module kernel computes), run their kernel-path apply: the
        kernel in bf16 on the card, its plain version in f32 on the CPU.  Any
        other denoiser runs its f32 module, as in the JAX runner."""
        if self.backbone_type == "wavenet":
            return True
        bargs = self.cfg.get("backbone_args", {})
        return (self.backbone_type == "lynxnet"
                and bargs.get("activation", "PReLU") == "PReLU")

    # -- preprocessing --------------------------------------------------------

    def preprocess_input(self, param: dict, idx: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        batch: Dict[str, np.ndarray] = {}
        summary = OrderedDict()
        tokens = np.asarray([self.ph_encoder.encode(param["ph_seq"])], np.int64)
        batch["tokens"] = tokens

        ph_dur = np.array(param["ph_dur"].split(), np.float32)
        ph_acc = np.round(np.cumsum(ph_dur) / self.timestep + 0.5).astype(np.int64)
        durations = np.diff(ph_acc, prepend=0)[None]
        durations = durations * (tokens != 0)
        length = int(durations.sum())
        batch["mel2ph"] = length_regulator(torch.from_numpy(durations), out_len=length).numpy()

        summary["tokens"] = tokens.shape[1]
        summary["frames"] = length
        summary["seconds"] = "%.2f" % (length * self.timestep)

        if cfg.get("use_spk_id", False):
            batch["spk_mix_id"], batch["spk_mix_value"] = self.load_speaker_mix(
                param_src=param, summary_dst=summary, mix_mode="frame", mix_length=length)

        def curve(key, timestep_key=None):
            return resample_align_curve(
                np.array(param[key].split(), np.float32),
                original_timestep=float(param[timestep_key or f"{key}_timestep"]),
                target_timestep=self.timestep,
                align_length=length,
            )

        batch["f0"] = curve("f0_seq", "f0_timestep")[None]
        for v_name in self.variances_to_embed:
            batch[v_name] = curve(v_name)[None]
            summary[v_name] = "manual"

        if cfg.get("use_key_shift_embed", False):
            shift_min, shift_max = cfg["augmentation_args"]["random_pitch_shifting"]["range"]
            gender = param.get("gender", 0.0)
            if gender is None:
                gender = 0.0
            if isinstance(gender, (int, float, bool)):
                summary["gender"] = f"static({gender:.3f})"
                val = gender * shift_max if gender >= 0 else gender * abs(shift_min)
                batch["key_shift"] = np.full((1, length), val, np.float32)
            else:
                summary["gender"] = "dynamic"
                gender_seq = curve("gender")
                mask = gender_seq >= 0
                key_shift = gender_seq * (mask * shift_max + (1 - mask) * abs(shift_min))
                batch["key_shift"] = np.clip(key_shift, shift_min, shift_max)[None]

        if cfg.get("use_speed_embed", False):
            if param.get("velocity") is None:
                summary["velocity"] = "default"
                batch["speed"] = np.full((1, length), 1.0, np.float32)
            else:
                summary["velocity"] = "manual"
                speed_min, speed_max = cfg["augmentation_args"]["random_time_stretching"]["range"]
                batch["speed"] = np.clip(curve("velocity"), speed_min, speed_max)[None]
        print(f"[{idx}]\t" + ", ".join(f"{k}: {v}" for k, v in summary.items()))
        return batch

    # -- model forward --------------------------------------------------------

    @torch.no_grad()
    def synthesize(self, tokens, mel2ph, f0, noise=None,
                   generator: Optional[torch.Generator] = None,
                   timings: Optional[dict] = None, key_shift=None, speed=None,
                   spk_mix_id=None, spk_mix_value=None, variances=None,
                   _f32_module: bool = False) -> torch.Tensor:
        """Tensors on the runner's device -> masked mel ``[B, T, M]`` (value
        domain).  ``noise`` is the sampler's start noise ``[B, 1, T, M]``;
        drawn from ``generator`` when None.  ``timings``, when given, receives
        host seconds of the condition + aux stage and of the sampler (both
        ended by a device synchronise).  ``key_shift``, ``speed`` ``[B, T]``,
        the speaker mix (ids ``[B, 1, N]``, proportions ``[B, T|1, N]``) and
        ``variances`` (name -> ``[B, T]``) are the encoder's optional inputs.
        ``_f32_module`` runs the denoiser's f32 module in place of its kernel
        path (the reference that ``chip_smoke.py`` holds the kernels to)."""
        cfg = self.cfg
        model = self.model
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        t0 = _now()
        spk_mix_embed = None if spk_mix_id is None \
            else speaker_mix_embed(model.fs2.spk_embed.weight, spk_mix_id, spk_mix_value)
        cond = model.condition(tokens, mel2ph, f0, key_shift=key_shift, speed=speed,
                               spk_mix_embed=spk_mix_embed, variances=variances)
        mask = (mel2ph > 0)[:, :, None]
        shape = (cond.shape[0], 1, cond.shape[1], cfg["audio_num_mel_bins"])
        x_src = None
        if cfg.get("use_shallow_diffusion", False):
            x_src = (model.aux_out(cond) * mask).float()[:, None]
        if timings is not None:
            sync()
            timings["cond_aux"] = _now() - t0
            t0 = _now()

        if self.use_kernels and not _f32_module:
            backbone = model.backbone
            cd = self.compute_dtype
            if self.backbone_type == "wavenet":
                projections, apply = wavenet_cond_projections, wavenet_denoiser_apply
            else:
                projections, apply = lynx_cond_projections, lynx_denoiser_apply
            cond_projs = projections(backbone, cond, cd)

            def denoise_fn(x, t):
                return apply(backbone, x, t, cond_projs=cond_projs,
                             kernel_weights=self.kernel_weights, compute_dtype=cd).float()
        else:
            def denoise_fn(x, t):
                return model.denoise(x, t, cond).float()

        core = self.core
        if isinstance(core, GaussianDiffusion):
            x = core.inference(
                denoise_fn, shape, x_start=x_src,
                depth=cfg.get("K_step_infer", core.k_step),
                speedup=cfg.get("diff_speedup", 10),
                algorithm=cfg.get("diff_accelerator", "ddim"),
                solver_order=cfg.get("dpm_solver_order", 2),
                unipc_variant=cfg.get("unipc_variant", "bh2"),
                noise=noise, generator=generator, device=self.device,
            )
        else:
            x = core.inference(
                denoise_fn, shape, x_end=x_src,
                t_start=cfg.get("T_start_infer", core.t_start),
                steps=cfg.get("sampling_steps", 20),
                algorithm=cfg.get("sampling_algorithm", "euler"),
                noise=noise, generator=generator, device=self.device,
            )
        mel = self.normalizer.denorm(x) * mask
        if timings is not None:
            sync()
            timings["sampler"] = _now() - t0
        return mel

    def forward_model(self, batch: Dict[str, np.ndarray], seed: int = 0,
                      noise: Optional[np.ndarray] = None,
                      _f32_module: bool = False) -> np.ndarray:
        """Pad to a frame bucket, synthesise, crop.  ``noise`` (``[1, 1,
        bucket, M]``) replaces the start noise drawn from ``seed``;
        ``_f32_module`` as in :meth:`synthesize`."""
        length = batch["mel2ph"].shape[1]
        padded_len = _bucket(length)
        dev = self.device

        def pad(v):
            v = np.asarray(v)
            return np.pad(v, [(0, 0), (0, padded_len - length)] + [(0, 0)] * (v.ndim - 2))

        tokens = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long, device=dev)
        mel2ph = torch.as_tensor(pad(batch["mel2ph"]), dtype=torch.long, device=dev)
        f0 = torch.as_tensor(pad(batch["f0"]), dtype=torch.float32, device=dev)
        inputs = {}
        for k in ("key_shift", "speed"):
            if k in batch:
                inputs[k] = torch.as_tensor(pad(batch[k]), dtype=torch.float32, device=dev)
        if self.variances_to_embed:
            inputs["variances"] = {
                v: torch.as_tensor(pad(batch[v]), dtype=torch.float32, device=dev)
                for v in self.variances_to_embed}
        if "spk_mix_id" in batch:
            value = np.asarray(batch["spk_mix_value"], np.float32)
            if value.shape[1] == length:  # a dynamic mix: its last proportions go on
                value = np.pad(value, [(0, 0), (0, padded_len - length), (0, 0)], mode="edge")
            inputs["spk_mix_id"] = torch.as_tensor(np.asarray(batch["spk_mix_id"]),
                                                   dtype=torch.long, device=dev)
            inputs["spk_mix_value"] = torch.as_tensor(value, device=dev)
        generator = None
        if noise is not None:
            noise = torch.tensor(np.asarray(noise, np.float32), device=dev)
        else:
            generator = generator_from_seed(seed, dev)
        mel = self.synthesize(tokens, mel2ph, f0, noise=noise, generator=generator,
                              _f32_module=_f32_module, **inputs)
        return mel[:, :length].cpu().numpy()

    def run_vocoder(self, mel: np.ndarray, f0: np.ndarray,
                    seed: Optional[int] = None) -> np.ndarray:
        """Vocode one segment; ``seed`` drives the NSF source noise."""
        return self.vocoder.spec2wav(mel[0], f0[0],
                                     generator=generator_from_seed(seed, self.device, salt=1))

    # -- a whole .ds ----------------------------------------------------------

    def run_inference(self, params: List[dict], out_dir, title: str, num_runs: int = 1,
                      seed: int = -1, save_mel: bool = False,
                      data_parallel: bool = False, devices=None) -> List[Path]:
        """``data_parallel=True`` synthesises the segments in bucket batches
        over ``devices`` (default: every visible card when the runner is on
        one, else the runner's device) and vocodes them in groups of equal
        length on the runner's device (serving mode,
        ``inference/serving.py``): per-segment seeds give way to one noise
        stream a chunk and a vocoder group."""
        batches = [self.preprocess_input(p, idx=i) for i, p in enumerate(params)]
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = ".wav" if not save_mel else ".mel.npz"
        sr = self.cfg["audio_sample_rate"]
        dp = None
        if data_parallel:
            from .serving import DataParallelSynthesizer

            dp = DataParallelSynthesizer(self, devices)
        paths = []
        for run in range(num_runs):
            run_seed = seed if seed >= 0 else fresh_seed()
            dp_mels = dp_wavs = None
            if dp is not None:
                dp_mels, dp_f0s = dp.synthesize_mels(params, seed=run_seed, batches=batches)
                if not save_mel:
                    dp_wavs = dp.vocode(dp_mels, dp_f0s, seed=run_seed)
            result = [] if save_mel else np.zeros(0)
            current_length = 0
            for i, (param, batch) in enumerate(zip(params, batches)):
                if dp_mels is not None:
                    mel_pred = dp_mels[i][None]
                else:
                    seg_seed = int(param.get("seed", run_seed + i))
                    mel_pred = self.forward_model(batch, seed=seg_seed)
                if save_mel:
                    result.append({"offset": param.get("offset", 0.0), "mel": mel_pred[0],
                                   "f0": np.asarray(batch["f0"])[0]})
                    continue
                wav = dp_wavs[i] if dp_wavs is not None else \
                    self.run_vocoder(mel_pred, np.asarray(batch["f0"]), seed=seg_seed)
                silent = round(param.get("offset", 0) * sr) - current_length
                if silent >= 0:
                    result = np.append(result, np.zeros(silent))
                    result = np.append(result, wav)
                else:
                    result = cross_fade(result, wav, current_length + silent)
                current_length = current_length + silent + wav.shape[0]
            name = f"{title}-{run:03d}{suffix}" if num_runs > 1 else title + suffix
            path = out_dir / name
            if save_mel:
                np.savez(path, **{f"seg{i}_{k}": v for i, d in enumerate(result)
                                  for k, v in d.items()})
                print(f"| save mel: {path}")
            else:
                from ..utils.audio import save_wav

                save_wav(result, path, sr)
                print(f"| save audio: {path}")
            paths.append(path)
        return paths


def _now() -> float:
    import time

    return time.perf_counter()


def load_ds(path) -> List[dict]:
    with open(path, "r", encoding="utf-8") as f:
        params = json.load(f)
    return params if isinstance(params, list) else [params]
