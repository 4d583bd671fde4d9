"""Variance inference: score -> durations, pitch and variance curves -> ``.ds``.

Counterpart of the JAX package's ``inference/variance.py``:
``preprocess_input`` (words from ``ph_num``, notes with rests filled from
the nearest note, ``mel2note`` and word durations from the rounded
cumulative note durations, the smoothed base pitch, phoneme-level MIDI,
``expr``, speaker mixes), the per-segment flags of auto-completion, the
rhythm-regulated duration head, the pitch and multi-variance diffusion
heads, and the write-back into the ``.ds`` JSON.

Segments are padded exactly as the JAX runner pads them (frames to
multiples of 256, tokens and notes to multiples of 32, with its pad values):
the encoders and the heads' dilated convs read the padded positions, and
the noise is drawn over the padded shape.

A WaveNet head runs ``wavenet_denoiser_apply``: bf16 with the
residual-block kernel (K4) on the card, f32 with its plain version on the
CPU, where it matches the f32 modules the JAX runner runs.  Any other head
runs its f32 module.  The start noise of the two heads comes in through
``noise=`` (the tests hand the port the JAX runner's arrays), else from a
``torch.Generator`` per head seeded from the segment's seed.
"""

from __future__ import annotations

import copy
import json
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compat import get_backbone_type
from ..models.backbones.wavenet_cuda import (
    wavenet_cond_projections, wavenet_denoiser_apply, wavenet_kernel_weights,
)
from ..models.diffusion.core import GaussianDiffusion, RectifiedFlow
from ..models.diffusion.schedule import DiffusionSchedule
from ..models.toplevel import (
    VARIANCE_CHECKLIST, VarianceModel, build_variance_normalizers, load_variance_state_dict,
)
from ..ops.seq import length_regulator, mel2ph_to_dur, rhythm_regulator
from ..training.checkpoint import load_model_state_dict
from ..utils import fresh_seed, generator_from_seed, resolve_device
from ..utils.curves import interp_f0, resample_align_curve, smooth_curve
from ..utils.music import hz_to_midi, midi_to_hz, note_to_midi
from ..utils.phonemes import PhonemeDictionary, locate_dictionary
from ..utils.text_encoder import TokenTextEncoder
from .base import BaseSVSInfer, speaker_mix_embed


def _lr_np(dur: np.ndarray, out_len: Optional[int] = None) -> np.ndarray:
    total = int(dur.sum(axis=1).max())
    return length_regulator(torch.from_numpy(np.asarray(dur, np.int64)),
                            out_len=total if out_len is None else out_len).numpy()


def _dur_np(mel2x: np.ndarray, n: int) -> np.ndarray:
    return mel2ph_to_dur(torch.from_numpy(np.asarray(mel2x, np.int64)), n).numpy()


def build_variance_cores(cfg):
    """DDPM over all ``timesteps`` (no shallow start), or rectified flow
    from t = 0."""
    if cfg.get("diffusion_type", "ddpm") == "ddpm":
        timesteps = cfg.get("timesteps", 1000)
        schedule = DiffusionSchedule.create(cfg.get("schedule_type", "linear"), timesteps)
        return GaussianDiffusion(schedule=schedule, timesteps=timesteps, k_step=timesteps)
    return RectifiedFlow(t_start=0.0, time_scale_factor=cfg.get("time_scale_factor", 1000))


# the dtypes of batch arrays as tensors (any other key: f32)
BATCH_TYPES = {"tokens": torch.long, "ph2word": torch.long, "word_dur": torch.long,
               "midi": torch.long, "ph_dur": torch.long, "mel2ph": torch.long,
               "mel2note": torch.long, "note_dur": torch.long, "note_glide": torch.long,
               "note_rest": torch.bool, "spk_mix_id": torch.long, "ph_spk_mix_id": torch.long,
               "spk_ids": torch.long, "uv": torch.bool}


def load_variance_model(cfg, vocab_size: int, ckpt_steps=None, device="cpu") -> VarianceModel:
    """The variance model of ``cfg`` with the weights of the work dir's
    latest (or ``ckpt_steps``') checkpoint, on ``device``, in eval mode."""
    model = VarianceModel.from_config(cfg, vocab_size)
    load_variance_state_dict(model, load_model_state_dict(cfg["work_dir"], cfg, "variance",
                                                          ckpt_steps))
    return model.to(device).eval()


def head_kernel_weights(cfg, heads: Dict[str, torch.nn.Module], compute_dtype):
    """Each WaveNet head's K4 weights (``wavenet_kernel_weights``), by head
    name: the heads that run ``wavenet_denoiser_apply``."""
    return {head: wavenet_kernel_weights(backbone, compute_dtype)
            for head, backbone in heads.items()
            if get_backbone_type(cfg, cfg.get(f"{head}_prediction_args", {})) == "wavenet"}


def head_denoiser(backbone, cond, kernel_weights, compute_dtype):
    """A head's denoiser ``(x, t) -> f32``: ``wavenet_denoiser_apply`` on
    its prepared K4 weights (bf16 with the kernel on the card, f32 with its
    plain version on the CPU), or the f32 module where ``kernel_weights`` is
    None."""
    if kernel_weights is None:
        return lambda x, t: backbone(x, t, cond).float()
    cond_projs = wavenet_cond_projections(backbone, cond, compute_dtype)
    return lambda x, t: wavenet_denoiser_apply(
        backbone, x, t, cond_projs=cond_projs, kernel_weights=kernel_weights,
        compute_dtype=compute_dtype).float()


class DiffSingerVarianceInfer(BaseSVSInfer):
    def __init__(self, cfg, predictions: Optional[set] = None, ckpt_steps=None, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)
        predictions = predictions or set()
        phdict = PhonemeDictionary.load(
            locate_dictionary(cfg.get("dictionary"), cfg.get("work_dir"))
        )
        self.ph_encoder = TokenTextEncoder(phdict.phoneme_list)
        self.model = load_variance_model(cfg, self.ph_encoder.vocab_size, ckpt_steps,
                                         self.device)
        self.core = build_variance_cores(cfg)
        self.normalizers = build_variance_normalizers(cfg)
        self.smooth_width = round(cfg["midi_smooth_width"] / self.timestep)

        glide_types = cfg.get("glide_types", [])
        assert "none" not in glide_types, (
            "Type name 'none' is reserved and should not appear in glide_types."
        )
        self.glide_map = {"none": 0, **{t: i + 1 for i, t in enumerate(glide_types)}}

        self.auto_completion_mode = len(predictions) == 0
        self.global_predict_dur = "dur" in predictions and cfg["predict_dur"]
        self.global_predict_pitch = "pitch" in predictions and cfg["predict_pitch"]
        self.variance_prediction_set = predictions.intersection(VARIANCE_CHECKLIST)
        self.global_predict_variances = len(self.variance_prediction_set) > 0

        # each WaveNet head's kernel weights, prepared once
        self.compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.kernel_weights = head_kernel_weights(cfg, self.heads(), self.compute_dtype)

    def heads(self) -> Dict[str, torch.nn.Module]:
        """The denoisers of the model: ``pitch`` and ``variances`` by name."""
        out = {}
        if self.model.predict_pitch:
            out["pitch"] = self.model.pitch_backbone
        if self.model.predict_variances:
            out["variances"] = self.model.variance_backbone
        return out

    # -- preprocessing --------------------------------------------------------

    def preprocess_input(self, param, idx=0, load_dur=False, load_pitch=False):
        cfg = self.cfg
        batch: Dict[str, np.ndarray] = {}
        summary = OrderedDict()
        tokens = np.asarray([self.ph_encoder.encode(param["ph_seq"].split())], np.int32)
        T_ph = tokens.shape[1]
        batch["tokens"] = tokens
        ph_num = np.asarray([param["ph_num"].split()], np.int64)
        ph2word = _lr_np(ph_num)[:, :T_ph]
        if ph2word.shape[1] < T_ph:
            ph2word = np.pad(ph2word, [(0, 0), (0, T_ph - ph2word.shape[1])])
        T_w = int(ph2word.max())
        batch["ph2word"] = ph2word

        note_midi = np.array(
            [note_to_midi(n, round_midi=False) if n != "rest" else -1
             for n in param["note_seq"].split()],
            dtype=np.float32,
        )
        note_rest = note_midi < 0
        if np.all(note_rest):
            note_midi = np.full_like(note_midi, 60.0)
        else:  # each rest takes the nearest note's pitch
            idx_known = np.where(~note_rest)[0]
            idx_rest = np.where(note_rest)[0]
            nearest = idx_known[np.abs(idx_rest[:, None] - idx_known[None, :]).argmin(axis=1)]
            note_midi[idx_rest] = note_midi[nearest]
        T_n = len(note_midi)

        note_dur_sec = np.asarray([param["note_dur"].split()], np.float32)
        note_acc = np.round(np.cumsum(note_dur_sec, axis=1) / self.timestep + 0.5).astype(
            np.int64)
        note_dur = np.diff(note_acc, axis=1, prepend=0)
        mel2note = _lr_np(note_dur)
        T_s = mel2note.shape[1]

        summary["words"] = T_w
        summary["notes"] = T_n
        summary["tokens"] = T_ph
        summary["frames"] = T_s
        summary["seconds"] = "%.2f" % (T_s * self.timestep)

        if cfg.get("use_spk_id", False):
            batch["ph_spk_mix_id"], batch["ph_spk_mix_value"] = self.load_speaker_mix(
                param, summary, mix_mode="token", mix_length=T_ph)
            batch["spk_mix_id"], batch["spk_mix_value"] = self.load_speaker_mix(
                param, summary, mix_mode="frame", mix_length=T_s)

        if load_dur:
            ph_dur_sec = np.asarray([param["ph_dur"].split()], np.float32)
            ph_acc = np.round(np.cumsum(ph_dur_sec, axis=1) / self.timestep + 0.5).astype(
                np.int64)
            ph_dur = np.diff(ph_acc, axis=1, prepend=0) * (tokens != 0)
            mel2ph = _lr_np(ph_dur)
            if mel2ph.shape[1] != T_s:
                if mel2ph.shape[1] < T_s:
                    mel2ph = np.pad(mel2ph, [(0, 0), (0, T_s - mel2ph.shape[1])], mode="edge")
                else:
                    mel2ph = mel2ph[:, :T_s]
                ph_dur = _dur_np(mel2ph, T_ph)
            word_dur = np.zeros((1, T_w + 1), np.int64)
            np.add.at(word_dur[0], ph2word[0], ph_dur[0])
            word_dur = word_dur[:, 1:]
        else:
            ph_dur = None
            mel2ph = None
            is_slur = np.asarray([[int(s) for s in param["note_slur"].split()]], bool)
            note2word = np.cumsum(~is_slur, axis=1)
            word_dur = np.zeros((1, T_w + 1), np.int64)
            np.add.at(word_dur[0], note2word[0], note_dur[0])
            word_dur = word_dur[:, 1:]

        batch["ph_dur"] = ph_dur
        batch["mel2ph"] = mel2ph

        mel2word = _lr_np(word_dur)
        if mel2word.shape[1] != T_s:
            if mel2word.shape[1] < T_s:
                mel2word = np.pad(mel2word, [(0, 0), (0, T_s - mel2word.shape[1])], mode="edge")
            else:
                mel2word = mel2word[:, :T_s]
            word_dur = _dur_np(mel2word, T_w)
        batch["word_dur"] = word_dur

        batch["note_midi"] = note_midi[None]
        batch["note_dur"] = note_dur
        batch["note_rest"] = note_rest[None]
        if cfg.get("use_glide_embed", False) and param.get("note_glide") is not None:
            batch["note_glide"] = np.asarray(
                [[self.glide_map.get(x, 0) for x in param["note_glide"].split()]], np.int32)
        else:
            batch["note_glide"] = np.zeros((1, T_n), np.int32)
        batch["mel2note"] = mel2note

        # the frame-level MIDI step curve, smoothed
        frame_midi = np.take(np.pad(note_midi, (1, 0)), mel2note[0])
        base_pitch = smooth_curve(frame_midi.astype(np.float32), self.smooth_width)
        batch["base_pitch"] = base_pitch[None]

        if ph_dur is not None:  # each phoneme's mean MIDI
            mel2pdur = np.take(np.pad(ph_dur[0], (1, 0), constant_values=1), mel2ph[0])
            ph_midi = np.zeros(T_ph + 1, np.float32)
            np.add.at(ph_midi, mel2ph[0], frame_midi / mel2pdur)
            ph_midi = ph_midi[1:]
        else:  # each word's mean MIDI, for its phonemes
            mel2wdur = np.take(np.pad(word_dur[0], (1, 0), constant_values=1), mel2word[0])
            w_midi = np.zeros(T_w + 1, np.float32)
            np.add.at(w_midi, mel2word[0], frame_midi / mel2wdur)
            w_midi = w_midi[1:]
            ph_midi = np.take(np.pad(w_midi, (1, 0)), ph2word[0])
        batch["midi"] = np.round(ph_midi).astype(np.int32)[None]

        if load_pitch:
            f0 = resample_align_curve(
                np.array(param["f0_seq"].split(), np.float32),
                original_timestep=float(param["f0_timestep"]),
                target_timestep=self.timestep,
                align_length=T_s,
            )
            batch["pitch"] = hz_to_midi(interp_f0(f0)[0]).astype(np.float32)[None]

        if cfg["predict_dur"]:
            summary["ph_dur"] = (
                "manual" if load_dur
                else "auto" if self.auto_completion_mode or self.global_predict_dur
                else "ignored"
            )
        if cfg["predict_pitch"]:
            if load_pitch:
                summary["pitch"] = "manual"
            elif self.auto_completion_mode or self.global_predict_pitch:
                summary["pitch"] = "auto"
                expr = param.get("expr", 1.0)
                if isinstance(expr, (int, float, bool)):
                    summary["expr"] = f"static({expr:.3f})"
                    batch["expr"] = np.full((1, T_s), expr, np.float32)
                else:
                    summary["expr"] = "dynamic"
                    batch["expr"] = resample_align_curve(
                        np.array(expr.split(), np.float32),
                        original_timestep=float(param["expr_timestep"]),
                        target_timestep=self.timestep,
                        align_length=T_s,
                    )[None]
            else:
                summary["pitch"] = "ignored"
        for v_name in self.model.variance_prediction_list:
            if (self.auto_completion_mode and param.get(v_name) is None) \
                    or v_name in self.variance_prediction_set:
                summary[v_name] = "auto"
            else:
                summary[v_name] = "ignored"

        print(f"[{idx}]\t" + ", ".join(f"{k}: {v}" for k, v in summary.items()))
        return batch

    # -- model forward --------------------------------------------------------

    @staticmethod
    def _pad_batch(batch, fb: int = 256, tb: int = 32):
        """Pad as the JAX runner pads: frames to multiples of ``fb``, tokens
        and notes to multiples of ``tb``.  -> (padded batch, frames, tokens)."""
        def up(n, m):
            return ((n + m - 1) // m) * m

        T_s = batch["mel2note"].shape[1] if batch.get("mel2note") is not None \
            else batch["mel2ph"].shape[1]
        T_ph = batch["tokens"].shape[1]
        out = dict(batch)
        pads = {"mel2ph": 0, "mel2note": 0, "base_pitch": "edge", "pitch": "edge",
                "expr": "edge", "spk_mix_value": "edge"}  # frame level
        for k in ("tokens", "ph2word", "midi", "ph_dur"):
            v = batch.get(k)
            if v is not None and v.shape[1] == T_ph:
                out[k] = np.pad(v, [(0, 0), (0, up(T_ph, tb) - T_ph)])
        v = batch.get("ph_spk_mix_value")  # a dynamic token-level mix [1, T_ph, N]
        if v is not None and v.ndim == 3 and v.shape[1] == T_ph and T_ph > 1:
            out["ph_spk_mix_value"] = np.pad(v, [(0, 0), (0, up(T_ph, tb) - T_ph), (0, 0)],
                                             mode="edge")
        for k, mode in pads.items():
            v = batch.get(k)
            if v is not None and v.ndim >= 2 and v.shape[1] == T_s:
                pad = [(0, 0), (0, up(T_s, fb) - T_s)] + [(0, 0)] * (v.ndim - 2)
                out[k] = np.pad(v, pad, mode="edge" if mode == "edge" else "constant")
        for k in ("note_midi", "note_dur", "note_rest", "note_glide"):
            v = batch.get(k)
            if v is not None:
                T_n = v.shape[1]
                pad = [(0, 0), (0, up(T_n, tb) - T_n)]
                if k == "note_midi":
                    out[k] = np.pad(v, pad, constant_values=-1.0)
                elif k == "note_rest":
                    out[k] = np.pad(v, pad, constant_values=True)
                else:
                    out[k] = np.pad(v, pad)
        return out, T_s, T_ph

    @torch.no_grad()
    def forward_model(self, batch, flags: Tuple[bool, bool, bool], seed: int = 0,
                      noise: Optional[Dict[str, np.ndarray]] = None,
                      _f32_module: bool = False):
        """Pad, predict, crop.  ``flags`` are (dur, pitch, variances) as
        :meth:`segment_flags` gives them.  ``noise`` maps a head (``pitch``,
        ``variances``) to its start noise over the padded shape; a head
        without one draws it from ``seed``.  ``_f32_module`` runs every head's
        f32 module in place of its kernel path (the reference that
        ``chip_smoke.py`` holds K4 to).  -> (durations ``[1, T_ph]`` int or
        None, pitch ``[1, T_s]`` in MIDI or None, {name: ``[1, T_s]``} in
        name order)."""
        batch, T_s_real, T_ph_real = self._pad_batch(batch)
        dev = self.device
        tensors = {k: None if v is None else torch.as_tensor(
            np.asarray(v), dtype=BATCH_TYPES.get(k, torch.float32), device=dev)
            for k, v in batch.items()}
        dur, pitch, variances = self._forward_padded(tensors, flags, seed, noise or {},
                                                     _f32_module)
        if dur is not None:
            dur = dur[:, :T_ph_real].cpu().numpy()
        if pitch is not None:
            pitch = pitch[:, :T_s_real].cpu().numpy()
        # the curves in name order, as the JAX runner's compiled forward returns them
        return dur, pitch, {k: v[:, :T_s_real].cpu().numpy()
                            for k, v in sorted(variances.items())}

    def _forward_padded(self, batch, flags, seed, noise, f32_module):
        predict_dur, predict_pitch, predict_variances = flags
        model = self.model

        ph_spk_mix_embed = spk_mix_embed = None
        if self.cfg.get("use_spk_id", False):
            table = model.spk_embed.weight
            ph_spk_mix_embed = speaker_mix_embed(table, batch["ph_spk_mix_id"],
                                                 batch["ph_spk_mix_value"])
            spk_mix_embed = speaker_mix_embed(table, batch["spk_mix_id"], batch["spk_mix_value"])

        ph2word, word_dur = batch["ph2word"], batch["word_dur"]
        T_s = batch["base_pitch"].shape[1]
        encoder_out, dur_pred = model.encode(
            batch["tokens"], batch["midi"], ph2word, ph_dur=batch["ph_dur"], word_dur=word_dur,
            ph_spk_mix_embed=ph_spk_mix_embed, infer=True)
        dur_out = rhythm_regulator(dur_pred, ph2word, word_dur) if predict_dur else None
        if not predict_pitch and not predict_variances:
            return dur_out, None, {}

        mel2ph = batch["mel2ph"]
        if mel2ph is None:
            mel2ph = length_regulator(rhythm_regulator(dur_pred, ph2word, word_dur), out_len=T_s)
        condition = model.frame_condition(encoder_out, mel2ph, spk_mix_embed=spk_mix_embed)

        base_pitch, pitch = batch["base_pitch"], batch.get("pitch")
        pitch_out = None
        if predict_pitch:
            cond = model.pitch_condition(
                condition, mel2ph, base_pitch, pitch_expr=batch.get("expr"),
                note_midi=batch["note_midi"], note_rest=batch["note_rest"],
                note_dur=batch["note_dur"], note_glide=batch["note_glide"],
                mel2note=batch["mel2note"])
            bins = self.cfg.get("pitch_prediction_args", {}).get("repeat_bins", 64)
            x = self._sample("pitch", cond, (1, 1, T_s, bins), seed, 0, noise, f32_module)
            pitch_out = base_pitch + self.normalizers["pitch"].denorm(x)

        variances_out = {}
        if predict_variances:
            if pitch is None:
                pitch = pitch_out
            cond = model.variance_condition(condition, pitch, {})
            names = model.variance_prediction_list
            bins = self.cfg.get("variances_prediction_args", {}).get("total_repeat_bins", 48)
            x = self._sample("variances", cond, (1, len(names), T_s, bins // len(names)), seed,
                             1, noise, f32_module)
            out = self.normalizers["variances"].denorm(x)
            variances_out = dict(zip(names, [out] if len(names) == 1 else out))
        return dur_out, pitch_out, variances_out

    def _sample(self, head, cond, shape, seed, salt, noise, f32_module):
        """One head's sampler from its start noise (``noise[head]``, else
        drawn from the segment's seed and the head's ``salt``); returns the
        model-domain ``x``."""
        cfg, dev = self.cfg, self.device
        denoise_fn = head_denoiser(self.heads()[head], cond,
                                   None if f32_module else self.kernel_weights.get(head),
                                   self.compute_dtype)
        generator = None
        start = noise.get(head)
        if start is not None:
            start = torch.tensor(np.asarray(start, np.float32), device=dev)
        else:
            generator = generator_from_seed(seed, dev, salt=salt)
        if isinstance(self.core, GaussianDiffusion):
            return self.core.inference(
                denoise_fn, shape, depth=cfg.get("K_step_infer", self.core.k_step),
                speedup=cfg.get("diff_speedup", 10),
                algorithm=cfg.get("diff_accelerator", "ddim"),
                noise=start, generator=generator, device=dev)
        return self.core.inference(
            denoise_fn, shape, t_start=0.0, steps=cfg.get("sampling_steps", 20),
            algorithm=cfg.get("sampling_algorithm", "euler"),
            noise=start, generator=generator, device=dev)

    # -- a whole .ds ----------------------------------------------------------

    def segment_flags(self, param) -> Tuple[bool, bool, bool]:
        """(predict durations, pitch, variances) for one segment: in
        auto-completion mode what the segment lacks, else what was asked
        for and what it needs."""
        model, cfg = self.model, self.cfg
        if self.auto_completion_mode:
            return (
                cfg["predict_dur"] and param.get("ph_dur") is None,
                cfg["predict_pitch"] and param.get("f0_seq") is None,
                model.predict_variances and any(
                    param.get(v) is None for v in model.variance_prediction_list),
            )
        predict_variances = model.predict_variances and self.global_predict_variances
        predict_pitch = cfg["predict_pitch"] and (
            self.global_predict_pitch or (param.get("f0_seq") is None and predict_variances))
        predict_dur = cfg["predict_dur"] and (
            self.global_predict_dur
            or (param.get("ph_dur") is None and (predict_pitch or predict_variances)))
        return predict_dur, predict_pitch, predict_variances

    def run_inference(self, params_list: List[dict], out_dir, title: str, num_runs: int = 1,
                      seed: int = -1, noise: Optional[List[dict]] = None) -> List[Path]:
        """Predict what each segment needs and write the ``.ds`` (durations to
        6 digits, f0 to 0.1 Hz, curves to 4 digits).  ``noise``, one dict per
        segment as in :meth:`forward_model`, replaces the drawn start noise
        (one run)."""
        flags = [self.segment_flags(p) for p in params_list]
        batches = [
            self.preprocess_input(p, idx=i, load_dur=not f[0] and (f[1] or f[2]),
                                  load_pitch=not f[1] and f[2])
            for i, (p, f) in enumerate(zip(params_list, flags))
        ]
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for run in range(num_runs):
            run_seed = seed if seed >= 0 else fresh_seed()
            results = []
            for i, (param, flag, batch) in enumerate(zip(params_list, flags, batches)):
                seg_seed = param.get("seed", run_seed + i)
                dur_pred, pitch_pred, variance_pred = self.forward_model(
                    batch, flag, seed=int(seg_seed), noise=None if noise is None else noise[i])
                out = copy.deepcopy(param)
                if dur_pred is not None and (self.auto_completion_mode
                                             or self.global_predict_dur):
                    durs = (dur_pred[0] * self.timestep).tolist()
                    out["ph_dur"] = " ".join(str(round(d, 6)) for d in durs)
                if pitch_pred is not None and (self.auto_completion_mode
                                               or self.global_predict_pitch):
                    f0 = midi_to_hz(pitch_pred[0])
                    out["f0_seq"] = " ".join(str(round(f, 1)) for f in f0.tolist())
                    out["f0_timestep"] = str(self.timestep)
                keep = {k: v for k, v in variance_pred.items()
                        if (self.auto_completion_mode and param.get(k) is None)
                        or k in self.variance_prediction_set}
                for v_name, v in keep.items():
                    out[v_name] = " ".join(str(round(float(x), 4)) for x in v[0])
                    out[f"{v_name}_timestep"] = str(self.timestep)
                results.append(out)
            name = f"{title}-{run:03d}.ds" if num_runs > 1 else f"{title}.ds"
            path = out_dir / name
            with open(path, "w", encoding="utf8") as f:
                print(f"| save params: {path}")
                json.dump(results, f, ensure_ascii=False, indent=2)
            paths.append(path)
        return paths
