"""Evaluation of trained models over a binarized set.

Counterpart of the JAX package's ``eval/copy_synthesis.py``:

* :func:`evaluate_acoustic` runs each item through the acoustic runner's
  ``forward_model`` (``inference/acoustic.py``: the 256-frame bucket and the
  denoiser's kernel) with the set's ground-truth ``mel2ph``, f0 and
  conditioning, and scores the mel against the stored one (mel MAE, MCD);
  with shallow diffusion the aux decoder's mel too; with ``with_pesq`` the
  vocoded waveforms (PESQ*, waveform MCD);
* :func:`evaluate_variance` scores the duration head (rhythm correctness,
  phoneme duration accuracy, a tolerance sweep and word-sum errors) and the
  pitch head sampled under the validation condition
  (``training/variance.sample_variance_inference``) at 0.5 semitones over
  voiced frames.

Both run on CUDA unless ``device`` names another device.  Two differences
from the JAX package, by design: the port vocodes only an item's own
frames (rounded up to the 128-frame bucket), never the frames that
``pad_frames_to`` forces on top, which the JAX evaluation vocodes into its
waveform scores; and only a missing vocoder checkpoint falls back to
Griffin-Lim inversion, where the JAX evaluation falls back on any error.
The start noise comes from ``torch.Generator`` seeded per item (acoustic:
``seed + i``, as the runner seeds a segment; variance: item ``i``), or from
``noise``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils import generator_from_seed, resolve_device
from .metrics import mcd, mel_mae


def _checkpoint_step(work_dir) -> int:
    """The step of the checkpoint the runners load by default
    (``training/checkpoint.find_model_checkpoint``), -1 without one."""
    from ..training.checkpoint import find_model_checkpoint

    try:
        ck = find_model_checkpoint(work_dir)
    except FileNotFoundError:
        return -1
    return int(re.search(r"(\d+)", ck.name).group(1))


def _batch_from_item(cfg, infer, b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A collated batch of one item as the runner's ``forward_model`` input
    (``preprocess_input``'s layout); with speakers, the item's own speaker
    at weight 1."""
    batch = {"tokens": b["tokens"], "mel2ph": b["mel2ph"], "f0": b["f0"]}
    for v in infer.variances_to_embed:
        batch[v] = b[v]
    if cfg.get("use_key_shift_embed", False):
        batch["key_shift"] = b["key_shift"]
    if cfg.get("use_speed_embed", False):
        batch["speed"] = b["speed"]
    if cfg.get("use_spk_id", False):
        batch["spk_mix_id"] = b["spk_ids"].reshape(1, 1, 1).astype(np.int32)
        batch["spk_mix_value"] = np.ones((1, 1, 1), np.float32)
    return batch


@torch.no_grad()
def _aux_mel(infer, batch: Dict[str, np.ndarray]) -> np.ndarray:
    """The aux decoder's mel ``[1, T, M]`` of a collated batch, at the
    collated length (no runner bucket), masked to the item's frames."""
    from ..inference.base import speaker_mix_embed

    model, dev = infer.model, infer.device

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.asarray(batch[key]), dtype=dtype, device=dev)

    mel2ph = t("mel2ph", torch.long)
    kwargs = {k: t(k) for k in ("key_shift", "speed") if k in batch}
    if "spk_mix_id" in batch:
        kwargs["spk_mix_embed"] = speaker_mix_embed(
            model.fs2.spk_embed.weight, t("spk_mix_id", torch.long), t("spk_mix_value"))
    if infer.variances_to_embed:
        kwargs["variances"] = {v: t(v) for v in infer.variances_to_embed}
    cond = model.condition(t("tokens", torch.long), mel2ph, t("f0"), **kwargs)
    aux = model.aux_out(cond).float() * (mel2ph > 0)[:, :, None]
    return infer.normalizer.denorm(aux[:, None]).cpu().numpy()


def evaluate_acoustic(
    cfg, dataset: str = "valid", limit: Optional[int] = None, seed: int = 0,
    with_pesq: bool = False, ckpt_steps: Optional[int] = None,
    pad_frames_to: int = 0, pad_tokens_to: int = 0, device=None,
    noise: Optional[Sequence[np.ndarray]] = None,
) -> Dict:
    """The acoustic model over ``<binary_data_dir>/<dataset>``: per item
    (``items``) and mean mel MAE and MCD, the aux decoder's with shallow
    diffusion, and with ``with_pesq`` PESQ* and waveform MCD of the vocoded
    prediction against the vocoded ground truth (and of the vocoded aux
    mel, with the items each side wins); a ``per_speaker`` breakdown with
    speaker ids.  ``noise``, one array per item over the runner's bucket
    (``[1, 1, bucket, M]``), replaces the start noise drawn from ``seed +
    i``.  ``pad_frames_to`` / ``pad_tokens_to`` are the collator's minimum
    padded lengths."""
    from ..data.dataset import FRAME_BUCKET, AcousticDataset, _round_up
    from ..inference.acoustic import DiffSingerAcousticInfer
    from ..models.vocoders import get_vocoder_cls
    from ..ops.mel import MelConfig
    from .metrics import griffin_lim_from_logmel, pesq_approx

    device = resolve_device(device)
    infer = DiffSingerAcousticInfer(cfg, load_vocoder=False, ckpt_steps=ckpt_steps,
                                    device=device)
    vocoder_ckpt = cfg.get("vocoder_ckpt")
    griffin_lim = with_pesq and not (vocoder_ckpt and Path(vocoder_ckpt).exists())
    if griffin_lim:  # only a missing checkpoint: any error building the vocoder propagates
        print(f"| WARN: no vocoder checkpoint at {vocoder_ckpt!r}; waveform metrics use "
              "Griffin-Lim inversion (both arms share the same mel->wav map, so relative "
              "orderings remain meaningful)")
    elif with_pesq:
        infer.vocoder = get_vocoder_cls(cfg.get("vocoder", "NsfHifiGAN"))(cfg, device=device)
    mel_cfg = MelConfig.from_config(cfg)
    sr = cfg["audio_sample_rate"]

    def vocode(mel, f0, s):
        if griffin_lim:
            return griffin_lim_from_logmel(np.asarray(mel)[0], mel_cfg, seed=s)
        return np.asarray(infer.run_vocoder(mel, f0, seed=s))

    def wave_scores(wav_ref, wav):
        m = min(len(wav), len(wav_ref))
        return (float(pesq_approx(wav_ref[:m], wav[:m], sr)),
                float(mcd(wav_ref[:m], wav[:m], is_mel=False, mel_cfg=mel_cfg)))

    ds = AcousticDataset(cfg["binary_data_dir"], dataset, cfg)
    use_shallow = cfg.get("use_shallow_diffusion", False)
    names = ds.metadata.get("names", [str(i) for i in range(len(ds))])
    n = len(ds) if limit is None else min(limit, len(ds))
    if n <= 0:
        raise ValueError(
            f"nothing to evaluate: dataset '{dataset}' has {len(ds)} items, limit={limit}")
    items = []
    for i in range(n):
        b = ds.collate([i], pad_to_bucket=True, pad_frames_to=pad_frames_to,
                       pad_tokens_to=pad_tokens_to)
        gt = b["mel"]
        mask = b["mel2ph"][0] > 0
        batch = _batch_from_item(cfg, infer, b)
        pred = infer.forward_model(batch, seed=seed + i,
                                   noise=None if noise is None else noise[i])
        item = {"name": str(names[i]) if i < len(names) else str(i),
                "spk_id": int(b["spk_ids"].ravel()[0]) if "spk_ids" in b else None,
                "frames": int(mask.sum()),
                "mel_mae": float(mel_mae(pred[0][mask], gt[0][mask])),
                "mcd_db": float(mcd(pred[0][mask], gt[0][mask])),
                "aux_mae": None, "aux_mcd_db": None, "pesq": None, "wav_mcd_db": None,
                "aux_pesq": None, "aux_wav_mcd_db": None}
        # the item's own frames, to the collator's bucket: what the JAX
        # evaluation vocodes without pad_frames_to
        n_voc = _round_up(ds[i]["mel"].shape[0], FRAME_BUCKET)
        f0 = b["f0"][:, :n_voc]
        wav_gt = None
        if with_pesq:
            wav_gt = vocode(gt[:, :n_voc], f0, seed + i)
            item["pesq"], item["wav_mcd_db"] = wave_scores(
                wav_gt, vocode(pred[:, :n_voc], f0, seed + i))
        if use_shallow:
            aux = _aux_mel(infer, batch)
            item["aux_mae"] = float(mel_mae(aux[0][mask], gt[0][mask]))
            item["aux_mcd_db"] = float(mcd(aux[0][mask], gt[0][mask]))
            if with_pesq:
                item["aux_pesq"], item["aux_wav_mcd_db"] = wave_scores(
                    wav_gt, vocode(aux[:, :n_voc], f0, seed + i))
        items.append(item)

    def mean(key, group=items):
        return float(np.mean([it[key] for it in group]))

    out = {"step": int(ckpt_steps) if ckpt_steps is not None
           else _checkpoint_step(cfg["work_dir"]),
           "dataset": dataset, "items": items,
           "mean_mel_mae": mean("mel_mae"), "mean_mcd_db": mean("mcd_db")}
    if use_shallow:
        out["mean_aux_mae"] = mean("aux_mae")
        out["mean_aux_mcd_db"] = mean("aux_mcd_db")
    if with_pesq:
        out["mean_pesq"] = mean("pesq")
        out["mean_wav_mcd_db"] = mean("wav_mcd_db")
        if use_shallow:
            out["mean_aux_pesq"] = mean("aux_pesq")
            out["mean_aux_wav_mcd_db"] = mean("aux_wav_mcd_db")
            out["diff_pesq_wins_items"] = sum(1 for it in items if it["pesq"] > it["aux_pesq"])
            out["diff_wav_mcd_wins_items"] = sum(
                1 for it in items if it["wav_mcd_db"] < it["aux_wav_mcd_db"])
    if any(it["spk_id"] is not None for it in items):
        spk_names = {}
        spk_map_path = Path(cfg["binary_data_dir"]) / "spk_map.json"
        if spk_map_path.exists():
            spk_names = {v: k for k, v in json.loads(spk_map_path.read_text()).items()}
        per_spk = {}
        for it in items:
            per_spk.setdefault(it["spk_id"], []).append(it)
        out["per_speaker"] = {
            str(spk_names.get(sid, sid)): {
                "n_items": len(group),
                "mean_mel_mae": mean("mel_mae", group), "mean_mcd_db": mean("mcd_db", group),
                **({"mean_aux_mae": mean("aux_mae", group),
                    "mean_aux_mcd_db": mean("aux_mcd_db", group)} if use_shallow else {}),
            }
            for sid, group in sorted(per_spk.items())
        }
    return out


def evaluate_variance(
    cfg, dataset: str = "valid", limit: Optional[int] = None,
    ckpt_steps: Optional[int] = None, rhythm_tolerances=(0.05, 0.1, 0.2, 0.3),
    device=None, noise: Optional[Sequence[np.ndarray]] = None,
) -> Dict:
    """The variance model over ``<binary_data_dir>/<dataset>``: with
    ``predict_dur`` rhythm correctness at 5 % (and at each of
    ``rhythm_tolerances``), phoneme duration accuracy at 20 %, the median
    relative error of word sums and the word count; with ``predict_pitch``
    the sampled pitch's accuracy at 0.5 semitones over voiced frames.
    ``noise``, one pitch start noise ``[1, 1, T, bins]`` per item at the
    collated length, replaces the draw from item ``i``'s generator."""
    from ..data.dataset import VarianceDataset
    from ..inference.variance import (
        build_variance_cores, head_kernel_weights, load_variance_model,
    )
    from ..models.toplevel import build_variance_normalizers
    from ..training.metrics import PhonemeDurationAccuracy, RawCurveAccuracy, RhythmCorrectness
    from ..training.variance import batch_tensors, sample_variance_inference
    from ..utils.phonemes import PhonemeDictionary, locate_dictionary
    from ..utils.text_encoder import TokenTextEncoder

    device = resolve_device(device)
    predict_dur = cfg.get("predict_dur", True)
    predict_pitch = cfg.get("predict_pitch", False)
    if not (predict_dur or predict_pitch):
        raise ValueError("variance eval needs a duration or pitch predictor "
                         "(predict_dur / predict_pitch)")
    phdict = PhonemeDictionary.load(locate_dictionary(cfg.get("dictionary"), cfg.get("work_dir")))
    ds = VarianceDataset(cfg["binary_data_dir"], dataset, cfg)
    model = load_variance_model(cfg, TokenTextEncoder(phdict.phoneme_list).vocab_size,
                                ckpt_steps, device)
    core, normalizers = build_variance_cores(cfg), build_variance_normalizers(cfg)
    heads = {"pitch": model.pitch_backbone} if model.predict_pitch else {}
    kernel_weights = head_kernel_weights(
        cfg, heads, torch.bfloat16 if device.type == "cuda" else torch.float32)

    n = len(ds) if limit is None else min(limit, len(ds))
    if n <= 0:
        raise ValueError(
            f"nothing to evaluate: dataset '{dataset}' has {len(ds)} items, limit={limit}")
    rhythms = {tol: RhythmCorrectness(tolerance=tol) for tol in rhythm_tolerances}
    rhythm = rhythms.setdefault(0.05, RhythmCorrectness(tolerance=0.05))
    ph_acc = PhonemeDurationAccuracy(tolerance=0.2)
    pitch_acc = RawCurveAccuracy(tolerance=0.5)
    wordsum_rel_errs = []
    for i in range(n):
        b = ds.collate([i], pad_to_bucket=True)
        if predict_dur:
            t = batch_tensors(b, device)
            with torch.no_grad():
                _, dur = model.encode(t["tokens"], t["midi"], t["ph2word"], ph_dur=t["ph_dur"],
                                      spk_id=t.get("spk_ids") if cfg.get("use_spk_id", False)
                                      else None, infer=True)
            dur_pred = dur.float().cpu().numpy()
            mask = b["tokens"] > 0
            for m_ in rhythms.values():
                m_.update(dur_pred, b["ph_dur"], b["ph2word"], mask=mask)
            ph_acc.update(dur_pred, b["ph_dur"], b["ph2word"], mask=mask)
            pd_, gt_, w_, mm = dur_pred[0], b["ph_dur"][0], b["ph2word"][0], mask[0]
            sums_p = np.bincount(w_[mm], weights=pd_[mm])
            sums_g = np.bincount(w_[mm], weights=gt_[mm])
            sel = sums_g > 0
            wordsum_rel_errs.extend((np.abs(sums_p[sel] - sums_g[sel]) / sums_g[sel]).tolist())
        if predict_pitch:
            pred_pitch, _ = sample_variance_inference(
                cfg, model, core, normalizers, b, kernel_weights=kernel_weights,
                generator=generator_from_seed(i, device),
                noise=None if noise is None else {"pitch": noise[i]})
            voiced = (b["mel2ph"] > 0) & ~b["uv"]
            pitch_acc.update(pred_pitch.cpu().numpy(), b["pitch"], mask=voiced)
    out = {"step": int(ckpt_steps) if ckpt_steps is not None
           else _checkpoint_step(cfg["work_dir"]),
           "dataset": dataset, "items_evaluated": n}
    if predict_dur:
        out["rhythm_corr"] = float(rhythm.compute())
        out["ph_dur_acc"] = float(ph_acc.compute())
        out["rhythm_sweep"] = {str(tol): float(m_.compute())
                               for tol, m_ in sorted(rhythms.items())}
        out["median_wordsum_rel_err"] = float(np.median(wordsum_rel_errs)) \
            if wordsum_rel_errs else None
        out["n_words"] = len(wordsum_rel_errs)
    if predict_pitch:
        out["pitch_acc"] = float(pitch_acc.compute())
    return out
