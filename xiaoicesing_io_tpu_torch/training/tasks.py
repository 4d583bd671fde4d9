"""Task assembly: config -> datasets, model, train step, validation, Trainer
(counterpart of the JAX package's ``training/tasks.py``).

The model is built from the config on the CPU with torch's initialisers
seeded by ``seed`` (default 0), optionally finetuned from a checkpoint and
partly frozen, then moved to the trainer's device: this process's card
(``parallel/mesh.local_device``) unless the caller passes another device.
In a group of more than one rank, rank 0 alone writes the work dir.

The validation extras run on the trainer's device and propagate every
error, where the JAX package's trainer prints and swallows them:

* acoustic: the first ``num_valid_plots`` valid items sampled through the
  acoustic runner's kernel path (``DiffSingerAcousticInfer.from_model``:
  the kernels' weights prepared from the current parameters at each
  validation; K1 for LYNXNet, K4 for WaveNet on the card), item ``i`` from
  seed ``i``; each mel vocoded (the folded NSF-HiFiGAN: K2 and K6 on the
  card), and at the first validation the ground truth too.  Only a
  ``vocoder_ckpt`` that is unset or names no file skips the audio, which
  is checked before the vocoder is built;
* variance: rhythm correctness, phoneme-duration accuracy and, with the
  pitch head, pitch accuracy, with both heads sampled by
  ``sample_variance_inference`` on their K4 weights.

Figures are drawn only where matplotlib is installed (checked up front).
"""

from __future__ import annotations

import shutil
from pathlib import Path

import torch

from ..data.dataset import AcousticDataset, VarianceDataset
from ..parallel.mesh import local_device, rank
from ..utils import generator_from_seed
from ..utils.phonemes import PhonemeDictionary, locate_dictionary
from ..utils.text_encoder import TokenTextEncoder
from .acoustic import (
    acoustic_losses, build_acoustic, make_acoustic_train_step, mixed_precision,
)
from .train_state import TrainState
from .trainer import _DEFAULT_WRITER, Trainer
from .variance import make_variance_train_step, variance_losses


def _prepare_work_dir(cfg) -> Path:
    """Save the config and copy ``spk_map.json`` and the dictionary into
    the work dir."""
    work_dir = Path(cfg["work_dir"])
    work_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(work_dir / "config.yaml")
    binary_dir = Path(cfg["binary_data_dir"])
    if (binary_dir / "spk_map.json").exists():
        shutil.copy(binary_dir / "spk_map.json", work_dir / "spk_map.json")
    dict_path = locate_dictionary(cfg.get("dictionary"), str(binary_dir))
    if dict_path.resolve() != (work_dir / "dictionary.txt").resolve():
        shutil.copy(dict_path, work_dir / "dictionary.txt")
    return work_dir


def build_phone_encoder(cfg) -> TokenTextEncoder:
    dict_path = locate_dictionary(cfg.get("dictionary"),
                                  cfg.get("binary_data_dir") or cfg.get("work_dir"))
    return TokenTextEncoder(PhonemeDictionary.load(dict_path).phoneme_list)


def _seeded(cfg, build):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg.get("seed", 0)))
        return build()


def _train_state(model, cfg, category: str, device) -> TrainState:
    from .finetune import freeze_parameters, load_finetune_params

    if cfg.get("finetune_enabled", False) and cfg.get("finetune_ckpt_path"):
        load_finetune_params(model, cfg, category)
    if cfg.get("freezing_enabled", False) and cfg.get("frozen_params"):
        freeze_parameters(model, cfg["frozen_params"])
    return TrainState(model.to(device).train(), cfg)


def build_acoustic_trainer(cfg, device=None, writer=_DEFAULT_WRITER) -> Trainer:
    device = local_device(device)
    if rank() == 0:
        _prepare_work_dir(cfg)
    encoder = build_phone_encoder(cfg)
    model, core, normalizer = _seeded(cfg, lambda: build_acoustic(cfg, encoder.vocab_size))
    state = _train_state(model, cfg, "acoustic", device)

    def val_losses(batch, generator):
        with mixed_precision(cfg, device):
            return acoustic_losses(model, core, normalizer, cfg, batch, generator)

    train_ds = AcousticDataset(cfg["binary_data_dir"], "train", cfg)
    valid_ds = AcousticDataset(cfg["binary_data_dir"], "valid", cfg)
    extras = make_acoustic_validation_extras(cfg, model, core, normalizer, valid_ds)
    return Trainer(cfg, state, make_acoustic_train_step(model, core, normalizer, cfg),
                   val_losses, train_ds, valid_ds, category="acoustic",
                   on_validation_extras=extras, writer=writer)


def make_acoustic_validation_extras(cfg, model, core, normalizer, valid_ds):
    """Sampled mels (and their figures and wavs) of the first
    ``num_valid_plots`` valid items at each validation."""
    from ..eval.copy_synthesis import _batch_from_item
    from ..inference.acoustic import DiffSingerAcousticInfer
    from ..models.vocoders import get_vocoder_cls
    from ..utils.plot import figures_available, spec_diff_to_figure, tb_add_audio

    figures = figures_available()
    sr = cfg["audio_sample_rate"]
    vocoder = None
    vocoder_ckpt = cfg.get("vocoder_ckpt")
    with_vocoder = cfg.get("val_with_vocoder", True)
    if with_vocoder and not (vocoder_ckpt and Path(vocoder_ckpt).exists()):
        with_vocoder = False  # only a missing checkpoint: any error building it propagates
        print(f"| WARN: no vocoder checkpoint at {vocoder_ckpt!r}: validation logs no audio")

    @torch.no_grad()
    def extras(trainer, step):
        nonlocal vocoder
        if trainer.writer is None:
            return
        device = trainer.device
        if with_vocoder and vocoder is None:
            vocoder = get_vocoder_cls(cfg.get("vocoder", "NsfHifiGAN"))(cfg, device=device)
        runner = DiffSingerAcousticInfer.from_model(cfg, model, core, normalizer)
        for i in range(min(cfg.get("num_valid_plots", 10), len(valid_ds))):
            b = valid_ds.collate([i], pad_to_bucket=True)
            mel_pred = runner.forward_model(_batch_from_item(cfg, runner, b), seed=i)[0]
            t_real = int((b["mel2ph"][0] > 0).sum())
            gt_mel = b["mel"][0]
            if figures:
                trainer.writer.add_figure(f"validation/diffmel_{i}", spec_diff_to_figure(
                    gt_mel[:t_real], mel_pred[:t_real], vmin=cfg.get("mel_vmin", -14.0),
                    vmax=cfg.get("mel_vmax", 4.0), title=f"diffmel_{i}"), step)
            if vocoder is None:
                continue
            f0 = b["f0"][0][:t_real]
            wav = vocoder.spec2wav(mel_pred[:t_real], f0)
            tb_add_audio(trainer.writer, f"validation/wav_diff_{i}", wav, step, sr)
            if step <= trainer.val_check_interval:  # the ground truth, once
                tb_add_audio(trainer.writer, f"validation/wav_gt_{i}",
                             vocoder.spec2wav(gt_mel[:t_real], f0), step, sr)
        del runner

    return extras


def build_variance_trainer(cfg, device=None, writer=_DEFAULT_WRITER) -> Trainer:
    from ..inference.variance import build_variance_cores
    from ..models.toplevel import VarianceModel, build_variance_normalizers

    device = local_device(device)
    if rank() == 0:
        _prepare_work_dir(cfg)
    encoder = build_phone_encoder(cfg)
    model = _seeded(cfg, lambda: VarianceModel.from_config(cfg, encoder.vocab_size))
    core, normalizers = build_variance_cores(cfg), build_variance_normalizers(cfg)
    state = _train_state(model, cfg, "variance", device)

    def val_losses(batch, generator):
        with mixed_precision(cfg, device):
            return variance_losses(model, core, normalizers, cfg, batch, generator)

    train_ds = VarianceDataset(cfg["binary_data_dir"], "train", cfg)
    valid_ds = VarianceDataset(cfg["binary_data_dir"], "valid", cfg)
    extras = make_variance_validation_extras(cfg, model, core, normalizers, valid_ds)
    return Trainer(cfg, state, make_variance_train_step(model, core, normalizers, cfg),
                   val_losses, train_ds, valid_ds, category="variance",
                   on_validation_extras=extras, writer=writer)


def make_variance_validation_extras(cfg, model, core, normalizers, valid_ds):
    """Duration metrics, sampled pitch and curves (with their figures) of
    the first ``num_valid_plots`` valid items at each validation."""
    from ..inference.variance import head_kernel_weights
    from ..utils.plot import (
        curve_to_figure, dur_to_figure, figures_available, pitch_notes_to_figure,
    )
    from .metrics import PhonemeDurationAccuracy, RawCurveAccuracy, RhythmCorrectness
    from .variance import batch_tensors, sample_variance_inference

    predict_dur = cfg.get("predict_dur", True)
    predict_pitch = cfg.get("predict_pitch", False)
    names = model.variance_prediction_list
    figures = figures_available()

    @torch.no_grad()
    def extras(trainer, step):
        writer = trainer.writer if figures else None
        device = trainer.device
        rhythm = RhythmCorrectness(tolerance=0.05)
        ph_acc = PhonemeDurationAccuracy(tolerance=0.2)
        pitch_acc = RawCurveAccuracy(tolerance=0.5)
        heads = {}
        if model.predict_pitch:
            heads["pitch"] = model.pitch_backbone
        if names:
            heads["variances"] = model.variance_backbone
        kernel_weights = head_kernel_weights(
            cfg, heads, torch.bfloat16 if device.type == "cuda" else torch.float32)
        for i in range(min(cfg.get("num_valid_plots", 10), len(valid_ds))):
            batch = valid_ds.collate([i], pad_to_bucket=True)
            mask = batch["tokens"] > 0
            if predict_dur:
                t = batch_tensors(batch, device)
                _, dur = model.encode(t["tokens"], t["midi"], t["ph2word"], ph_dur=t["ph_dur"],
                                      spk_id=t.get("spk_ids") if cfg.get("use_spk_id", False)
                                      else None, infer=True)
                dur_pred = dur.float().cpu().numpy()
                rhythm.update(dur_pred, batch["ph_dur"], batch["ph2word"], mask=mask)
                ph_acc.update(dur_pred, batch["ph_dur"], batch["ph2word"], mask=mask)
                if writer is not None and i < 3:
                    n = int(mask[0].sum())
                    writer.add_figure(f"validation/dur_{i}", dur_to_figure(
                        batch["ph_dur"][0][:n], dur_pred[0][:n],
                        [str(x) for x in batch["tokens"][0][:n]]), step)
            if not (predict_pitch or names):
                continue
            frame_mask = batch["mel2ph"][0] > 0
            t_real = int(frame_mask.sum())
            pred_pitch, curves = sample_variance_inference(
                cfg, model, core, normalizers, batch, kernel_weights=kernel_weights,
                generator=generator_from_seed(i, device), want_pitch=predict_pitch,
                want_variances=bool(names))
            if pred_pitch is not None:
                pred_pitch = pred_pitch.float().cpu().numpy()
                voiced = frame_mask & ~batch["uv"][0]
                pitch_acc.update(pred_pitch, batch["pitch"], mask=voiced[None])
                if writer is not None and i < 3:
                    writer.add_figure(f"validation/pitch_{i}", pitch_notes_to_figure(
                        batch["pitch"][0][:t_real], pred_pitch[0][:t_real],
                        note_midi=batch["note_midi"][0], note_dur=batch["note_dur"][0],
                        note_rest=batch["note_rest"][0]), step)
            if writer is not None and i < 3:
                for name, curve in curves.items():
                    writer.add_figure(f"validation/{name}_{i}", curve_to_figure(
                        batch[name][0][:t_real], curve.float().cpu().numpy()[0][:t_real],
                        title=name), step)
        scalars = {}
        if predict_dur:
            scalars["rhythm_corr"] = rhythm.compute()
            scalars["ph_dur_acc"] = ph_acc.compute()
        if predict_pitch:
            scalars["pitch_acc"] = pitch_acc.compute()
        if trainer.writer is not None:
            for k, v in scalars.items():
                trainer.writer.add_scalar(f"metrics/{k}", v, step)
        if scalars:
            print(f"| metrics @ step {step}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in scalars.items()))
        trainer.last_metrics = scalars

    return extras


def build_trainer_from_config(cfg, device=None) -> Trainer:
    task_cls = str(cfg.get("task_cls", "")).lower()
    if "acoustic" in task_cls:
        return build_acoustic_trainer(cfg, device)
    if "variance" in task_cls:
        return build_variance_trainer(cfg, device)
    raise ValueError(f"Cannot infer task from task_cls={cfg.get('task_cls', '')!r}")
