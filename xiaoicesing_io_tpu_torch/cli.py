"""Command line of the port.

    python -m xiaoicesing_io_tpu_torch.cli infer acoustic song.ds --exp my_exp [--dp] [--device cpu]
    python -m xiaoicesing_io_tpu_torch.cli infer variance song.ds --exp var_exp [--predict dur]
    python -m xiaoicesing_io_tpu_torch.cli val_vocoder a.wav b.wav --config cfg.yaml [--out DIR]
    python -m xiaoicesing_io_tpu_torch.cli vocode song.mel.npz (--exp my_exp | --config cfg.yaml)
    python -m xiaoicesing_io_tpu_torch.cli eval --exp my_exp [--dataset valid] [--pesq] [--json out.json]
    python -m xiaoicesing_io_tpu_torch.cli train --config cfg.yaml --exp_name my_exp [--hparams k=v,...]
        [--coordinator host:port --num_processes N --process_id I]
    python -m xiaoicesing_io_tpu_torch.cli binarize --config cfg.yaml [--hparams k=v,...]
    python -m xiaoicesing_io_tpu_torch.cli drop_spk my_exp --spk name [--fill zeros] [--out PATH]
    python -m xiaoicesing_io_tpu_torch.cli export acoustic|variance --exp my_exp [--out DIR] [--freeze_* ...]
    python -m xiaoicesing_io_tpu_torch.cli export nsf-hifigan (--exp my_exp | --config cfg.yaml) [--ckpt model.ckpt]
    python -m xiaoicesing_io_tpu_torch.cli convert_ckpt (--exp my_exp | --config cfg.yaml) [--ckpt_steps N] [--out DIR]

``--exp`` names a work dir under ``checkpoints/`` (exact name or unique
prefix) holding ``config.yaml`` or ``config.json`` and a reference-format
``model_ckpt_steps_*.ckpt`` or the JAX package's checkpoint directory
``model_ckpt_steps_*/`` (reading that needs ``tensorstore``); the config's
``vocoder_ckpt`` names the NSF-HiFiGAN ``model.ckpt`` (with its
``config.json`` beside it).
``infer acoustic --dp`` synthesises the segments in bucket batches and
vocodes them in groups of equal length (serving mode: one noise stream a
chunk in place of per-segment seeds).
``infer variance`` predicts what each segment lacks (or what ``--predict``
names: dur, pitch, energy, breathiness, voicing, tension) and writes the
``.ds`` with the predictions beside the input.  ``val_vocoder``
copy-synthesises wav files through the vocoder and scores them (mel MAE,
PESQ*); ``vocode`` turns the ``.mel.npz`` that ``infer
acoustic --mel`` writes into a wav.  ``eval`` scores an experiment over its
binarized ``valid`` (or ``train``) set: mel MAE and MCD of an acoustic model
(``--pesq``: also the vocoded waveforms), duration and pitch accuracy of a
variance model.  ``train`` trains the acoustic or variance model that the
config's ``task_cls`` names on its ``binary_data_dir``, writing the merged
config and reference-format checkpoints into ``<work_dir>/<exp_name>``;
``--reset`` ignores a config saved there; with ``--num_processes N`` (> 1)
each of N processes, started with its ``--process_id`` and the same
``--coordinator``, trains data-parallel on its own card (``nccl``; ``gloo``
with ``--device cpu``) and rank 0 writes the work dir.  ``binarize`` turns
the raw sets of ``raw_data_dir`` into ``binary_data_dir``'s ``{train,valid}.{data,meta}``,
``spk_map.json`` and ``dictionary.txt`` with the binarizer whose class name
``binarizer_cls`` ends in (``AcousticBinarizer`` or ``VarianceBinarizer``,
whatever module path precedes it: nothing is imported from that path).
``drop_spk`` scrubs speakers from the speaker table of an experiment's
latest checkpoint (in place with ``--overwrite``, or into ``--out``); the
edit is host work, so it takes no ``--device``.  ``export`` writes the ONNX
graphs, manifest and attachments of an experiment (or of its vocoder) for
deployment; it loads the checkpoint on the CPU and traces the f32 modules,
so it takes no ``--device`` either.  ``convert_ckpt`` writes the JAX
package's checkpoint directory of an experiment (the latest, or step
``--ckpt_steps``), optimizer state included, as the reference-format
``model_ckpt_steps_N.ckpt`` (into the work dir, or ``--out``): run it where
the JAX package (and so ``tensorstore``) is installed, then ``train``
resumes from that file and every other command reads it, on a host
without ``tensorstore`` too.  It is host work and takes no ``--device``.
Every other command runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional


def _find_exp(exp: str, root: str = "checkpoints") -> str:
    base = pathlib.Path(root)
    if not (base / exp).exists():
        matches = sorted(d.name for d in base.iterdir()
                         if d.is_dir() and d.name.startswith(exp)) if base.exists() else []
        if not matches:
            raise SystemExit(f"| There are no matching exp starting with '{exp}' in '{root}'.")
        if len(matches) > 1:
            print(f"| There are more than one matching exp, pick the first one: {matches}")
        exp = matches[0]
    print(f"| found ckpt by prefix: {exp}")
    return exp


def _trans_key(params, key: int):
    """Transpose ``note_seq`` and ``f0_seq`` by ``key`` semitones."""
    from .utils.music import midi_to_note, note_to_midi

    warned = False
    for seg in params:
        if "note_seq" in seg:
            seg["note_seq"] = " ".join(
                n if n == "rest" else midi_to_note(note_to_midi(n, round_midi=True) + key)
                for n in seg["note_seq"].split()
            )
        if seg.get("f0_seq"):
            seg["f0_seq"] = " ".join(
                str(round(float(x) * 2 ** (key / 12), 1)) for x in seg["f0_seq"].split()
            )
        else:
            warned = True
    if warned:
        print("Warning: parts of f0_seq do not exist, please freeze the pitch line in the editor.")
    return params


def infer_acoustic(args) -> None:
    from .compat import migrate_sampling_keys
    from .config import load_config
    from .inference.acoustic import DiffSingerAcousticInfer, load_ds

    exp = _find_exp(args.exp, args.work_dir)
    params = load_ds(args.proj)
    if args.key != 0:
        params = _trans_key(params, args.key)
    if args.gender is not None:
        assert -1.0 <= args.gender <= 1.0, "--gender must be in [-1, 1]"
        for seg in params:
            seg["gender"] = args.gender
    if args.spk:
        from .utils.spk_mix import parse_commandline_spk_mix

        for seg in params:
            seg["spk_mix"] = parse_commandline_spk_mix(args.spk)
    cfg = load_config(None, exp_name=exp, work_dir_root=args.work_dir, infer=True)
    migrate_sampling_keys(cfg, depth=args.depth, steps=args.steps)
    runner = DiffSingerAcousticInfer(cfg, load_vocoder=not args.mel, ckpt_steps=args.ckpt,
                                     device=args.device)
    out_dir = pathlib.Path(args.out) if args.out else pathlib.Path(args.proj).parent
    runner.run_inference(params, out_dir=out_dir, title=args.title or pathlib.Path(args.proj).stem,
                         num_runs=args.num, seed=args.seed, save_mel=args.mel,
                         data_parallel=args.dp)


def infer_variance(args) -> None:
    from .compat import migrate_sampling_keys
    from .config import load_config
    from .inference.acoustic import load_ds
    from .inference.variance import DiffSingerVarianceInfer

    exp = _find_exp(args.exp, args.work_dir)
    params = load_ds(args.proj)
    if args.key != 0:
        params = _trans_key(params, args.key)
    if args.expr is not None:
        assert 0.0 <= args.expr <= 1.0, "--expr must be in [0, 1]"
        for seg in params:
            seg["expr"] = args.expr
    cfg = load_config(None, exp_name=exp, work_dir_root=args.work_dir, infer=True)
    migrate_sampling_keys(cfg, steps=args.steps)
    if args.spk:
        from .utils.spk_mix import parse_commandline_spk_mix

        mix = parse_commandline_spk_mix(args.spk)
        for seg in params:  # the token-level and the frame-level mix
            seg["ph_spk_mix"] = seg["spk_mix"] = mix
    runner = DiffSingerVarianceInfer(cfg, predictions=set(args.predict), ckpt_steps=args.ckpt,
                                     device=args.device)
    out_dir = pathlib.Path(args.out) if args.out else pathlib.Path(args.proj).parent
    runner.run_inference(params, out_dir=out_dir, title=args.title or pathlib.Path(args.proj).stem,
                         num_runs=args.num, seed=args.seed)


def val_vocoder(args) -> None:
    from .config import load_config
    from .inference.val_vocoder import copy_synthesis

    cfg = load_config(args.config, infer=True)
    copy_synthesis(list(args.wavs), cfg, args.out, device=args.device)


def vocode(args) -> None:
    """Vocode every segment of a ``.mel.npz`` (``seg<i>_mel``, ``seg<i>_f0``,
    ``seg<i>_offset``) and place the segments as ``infer acoustic`` does:
    silence up to each offset, a linear crossfade where segments overlap."""
    import numpy as np

    from .config import load_config
    from .models.vocoders import get_vocoder_cls
    from .utils import fresh_seed, generator_from_seed, resolve_device
    from .utils.audio import save_wav
    from .utils.curves import cross_fade

    if args.exp:
        cfg = load_config(None, exp_name=_find_exp(args.exp, args.work_dir),
                          work_dir_root=args.work_dir, infer=True)
    else:
        cfg = load_config(args.config, infer=True)
    device = resolve_device(args.device)
    cls = get_vocoder_cls(args.vocoder_cls or cfg.get("vocoder", "NsfHifiGAN"))
    vocoder = cls(cfg, model_path=args.vocoder_ckpt, device=device)
    data = np.load(args.mel_path)
    segs = {}
    for k in data.files:
        seg_name, attr = k.split("_", 1)
        segs.setdefault(seg_name, {})[attr] = data[k]
    sr = cfg["audio_sample_rate"]
    result = np.zeros(0)
    current_length = 0
    base_seed = args.seed if args.seed >= 0 else fresh_seed()
    for i, seg_name in enumerate(sorted(segs, key=lambda s: int(s.removeprefix("seg")))):
        seg = segs[seg_name]
        wav = vocoder.spec2wav(seg["mel"], seg["f0"],
                               generator=generator_from_seed(base_seed + i, device, salt=1))
        silent = round(float(seg.get("offset", 0.0)) * sr) - current_length
        if silent >= 0:
            result = np.append(result, np.zeros(silent))
            result = np.append(result, wav)
        else:
            result = cross_fade(result, wav, current_length + silent)
        current_length = current_length + silent + wav.shape[0]
    out_dir = pathlib.Path(args.out) if args.out else pathlib.Path(args.mel_path).parent
    out_path = out_dir / ((args.title or pathlib.Path(args.mel_path).stem.removesuffix(".mel"))
                          + ".wav")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    save_wav(result, out_path, sr)
    print(f"| save audio: {out_path}")


def eval_cmd(args) -> None:
    """The JAX package's ``eval`` command: one line an item and a summary
    line (acoustic), or one summary line (variance); ``--json`` also writes
    the whole report."""
    import json

    from .config import load_config

    def dump(report):
        if args.json_path:
            p = pathlib.Path(args.json_path)
            if p.parent != pathlib.Path("."):
                p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(report, indent=2))
            print(f"| save report: {args.json_path}")

    exp = _find_exp(args.exp, args.work_dir)
    cfg = load_config(None, exp_name=exp, work_dir_root=args.work_dir, infer=True)
    if "variance" in str(cfg.get("task_cls", "")).lower():
        from .eval.copy_synthesis import evaluate_variance

        report = evaluate_variance(cfg, dataset=args.dataset, limit=args.limit,
                                   ckpt_steps=args.ckpt, device=args.device)
        metrics = " ".join(f"{k}={report[k]:.4f}"
                           for k in ("rhythm_corr", "ph_dur_acc", "pitch_acc") if k in report)
        print(f"| step {report['step']} {report['dataset']} "
              f"({report['items_evaluated']} items): {metrics}")
        dump(report)
        return
    from .eval.copy_synthesis import evaluate_acoustic

    report = evaluate_acoustic(cfg, dataset=args.dataset, limit=args.limit, seed=args.seed,
                               with_pesq=args.with_pesq, ckpt_steps=args.ckpt,
                               device=args.device)
    for it in report["items"]:
        aux = "" if it["aux_mae"] is None else f"  aux_mae={it['aux_mae']:.4f}"
        pq = "" if it.get("pesq") is None else f"  pesq={it['pesq']:.2f}"
        print(f"| {it['name']}: frames={it['frames']} "
              f"mel_mae={it['mel_mae']:.4f} mcd={it['mcd_db']:.3f}dB{aux}{pq}")
    aux = ("" if "mean_aux_mae" not in report
           else f"  mean_aux_mae={report['mean_aux_mae']:.4f}")
    pq = "" if "mean_pesq" not in report else f"  mean_pesq={report['mean_pesq']:.2f}"
    print(f"| step {report['step']} {report['dataset']}: "
          f"mean_mel_mae={report['mean_mel_mae']:.4f} "
          f"mean_mcd={report['mean_mcd_db']:.3f}dB{aux}{pq}")
    dump(report)


def train(args) -> None:
    from .config import load_config
    from .parallel.mesh import init_distributed, rank
    from .training.tasks import build_trainer_from_config

    init_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    cfg = load_config(args.config, exp_name=args.exp_name, work_dir_root=args.work_dir,
                      overrides=args.hparams, reset=args.reset, save=rank() == 0)
    build_trainer_from_config(cfg, device=args.device).fit()


BINARIZERS = {
    "AcousticBinarizer": "preprocessing.acoustic_binarizer",
    "VarianceBinarizer": "preprocessing.variance_binarizer",
}


def binarizer_class(binarizer_cls: str):
    """The port's binarizer for a ``binarizer_cls`` of any package, by its
    class name alone."""
    import importlib

    name = str(binarizer_cls).rsplit(".", 1)[-1]
    if name not in BINARIZERS:
        raise ValueError(f"Unknown binarizer_cls {binarizer_cls!r}: the port has "
                         f"{', '.join(BINARIZERS)}")
    return getattr(importlib.import_module(f".{BINARIZERS[name]}", __package__), name)


def binarize(args) -> None:
    from .config import load_config

    cfg = load_config(args.config, overrides=args.hparams)
    cls = binarizer_class(cfg["binarizer_cls"])
    print(f"| Binarizer: {cls.__module__}.{cls.__name__}")
    cls(cfg, device=args.device).process()


def drop_spk(args) -> None:
    from .deployment.drop_spk import drop_speakers

    drop_speakers(_find_exp(args.exp, args.work_dir), list(args.spk), args.fill,
                  work_dir_root=args.work_dir, retain=args.retain, out=args.out,
                  overwrite=args.overwrite)


def convert_ckpt(args) -> None:
    import time

    import torch

    from .config import load_config
    from .training.jax_bridge import convert_jax_checkpoint
    from .utils import orbax_ckpt

    if args.exp is not None:
        cfg = load_config(args.config, exp_name=_find_exp(args.exp, args.work_dir),
                          work_dir_root=args.work_dir, infer=True)
    elif args.config is not None:
        cfg = load_config(args.config, infer=True)
        if not cfg.get("work_dir"):
            raise SystemExit("| convert_ckpt: the config names no work_dir; pass --exp")
    else:
        raise SystemExit("| convert_ckpt: pass --exp or --config")
    work_dir = pathlib.Path(cfg["work_dir"])
    dirs = orbax_ckpt.list_checkpoints(work_dir)
    if args.ckpt_steps is not None:
        dirs = [p for p in dirs if orbax_ckpt.checkpoint_dir_step(p) == args.ckpt_steps]
    if not dirs:
        what = "" if args.ckpt_steps is None else f" of step {args.ckpt_steps}"
        raise SystemExit(f"| convert_ckpt: no JAX checkpoint directory{what} "
                         f"(model_ckpt_steps_N/ with a meta.json) in {work_dir}")
    t0 = time.perf_counter()
    path = convert_jax_checkpoint(cfg, dirs[-1], args.out or work_dir)
    seconds = time.perf_counter() - t0
    ckpt = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    print(f"| converted {dirs[-1]} -> {path}: step {ckpt['global_step']}, category "
          f"{ckpt['category']}, {len(ckpt['state_dict'])} tensors, {seconds:.2f}s")


def export_acoustic(args) -> None:
    from .config import load_config
    from .deployment.export import export_acoustic as _export

    cfg = load_config(None, exp_name=_find_exp(args.exp, args.work_dir),
                      work_dir_root=args.work_dir, infer=True)
    _export(cfg, out_dir=args.out, ckpt_steps=args.ckpt, fmt=args.fmt,
            freeze_gender=args.freeze_gender, freeze_velocity=args.freeze_velocity,
            freeze_spk=args.freeze_spk, export_spk=list(args.export_spk))


def export_variance(args) -> None:
    from .config import load_config
    from .deployment.export import export_variance as _export

    cfg = load_config(None, exp_name=_find_exp(args.exp, args.work_dir),
                      work_dir_root=args.work_dir, infer=True)
    _export(cfg, out_dir=args.out, ckpt_steps=args.ckpt, fmt=args.fmt,
            freeze_expr=args.freeze_expr, freeze_glide=args.freeze_glide,
            freeze_spk=args.freeze_spk, export_spk=list(args.export_spk))


def export_nsf_hifigan(args) -> None:
    from .config import load_config
    from .deployment.export import export_nsf_hifigan as _export

    exp = _find_exp(args.exp, args.work_dir) if args.exp else None
    cfg = load_config(args.config, exp_name=exp, work_dir_root=args.work_dir, infer=True)
    _export(cfg, out_dir=args.out, ckpt_path=args.ckpt, fmt=args.fmt)


def _add_export_parsers(sub) -> None:
    """``export acoustic|variance|nsf-hifigan``: the JAX command group's
    options; ``--format`` takes ``onnx`` only."""
    ex = sub.add_parser("export", help="Export models for deployment (ONNX graphs + manifest)")
    ex_sub = ex.add_subparsers(dest="kind", required=True)

    def common(p, exp_required=True):
        p.add_argument("--exp", required=exp_required, help="experiment name or unique prefix")
        p.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
        p.add_argument("--out", default=None,
                       help="output directory (default: artifacts/<exp_name>)")
        p.add_argument("--format", dest="fmt", default="onnx", choices=["onnx"],
                       help="graph format (the JAX package's stablehlo and savedmodel are "
                            "JAX and TensorFlow artifacts)")

    ea = ex_sub.add_parser("acoustic", help="Export the acoustic model (graphs + manifest)")
    common(ea)
    ea.add_argument("--ckpt", type=int, default=None, help="checkpoint step (default: latest)")
    ea.add_argument("--freeze_gender", type=float, default=None,
                    help="bake a static gender value [-1, 1] instead of a key_shift input")
    ea.add_argument("--freeze_velocity", type=float, nargs="?", const=1.0, default=None,
                    help="bake a static velocity instead of a speed input "
                         "(bare flag = default velocity 1.0, like the reference)")
    ea.add_argument("--freeze_spk", default=None,
                    help="bake a static speaker mix, e.g. 'alice' or 'alice:0.6|bob:0.4'")
    ea.add_argument("--export_spk", action="append", default=[],
                    help="write named speaker-mix .emb attachments, e.g. "
                         "'duet=alice:0.6|bob:0.4' (repeatable)")
    ea.set_defaults(func=export_acoustic)

    ev = ex_sub.add_parser("variance", help="Export the variance model (graphs + manifest)")
    common(ev)
    ev.add_argument("--ckpt", type=int, default=None, help="checkpoint step (default: latest)")
    ev.add_argument("--freeze_expr", type=float, nargs="?", const=1.0, default=None,
                    help="bake a static expressiveness factor instead of an input "
                         "(bare flag = default 1.0, like the reference)")
    ev.add_argument("--freeze_glide", action="store_true",
                    help="bake the default (none) glide embedding; drops the note_glide input")
    ev.add_argument("--freeze_spk", default=None,
                    help="bake a static speaker mix, e.g. 'alice:0.6|bob:0.4'")
    ev.add_argument("--export_spk", action="append", default=[],
                    help="write named speaker-mix .emb attachments (repeatable)")
    ev.set_defaults(func=export_variance)

    en = ex_sub.add_parser("nsf-hifigan", help="Export the NSF-HiFiGAN vocoder graph + "
                                               "vocoder.yaml")
    common(en, exp_required=False)
    en.add_argument("--config", default=None,
                    help="configuration naming vocoder_ckpt (alternative to --exp)")
    en.add_argument("--ckpt", default=None, help="vocoder model.ckpt path override")
    en.set_defaults(func=export_nsf_hifigan)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m xiaoicesing_io_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    infer = sub.add_parser("infer", help="Run inference")
    infer_sub = infer.add_subparsers(dest="kind", required=True)
    ac = infer_sub.add_parser("acoustic", help="Acoustic inference: .ds -> .wav")
    ac.add_argument("proj", help="the .ds file")
    ac.add_argument("--exp", required=True, help="experiment name or unique prefix")
    ac.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
    ac.add_argument("--ckpt", type=int, default=None, help="checkpoint step (default: latest)")
    ac.add_argument("--out", default=None, help="output directory (default: beside the .ds)")
    ac.add_argument("--title", default=None)
    ac.add_argument("--num", type=int, default=1, help="number of runs")
    ac.add_argument("--key", type=int, default=0, help="transpose key in semitones")
    ac.add_argument("--spk", default=None, help="speaker mix, e.g. 'a|b:0.5'")
    ac.add_argument("--gender", type=float, default=None,
                    help="static formant shift (gender) in [-1, 1]")
    ac.add_argument("--seed", type=int, default=-1, help="-1: fresh entropy per run")
    ac.add_argument("--depth", type=float, default=None)
    ac.add_argument("--steps", type=int, default=None)
    ac.add_argument("--mel", action="store_true", help="save the mel instead of the waveform")
    ac.add_argument("--dp", action="store_true",
                    help="synthesise in bucket batches (serving mode; per-segment seeds are "
                         "replaced by one noise stream per batch chunk)")
    ac.add_argument("--device", default=None, help="torch device (default: cuda)")
    ac.set_defaults(func=infer_acoustic)

    va = infer_sub.add_parser("variance", help="Variance inference: .ds -> .ds with predictions")
    va.add_argument("proj", help="the .ds file")
    va.add_argument("--exp", required=True, help="experiment name or unique prefix")
    va.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
    va.add_argument("--ckpt", type=int, default=None, help="checkpoint step (default: latest)")
    va.add_argument("--predict", action="append", default=[],
                    help="dur / pitch / energy / breathiness / voicing / tension (repeatable; "
                         "none: predict what each segment lacks)")
    va.add_argument("--spk", default=None, help="speaker mix, e.g. 'a|b:0.5'")
    va.add_argument("--out", default=None, help="output directory (default: beside the .ds)")
    va.add_argument("--title", default=None)
    va.add_argument("--num", type=int, default=1, help="number of runs")
    va.add_argument("--key", type=int, default=0, help="transpose key in semitones")
    va.add_argument("--expr", type=float, default=None,
                    help="static expressiveness in [0, 1] (the pitch retake mix)")
    va.add_argument("--seed", type=int, default=-1, help="-1: fresh entropy per run")
    va.add_argument("--steps", type=int, default=None)
    va.add_argument("--device", default=None, help="torch device (default: cuda)")
    va.set_defaults(func=infer_variance)

    vv = sub.add_parser("val_vocoder", aliases=["val-vocoder"],
                        help="Vocoder copy-synthesis evaluation on wav files")
    vv.add_argument("wavs", nargs="+", help="wav files")
    vv.add_argument("--config", required=True, help="configuration (names vocoder_ckpt)")
    vv.add_argument("--out", default="copysyn_out", help="output directory")
    vv.add_argument("--device", default=None, help="torch device (default: cuda)")
    vv.set_defaults(func=val_vocoder)

    vo = sub.add_parser("vocode", help="Vocode a saved .mel.npz to a waveform")
    vo.add_argument("mel_path", help="the .mel.npz of infer acoustic --mel")
    src = vo.add_mutually_exclusive_group(required=True)
    src.add_argument("--exp", help="experiment name or unique prefix")
    src.add_argument("--config", help="configuration file")
    vo.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
    vo.add_argument("--cls", "--class", dest="vocoder_cls", default=None,
                    help="vocoder class override (e.g. NsfHifiGAN)")
    vo.add_argument("--ckpt", dest="vocoder_ckpt", default=None,
                    help="vocoder checkpoint path override")
    vo.add_argument("--out", default=None, help="output directory (default: beside the input)")
    vo.add_argument("--title", default=None)
    vo.add_argument("--seed", type=int, default=-1,
                    help="seed of the NSF source noise; -1: fresh entropy per run")
    vo.add_argument("--device", default=None, help="torch device (default: cuda)")
    vo.set_defaults(func=vocode)

    ev = sub.add_parser("eval", help="Evaluate an experiment over its binarized set")
    ev.add_argument("--exp", required=True, help="experiment name or unique prefix")
    ev.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
    ev.add_argument("--dataset", default="valid", choices=["valid", "train"])
    ev.add_argument("--limit", type=int, default=None, help="evaluate at most N items")
    ev.add_argument("--seed", type=int, default=0)
    ev.add_argument("--json", dest="json_path", default=None,
                    help="also write the full report as JSON to this path")
    ev.add_argument("--pesq", dest="with_pesq", action="store_true",
                    help="also vocode predicted + GT mels and report waveform PESQ*")
    ev.add_argument("--ckpt", type=int, default=None,
                    help="evaluate a specific checkpoint step (default: latest)")
    ev.add_argument("--device", default=None, help="torch device (default: cuda)")
    ev.set_defaults(func=eval_cmd)

    tr = sub.add_parser("train", help="Train a model (acoustic or variance, from task_cls)")
    tr.add_argument("--config", default=None, help="configuration file")
    tr.add_argument("--exp_name", required=True, help="experiment name")
    tr.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
    tr.add_argument("--hparams", default="", help="key=value overrides, comma separated")
    tr.add_argument("--reset", action="store_true", help="ignore the saved work-dir config")
    tr.add_argument("--device", default=None,
                    help="torch device (default: this process's card)")
    tr.add_argument("--coordinator", default=None,
                    help="several processes: the rendezvous host:port")
    tr.add_argument("--num_processes", type=int, default=None,
                    help="several processes: how many (one a card)")
    tr.add_argument("--process_id", type=int, default=None,
                    help="several processes: this one's rank, 0 to num_processes - 1")
    tr.set_defaults(func=train)

    bi = sub.add_parser("binarize", help="Binarize the raw sets a config names")
    bi.add_argument("--config", required=True, help="configuration file")
    bi.add_argument("--hparams", default="", help="key=value overrides, comma separated")
    bi.add_argument("--device", default=None,
                    help="torch device of RMVPE and the vocal remover (default: cuda)")
    bi.set_defaults(func=binarize)

    ds = sub.add_parser("drop_spk", help="Scrub speaker embeddings in a checkpoint (privacy)")
    ds.add_argument("exp", help="experiment name or unique prefix")
    ds.add_argument("--spk", action="append", required=True,
                    help="speaker name or id to drop (repeatable)")
    ds.add_argument("--fill", default="zeros", choices=["zeros", "random", "mean", "cyclic"])
    ds.add_argument("--retain", action="store_true",
                    help="invert: keep the listed speakers and scrub all others")
    ds.add_argument("--out", default=None,
                    help="write the scrubbed checkpoint here instead of in place")
    ds.add_argument("--overwrite", action="store_true",
                    help="allow replacing an existing checkpoint (required for in-place edits)")
    ds.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
    ds.set_defaults(func=drop_spk)

    cc = sub.add_parser("convert_ckpt", help="Write a JAX checkpoint directory (with its "
                        "optimizer state) as a reference-format .ckpt")
    cc.add_argument("--exp", default=None, help="experiment name or unique prefix")
    cc.add_argument("--config", default=None,
                    help="configuration (naming work_dir; alternative to --exp)")
    cc.add_argument("--work_dir", default="checkpoints", help="root of the experiments")
    cc.add_argument("--ckpt_steps", type=int, default=None,
                    help="the step to convert (default: the latest)")
    cc.add_argument("--out", default=None, help="output directory (default: the work dir)")
    cc.set_defaults(func=convert_ckpt)
    _add_export_parsers(sub)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
