"""Command line of the port.

    python -m xiaoicesing_io_tpu_torch.cli infer acoustic song.ds --exp my_exp [--device cpu]
    python -m xiaoicesing_io_tpu_torch.cli val_vocoder a.wav b.wav --config cfg.yaml [--out DIR]
    python -m xiaoicesing_io_tpu_torch.cli vocode song.mel.npz (--exp my_exp | --config cfg.yaml)

``--exp`` names a work dir under ``checkpoints/`` (exact name or unique
prefix) holding ``config.yaml`` or ``config.json`` and a reference-format
``model_ckpt_steps_*.ckpt``; the config's ``vocoder_ckpt`` names the
NSF-HiFiGAN ``model.ckpt`` (with its ``config.json`` beside it).
``val_vocoder`` copy-synthesises wav files through the vocoder and scores
them (mel MAE, PESQ*); ``vocode`` turns the ``.mel.npz`` that ``infer
acoustic --mel`` writes into a wav.  Every command runs on CUDA unless
``--device`` names another device.
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
    cfg = load_config(None, exp_name=exp, work_dir_root=args.work_dir, infer=True)
    migrate_sampling_keys(cfg, depth=args.depth, steps=args.steps)
    runner = DiffSingerAcousticInfer(cfg, load_vocoder=not args.mel, ckpt_steps=args.ckpt,
                                     device=args.device)
    out_dir = pathlib.Path(args.out) if args.out else pathlib.Path(args.proj).parent
    runner.run_inference(params, out_dir=out_dir, title=args.title or pathlib.Path(args.proj).stem,
                         num_runs=args.num, seed=args.seed, save_mel=args.mel)


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
    ac.add_argument("--seed", type=int, default=-1, help="-1: fresh entropy per run")
    ac.add_argument("--depth", type=float, default=None)
    ac.add_argument("--steps", type=int, default=None)
    ac.add_argument("--mel", action="store_true", help="save the mel instead of the waveform")
    ac.add_argument("--device", default=None, help="torch device (default: cuda)")
    ac.set_defaults(func=infer_acoustic)

    vv = sub.add_parser("val_vocoder", help="Vocoder copy-synthesis evaluation on wav files")
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
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
