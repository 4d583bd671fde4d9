"""Deployment export: ONNX graphs + OpenUTAU-style manifests.

Counterpart of the JAX package's ``deployment/export.py``, writing its
``--format onnx`` artifacts: the model is split into the partial graphs the
downstream editor consumes, as the reference DiffSinger's exporters do
(``deployment/exporters/*`` + ``deployment/modules/*``) —
``linguistic_dur``, ``frame_condition``, ``pitch_*`` and ``variance_*`` for
the variance model, ``fs2_aux`` + ``diffusion_step`` for the acoustic model,
and one loop-bearing merged graph per sampler (``acoustic.onnx``,
``pitch.onnx``, ``variance.onnx``) that a consumer drives with ``depth`` /
``steps`` — plus:

* ``dsconfig.yaml`` manifest (phonemes, features, sample_rate, hop size, ...)
* ``phonemes.txt`` and ``dictionary.txt`` attachments
* per-speaker ``*.emb`` raw float32 embedding files (ref:
  acoustic_exporter.py:108-158)

ONNX is the only format: the JAX package's ``stablehlo`` and ``savedmodel``
are JAX and TensorFlow artifacts.  Export loads the checkpoint on the CPU in
f32 and traces the plain modules through the aten -> ONNX converter
(``onnx_export.py``); no kernel runs, as in the JAX package, whose tracing is
device-free too.  The artifact is a file: where it runs is the consumer's
choice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.diffusion.core import GaussianDiffusion
from ..utils.phonemes import PhonemeDictionary, locate_dictionary
from ..utils.text_encoder import TokenTextEncoder
from .graph_passes import simplify_graph
from .onnx_export import export_onnx, reuse_traces, trace_to_graph
from .onnx_loop import build_ddpm_graph, build_reflow_graph, merge_graphs
from .onnx_proto import build_model

FORMATS = ("onnx",)


def _check_format(fmt: str) -> None:
    if fmt in ("stablehlo", "savedmodel"):
        raise ValueError(
            f"export format {fmt!r} is a JAX/TensorFlow artifact; the PyTorch port "
            f"exports {FORMATS}")
    if fmt not in FORMATS:
        raise ValueError(f"unknown export format {fmt!r}; choose from {FORMATS}")


def _export_fn(fn, args, path: Path, name: str) -> Path:
    """Trace ``fn`` at the example ``args`` (static shapes) into
    ``<path>/<name>.onnx``."""
    out = path / f"{name}.onnx"
    data = export_onnx(fn, [np.asarray(a) for a in args], out, graph_name=name)
    print(f"| export graph: {out} ({len(data) / 1e6:.2f} MB)")
    return out


def _write_yaml(path: Path, manifest: dict) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(manifest, f, sort_keys=False)
    print(f"| export manifest: {path}")


def _sampling_block(cfg) -> dict:
    """Diffusion-loop parameters a consumer needs to drive the exported
    ``*_step`` graphs (the merged graphs embed the loop; the step graphs
    leave it to the consumer, so the manifest records them)."""
    if cfg.get("diffusion_type", "ddpm") == "reflow":
        shallow = cfg.get("use_shallow_diffusion", False)
        return {
            "type": "reflow",
            "algorithm": cfg.get("sampling_algorithm", "euler"),
            "steps": cfg.get("sampling_steps", 20),
            "t_start_infer": cfg.get("T_start_infer", 0.0) if shallow else 0.0,
            "time_scale_factor": cfg.get("time_scale_factor", 1000),
        }
    timesteps = cfg.get("timesteps", 1000)
    return {
        "type": "ddpm",
        "algorithm": cfg.get("diff_accelerator", "ddim"),
        "timesteps": timesteps,
        "k_step_infer": cfg.get("K_step_infer", cfg.get("K_step", timesteps)),
        "speedup": cfg.get("diff_speedup", 10),
    }


def _speaker_names(cfg, export_spk=None) -> list:
    """Names a consumer can expect .emb attachments for."""
    names = []
    spk_map_path = Path(cfg.get("work_dir", ".")) / "spk_map.json"
    if cfg.get("use_spk_id", False) and spk_map_path.exists():
        with open(spk_map_path) as f:
            names = sorted(json.load(f).keys())
    for entry in export_spk or []:
        key = entry.partition("=")[0]
        if key not in names:
            names.append(key)
    return names


def _spk_table(model) -> Optional[np.ndarray]:
    """The speaker embedding table: ``fs2.spk_embed`` (acoustic) or the
    top-level ``spk_embed`` (variance)."""
    table = None
    for holder in (getattr(model, "fs2", None), model):
        if holder is not None and hasattr(holder, "spk_embed"):
            table = holder.spk_embed.weight.detach().float().numpy()
    return table


def _write_attachments(cfg, out_dir: Path, encoder: TokenTextEncoder, model):
    dict_path = locate_dictionary(cfg.get("dictionary"), cfg.get("work_dir"))
    (out_dir / "dictionary.txt").write_bytes(Path(dict_path).read_bytes())
    encoder.store_to_file(out_dir / "phonemes.txt")
    # speaker embedding attachments
    spk_map_path = Path(cfg["work_dir"]) / "spk_map.json"
    if cfg.get("use_spk_id", False) and spk_map_path.exists():
        with open(spk_map_path) as f:
            spk_map = json.load(f)
        table = _spk_table(model)
        if table is not None:
            for name, idx in spk_map.items():
                (out_dir / f"{name}.emb").write_bytes(table[idx].tobytes())
                print(f"| export speaker embed: {name}.emb")


def _load_spk_map(cfg) -> dict:
    with open(Path(cfg["work_dir"]) / "spk_map.json") as f:
        return json.load(f)


def _spk_mix_vector(cfg, model, mixspec: str, spk_map=None) -> np.ndarray:
    """Resolve a 'name[:w]|name[:w]' mix to one embedding vector [H]."""
    from ..utils.spk_mix import parse_commandline_spk_mix

    spk_map = spk_map if spk_map is not None else _load_spk_map(cfg)
    mix = parse_commandline_spk_mix(mixspec)
    unknown = sorted(set(mix) - set(spk_map))
    assert not unknown, f"unknown speaker(s) {unknown}; available: {sorted(spk_map)}"
    table = _spk_table(model)
    return sum(w * table[spk_map[name]] for name, w in mix.items())


def _static_spk_mix_embed(cfg, model, freeze_spk: str) -> torch.Tensor:
    """Bake a static speaker mix into the graph (ref:
    deployment/exporters/acoustic_exporter.py:57-79 ``--freeze_spk``)."""
    vec = np.asarray(_spk_mix_vector(cfg, model, freeze_spk), np.float32)
    return torch.from_numpy(vec)[None, None]  # [1, 1, H]


def _export_spk_attachments(cfg, model, out: Path, export_spk):
    """Write named speaker-mix .emb attachments for ``--export_spk``
    'key=mixspec' entries (ref: acoustic_exporter.py:108-158)."""
    if not export_spk:
        return
    spk_map = _load_spk_map(cfg)
    for entry in export_spk:
        key, _, mixspec = entry.partition("=")
        vec = _spk_mix_vector(cfg, model, mixspec or key, spk_map)
        (out / f"{key}.emb").write_bytes(vec.astype(np.float32).tobytes())
        print(f"| export speaker mix embed: {key}.emb")


def _write_merged(merged, out: Path, name: str) -> str:
    merged = simplify_graph(merged, verbose=True)
    data = build_model(merged)
    path = out / f"{name}.onnx"
    path.write_bytes(data)
    print(f"| export merged graph: {path} ({len(data) / 1e6:.2f} MB)")
    return f"{name}.onnx"


def _export_merged_acoustic(cfg, model, core, normalizer, fs2_aux, inputs, names,
                            denoiser, B, T_f, M, out: Path) -> str:
    """ONE loop-bearing ``acoustic.onnx``: fs2+aux merged with a diffusion
    graph that embeds the full sampling loop behind runtime ``depth`` /
    ``steps`` inputs (ref: deployment/modules/diffusion.py:18-161 +
    acoustic_exporter.py:363-390, which OpenUTAU consumes)."""
    has_aux = model.aux_decoder is not None
    shallow = has_aux and cfg.get("use_shallow_diffusion", False)
    H = cfg.get("hidden_size", 256)
    out_names = ["condition", "aux_mel"] if has_aux else ["condition"]
    fs2_graph = trace_to_graph(
        fs2_aux, tuple(inputs.values()), input_names=names, output_names=out_names,
        graph_name="fs2_aux", prefix="fs2.",
    )
    spec_min = np.asarray(normalizer.spec_min)[:, 0]  # [1, 1, M]
    spec_max = np.asarray(normalizer.spec_max)[:, 0]
    if isinstance(core, GaussianDiffusion):
        diff_graph = build_ddpm_graph(
            denoiser, (B, 1, T_f, M), (B, T_f, H),
            spec_min=spec_min, spec_max=spec_max,
            alphas_cumprod=core.schedule.alphas_cumprod,
            timesteps=core.timesteps, k_step=core.k_step, shallow=shallow,
        )
    else:
        diff_graph = build_reflow_graph(
            denoiser, (B, 1, T_f, M), (B, T_f, H),
            spec_min=spec_min, spec_max=spec_max,
            t_start_cfg=core.t_start, time_scale_factor=core.time_scale_factor,
            shallow=shallow,
        )
    io_map = [("condition", "condition")]
    if shallow:
        io_map.append(("aux_mel", "x_aux"))
    return _write_merged(merge_graphs(fs2_graph, diff_graph, io_map, "acoustic"), out,
                         "acoustic")


def _export_merged_predictor(core, out: Path, *, name, pre_fn, pre_args, pre_names, den_fn,
                             shape, cond_shape, normalizer, out_names) -> str:
    """ONE loop-bearing ``<name>.onnx`` for a variance-family predictor:
    pre-conditioning graph merged with a sampler-loop graph whose repeat-bin
    denorm/mean/clamp post runs in-graph (ref:
    deployment/modules/diffusion.py:164-231 Pitch/MultiVariance ONNX)."""
    cond_out = f"{name}_cond"
    pre_g = trace_to_graph(
        pre_fn, tuple(pre_args), input_names=list(pre_names), output_names=[cond_out],
        graph_name=f"{name}_pre", prefix=f"{name}pre.",
    )
    kw = dict(
        spec_min=np.asarray(normalizer.spec_min), spec_max=np.asarray(normalizer.spec_max),
        shallow=False, post="curves", clamps=normalizer.clamps, out_names=out_names,
        cond_name=f"{name}_cond_in", prefix=f"{name}diff.", graph_name=f"{name}_diffusion",
    )
    if isinstance(core, GaussianDiffusion):
        dg = build_ddpm_graph(
            den_fn, shape, cond_shape, alphas_cumprod=core.schedule.alphas_cumprod,
            timesteps=core.timesteps, k_step=core.k_step, **kw)
    else:
        dg = build_reflow_graph(
            den_fn, shape, cond_shape, t_start_cfg=0.0,
            time_scale_factor=core.time_scale_factor, **kw)
    return _write_merged(merge_graphs(pre_g, dg, [(cond_out, f"{name}_cond_in")], name), out,
                         name)


def _phoneme_encoder(cfg) -> TokenTextEncoder:
    phdict = PhonemeDictionary.load(
        locate_dictionary(cfg.get("dictionary"), cfg.get("work_dir")))
    return TokenTextEncoder(phdict.phoneme_list)


@reuse_traces()
def export_acoustic(cfg, out_dir: Optional[str] = None, ckpt_steps=None, fmt: str = "onnx",
                    freeze_gender: Optional[float] = None,
                    freeze_velocity: Optional[float] = None,
                    freeze_spk: Optional[str] = None, export_spk: Optional[list] = None):
    """Gender (key-shift) / velocity (speed) / variance curves are exported
    as graph inputs when the model embeds them, matching the reference's
    exported input surface (deployment/modules/fastspeech2.py:43-108);
    ``freeze_*`` bakes a constant curve / speaker mix in instead
    (ref: acoustic_exporter.py:57-79)."""
    from ..models.toplevel import load_acoustic_state_dict
    from ..training.acoustic import build_acoustic
    from ..training.checkpoint import load_model_state_dict

    _check_format(fmt)
    out = Path(out_dir or (Path("artifacts") / cfg["exp_name"]))
    out.mkdir(parents=True, exist_ok=True)
    encoder = _phoneme_encoder(cfg)
    model, core, normalizer = build_acoustic(cfg, encoder.vocab_size)
    load_acoustic_state_dict(model, load_model_state_dict(cfg["work_dir"], cfg, "acoustic",
                                                          ckpt_steps))
    model.eval()

    B, T_ph, T_f, M = 1, 64, 512, cfg["audio_num_mel_bins"]
    H = cfg.get("hidden_size", 256)
    use_spk = cfg.get("use_spk_id", False)
    variance_inputs = [
        v for v in ("energy", "breathiness", "voicing", "tension")
        if cfg.get(f"use_{v}_embed", False)
    ]

    # dynamic input surface: name -> example array
    inputs = {
        "tokens": np.zeros((B, T_ph), np.int32),
        "mel2ph": np.zeros((B, T_f), np.int32),
        "f0": np.full((B, T_f), 220.0, np.float32),
    }
    for v in variance_inputs:
        inputs[v] = np.zeros((B, T_f), np.float32)
    frozen = {}
    if cfg.get("use_key_shift_embed", False):
        if freeze_gender is not None:
            shift_min, shift_max = cfg["augmentation_args"]["random_pitch_shifting"]["range"]
            val = freeze_gender * (shift_max if freeze_gender >= 0 else abs(shift_min))
            frozen["key_shift"] = torch.full((B, 1), val, dtype=torch.float32)
        else:
            inputs["key_shift"] = np.zeros((B, T_f), np.float32)
    if cfg.get("use_speed_embed", False):
        if freeze_velocity is not None:
            frozen["speed"] = torch.full((B, 1), float(freeze_velocity), dtype=torch.float32)
        else:
            inputs["speed"] = np.ones((B, T_f), np.float32)
    if use_spk:
        if freeze_spk is not None:
            frozen["spk_mix_embed"] = _static_spk_mix_embed(cfg, model, freeze_spk)
        else:
            # the editor supplies the (mixed) speaker embedding as an input,
            # like the reference's exported spk_embed input
            inputs["spk_mix_embed"] = np.zeros((B, 1, H), np.float32)
    names = list(inputs)

    def fs2_aux(*args):
        kw = dict(zip(names, args))
        kw.update(frozen)
        variances = {v: kw.pop(v) for v in variance_inputs}
        cond = model.condition(kw.pop("tokens"), kw.pop("mel2ph"), kw.pop("f0"),
                               variances=variances, **kw)
        if model.aux_decoder is None:
            return cond
        return cond, model.aux_out(cond)

    _export_fn(fs2_aux, tuple(inputs.values()), out, "fs2_aux")
    if use_spk:
        _export_spk_attachments(cfg, model, out, export_spk)

    x = np.zeros((B, 1, T_f, M), np.float32)
    t = np.zeros((B,), np.float32)
    cond = np.zeros((B, T_f, H), np.float32)

    def denoiser(x, t, cond):
        return model.denoise(x, t, cond)

    _export_fn(denoiser, (x, t, cond), out, "diffusion_step")
    merged_name = _export_merged_acoustic(
        cfg, model, core, normalizer, fs2_aux, inputs, names, denoiser, B, T_f, M, out)

    manifest = {
        "model_type": "acoustic",
        "diffusion_type": cfg.get("diffusion_type", "ddpm"),
        "phonemes": "phonemes.txt",
        "acoustic": f"fs2_aux.{fmt}",
        "acoustic_inputs": names,
        "frozen": sorted(frozen),
        "diffusion": f"diffusion_step.{fmt}",
        "vocoder": cfg.get("vocoder", "NsfHifiGAN"),
        "sample_rate": cfg["audio_sample_rate"],
        "hop_size": cfg["hop_size"],
        "num_mel_bins": cfg["audio_num_mel_bins"],
        "mel_base": str(cfg.get("mel_base", "e")),
        "use_key_shift_embed": cfg.get("use_key_shift_embed", False),
        "use_speed_embed": cfg.get("use_speed_embed", False),
        "use_energy_embed": cfg.get("use_energy_embed", False),
        "use_breathiness_embed": cfg.get("use_breathiness_embed", False),
        "use_voicing_embed": cfg.get("use_voicing_embed", False),
        "use_tension_embed": cfg.get("use_tension_embed", False),
        "speakers": _speaker_names(cfg, export_spk),
        "sampling": _sampling_block(cfg),
        # the single loop-bearing artifact an OpenUTAU-style consumer drives
        # directly with depth/steps (ref: acoustic_exporter.py:363-390)
        "acoustic_merged": merged_name,
        "acoustic_merged_inputs": names + ["depth", "steps"],
    }
    _write_attachments(cfg, out, encoder, model)
    _write_yaml(out / "dsconfig.yaml", manifest)
    return out


@reuse_traces()
def export_variance(cfg, out_dir: Optional[str] = None, ckpt_steps=None, fmt: str = "onnx",
                    freeze_expr: Optional[float] = None, freeze_glide: bool = False,
                    freeze_spk: Optional[str] = None, export_spk: Optional[list] = None):
    """``freeze_expr``/``freeze_glide``/``freeze_spk`` bake the
    expressiveness factor, the 'no glide' embedding, or a static speaker mix
    into the graphs instead of exposing them as inputs (ref:
    scripts/export.py variance options + deployment/modules/toplevel.py)."""
    from ..inference.variance import build_variance_cores, load_variance_model
    from ..models.toplevel import build_variance_normalizers

    _check_format(fmt)
    out = Path(out_dir or (Path("artifacts") / cfg["exp_name"]))
    out.mkdir(parents=True, exist_ok=True)
    encoder = _phoneme_encoder(cfg)
    model = load_variance_model(cfg, encoder.vocab_size, ckpt_steps, device="cpu")
    core = build_variance_cores(cfg)

    B, T_ph, T_f, T_n = 1, 64, 512, 32
    H = cfg.get("hidden_size", 256)
    use_spk = cfg.get("use_spk_id", False)
    frozen = []
    spk_const = None
    if use_spk and freeze_spk is not None:
        spk_const = _static_spk_mix_embed(cfg, model, freeze_spk)
        frozen.append("spk_mix_embed")
    tokens = np.zeros((B, T_ph), np.int32)
    midi = np.zeros((B, T_ph), np.int32)
    ph2word = np.ones((B, T_ph), np.int32)
    ph_dur = np.ones((B, T_ph), np.int32)
    word_dur = np.ones((B, T_ph), np.int32)  # [B, T_w], T_w <= T_ph
    spk_embed_in = np.zeros((B, 1, H), np.float32)
    spk_input = use_spk and spk_const is None
    # word mode: the consumer knows word durations (from the score), not
    # ph_dur — the reference's word-mode linguistic input surface
    # (deployment/modules/toplevel.py:197 forward_linguistic_encoder_word)
    dur_name = "word_dur" if cfg.get("predict_dur", True) else "ph_dur"

    def linguistic(tokens, midi, ph2word, durations, ph_spk_mix_embed=None):
        enc, dur = model.encode(
            tokens, midi, ph2word, infer=True, **{dur_name: durations},
            ph_spk_mix_embed=spk_const if spk_const is not None else ph_spk_mix_embed,
        )
        return (enc, dur) if dur is not None else enc

    ling_args = (tokens, midi, ph2word, word_dur if dur_name == "word_dur" else ph_dur)
    ling_names = ["tokens", "midi", "ph2word", dur_name]
    if spk_input:
        ling_args = ling_args + (spk_embed_in,)
        ling_names.append("ph_spk_mix_embed")
    _export_fn(linguistic, ling_args, out, "linguistic_dur")

    mel2ph = np.zeros((B, T_f), np.int32)
    enc_out = np.zeros((B, T_ph, H), np.float32)
    cond = np.zeros((B, T_f, H), np.float32)

    # frame-level condition builder (gather by mel2ph + spk), the stage
    # between the linguistic encoder and either predictor branch
    def frame_cond(encoder_out, mel2ph, spk_mix_embed=None):
        return model.frame_condition(
            encoder_out, mel2ph,
            spk_mix_embed=spk_const if spk_const is not None else spk_mix_embed)

    fc_args = (enc_out, mel2ph)
    if spk_input:
        fc_args = fc_args + (spk_embed_in,)
    _export_fn(frame_cond, fc_args, out, "frame_condition")
    if use_spk:
        _export_spk_attachments(cfg, model, out, export_spk)

    graphs = {
        "linguistic": f"linguistic_dur.{fmt}",
        "frame_condition": f"frame_condition.{fmt}",
    }
    graph_inputs = {
        "linguistic": ling_names,
        "frame_condition": (
            ["encoder_out", "mel2ph"] + (["spk_mix_embed"] if spk_input else [])
        ),
    }
    normalizers = build_variance_normalizers(cfg)
    if model.predict_pitch:
        pargs = cfg.get("pitch_prediction_args", {})
        xp = np.zeros((B, 1, T_f, pargs.get("repeat_bins", 64)), np.float32)
        t = np.zeros((B,), np.float32)

        # pre-predictor: base_pitch/retake(+melody encoder) conditioning
        # (ref: deployment/modules/toplevel.py:300-392 view_as_pitch_pre)
        base_pitch = np.full((B, T_f), 60.0, np.float32)
        note_midi = np.full((B, T_n), 60.0, np.float32)
        note_rest = np.zeros((B, T_n), bool)
        note_dur = np.ones((B, T_n), np.int32)
        note_glide = np.zeros((B, T_n), np.int32)
        mel2note = np.ones((B, T_f), np.int32)
        expr = np.ones((B, T_f), np.float32)

        pre_names = ["condition", "mel2ph", "base_pitch"]
        pre_vals = [cond, mel2ph, base_pitch]
        pre_frozen = {}
        if freeze_expr is not None:
            pre_frozen["pitch_expr"] = torch.full((B, 1), float(freeze_expr),
                                                  dtype=torch.float32)
            frozen.append("expr")
        else:
            pre_names.append("pitch_expr")
            pre_vals.append(expr)
        pre_names += ["note_midi", "note_rest", "note_dur"]
        pre_vals += [note_midi, note_rest, note_dur]
        if freeze_glide:
            pre_frozen["note_glide"] = torch.from_numpy(note_glide)  # all 'none' glide
            frozen.append("glide")
        else:
            pre_names.append("note_glide")
            pre_vals.append(note_glide)
        pre_names.append("mel2note")
        pre_vals.append(mel2note)

        def pitch_pre(*args):
            kw = dict(zip(pre_names, args))
            kw.update(pre_frozen)
            return model.pitch_condition(kw.pop("condition"), kw.pop("mel2ph"),
                                         kw.pop("base_pitch"), **kw)

        _export_fn(pitch_pre, tuple(pre_vals), out, "pitch_pre")

        def pitch_step(x, t, cond):
            return model.denoise_pitch(x, t, cond)

        _export_fn(pitch_step, (xp, t, cond), out, "pitch_step")
        graphs["pitch_pre"] = f"pitch_pre.{fmt}"
        graphs["pitch"] = f"pitch_step.{fmt}"
        graph_inputs["pitch_pre"] = list(pre_names)
        graph_inputs["pitch"] = ["x", "t", "condition"]
        graphs["pitch_merged"] = _export_merged_predictor(
            core, out, name="pitch", pre_fn=pitch_pre, pre_args=tuple(pre_vals),
            pre_names=pre_names, den_fn=pitch_step, shape=tuple(xp.shape),
            cond_shape=(B, T_f, H), normalizer=normalizers["pitch"], out_names=("pitd",),
        )
        graph_inputs["pitch_merged"] = list(pre_names) + ["depth", "steps"]
    if model.predict_variances:
        vargs = cfg.get("variances_prediction_args", {})
        n = len(model.variance_prediction_list)
        xv = np.zeros((B, n, T_f, vargs.get("total_repeat_bins", 48) // n), np.float32)
        t = np.zeros((B,), np.float32)

        # pre-predictor: pitch embedding into the condition
        pitch = np.full((B, T_f), 60.0, np.float32)

        def variance_pre(condition, pitch):
            return model.variance_condition(condition, pitch, {})

        _export_fn(variance_pre, (cond, pitch), out, "variance_pre")

        def var_step(x, t, cond):
            return model.denoise_variance(x, t, cond)

        _export_fn(var_step, (xv, t, cond), out, "variance_step")
        graphs["variance_pre"] = f"variance_pre.{fmt}"
        graphs["variance"] = f"variance_step.{fmt}"
        graph_inputs["variance_pre"] = ["condition", "pitch"]
        graph_inputs["variance"] = ["x", "t", "condition"]
        graphs["variance_merged"] = _export_merged_predictor(
            core, out, name="variance", pre_fn=variance_pre, pre_args=(cond, pitch),
            pre_names=["condition", "pitch"], den_fn=var_step, shape=tuple(xv.shape),
            cond_shape=(B, T_f, H), normalizer=normalizers["variances"],
            out_names=tuple(model.variance_prediction_list),
        )
        graph_inputs["variance_merged"] = ["condition", "pitch", "depth", "steps"]

    manifest = {
        "model_type": "variance",
        "diffusion_type": cfg.get("diffusion_type", "ddpm"),
        "phonemes": "phonemes.txt",
        "graphs": graphs,
        "graph_inputs": graph_inputs,
        "speakers": _speaker_names(cfg, export_spk),
        "sampling": _sampling_block(cfg),
        "sample_rate": cfg["audio_sample_rate"],
        "hop_size": cfg["hop_size"],
        "predict_dur": cfg.get("predict_dur", True),
        "predict_pitch": cfg.get("predict_pitch", True),
        "predict_variances": list(model.variance_prediction_list),
        "use_melody_encoder": cfg.get("use_melody_encoder", False),
        "frozen": sorted(frozen),
        # post-predictor denormalization: mean over repeat bins, then map
        # [-1, 1] back to [norm_min, norm_max] (see models/diffusion/core.py)
        "pitch_post": {
            k: cfg.get("pitch_prediction_args", {}).get(k)
            for k in ("pitd_norm_min", "pitd_norm_max", "pitd_clip_min",
                      "pitd_clip_max", "repeat_bins")
        } if model.predict_pitch else None,
        "variance_post": {
            "total_repeat_bins": cfg.get("variances_prediction_args", {}).get(
                "total_repeat_bins"),
            "ranges": {
                v: [cfg.get(f"{v}_db_min" if v != "tension" else "tension_logit_min"),
                    cfg.get(f"{v}_db_max" if v != "tension" else "tension_logit_max")]
                for v in model.variance_prediction_list
            },
        } if model.predict_variances else None,
    }
    _write_attachments(cfg, out, encoder, model)
    _write_yaml(out / "dsconfig.yaml", manifest)
    return out


def export_nsf_hifigan(cfg, out_dir: Optional[str] = None, ckpt_path: Optional[str] = None,
                       fmt: str = "onnx"):
    """Export the NSF-HiFiGAN vocoder as a (mel, f0) -> wav graph plus a
    ``vocoder.yaml`` mel-spec manifest (ref:
    deployment/exporters/nsf_hifigan_exporter.py:32-118).

    The graph is the stock f32 generator (not the time-folded layout the
    runners use), as the reference exports it.  It takes natural-log mel
    [1, T, M] and f0 [1, T] and returns the 44.1 kHz waveform [1, T * hop];
    consumers feeding log10 mel must scale by ln(10) first (the manifest
    records ``mel_base``).  The NSF source is the deterministic one (no
    random phases or noise).
    """
    from ..models.vocoders.wrapper import load_generator

    _check_format(fmt)
    out = Path(out_dir or (Path("artifacts") / "nsf_hifigan"))
    out.mkdir(parents=True, exist_ok=True)
    h, generator = load_generator(ckpt_path or cfg["vocoder_ckpt"])

    T_f = 256
    mel = np.zeros((1, T_f, h["num_mels"]), np.float32)
    f0 = np.full((1, T_f), 220.0, np.float32)

    def spec2wav(mel, f0):
        return generator(mel, f0, dtype=torch.float32, stages={})

    _export_fn(spec2wav, (mel, f0), out, "nsf_hifigan")

    manifest = {
        "name": "NSF-HiFiGAN",
        "model": f"nsf_hifigan.{fmt}",
        "sample_rate": h["sampling_rate"],
        "hop_size": h["hop_size"],
        "win_size": h["win_size"],
        "fft_size": h["n_fft"],
        "num_mel_bins": h["num_mels"],
        "mel_fmin": h["fmin"],
        "mel_fmax": h["fmax"],
        "mel_base": "e",
        "mel_scale": "slaney",
    }
    _write_yaml(out / "vocoder.yaml", manifest)
    return out
