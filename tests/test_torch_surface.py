"""The port covers the JAX package's public surface: its files, its public
names and its command line.

Pure AST: neither package is imported.  Each check has a table of the
places where the port departs from the JAX package by design; every entry
names the port's counterpart, which must exist, and a reason.  An entry
that is no longer needed (the JAX name or file is gone, or the port now has
it under the same name) fails the test, so the tables stay tight.
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "xiaoicesing_io_tpu"
PORT = ROOT / "xiaoicesing_io_tpu_torch"

# JAX file (relative to its package) -> (port counterparts, reason).  The
# names of a JAX module listed here are looked up in its ``.py``
# counterparts.
FILES = {
    "cli/__init__.py": (("cli.py",), "the click package is one argparse module"),
    "cli/main.py": (("cli.py",), "click commands become argparse subcommands "
                                 "(checked by test_cli_command_covered)"),
    "configs/base.yaml": (("configs/acoustic.json", "configs/variance.json"),
                          "merged into both shipped configs, which load without PyYAML"),
    "configs/acoustic.yaml": (("configs/acoustic.json",), "base.yaml + acoustic.yaml, merged"),
    "configs/variance.yaml": (("configs/variance.json",), "base.yaml + variance.yaml, merged"),
    "dsp/native.py": (("dsp/pitch.py", "dsp/hnsep.py"),
                      "numpy by design: the port runs the numpy routines that are the "
                      "JAX package's fallbacks, with no g++-built library"),
    "models/backbones/lynx_pallas.py": (("models/backbones/lynx_cuda.py",),
                                        "the LYNXNet denoiser on the CUDA kernels"),
    "models/backbones/wavenet_pallas.py": (("models/backbones/wavenet_cuda.py",),
                                           "the WaveNet denoiser on the CUDA kernel"),
    "ops/pallas/__init__.py": (("ops/cuda/__init__.py", "ops/cuda/sm90.py"),
                               "Pallas kernels -> hand-written CUDA kernels for sm_90a"),
    "ops/pallas/hifigan_resblock.py": (("ops/cuda/hifigan_resblock.py",
                                        "csrc/hifigan_resblock.cu"), "kernel K6"),
    "ops/pallas/hifigan_stage.py": (("ops/cuda/hifigan_stage.py", "csrc/hifigan_stage.cu"),
                                    "kernel K2"),
    "ops/pallas/lynx_conv.py": (("ops/cuda/lynx_conv.py", "csrc/lynx_conv.cu"), "kernel K1"),
    "ops/pallas/lynx_conv2.py": (("ops/cuda/lynx_layer.py", "csrc/lynx_layer.cu"),
                                 "kernel K5"),
    "ops/pallas/lynx_conv3.py": (("ops/cuda/lynx_layer.py", "csrc/lynx_layer.cu"),
                                 "kernel K7, the GEMM core's persistent entry"),
    "ops/pallas/lynx_hybrid.py": (("ops/cuda/lynx_hybrid.py", "csrc/lynx_hybrid.cu"),
                                  "kernel K8"),
    "ops/pallas/mel_kernel.py": (("ops/cuda/mel_spec.py", "csrc/mel_spec.cu"), "kernel K3"),
    "ops/pallas/wavenet_block.py": (("ops/cuda/wavenet_block.py", "csrc/wavenet_block.cu"),
                                    "kernel K4"),
}

# JAX modules whose names are not walked, with the reason.
UNWALKED = {
    "cli/main.py": "its names are click callbacks; test_cli_command_covered checks the "
                   "commands and options",
    "dsp/native.py": "ctypes bindings of a native library the port does not build",
}

# "JAX module:qualname" -> ("port module:qualname", reason).  An entry for a
# class covers its methods.  A counterpart is a function, class or method
# the port module defines, or an attribute it uses (``nn.BatchNorm2d``).
NAMES = {
    # idiom
    "utils/__init__.py:key_from_seed": (
        "utils/__init__.py:generator_from_seed",
        "JAX PRNG keys -> torch.Generator, seeded through seed_for"),
    "utils/profiling.py:xla_trace": (
        "utils/profiling.py:torch_trace", "XLA profiler -> torch.profiler"),
    "data/sampler.py:DistributedBatchSampler": (
        "data/sampler.py:BatchSampler", "one sampler, per rank under torch.distributed"),
    "ops/mel.py:MelSpectrogram.jax": (
        "ops/mel.py:MelSpectrogram.torch", "the jnp route -> the torch route (and .device)"),
    # JAX-only machinery with a torch counterpart
    "training/train_state.py:TrainState.create": (
        "training/train_state.py:TrainState.__init__", "a flax struct's factory"),
    "training/train_state.py:make_schedule_fn": (
        "training/schedules.py:build_lr_schedule", "optax schedule -> a function of the step"),
    "training/acoustic.py:init_acoustic_state": (
        "training/tasks.py:_train_state", "flax init -> torch modules hold their parameters"),
    "training/variance.py:init_variance_state": (
        "training/tasks.py:_train_state", "flax init -> torch modules hold their parameters"),
    "training/variance.py:build_variance": (
        "training/tasks.py:build_variance_trainer", "model, core and normalizers built there"),
    "training/finetune.py:freeze_mask": (
        "training/finetune.py:freeze_parameters", "optax mask -> requires_grad"),
    "training/finetune.py:wrap_optimizer_with_freezing": (
        "training/finetune.py:freeze_parameters", "optax mask -> requires_grad"),
    "training/checkpoint.py:load_params_for_inference": (
        "training/checkpoint.py:load_model_state_dict",
        "orbax params -> a state dict (found by find_model_checkpoint)"),
    "parallel/mesh.py:make_mesh": (
        "parallel/mesh.py:init_distributed", "jax.sharding mesh -> a torch.distributed group"),
    "parallel/mesh.py:batch_sharding": (
        "data/sampler.py:BatchSampler.batches_at_step", "each rank loads its own rows"),
    "parallel/mesh.py:replicated_sharding": (
        "parallel/mesh.py:broadcast_", "replicated arrays -> rank 0's tensors broadcast"),
    "parallel/mesh.py:shard_batch": (
        "data/sampler.py:BatchSampler.batches_at_step", "each rank loads its own rows"),
    "parallel/mesh.py:shard_host_local_batch": (
        "data/sampler.py:BatchSampler.batches_at_step", "each rank loads its own rows"),
    "parallel/mesh.py:make_train_step": (
        "parallel/mesh.py:all_reduce_mean_", "a pjit step -> gradients averaged over ranks"),
    "utils/torch_ckpt.py:convert_nsf_hifigan": (
        "models/vocoders/wrapper.py:load_generator", "the port loads torch state dicts natively"),
    "utils/torch_ckpt.py:convert_rmvpe": (
        "models/pe/rmvpe.py:E2E0.from_state_dict", "the port loads torch state dicts natively"),
    "utils/torch_ckpt.py:convert_cascaded_net": (
        "models/hnsep_vr.py:VocalRemover.__init__", "the port loads torch state dicts natively"),
    "utils/torch_ckpt.py:conv2d": (
        "utils/__init__.py:load_reference_weights", "the port loads torch state dicts natively"),
    "utils/torch_ckpt.py:batch_norm2d": (
        "utils/__init__.py:load_reference_weights", "the port loads torch state dicts natively"),
    "utils/torch_ckpt.py:load_torch_file": (
        "training/checkpoint.py:torch.load", "the port calls torch.load itself"),
    "models/diffusion/core.py:GaussianDiffusion.sample_t": (
        "training/acoustic.py:sample_t", "training's draw of t, from a torch.Generator"),
    "models/diffusion/core.py:RectifiedFlow.sample_t": (
        "training/acoustic.py:sample_t", "training's draw of t, from a torch.Generator"),
    "models/diffusion/core.py:RectifiedFlow.interpolate": (
        "training/acoustic.py:diffusion_branch", "x_t = x0 + t (x1 - x0) is inline there"),
    "ops/pallas/__init__.py:flatten_batch_windows": (
        "ops/cuda/sm90.py:map_plan",
        "the kernels read halo rows through a TMA tensor map, not gathered windows"),
    "ops/pallas/mel_kernel.py:PallasMelSpectrogram": (
        "ops/cuda/mel_spec.py:mel_spectrogram", "a module object -> the kernel's wrapper"),
    "models/toplevel.py:AcousticModel.__call__": (
        "models/toplevel.py:AcousticModel.__init__",
        "flax's init-only path; torch modules make their parameters when built"),
    "models/toplevel.py:VarianceModel.__call__": (
        "models/toplevel.py:VarianceModel.__init__",
        "flax's init-only path; torch modules make their parameters when built"),
    "models/toplevel.py:VarianceModel.setup": (
        "models/toplevel.py:VarianceModel.__init__", "flax setup -> the constructor"),
    "models/toplevel.py:VarianceModel.spk_embed_of": (
        "models/toplevel.py:VarianceModel._spk", "the speaker lookup"),
    # torch.nn built-ins
    "models/backbones/lynxnet.py:PReLU": ("models/backbones/lynxnet.py:nn.PReLU", "torch.nn"),
    "models/hnsep_vr.py:BatchNorm": ("models/hnsep_vr.py:nn.BatchNorm2d", "torch.nn"),
    "models/hnsep_vr.py:LSTMTorch": ("models/hnsep_vr.py:nn.LSTM", "torch.nn"),
    "models/hnsep_vr.py:upsample2_bilinear": ("models/hnsep_vr.py:F.interpolate", "torch.nn"),
    "models/pe/rmvpe.py:BatchNorm": ("models/pe/rmvpe.py:nn.BatchNorm2d", "torch.nn"),
    "models/pe/rmvpe.py:GRUCellTorch": ("models/pe/rmvpe.py:nn.GRU", "torch.nn"),
    "models/vocoders/nsf_hifigan.py:ConvTranspose1d": (
        "models/vocoders/nsf_hifigan.py:nn.ConvTranspose1d", "torch.nn"),
    "models/common.py:normal_embed_init": (
        "models/fastspeech/acoustic.py:nn.Embedding",
        "torch.nn; weights come from a checkpoint or a seed, not flax initialisers"),
    # moved
    "models/vocoders/wrapper.py:DDSP": ("models/vocoders/ddsp.py:DDSP", "a module of its own"),
}


def _jax_files():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts and p.suffix != ".pyc")


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(encoding="utf-8"))


def _defs(path: Path) -> set:
    """Every top-level function and class of a module, and every method of
    its top-level classes, as qualnames."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return out


def _public(path: Path) -> set:
    """Public functions and classes, and the public methods of public
    classes; a flax ``__call__`` counts as public."""
    out = set()
    for qual in _defs(path):
        head, _, meth = qual.partition(".")
        if not head.startswith("_") and (not meth.startswith("_") or meth == "__call__"):
            out.add(qual)
    return out


def _attributes(path: Path) -> set:
    """Dotted attribute chains a module uses (``nn.BatchNorm2d``)."""
    out = set()
    for node in ast.walk(_tree(path)):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if parts and isinstance(node, ast.Name):
            out.add(".".join([node.id, *reversed(parts)]))
    return out


def _mirrors(rel: str):
    """The port's ``.py`` modules that hold a JAX module's names."""
    return [r for r in FILES.get(rel, ((rel,), ""))[0] if r.endswith(".py")]


def _port_has(rel: str, qual: str) -> bool:
    """The port's mirror of JAX module ``rel`` has ``qual`` (a flax
    ``__call__`` may be a torch ``forward``)."""
    quals = {qual}
    if qual.endswith(".__call__"):
        quals.add(qual[: -len("__call__")] + "forward")
    return any(quals & _defs(PORT / m) for m in _mirrors(rel) if (PORT / m).exists())


def _counterpart_exists(spec: str) -> bool:
    mod, qual = spec.split(":")
    path = PORT / mod
    return path.exists() and (qual in _defs(path) or qual in _attributes(path))


def test_every_jax_file_has_a_port_counterpart():
    missing = [rel for rel in _jax_files() if rel not in FILES and not (PORT / rel).exists()]
    assert not missing, f"JAX files with no port file and no FILES entry: {missing}"


@pytest.mark.parametrize("rel", sorted(FILES))
def test_file_table_entry_is_needed_and_resolves(rel):
    counterparts, reason = FILES[rel]
    assert reason
    assert (JAX / rel).exists(), f"{rel} is gone from the JAX package; drop its entry"
    assert not (PORT / rel).exists(), f"the port now mirrors {rel}; drop its entry"
    absent = [c for c in counterparts if not (PORT / c).exists()]
    assert not absent, f"{rel}: counterparts missing from the port: {absent}"


@pytest.mark.parametrize("rel", [r for r in _jax_files() if r.endswith(".py")])
def test_public_names_covered(rel):
    if rel in UNWALKED:
        assert (JAX / rel).exists() and rel in FILES
        return
    listed = {k.split(":")[1] for k in NAMES if k.split(":")[0] == rel}
    missing = []
    for qual in sorted(_public(JAX / rel)):
        if qual in listed or qual.split(".")[0] in listed:
            continue
        if not _port_has(rel, qual):
            missing.append(qual)
    assert not missing, (f"{rel}: public names with no port counterpart of the same "
                         f"name and no NAMES entry: {missing}")


@pytest.mark.parametrize("key", sorted(NAMES))
def test_name_table_entry_is_needed_and_resolves(key):
    rel, qual = key.split(":")
    counterpart, reason = NAMES[key]
    assert reason
    assert rel not in UNWALKED, f"{key}: {rel} is not walked"
    assert qual in _public(JAX / rel), f"{key} is gone from the JAX package; drop its entry"
    assert not _port_has(rel, qual), f"the port now has {key} itself; drop its entry"
    assert _counterpart_exists(counterpart), f"{key}: counterpart {counterpart} not found"


# -- the command line -------------------------------------------------------

def _str_args(call: ast.Call):
    return [a.value for a in call.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]


def _click_name(fn_name: str) -> str:
    """click's default command name for a callback."""
    name = fn_name.lower().replace("_", "-")
    for suffix in ("-command", "-cmd", "-group", "-grp"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _jax_cli():
    """{command path: option strings and argument names} of the click CLI."""
    tree = _tree(JAX / "cli/main.py")
    shared = {n.targets[0].id: n.value for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
              and isinstance(n.targets[0], ast.Name)}
    groups, out = {}, {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        path, opts = None, set()
        for dec in node.decorator_list:
            call = shared.get(dec.id) if isinstance(dec, ast.Name) else dec
            if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                    and isinstance(call.func.value, ast.Name)):
                continue
            owner, kind = call.func.value.id, call.func.attr
            if owner == "click" and kind == "group":
                path = ()
            elif kind in ("command", "group") and owner in groups:
                names = _str_args(call)
                path = groups[owner] + (names[0] if names else _click_name(node.name),)
            elif owner == "click" and kind == "option":
                opts |= {s for s in _str_args(call) if s.startswith("-")}
            elif owner == "click" and kind == "argument":
                opts.add(_str_args(call)[0])
            if kind == "group" and path is not None:
                groups[node.name] = path
        if path is not None:
            out[path] = opts
    return out


def _port_cli():
    """{command path: option strings and positional names} of the argparse
    CLI, read by following ``build_parser`` through its helpers."""
    tree = _tree(PORT / "cli.py")
    funcs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    out = {}

    def in_order(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.Lambda)):
                continue
            yield child
            yield from in_order(child)

    def run(fn, env):
        for node in in_order(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                call, target = node.value, node.targets[0]
                f = call.func
                if not isinstance(target, ast.Name) or not isinstance(f, ast.Attribute):
                    continue
                if f.attr == "ArgumentParser":
                    env[target.id] = [()]
                owner = env.get(f.value.id) if isinstance(f.value, ast.Name) else None
                if owner is None:
                    continue
                if f.attr == "add_parser":
                    names = _str_args(call)[:1]
                    for kw in call.keywords:
                        if kw.arg == "aliases":
                            names += [e.value for e in kw.value.elts]
                    env[target.id] = [p + (n,) for p in owner for n in names]
                    for p in env[target.id]:
                        out.setdefault(p, set())
                elif f.attr in ("add_subparsers", "add_mutually_exclusive_group",
                                "add_argument_group"):
                    env[target.id] = owner
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr == "add_argument"
                        and isinstance(f.value, ast.Name) and f.value.id in env):
                    for p in env[f.value.id]:
                        out.setdefault(p, set()).update(_str_args(node))
                elif isinstance(f, ast.Name) and f.id in funcs:
                    callee = funcs[f.id]
                    params = [a.arg for a in callee.args.args]
                    bound = {p: env[a.id] for p, a in zip(params, node.args)
                             if isinstance(a, ast.Name) and a.id in env}
                    run(callee, {**env, **bound})

    run(funcs["build_parser"], {})
    return out


def test_cli_tables_read():
    jax, port = _jax_cli(), _port_cli()
    assert ("infer", "acoustic") in jax and "--dp" in jax[("infer", "acoustic")]
    assert ("export", "nsf-hifigan") in jax and "--format" in jax[("export", "nsf-hifigan")]
    assert ("convert_ckpt",) in port and "--ckpt_steps" in port[("convert_ckpt",)]
    assert "--format" in port[("export", "variance")]


@pytest.mark.parametrize("path", sorted(p for p in _jax_cli() if p), ids="/".join)
def test_cli_command_covered(path):
    port = _port_cli()
    assert path in port, f"the port's cli.py has no command {' '.join(path)}"
    missing = sorted(_jax_cli()[path] - port[path])
    assert not missing, f"{' '.join(path)}: options or arguments missing from the port: {missing}"
