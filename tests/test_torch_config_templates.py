"""The port's config templates, ``Config`` helpers, ``utils`` helpers,
``spec_to_figure`` and the models' ``category`` against the JAX package's,
on the CPU."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu import config as jconfig
from xiaoicesing_io_tpu import utils as jutils
from xiaoicesing_io_tpu_torch import config as pconfig
from xiaoicesing_io_tpu_torch import utils as putils

ROOT = Path(__file__).resolve().parent.parent
JAX_TEMPLATES = ROOT / "xiaoicesing_io_tpu" / "configs" / "templates"
PORT_TEMPLATES = ROOT / "xiaoicesing_io_tpu_torch" / "configs" / "templates"
TEMPLATES = ["config_acoustic.yaml", "config_variance.yaml"]


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_loads_as_jax_copy(name):
    ref = jconfig.load_config(JAX_TEMPLATES / name)
    got = pconfig.load_config(PORT_TEMPLATES / name)
    assert isinstance(got, pconfig.Config)
    assert got == ref
    # the template's own keys are there as written
    assert got.dictionary == "dictionaries/opencpop-extension.txt"
    assert got.max_updates == 160000


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_loads_alone(name, tmp_path, monkeypatch):
    """A user copies the template next to their data and runs from there."""
    shutil.copy(PORT_TEMPLATES / name, tmp_path / f"my_{name}")
    monkeypatch.chdir(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"my_{name}"]
    got = pconfig.load_config(f"my_{name}")
    assert got == jconfig.load_config(JAX_TEMPLATES / name)


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_names_port_commands(name):
    head = (PORT_TEMPLATES / name).read_text().split("\n\n")[0]
    assert "python -m xiaoicesing_io_tpu_torch.cli binarize --config" in head
    assert "python -m xiaoicesing_io_tpu_torch.cli train --config" in head
    assert "scripts/" not in head


def _mutate(cfg):
    """Copy ``cfg``, mutate the copy's nested dicts and a list, and return
    what the original looks like afterwards."""
    c = cfg.copy()
    c.binarization_args.num_workers = 99
    c.augmentation_args.random_pitch_shifting.enabled = False
    c.raw_data_dir.append("shared/list")
    c.augmentation_args.random_pitch_shifting.range.append(9.0)
    c.top_level_new_key = 1
    return type(c).__name__, dict(cfg), dict(c)


def test_config_copy_aliasing_matches_jax():
    name = TEMPLATES[0]
    jname, jorig, jcopy = _mutate(jconfig.load_config(JAX_TEMPLATES / name))
    pname, porig, pcopy = _mutate(pconfig.load_config(PORT_TEMPLATES / name))
    assert pname == "Config" == jname
    assert porig == jorig and pcopy == jcopy
    # nested dicts were copied at every level; lists are shared
    assert porig["binarization_args"]["num_workers"] == 8
    assert porig["augmentation_args"]["random_pitch_shifting"]["enabled"] is True
    assert porig["raw_data_dir"][-1] == "shared/list"
    assert porig["augmentation_args"]["random_pitch_shifting"]["range"][-1] == 9.0
    assert "top_level_new_key" not in porig


def test_config_subset_and_from_yaml_match_jax():
    path = PORT_TEMPLATES / TEMPLATES[1]
    pcfg = pconfig.Config.from_yaml(path)
    jcfg = jconfig.Config.from_yaml(JAX_TEMPLATES / TEMPLATES[1])
    assert isinstance(pcfg, pconfig.Config) and pcfg == jcfg == pconfig.load_config(path)
    keys = ["predict_dur", "melody_encoder_args", "no_such_key", "glide_types"]
    psub, jsub = pcfg.subset(keys), jcfg.subset(keys)
    assert isinstance(psub, pconfig.Config)
    assert psub == jsub and list(psub) == ["predict_dur", "melody_encoder_args", "glide_types"]
    assert psub.melody_encoder_args is pcfg.melody_encoder_args


class _Base:
    pass


class Built(_Base):
    def __init__(self, width, depth=2):
        self.width, self.depth = width, depth


def test_build_object_from_class_name():
    path = "xiaoicesing_io_tpu_torch.training.checkpoint.CheckpointManager"
    kw = dict(work_dir="ckpts", category="acoustic", num_ckpt_keep=3, unused_key=1)
    got = putils.build_object_from_class_name(path, None, **kw)
    ref = jutils.build_object_from_class_name(path, None, **kw)
    assert type(got) is type(ref)
    assert vars(got) == vars(ref)
    assert got.num_ckpt_keep == 3 and got.category == "acoustic"
    # positional arguments after base_cls, kwargs filtered by the signature
    got = putils.build_object_from_class_name(f"{__name__}.Built", _Base, 16, depth=3, other=0)
    assert (got.width, got.depth) == (16, 3)
    for fn in (putils.build_object_from_class_name, jutils.build_object_from_class_name):
        with pytest.raises(TypeError, match="is not a subclass of"):
            fn(path, torch.nn.Module, **kw)


@pytest.mark.parametrize("seed,B,T", [(0, 4, 10), (1, 8, 1), (7, 3, 257)])
def test_random_continuous_masks_bit_identical(seed, B, T):
    got = putils.random_continuous_masks(B, T, np.random.default_rng(seed))
    ref = jutils.random_continuous_masks(B, T, np.random.default_rng(seed))
    assert got.dtype == np.bool_ and got.shape == (B, T)
    np.testing.assert_array_equal(got, ref)
    # each row is one contiguous span
    for row in got.astype(np.int8):
        steps = np.diff(row)
        assert np.count_nonzero(steps == 1) <= 1 and np.count_nonzero(steps == -1) <= 1


@pytest.mark.parametrize("name", [
    "model_ckpt_steps_1200.ckpt", "exp/model_ckpt_steps_7", Path("w/model_ckpt_steps_0.ckpt"),
    "model_ckpt_steps_.ckpt", "model_ckpt_step_5.ckpt", "config.yaml", "",
])
def test_parse_ckpt_step(name):
    assert putils.parse_ckpt_step(name) == jutils.parse_ckpt_step(name)


def test_parse_ckpt_step_values():
    assert putils.parse_ckpt_step("model_ckpt_steps_1200.ckpt") == 1200
    assert putils.parse_ckpt_step("config.yaml") is None


def test_spec_to_figure_matches_jax():
    import matplotlib.pyplot as plt

    from xiaoicesing_io_tpu.utils import plot as jplot
    from xiaoicesing_io_tpu_torch.utils import plot as pplot

    spec = np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    figs = [m.spec_to_figure(spec, vmin=-1.0, vmax=2.0, title="mel") for m in (pplot, jplot)]
    try:
        (pq,), (jq,) = (f.axes[0].collections for f in figs)
        np.testing.assert_array_equal(np.asarray(pq.get_array()), np.asarray(jq.get_array()))
        np.testing.assert_array_equal(np.asarray(pq.get_array()).reshape(8, 20), spec.T)
        assert pq.get_clim() == jq.get_clim() == (-1.0, 2.0)
        assert [f.axes[0].get_title() for f in figs] == ["mel", "mel"]
        assert figs[0].get_size_inches().tolist() == figs[1].get_size_inches().tolist()
    finally:
        for f in figs:
            plt.close(f)


def test_models_category():
    from xiaoicesing_io_tpu.models.toplevel import AcousticModel as JAcoustic
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel as JVariance
    from xiaoicesing_io_tpu_torch.models.toplevel import AcousticModel, VarianceModel

    tiny = ("hidden_size=16,enc_layers=1,num_heads=2,"
            "backbone_args={'num_channels': 16, 'num_layers': 1, 'kernel_size': 31}")
    acfg = pconfig.load_config(PORT_TEMPLATES / TEMPLATES[0], overrides=tiny)
    vcfg = pconfig.load_config(
        PORT_TEMPLATES / TEMPLATES[1],
        overrides="hidden_size=16,enc_layers=1,num_heads=2,dur_prediction_args.hidden_size=16,"
                  "pitch_prediction_args.backbone_args.num_channels=16,"
                  "pitch_prediction_args.backbone_args.num_layers=1")
    acoustic, variance = AcousticModel.from_config(acfg, 8), VarianceModel.from_config(vcfg, 8)
    assert acoustic.category == "acoustic" == JAcoustic.from_config(acfg, 8).category
    assert variance.category == "variance" == JVariance.from_config(vcfg, 8).category
    with pytest.raises(AttributeError):
        acoustic.category = "variance"
