"""The port's variance binarizer with its nets, against the JAX package, on
the CPU: ``pe: rmvpe`` with ``hnsep: vr``, ``prefer_ds`` (two items carry
their f0, energy and breathiness in a ``.ds``), and ``num_workers``.

RMVPE and the vocal remover have random weights written under the
reference names (the small ``E2E0`` of ``tests/test_torch_pe.py``; the
``CascadedNet`` of ``tests/test_torch_hnsep.py``).  The JAX RMVPE is built
as usual from a full-depth checkpoint, then given the small net's model and
params; the port loads the small checkpoint itself.  The sets are held as
in ``tests/test_torch_binarizer.py``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu.dsp.hnsep import DecomposedWaveform as JDecomposed
from xiaoicesing_io_tpu.models.pe import rmvpe as jrmvpe
from xiaoicesing_io_tpu_torch.data.indexed_dataset import IndexedDataset
from xiaoicesing_io_tpu_torch.preprocessing.variance_binarizer import VarianceBinarizer
from xiaoicesing_io_tpu_torch.utils.jax_weights import rmvpe_state_dict_from_jax

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_binarizer import (  # noqa: E402
    CURVE_TOL, CURVES, check_variance_binarizer, make_variance_set, read_set, run_port,
    variance_cfg,
)
from test_torch_hnsep import write_vr  # noqa: E402
from test_torch_pe import (  # noqa: E402,F401 (few_torch_threads: autouse)
    SMALL, few_torch_threads, full_depth_checkpoint, small_params,
)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Small RMVPE and vocal-remover checkpoints under the reference names,
    and the full-depth checkpoint the JAX runner's constructor converts."""
    d = tmp_path_factory.mktemp("nets")
    params = small_params(11)
    torch.save({"model": rmvpe_state_dict_from_jax(params)}, d / "rmvpe_small.pt")
    full_depth_checkpoint(d / "rmvpe_full.pt")
    return {"pe_port": str(d / "rmvpe_small.pt"), "pe_jax": str(d / "rmvpe_full.pt"),
            "vr": str(write_vr(d / "vr", seed=12)), "small_rmvpe": (jrmvpe.E2E0(**SMALL), params)}


def test_variance_binarizer_with_nets_matches_jax(tmp_path, nets, monkeypatch):
    monkeypatch.setattr(JDecomposed, "_VR_MODEL", None)
    root = make_variance_set(tmp_path)
    check_variance_binarizer(root, "rmvpe", "vr", nets, nets["small_rmvpe"])
    # the .ds items carry their f0 and their energy and breathiness unsmoothed
    item = read_set(IndexedDataset, root / "port", "valid")[0]
    ds = json.loads((root / "tenor" / "ds" / "w1.ds").read_text())[0]
    assert abs(float(item["energy"][0]) - float(ds["energy"].split()[0])) < 0.5


def test_workers_give_the_same_set(tmp_path, nets):
    """``num_workers`` 2 (``spawn`` workers that load RMVPE and the vocal
    remover on the binarizer's device themselves) writes the set that 0
    writes: the same ``.meta`` and integer arrays, floats within 1e-5 and the
    curves within ``CURVE_TOL``.  A worker runs torch on another number of
    threads, which can move an f32 sum by an ulp, and the logit of a tension
    near 1 magnifies that (2.6e-4 measured at a tension of 0.9996)."""
    root = make_variance_set(tmp_path)
    outs = []
    for workers in (0, 2):
        cfg = variance_cfg(True, root, f"w{workers}", "rmvpe", "vr", nets)
        cfg["binarization_args"] = dict(cfg["binarization_args"], num_workers=workers)
        run_port(VarianceBinarizer, cfg)
        outs.append(root / f"w{workers}")
    for prefix in ("valid", "train"):
        assert ((outs[0] / f"{prefix}.meta").read_bytes()
                == (outs[1] / f"{prefix}.meta").read_bytes())
        for a, b in zip(read_set(IndexedDataset, outs[0], prefix),
                        read_set(IndexedDataset, outs[1], prefix)):
            assert sorted(a) == sorted(b)
            for k in a:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                assert x.dtype == y.dtype and x.shape == y.shape, k
                if np.issubdtype(x.dtype, np.floating):
                    np.testing.assert_allclose(x, y, rtol=0, err_msg=k,
                                               atol=CURVE_TOL if k in CURVES else 1e-5)
                else:
                    np.testing.assert_array_equal(x, y, err_msg=k)
