"""Legacy-config compatibility (same semantics as the JAX package's ``compat.py``)."""

from __future__ import annotations


def migrate_legacy_keys(cfg: dict) -> dict:
    """``g2p_dictionary`` -> ``dictionary`` and ``pl_trainer_precision`` ->
    ``precision`` when the new key is absent.  Mutates and returns ``cfg``."""
    if "dictionary" not in cfg and cfg.get("g2p_dictionary"):
        cfg["dictionary"] = cfg["g2p_dictionary"]
    if "precision" not in cfg and cfg.get("pl_trainer_precision"):
        cfg["precision"] = str(cfg["pl_trainer_precision"])
    return cfg


def get_backbone_type(root_config: dict, nested_config: dict = None) -> str:
    if nested_config is None:
        nested_config = root_config
    return nested_config.get(
        "backbone_type",
        root_config.get("backbone_type", root_config.get("diff_decoder_type", "wavenet")),
    )


def get_backbone_args(config: dict, backbone_type: str):
    args = config.get("backbone_args")
    if args is not None:
        return args
    if backbone_type == "wavenet":
        return {
            "num_layers": config.get("residual_layers"),
            "num_channels": config.get("residual_channels"),
            "dilation_cycle_length": config.get("dilation_cycle_length"),
        }
    return None


def migrate_sampling_keys(cfg, depth=None, steps=None):
    """timesteps/K_step/diff_speedup -> time_scale_factor/T_start/
    sampling_steps, plus the ``--depth`` / ``--steps`` overrides.  Mutates and
    returns ``cfg``."""
    if "diff_speedup" not in cfg and "pndm_speedup" in cfg:
        cfg["diff_speedup"] = cfg["pndm_speedup"]
    timesteps = cfg.get("timesteps", 1000)
    if "T_start" not in cfg and "K_step" in cfg:
        cfg["T_start"] = 1 - cfg["K_step"] / timesteps
    if "T_start_infer" not in cfg and "K_step_infer" in cfg:
        cfg["T_start_infer"] = 1 - cfg["K_step_infer"] / timesteps
    if "sampling_steps" not in cfg:
        speedup = max(1, cfg.get("diff_speedup", 10))
        if cfg.get("use_shallow_diffusion", False) and "K_step_infer" in cfg:
            cfg["sampling_steps"] = cfg["K_step_infer"] // speedup
        else:
            cfg["sampling_steps"] = timesteps // speedup
    if "time_scale_factor" not in cfg:
        cfg["time_scale_factor"] = timesteps

    if depth is not None:
        t_start = cfg.get("T_start", 0.0)
        assert depth <= 1 - t_start, (
            f"Depth should not be larger than 1 - T_start ({1 - t_start})"
        )
        cfg["K_step_infer"] = round(timesteps * depth)
        cfg["T_start_infer"] = 1 - depth
    if steps is not None:
        if cfg.get("use_shallow_diffusion", False):
            step_size = (1 - cfg.get("T_start_infer", 0.0)) / steps
            if "K_step_infer" in cfg:
                cfg["diff_speedup"] = max(1, round(step_size * cfg["K_step_infer"]))
        elif "timesteps" in cfg:
            cfg["diff_speedup"] = max(1, round(timesteps / steps))
        cfg["sampling_steps"] = steps
    return cfg
