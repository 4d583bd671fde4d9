"""Denoiser backbones.  This slice ports LYNXNet; WaveNet is queued."""

from __future__ import annotations

from .lynxnet import LYNXNet

BACKBONES = {"lynxnet": LYNXNet}


def build_backbone(out_dims: int, num_feats: int, backbone_type: str, backbone_args: dict,
                   cond_dims: int = 256):
    from ...utils import filter_kwargs

    if backbone_type not in BACKBONES:
        raise NotImplementedError(
            f"backbone {backbone_type!r} is not ported yet (ported: {sorted(BACKBONES)})"
        )
    cls = BACKBONES[backbone_type]
    kwargs = dict(backbone_args or {})
    kwargs.update(in_dims=out_dims, n_feats=num_feats, cond_dims=cond_dims)
    return cls(**filter_kwargs(kwargs, cls.__init__))
