"""The program half of the image families: the program's image classifier of
the configuration's ``network`` (``gqx_torch.models.create_model``), sized by
the data pipeline's images, its leaves' paths (``gqx_torch.convert``) and
its batch norms' running statistics.  It imports the program only inside its
functions."""

from __future__ import annotations

from typing import Dict

import torch

BN_SCALE = "/BatchNorm_0/scale"


def config_fields(spec, traffic, seed: int) -> dict:
    """The data fields of the program's ``GQConfig``."""
    data = traffic["data"]
    return dict(dataset=data["dataset"], num_classes=spec["num_classes"],
                dataset_kwargs=dict(num_train=data["num_train"], num_test=data["num_test"],
                                    seed=int(seed)))


def build(spec, config, pipeline):
    from gqx_torch.models import create_model

    return create_model(spec["network"], config.num_classes, spec["compute_dtype"], None,
                        image_shape=pipeline.image_shape)


def leaf_paths(model) -> Dict[str, str]:
    from gqx_torch.convert import leaf_paths

    return leaf_paths(model)


def running_buffers(model, paths: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """{"<bn prefix>/mean" or "/var": running statistic} by the
    configuration's paths."""
    mods = dict(model.named_modules())
    out = {}
    for n, path in paths.items():
        if path.endswith(BN_SCALE):
            mod = mods[n[:-len(".weight")]]
            prefix = path[:-len(BN_SCALE)]
            out[f"{prefix}/mean"] = mod.running_mean
            out[f"{prefix}/var"] = mod.running_var
    return out
