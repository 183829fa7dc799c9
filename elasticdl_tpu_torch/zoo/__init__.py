"""The port's model zoo: a registry from an artifact's recorded
``model_def`` to the port's module.

Counterpart of ``elasticdl_tpu/common/model_utils.py`` ``load_module`` +
``load_model_spec``.  The nine names below are the JAX zoo's, which
artifacts and jobs record; they resolve to the port's modules whatever
the recorded ``model_zoo`` says (importing it would load the JAX zoo).
Any other ``model_def`` is a user's module, imported from ``model_zoo``
by ``common/model_utils.load_module``.  This directory is deliberately
not named ``model_zoo``.
"""

from __future__ import annotations

import inspect
from types import ModuleType
from typing import Union

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.params import parse_dict_params
from elasticdl_tpu_torch.zoo import (
    census_feature_columns,
    census_wide_deep,
    cifar10,
    deepfm,
    mnist,
    resnet50,
    transformer_lm,
    wide_and_deep,
)

REGISTRY = {
    "deepfm.deepfm_functional_api": deepfm,
    "transformer.transformer_lm": transformer_lm,
    "mnist.mnist_functional_api": mnist,
    "mnist.mnist_subclass": mnist.SUBCLASS,
    "cifar10.cifar10_functional_api": cifar10,
    "resnet50.resnet50_subclass": resnet50,
    "census.census_wide_deep": census_wide_deep,
    "census.census_feature_columns": census_feature_columns,
    "wide_and_deep.wide_and_deep": wide_and_deep,
}

#: Job flags the JAX loader forwards into ``model_params`` when the
#: model's ``custom_model`` declares them and the params do not set them
#: (``model_utils._forward_flag``), at the values a serving load gets.
SERVING_FLAG_DEFAULTS = {
    "use_bf16": True,
    "sparse_apply_every": 1,
    "sparse_kernel": "auto",
}


def resolve(model_def: str, model_zoo: str = "") -> ModuleType:
    """The module of ``model_def``: the port's own for a registry name,
    else the user's from ``model_zoo`` (``model_utils.load_module``)."""
    from elasticdl_tpu_torch.common.model_utils import load_module

    return load_module(model_zoo, model_def)


def build_model(model_def: str, model_params: Union[str, dict], device=None,
                model_zoo: str = ""):
    """Build the module of an artifact's ``model_def`` (from ``model_zoo``
    when it is a user's) and ``model_params`` on ``device`` (None: the
    CUDA card, raising without one, or the device of a ``mesh`` in the
    params; weights uninitialised)."""
    module = resolve(model_def, model_zoo)
    params = (
        parse_dict_params(model_params)
        if isinstance(model_params, str)
        else dict(model_params)
    )
    accepted = inspect.signature(module.custom_model).parameters
    for name, value in SERVING_FLAG_DEFAULTS.items():
        if name in accepted and name not in params:
            params[name] = value
    if device is None and params.get("mesh") is not None:
        return module.custom_model(**params)  # on the mesh's device
    return module.custom_model(**params, device=resolve_device(device))
