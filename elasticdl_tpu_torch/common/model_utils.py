"""The model-zoo contract of a job: the port's copy of
``elasticdl_tpu/common/model_utils.py`` (``ModelSpec`` :24,
``load_model_spec`` :103).

``model_def`` resolves through the port's zoo (``zoo.REGISTRY``), never
by importing ``--model_zoo``, which is accepted and ignored.  The job
flags JAX forwards into ``model_params`` when ``custom_model`` declares
them and the params do not set them (``_forward_flag``): ``use_bf16``,
``sparse_apply_every`` and ``sparse_kernel``.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.params import parse_dict_params

logger = get_logger("common.model_utils")


@dataclass
class ModelSpec:
    module: Any
    custom_model: Callable
    loss: Callable
    optimizer: Callable
    dataset_fn: Callable
    # The columnar task path's whole-column transform (data/columnar.py).
    columnar_dataset_fn: Optional[Callable] = None
    eval_metrics_fn: Optional[Callable] = None
    callbacks: Optional[Callable] = None
    custom_data_reader: Optional[Callable] = None
    # The model's sparse row-wise optimizer for its embedding tables (PS).
    embedding_optimizer: Optional[Callable] = None
    model_params: dict = field(default_factory=dict)

    def build_model(self, mesh=None, device=None):
        """The model on ``device`` (None: the card), or on ``mesh``'s
        device when the model takes a mesh (``custom_model`` declaring
        ``mesh``)."""
        params = dict(self.model_params)
        if mesh is not None and _accepts(self.custom_model, "mesh"):
            logger.info("Mesh-aware model: forwarding %r", mesh)
            return self.custom_model(**params, mesh=mesh)
        return self.custom_model(**params, device=device)


def _accepts(fn, name: str) -> bool:
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _forward_flag(custom_model, model_params: dict, name, value) -> None:
    if _accepts(custom_model, name) and name not in model_params:
        model_params[name] = value


def load_model_spec(args) -> ModelSpec:
    """Resolve the zoo contract from parsed job args."""
    from elasticdl_tpu_torch import zoo

    module = zoo.resolve(args.model_def)

    def require(name):
        fn = getattr(module, name, None)
        if fn is None:
            raise ValueError(f"Model module {args.model_def!r} must define {name}()")
        return fn

    def optional(name):
        return getattr(module, name, None) if name else None

    custom_model = require("custom_model")
    model_params = parse_dict_params(args.model_params)
    _forward_flag(custom_model, model_params, "use_bf16", bool(getattr(args, "use_bf16", True)))
    job_w = getattr(args, "sparse_apply_every", 1) or 1
    if job_w != "auto":
        job_w = int(job_w)
    explicit_w = model_params.get("sparse_apply_every")
    if explicit_w is not None and explicit_w != job_w and job_w != "auto":
        logger.warning(
            "model_params sparse_apply_every=%s overrides the job flag "
            "--sparse_apply_every=%s for the TABLE LAYOUT only; the trainer still "
            "applies with the job flag's interval", explicit_w, job_w)
    _forward_flag(custom_model, model_params, "sparse_apply_every", job_w)
    _forward_flag(custom_model, model_params, "sparse_kernel",
                  getattr(args, "sparse_kernel", "auto") or "auto")
    return ModelSpec(
        module=module,
        custom_model=custom_model,
        loss=require(args.loss),
        optimizer=require(args.optimizer),
        dataset_fn=require(args.dataset_fn),
        columnar_dataset_fn=optional("columnar_dataset_fn"),
        eval_metrics_fn=optional(args.eval_metrics_fn),
        callbacks=optional(args.callbacks),
        custom_data_reader=optional(args.custom_data_reader),
        embedding_optimizer=optional("embedding_optimizer"),
        model_params=model_params,
    )
