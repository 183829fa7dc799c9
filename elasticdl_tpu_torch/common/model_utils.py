"""The model-zoo contract of a job: the port's copy of
``elasticdl_tpu/common/model_utils.py`` (``ModelSpec`` :24,
``load_model_spec`` :103).

``load_module`` (``:73-87``) resolves ``model_def``: the nine names of
the port's zoo (``zoo.REGISTRY``: what artifacts and jobs record, the
JAX zoo's names) are the port's own modules, whatever ``--model_zoo``
says; any other name is imported from the ``--model_zoo`` directory as
JAX does (its parent on ``sys.path``, then
``<basename>.<model_def>``), or from an importable package of that
name.  A user module whose import pulls in a forbidden module (JAX,
flax, optax, the JAX package or its zoo: ``common/boundary.py``) is
refused, naming the modules.  The job
flags JAX forwards into ``model_params`` when ``custom_model`` declares
them and the params do not set them (``_forward_flag``): ``use_bf16``,
``sparse_apply_every`` and ``sparse_kernel``.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Callable, Optional

from elasticdl_tpu_torch.common import boundary
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


def _module_of(value) -> str:
    name = value.__name__ if isinstance(value, ModuleType) else getattr(value, "__module__", "")
    return name if isinstance(name, str) else ""


def load_module(model_zoo: str, model_def: str):
    """The module of ``model_def``: the port's own for a name of
    ``zoo.REGISTRY``; else ``model_def`` (a dotted module path) imported
    from the ``model_zoo`` directory (added to ``sys.path``), from the
    importable package ``model_zoo``, or as it is when ``model_zoo`` is
    empty.  Raises ``ValueError`` when that module does not exist and
    ``ImportError`` when its import would load a forbidden module."""
    from elasticdl_tpu_torch.zoo import REGISTRY

    if model_def in REGISTRY:
        return REGISTRY[model_def]
    directory = ""
    if model_zoo and os.path.isdir(model_zoo):
        directory = os.path.abspath(model_zoo)
        parent = os.path.dirname(directory)
        if parent not in sys.path:
            sys.path.insert(0, parent)
        package = os.path.basename(directory)
        module_name = f"{package}.{model_def}"
    else:
        package = model_zoo
        module_name = f"{model_zoo}.{model_def}" if model_zoo else model_def
    if directory and package in sys.modules:
        loaded = boundary.module_directory(sys.modules[package])
        if loaded != os.path.realpath(directory):
            raise ImportError(f"model_zoo {model_zoo!r}: another package {package!r} is already "
                              f"loaded in this process, from {loaded}")
    before = set(sys.modules)
    try:
        with boundary.refusing_forbidden_imports(own_package=package if directory else ""):
            module = importlib.import_module(module_name)
    except ModuleNotFoundError as exc:
        missing = exc.name or ""
        if not (module_name == missing or module_name.startswith(missing + ".")):
            raise  # a dependency of the user's module is missing
        raise ValueError(
            f"model_def {model_def!r} is not ported and not importable from model_zoo "
            f"{model_zoo!r} ({exc}); the port's zoo serves {sorted(REGISTRY)}") from None
    except ImportError as exc:
        raise ImportError(f"model_def {model_def!r} from model_zoo {model_zoo!r} is refused: "
                          f"{exc}") from exc
    own = (lambda m: m == package or m.startswith(package + ".")) if directory else (
        lambda m: False)
    loaded = (set(sys.modules) - before) | {module_name}
    # What the user's modules hold (``from jax import jit``), for modules
    # this process had loaded before: their import statements were
    # refused above, an ``importlib`` call is caught here.
    held = {_module_of(value) for m in loaded if own(m) or m == module_name
            for value in list(vars(sys.modules.get(m, module)).values())}
    pulled = sorted(m for m in loaded | held
                    if m and boundary.is_forbidden(m) and not own(m))
    if pulled:
        raise ImportError(f"model_def {model_def!r} from model_zoo {model_zoo!r} is refused: "
                          f"loading it loaded {pulled}")
    if directory:
        boundary.admit_user_zoo(package, directory)
    logger.info("Loaded model_def %r from model_zoo %r (%s)", model_def, model_zoo,
                getattr(module, "__file__", module_name))
    return module


def load_model_spec(args) -> ModelSpec:
    """Resolve the zoo contract from parsed job args."""
    module = load_module(getattr(args, "model_zoo", ""), args.model_def)

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
