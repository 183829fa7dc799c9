"""Carry JAX (flax) variables across to the port's modules.

The JAX package names a variable by its flax path, ``params/<module
path>/<leaf>``: the nested ``variables.pkl`` tree of a serving artifact,
or the flat ``/``-joined keys of a trainer's ``get_variables_numpy()``
(``elasticdl_tpu/worker/trainer.py``).  The port's modules carry the
flax module names as attribute names, so each flax path has exactly one
port tensor:

- flax ``Dense`` ``kernel [in, out]`` / ``bias`` -> ``nn.Linear``
  ``weight [out, in]`` (transposed) / ``bias``;
- ``DenseGeneral`` ``kernel`` / ``bias`` -> the same names, as stored;
- ``LayerNorm`` ``scale`` / ``bias`` -> ``nn.LayerNorm`` ``weight`` /
  ``bias``; flax ``Embed`` ``embedding`` -> ``nn.Embedding`` ``weight``;
- an Embedding's ``embedding`` table, packed ``[num_blocks, 128]``,
  logical ``[vocab, dim]`` or already ``[vocab_padded, dim_padded]`` ->
  the layer's ``[vocab_padded, dim_padded]`` buffer
  (``parallel/packed.as_rows``; a packed memmap stays a view);
- flax ``Conv`` ``kernel [kh, kw, in, out]`` / ``bias`` -> the vision
  zoo's ``Conv`` ``weight [out, in, kh, kw]`` / ``bias``;
- ``BatchNorm`` ``scale`` / ``bias`` -> ``weight`` / ``bias``, and its
  ``batch_stats/<module path>/mean|var`` -> the buffers ``mean`` /
  ``var`` (the one collection besides ``params``).

A leftover or missing key, or a shape that does not fit, raises.

The other direction (``jax_variables_from_port``) writes the port's
weights in the JAX layout for export, and ``trainer_state_from_jax``
carries a whole JAX PS trainer state across (dense params, tables,
sparse slots, optax Adam moments), ``dp_trainer_state_from_jax`` a JAX
``DataParallelTrainer`` state and ``local_trainer_state_from_jax`` a
single-device ``Trainer`` one (params, ``batch_stats``, the optax AdamW
moments or the SGD momentum trace), so the trainers can start from the
same bits.  Their inverses, ``jax_trainer_state_from_port`` and
``jax_dp_trainer_state_from_port`` (the DP and the single-device
trainers share JAX's ``TrainState``), give the port's states in the JAX
layout with numpy leaves, the optax chain rebuilt from the port's
``{"count", "mu", "nu"}`` or ``{"trace"}`` (``jax_opt_state``): the
trees the checkpoints write (``checkpoint/``), which the JAX package
restores.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.checkpoint import _pickle
from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.parallel.packed import as_rows
from elasticdl_tpu_torch.zoo.deepfm import DenseGeneral
from elasticdl_tpu_torch.zoo.vision import BatchNorm, Conv

#: Rows copied to the device per step when loading a table, so loading
#: never holds more than this many rows of it on the host at once.
CHUNK_ROWS = 1 << 20


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """Nested variables tree -> flat ``{"a/b/c": leaf}``; a flat dict
    passes through."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
        else:
            flat["/".join(path)] = node

    walk(variables, ())
    return flat


def _targets(model: nn.Module) -> Iterator[Tuple[str, str, str, object]]:
    """(jax key, port state_dict key, kind, module) for every variable."""
    for name, module in model.named_modules():
        prefix = "/".join(("params", name.replace(".", "/")) if name else ("params",))
        port = name + "." if name else ""
        if isinstance(module, nn.Linear):
            yield prefix + "/kernel", port + "weight", "dense_kernel", module
            yield prefix + "/bias", port + "bias", "as_is", module
        elif isinstance(module, DenseGeneral):
            yield prefix + "/kernel", port + "kernel", "as_is", module
            yield prefix + "/bias", port + "bias", "as_is", module
        elif isinstance(module, Embedding):
            yield prefix + "/embedding", port + "embedding", "table", module
        elif isinstance(module, nn.LayerNorm):
            yield prefix + "/scale", port + "weight", "as_is", module
            yield prefix + "/bias", port + "bias", "as_is", module
        elif isinstance(module, nn.Embedding):
            yield prefix + "/embedding", port + "weight", "as_is", module
        elif isinstance(module, Conv):
            yield prefix + "/kernel", port + "weight", "conv_kernel", module
            if module.bias is not None:
                yield prefix + "/bias", port + "bias", "as_is", module
        elif isinstance(module, BatchNorm):
            yield prefix + "/scale", port + "weight", "bn_scale", module
            yield prefix + "/bias", port + "bias", "as_is", module
            stats = "batch_stats" + prefix[len("params"):]
            yield stats + "/mean", port + "mean", "stat_mean", module
            yield stats + "/var", port + "var", "stat_var", module


#: Kinds of ``_targets`` that are ``batch_stats``, not ``params``.
STAT_KINDS = ("stat_mean", "stat_var")


def _to_port(kind: str, value) -> np.ndarray:
    """A JAX-layout dense leaf -> the port's layout."""
    value = np.asarray(value)
    if kind == "dense_kernel":
        return value.T
    if kind == "conv_kernel":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return value


def _to_jax(kind: str, value: np.ndarray) -> np.ndarray:
    """The inverse of ``_to_port``, C-contiguous (what a JAX export or
    checkpoint holds)."""
    if kind == "dense_kernel":
        return np.ascontiguousarray(value.T)
    if kind == "conv_kernel":
        return np.ascontiguousarray(value.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    return value


def state_dict_from_jax(variables: Mapping, model: nn.Module) -> Dict[str, np.ndarray]:
    """JAX variables (nested tree or flat ``/``-joined keys, numpy
    leaves) -> the port's ``state_dict`` as numpy arrays.  Tables stay
    views of their source where the stored form allows it."""
    flat = flatten_variables(variables)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: Dict[str, np.ndarray] = {}
    for jax_key, port_key, kind, module in _targets(model):
        if jax_key not in flat:
            raise KeyError(f"JAX variables lack {jax_key!r} (for {port_key})")
        value = flat.pop(jax_key)
        value = as_rows(module.spec, value) if kind == "table" else _to_port(kind, value)
        if tuple(value.shape) != shapes[port_key]:
            raise ValueError(
                f"{jax_key} has shape {tuple(value.shape)}, the port's "
                f"{port_key} {shapes[port_key]}"
            )
        out[port_key] = value
    if flat:
        raise KeyError(f"JAX variables without a port counterpart: {sorted(flat)}")
    return out


def set_in_tree(tree: Dict, path, value) -> None:
    """tree[path[0]][path[1]]... = value, making the inner dicts."""
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def random_jax_variables(model: nn.Module, seed: int, scale: float = 0.05):
    """Seeded random weights for ``model`` in the JAX layout, the inverse
    of ``state_dict_from_jax``: ``(variables, tables)`` as
    ``serving/export.write_artifact`` takes them — the nested
    ``{"params": ...}`` tree without the tables, and ``{key: (spec,
    [vocab_padded, dim_padded] rows)}`` with zero pad cells.  Only
    shapes are read from ``model``, so a model built on the ``meta``
    device serves.  Values are uniform in ``[-scale, scale)``, drawn
    from numpy, table rows a chunk at a time."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    variables: Dict = {}
    tables = {}
    for jax_key, port_key, kind, module in _targets(model):
        path = jax_key.split("/")
        if kind in ("conv_kernel", "bn_scale") + STAT_KINDS:
            set_in_tree(variables, path, _random_vision_leaf(rng, kind, shapes[port_key], scale))
            continue
        if kind == "table":
            spec = module.spec
            rows = np.zeros(spec.rows_shape, np.float32)
            for lo in range(0, spec.vocab_size, CHUNK_ROWS):
                hi = min(spec.vocab_size, lo + CHUNK_ROWS)
                draw = rng.random((hi - lo, spec.dim), dtype=np.float32)
                rows[lo:hi, : spec.dim] = (2.0 * draw - 1.0) * scale
            tables["/".join(path[1:])] = (spec, rows)
            continue
        shape = shapes[port_key]
        if kind == "dense_kernel":
            shape = shape[::-1]  # flax Dense kernels are [in, out]
        draw = rng.random(shape, dtype=np.float32)
        set_in_tree(variables, path, (2.0 * draw - 1.0) * np.float32(scale))
    return variables, tables


def _random_vision_leaf(rng, kind: str, port_shape, scale: float) -> np.ndarray:
    """A conv net's leaves, drawn so a deep stack keeps its signal: conv
    kernels uniform with lecun's variance ``1 / fan_in`` (HWIO), batch
    norm scales and running variances in ``[0.5, 1.5)``, running means in
    ``[-scale, scale)``."""
    draw = rng.random(port_shape, dtype=np.float32)
    if kind == "conv_kernel":
        bound = np.float32(np.sqrt(3.0 / np.prod(port_shape[1:])))
        return _to_jax(kind, (2.0 * draw - 1.0) * bound)
    if kind == "stat_mean":
        return (2.0 * draw - 1.0) * np.float32(scale)
    return draw + np.float32(0.5)


def jax_variables_from_port(model: nn.Module, gather=None):
    """The port's weights in the JAX layout, the inverse of
    ``state_dict_from_jax``: ``(variables, tables)`` as
    ``serving/export.write_artifact`` takes them — the nested ``{"params":
    ...}`` tree of numpy arrays without the tables (Dense kernels back to
    ``[in, out]``), and ``{key: (spec, [vocab_padded, dim_padded] rows)}``
    with ``key`` the table's path under ``params``.  ``gather(key,
    table)`` gives a table's full rows as a host array (a trainer whose
    tables are split over a process mesh passes it); by default the
    table as it is."""
    state = model.state_dict()
    tables = {}
    for jax_key, port_key, kind, module in _targets(model):
        if kind == "table":
            key = jax_key[len("params/"):]
            value = state[port_key].detach()
            rows = gather(key, value) if gather is not None else value.cpu().numpy()
            tables[key] = (module.spec, rows)
    return {"params": _dense_to_jax(state, model), **_model_state_to_jax(state, model)}, tables


def flat_jax_variables(model: nn.Module, gather=None) -> Dict[str, np.ndarray]:
    """Flat ``{"params/<path>/<leaf>": array}`` (and
    ``"batch_stats/<path>/mean|var"``) with LOGICAL ``[vocab,
    dim]`` tables: the JAX trainers' ``get_variables_numpy`` view
    (``gather`` as in ``jax_variables_from_port``)."""
    variables, tables = jax_variables_from_port(model, gather)
    flat = flatten_variables(variables)
    for key, (spec, rows) in tables.items():
        flat["params/" + key] = np.ascontiguousarray(rows[: spec.vocab_size, : spec.dim])
    return flat


def _dense_from_jax(tree: Mapping, model: nn.Module) -> Dict[str, np.ndarray]:
    """A params-shaped JAX tree (params, or an optimizer moment of them)
    -> ``{port parameter name: array}``; table leaves are skipped (the PS
    trainer keeps 0-d placeholders there)."""
    flat = flatten_variables({"params": tree})
    out = {}
    for jax_key, port_key, kind, _ in _targets(model):
        if kind == "table" or kind in STAT_KINDS:
            continue
        out[port_key] = _to_port(kind, flat[jax_key])
    return out


def _model_state_from_jax(model_state, model: nn.Module) -> Dict:
    """A JAX ``model_state`` (``{"batch_stats": tree}``, or empty) -> the
    port's ``{"batch_stats": {"<module>.mean"|".var": array}}``, or ``{}``
    for a model without batch norm.  A missing or extra leaf raises."""
    flat = flatten_variables(dict(model_state or {}))
    out = {}
    for jax_key, port_key, kind, _ in _targets(model):
        if kind in STAT_KINDS:
            if jax_key not in flat:
                raise KeyError(f"JAX model_state lacks {jax_key!r} (for {port_key})")
            out[port_key] = np.asarray(flat.pop(jax_key))
    if flat:
        raise KeyError(f"JAX model_state without a port counterpart: {sorted(flat)}")
    return {"batch_stats": out} if out else {}


def _model_state_to_jax(values: Mapping, model: nn.Module) -> Dict:
    """``{port buffer name: value}`` (a state dict, or a ``model_state``'s
    ``batch_stats``) -> the JAX ``{"batch_stats": tree}``, or ``{}``."""
    tree: Dict = {}
    for jax_key, port_key, kind, _ in _targets(model):
        if kind in STAT_KINDS:
            set_in_tree(tree, jax_key.split("/"), _host(values[port_key]))
    return tree


def _host(value) -> np.ndarray:
    """A tensor or array as a C-contiguous numpy copy."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.array(value, order="C")


def _dense_to_jax(values: Mapping, model: nn.Module, placeholders: bool = False) -> Dict:
    """The inverse of ``_dense_from_jax``: ``{port parameter name:
    value}`` -> the params-shaped JAX tree with numpy leaves (Dense
    kernels back to ``[in, out]``).  ``placeholders``: each table's leaf
    is the 0-d f32 zero the JAX PS trainer keeps in its dense params,
    else tables are left out."""
    tree: Dict = {}
    for jax_key, port_key, kind, _ in _targets(model):
        path = jax_key.split("/")[1:]
        if kind in STAT_KINDS:
            continue
        if kind == "table":
            if placeholders:
                set_in_tree(tree, path, np.zeros((), np.float32))
            continue
        set_in_tree(tree, path, _to_jax(kind, _host(values[port_key])))
    return tree


def jax_opt_state(optimizer: str, opt_state: Mapping, model: nn.Module,
                  placeholders: bool = False):
    """The port's dense optimizer state (``parallel/optim.py``, by the
    optimizer's ``name``) -> the optax chain state the zoo's optimizer of
    that name carries: ``adam`` -> ``(ScaleByAdamState(count, mu, nu),
    EmptyState())``, ``adamw`` one ``EmptyState()`` more (its decay and
    learning-rate scale), ``sgd`` -> ``(EmptyState(), EmptyState())``, or
    ``(TraceState(trace), EmptyState())`` with momentum (a ``"trace"``
    in the state).  ``placeholders`` as in ``_dense_to_jax`` (the PS
    trainer's)."""
    if optimizer == "sgd":
        if "trace" in opt_state:
            trace = _dense_to_jax(opt_state["trace"], model, placeholders)
            return (_pickle.TraceState(trace=trace), _pickle.EmptyState())
        return (_pickle.EmptyState(), _pickle.EmptyState())
    if optimizer not in ("adam", "adamw"):
        raise ValueError(f"no optax chain known for the dense optimizer {optimizer!r}")
    adam = _pickle.ScaleByAdamState(
        count=np.asarray(_host(opt_state["count"]), np.int32),
        mu=_dense_to_jax(opt_state["mu"], model, placeholders),
        nu=_dense_to_jax(opt_state["nu"], model, placeholders),
    )
    empties = 1 if optimizer == "adam" else 2
    return (adam,) + (_pickle.EmptyState(),) * empties


def port_opt_state(opt_state, model: nn.Module) -> Dict:
    """An optax chain state -> the port's dense optimizer state: optax
    Adam's ``{"count", "mu", "nu"}``, sgd's momentum ``{"trace"}``, or
    ``{}`` (a chain of empty states carries nothing: plain sgd)."""
    trace = _optax_trace_state(opt_state)
    if trace is not None:
        return {"trace": _dense_from_jax(trace.trace, model)}
    adam = _optax_adam_state(opt_state)
    if adam is None:
        return {}
    return {
        "count": np.asarray(adam.count, np.int32),
        "mu": _dense_from_jax(adam.mu, model),
        "nu": _dense_from_jax(adam.nu, model),
    }


def _table_specs(model: nn.Module):
    return {jax_key[len("params/"):]: module.spec
            for jax_key, _, kind, module in _targets(model) if kind == "table"}


def _optax_adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax chain's state, or None."""
    if all(hasattr(opt_state, name) for name in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _optax_adam_state(part)
            if found is not None:
                return found
    return None


def _optax_trace_state(opt_state):
    """The ``TraceState`` of an optax ``sgd`` chain with momentum, or None."""
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    for part in parts:
        if isinstance(part, tuple) and getattr(part, "_fields", None) == ("trace",):
            return part
    return None


def trainer_state_from_jax(state, model: nn.Module):
    """A JAX ``PSTrainState`` with numpy leaves (``jax.device_get`` of
    ``ShardedEmbeddingTrainer.state``) -> the port's ``PSTrainState`` with
    numpy leaves, for ``parallel.ps_trainer.ShardedEmbeddingTrainer.state``:
    dense params (Dense kernels transposed), packed tables and their
    sparse slots (``m``/``v``/``t``/``momentum``/``accumulator`` as rows,
    ``t_global`` as a scalar) through a reshape, and optax Adam's
    ``mu``/``nu``/``count`` (an optax state without Adam carries nothing:
    sgd has none)."""
    from elasticdl_tpu_torch.parallel.ps_trainer import PSTrainState

    specs = _table_specs(model)
    if set(state.tables) != set(specs):
        raise KeyError(f"JAX tables {sorted(state.tables)} != the port's {sorted(specs)}")
    tables = {key: as_rows(specs[key], np.asarray(arr)) for key, arr in state.tables.items()}
    slots = {
        key: {
            name: as_rows(specs[key], np.asarray(arr)) if np.ndim(arr) else np.asarray(arr, np.float32)
            for name, arr in group.items()
        }
        for key, group in state.slots.items()
    }
    return PSTrainState(
        step=int(np.asarray(state.step)),
        params=_dense_from_jax(state.params, model),
        opt_state=port_opt_state(state.opt_state, model),
        tables=tables,
        slots=slots,
    )


def jax_trainer_state_from_port(state, model: nn.Module, optimizer: str):
    """The inverse of ``trainer_state_from_jax``: the port's
    ``PSTrainState`` (tensors or numpy, whole tables) -> the JAX
    ``PSTrainState`` with numpy leaves: dense params with the table
    placeholders, the optax chain of the dense ``optimizer`` (its name),
    an empty ``model_state``, tables and table-shaped slots packed
    ``[num_blocks, block_width]``, scalar slots as 0-d f32."""
    specs = _table_specs(model)

    def packed(key, value):
        return _host(value).reshape(specs[key].packed_shape)

    return _pickle.PSTrainState(
        step=np.asarray(state.step, np.int32),
        params=_dense_to_jax(state.params, model, placeholders=True),
        opt_state=jax_opt_state(optimizer, state.opt_state, model, placeholders=True),
        model_state={},
        tables={key: packed(key, value) for key, value in state.tables.items()},
        slots={
            key: {name: packed(key, v) if np.ndim(v) else np.asarray(_host(v), np.float32)
                  for name, v in group.items()}
            for key, group in state.slots.items()
        },
    )


def _dense_opt_state_from_jax(opt_state, model: nn.Module) -> Dict:
    """The optax chain of a dense trainer -> the port's optimizer state:
    ``adam``/``adamw``'s ``(ScaleByAdamState(count, mu, nu), EmptyState()
    [, EmptyState()])`` -> ``{"count", "mu", "nu"}``, momentum ``sgd``'s
    ``(TraceState(trace), EmptyState())`` -> ``{"trace"}``; the decay and
    the learning-rate scale carry nothing.  Any other chain raises."""
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    moments = _optax_adam_state(opt_state) or _optax_trace_state(opt_state)
    others = [part for part in parts if part is not moments]
    if moments is None or any(not isinstance(part, tuple) or len(part) for part in others):
        raise ValueError("not an optax adam/adamw chain state, nor sgd's momentum chain: "
                         f"{opt_state!r:.200}")
    return port_opt_state(opt_state, model)


def dp_trainer_state_from_jax(state, model: nn.Module):
    """A JAX ``TrainState`` with numpy leaves (``jax.device_get`` of
    ``DataParallelTrainer.state``) -> the port's ``DPTrainState`` with
    numpy leaves, for ``parallel.dp_trainer.DataParallelTrainer.state``:
    params (Dense kernels transposed, conv kernels to OIHW), the optimizer
    state (``_dense_opt_state_from_jax``) and the ``batch_stats``."""
    from elasticdl_tpu_torch.parallel.dp_trainer import DPTrainState

    return DPTrainState(*_train_state_from_jax(state, model))


def local_trainer_state_from_jax(state, model: nn.Module):
    """A JAX single-device ``Trainer``'s ``TrainState`` (numpy leaves) ->
    the port's ``worker.trainer.TrainState`` with numpy leaves."""
    from elasticdl_tpu_torch.worker.trainer import TrainState

    return TrainState(*_train_state_from_jax(state, model))


def _train_state_from_jax(state, model: nn.Module) -> tuple:
    return (int(np.asarray(state.step)), _dense_from_jax(state.params, model),
            _dense_opt_state_from_jax(state.opt_state, model),
            _model_state_from_jax(state.model_state, model))


def jax_dp_trainer_state_from_port(state, model: nn.Module, optimizer: str):
    """The inverse of ``dp_trainer_state_from_jax`` and of
    ``local_trainer_state_from_jax``: the port's ``DPTrainState`` or
    ``worker.trainer.TrainState`` -> the JAX ``TrainState(step, params,
    opt_state, model_state)`` (both JAX trainers keep that one) with numpy
    leaves and the optax chain of the dense ``optimizer`` (its name): what
    a JAX ``state.pkl`` holds."""
    return _pickle.TrainState(
        step=np.asarray(state.step, np.int32),
        params=_dense_to_jax(state.params, model),
        opt_state=jax_opt_state(optimizer, state.opt_state, model),
        model_state=_model_state_to_jax(dict(state.model_state).get("batch_stats", {}), model),
    )


@torch.no_grad()
def load_state(
    model: nn.Module, state: Mapping[str, np.ndarray], chunk_rows: int = CHUNK_ROWS
) -> None:
    """Copy ``state`` into the model's own (preallocated) tensors, in
    chunks of ``chunk_rows`` rows: a multi-gigabyte memmapped table is
    never copied whole on the host, and a read-only memmap is never
    handed to ``torch.from_numpy``."""
    targets = model.state_dict(keep_vars=True)
    missing = set(targets) - set(state)
    if missing:
        raise KeyError(f"state lacks {sorted(missing)}")
    for key, value in state.items():
        target = targets[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(target.shape)}")
        if not target.is_contiguous():  # a channels_last conv kernel: small, copied whole
            target.data.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
            continue
        rows = value.shape[0] if value.ndim else 1
        value = value.reshape(rows, -1)
        flat_target = target.data.view(rows, -1)
        for lo in range(0, rows, chunk_rows):
            hi = min(rows, lo + chunk_rows)
            chunk = np.array(value[lo:hi], dtype=np.float32)  # writable copy
            flat_target[lo:hi].copy_(torch.from_numpy(chunk))
