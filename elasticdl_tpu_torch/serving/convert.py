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
  (``parallel/packed.as_rows``; a packed memmap stays a view).

A leftover or missing key, or a shape that does not fit, raises.

The other direction (``jax_variables_from_port``) writes the port's
weights in the JAX layout for export, and ``trainer_state_from_jax``
carries a whole JAX PS trainer state across (dense params, tables,
sparse slots, optax Adam moments), and ``dp_trainer_state_from_jax`` a
JAX ``DataParallelTrainer`` state (params, optax AdamW), so both trainers
can start from the same bits.  Their inverses,
``jax_trainer_state_from_port`` and ``jax_dp_trainer_state_from_port``,
give the port's states in the JAX layout with numpy leaves, the optax
chain rebuilt from the port's ``{"count", "mu", "nu"}``
(``jax_opt_state``): the trees the checkpoints write
(``checkpoint/``), which the JAX package restores.
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
        if kind == "dense_kernel":
            value = np.asarray(value).T
        elif kind == "table":
            value = as_rows(module.spec, value)
        else:
            value = np.asarray(value)
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
    return {"params": _dense_to_jax(state, model)}, tables


def flat_jax_variables(model: nn.Module, gather=None) -> Dict[str, np.ndarray]:
    """Flat ``{"params/<path>/<leaf>": array}`` with LOGICAL ``[vocab,
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
        if kind == "table":
            continue
        value = np.asarray(flat[jax_key])
        out[port_key] = value.T if kind == "dense_kernel" else value
    return out


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
        if kind == "table":
            if placeholders:
                set_in_tree(tree, path, np.zeros((), np.float32))
            continue
        value = values[port_key]
        if kind == "dense_kernel":
            value = value.T
        set_in_tree(tree, path, _host(value))
    return tree


def jax_opt_state(optimizer: str, opt_state: Mapping, model: nn.Module,
                  placeholders: bool = False):
    """The port's dense optimizer state (``parallel/optim.py``, by the
    optimizer's ``name``) -> the optax chain state the zoo's optimizer of
    that name carries: ``adam`` -> ``(ScaleByAdamState(count, mu, nu),
    EmptyState())``, ``adamw`` one ``EmptyState()`` more (its decay and
    learning-rate scale), ``sgd`` -> ``(EmptyState(), EmptyState())``.
    ``placeholders`` as in ``_dense_to_jax`` (the PS trainer's)."""
    if optimizer == "sgd":
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
    Adam's ``{"count", "mu", "nu"}``, or ``{}`` (a chain without Adam
    carries nothing: sgd has none)."""
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


def dp_trainer_state_from_jax(state, model: nn.Module):
    """A JAX ``TrainState`` with numpy leaves (``jax.device_get`` of
    ``DataParallelTrainer.state``) -> the port's ``DPTrainState`` with
    numpy leaves, for ``parallel.dp_trainer.DataParallelTrainer.state``:
    params (Dense kernels transposed) and the optax ``adamw`` chain's
    state, ``(ScaleByAdamState(count, mu, nu), EmptyState(),
    EmptyState())`` -> ``{"count", "mu", "nu"}``; the decay and the
    learning-rate scale carry nothing.  A state of another shape, or any
    ``model_state``, raises."""
    from elasticdl_tpu_torch.parallel.dp_trainer import DPTrainState

    adam = _optax_adam_state(state.opt_state)
    parts = state.opt_state if isinstance(state.opt_state, (tuple, list)) else (state.opt_state,)
    others = [part for part in parts if part is not adam]
    if adam is None or any(not isinstance(part, tuple) or len(part) for part in others):
        raise ValueError(f"not an optax adam/adamw chain state: {state.opt_state!r:.200}")
    if flatten_variables(state.model_state or {}):
        raise KeyError(f"model_state collections are not ported: {sorted(state.model_state)}")
    return DPTrainState(
        step=int(np.asarray(state.step)),
        params=_dense_from_jax(state.params, model),
        opt_state={
            "count": np.asarray(adam.count, np.int32),
            "mu": _dense_from_jax(adam.mu, model),
            "nu": _dense_from_jax(adam.nu, model),
        },
        model_state={},
    )


def jax_dp_trainer_state_from_port(state, model: nn.Module, optimizer: str):
    """The inverse of ``dp_trainer_state_from_jax``: the port's
    ``DPTrainState`` -> the JAX ``TrainState(step, params, opt_state,
    model_state)`` with numpy leaves and the optax chain of the dense
    ``optimizer`` (its name): what a JAX ``state.pkl`` holds."""
    return _pickle.TrainState(
        step=np.asarray(state.step, np.int32),
        params=_dense_to_jax(state.params, model),
        opt_state=jax_opt_state(optimizer, state.opt_state, model),
        model_state={},
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
        rows = value.shape[0] if value.ndim else 1
        value = value.reshape(rows, -1)
        flat_target = target.data.view(rows, -1)
        for lo in range(0, rows, chunk_rows):
            hi = min(rows, lo + chunk_rows)
            chunk = np.array(value[lo:hi], dtype=np.float32)  # writable copy
            flat_target[lo:hi].copy_(torch.from_numpy(chunk))
