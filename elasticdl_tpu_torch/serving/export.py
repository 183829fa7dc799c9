"""Serving artifacts: load one onto the card, or write one.

Reads the JAX package's artifact format (``elasticdl_tpu/serving/
export.py``) as it is:

    <model_dir>/
      signature.json   - model identity (zoo/def/params), table inventory
      variables.pkl    - nested variables tree ({"params": ...} and, for
                         a conv net, {"batch_stats": ...}); embedding-
                         table leaves are {"__table__": "tables/<i>.npy"}
                         references
      tables/<i>.npy   - one packed [num_blocks, 128] f32 table per file

``variables.pkl`` is read with a restricted unpickler that resolves only
the numpy globals an artifact needs.  An artifact exported by the JAX
package (a PS-mode ``ShardedEmbeddingTrainer`` and a single-device
``Trainer``, both checked by exporting one in the tests) names exactly
three: ``numpy.ndarray``, ``numpy.dtype`` and
``numpy._core.multiarray._reconstruct`` (``numpy.core.multiarray`` under
numpy 1.x); containers, strings and numbers are pickle opcodes, not
globals.  A numpy scalar (``multiarray.scalar``) is allowed as well.
Anything else — a JAX array, a flax ``FrozenDict``, any other class —
fails loudly with ``pickle.UnpicklingError``, and reading an artifact
never imports JAX.

Tables are opened as memmaps and copied to the device in bounded row
chunks into preallocated buffers (``serving/convert.load_state``).

Over a ``parallel.mesh.Mesh`` (``load_for_serving(..., mesh=)``) the
model is built over the mesh, whose lookups then take the sharded
dispatch, and each sparse table is placed by ``serving_rules``: split
over the ``model`` axis when its storage blocks divide it, else
replicated.  In process a split table stays one tensor (the dispatch
takes a row view per model slot); on a process mesh each rank loads its
own rows only.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.checkpoint import _pickle
from elasticdl_tpu_torch.common.device import DeviceLike, resolve_device
from elasticdl_tpu_torch.common.params import parse_dict_params
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel.compile import Rule, RuleTable, tree_paths
from elasticdl_tpu_torch.parallel.dp_trainer import model_apply
from elasticdl_tpu_torch.parallel.mesh import resolve_mesh
from elasticdl_tpu_torch.parallel.packed import PackedSpec, as_rows
from elasticdl_tpu_torch.parallel.sharding import axis_rows
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model

FORMAT = "elasticdl_tpu_serving/1"
_SIGNATURE = "signature.json"
_VARIABLES = "variables.pkl"
_TABLES_DIR = "tables"
_TABLE_REF = "__table__"

def read_variables(path: str):
    """Unpickle an artifact's ``variables.pkl`` with numpy-only globals."""
    with open(path, "rb") as f:
        return _pickle.load(f, jax_names=False, what=f"artifact variables {_VARIABLES}")


def _resolve_refs(tree, model_dir: str):
    if isinstance(tree, Mapping):
        if _TABLE_REF in tree:
            return np.load(
                os.path.join(model_dir, tree[_TABLE_REF]), mmap_mode="r"
            )
        return {k: _resolve_refs(v, model_dir) for k, v in tree.items()}
    return tree


def serving_rules(mesh) -> RuleTable:
    """Placement of serving variables (the fused branch of the JAX
    ``serving_rules``): a leaf named ``embedding`` is a table in packed
    storage, whose dim 0 counts its blocks, and splits over the mesh's
    ``model`` axis when they divide it (``ske.table_partition_axis``);
    everything else replicates."""

    def table_blocks(path, shape):
        return ske.table_partition_axis(shape[0], mesh)

    return RuleTable(
        [Rule(r"(^|/)embedding$", table_blocks), Rule(".*", None)],
        name="serving-fused",
    )


class ServingModel:
    """A loaded artifact: the port's module with its weights on
    ``device``, in eval mode; over a ``mesh``, ``placements`` maps each
    table key to the axis its rows are split over (None: replicated)."""

    def __init__(self, model: torch.nn.Module, signature: dict, device: torch.device,
                 mesh=None, placements=None):
        self.model = model
        self.signature = signature
        self.device = device
        self.mesh = mesh
        self.placements = placements or {}

    def forward(self, features) -> torch.Tensor:
        """Host features (a dict of arrays, or one array: an image batch)
        -> device outputs; batch norm reads its running averages.  The
        copies from pageable host memory synchronise with the card."""
        if isinstance(features, Mapping):
            tensors = {key: torch.from_numpy(np.ascontiguousarray(value)).to(self.device)  # noqa-invariant: jit-host-sync (the request's host arrays reach the card here, once per dispatch; the copy from pageable memory blocks)
                       for key, value in features.items()}
        else:
            tensors = torch.from_numpy(np.ascontiguousarray(features)).to(self.device)  # noqa-invariant: jit-host-sync (the request's host arrays reach the card here, once per dispatch; the copy from pageable memory blocks)
        return model_apply(self.model, tensors, train=False)

    def predict(self, features) -> np.ndarray:
        """Host features -> host outputs; ``.cpu()`` is the device sync."""
        with torch.inference_mode():
            return self.forward(features).cpu().numpy()  # noqa-invariant: jit-host-sync (the response leaves the card here: one read per dispatch, where the JAX serving runtime reads its compiled step's outputs)


def load_for_serving(model_dir: str, device: DeviceLike = None, mesh=None,
                     model_zoo: str = "") -> ServingModel:
    """Load an artifact onto ``device`` (``None``: the CUDA card), or over
    ``mesh`` on its device with each table placed by ``serving_rules``.
    A user's ``model_def`` is imported from ``model_zoo``, which overrides
    the artifact's recorded one when the artifact moved between machines
    (JAX's ``load_for_serving``, ``elasticdl_tpu/serving/export.py:254-285``)."""
    mesh = resolve_mesh(mesh, "load_for_serving")
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    with open(os.path.join(model_dir, _SIGNATURE)) as f:
        signature = json.load(f)
    variables = _resolve_refs(
        read_variables(os.path.join(model_dir, _VARIABLES)), model_dir
    )
    params = signature["model_params"]
    if mesh is not None:
        params = dict(parse_dict_params(params) if isinstance(params, str) else params,
                      mesh=mesh)
    model = build_model(signature["model_def"], params, device,
                        model_zoo=model_zoo or signature.get("model_zoo", ""))
    state = convert.state_dict_from_jax(variables, model)
    placements = {}
    if mesh is not None:
        by_path = dict(tree_paths(serving_rules(mesh).match(variables)[0]))
        for jax_key, port_key, kind, module in convert._targets(model):
            if kind != "table":
                continue  # the port splits its sparse tables only
            axis = placements[jax_key[len("params/"):]] = by_path[jax_key]
            rows = axis_rows(module.spec.vocab_padded, mesh, axis)
            if rows.stop - rows.start < module.spec.vocab_padded:  # a process mesh's share
                module.embedding = torch.empty(
                    (rows.stop - rows.start, module.spec.dim_padded),
                    dtype=torch.float32, device=device)
                state[port_key] = state[port_key][rows]
    convert.load_state(model, state)
    model.eval()
    return ServingModel(model, signature, device, mesh, placements)


def write_artifact(
    out_dir: str,
    variables: Mapping,
    tables: Mapping[str, Tuple[PackedSpec, np.ndarray]],
    signature: Mapping,
    chunk_rows: int = convert.CHUNK_ROWS,
) -> str:
    """Write an artifact in the JAX package's format (the file-writing
    half of its ``export_model``).

    variables: the nested ``{"params": ...}`` tree of numpy arrays,
    without the tables.  tables: ``{key: (spec, array)}`` with ``key``
    the table's path under ``params`` (``"fm_embedding/embedding"``) and
    the array in packed, row or logical form (``packed.as_rows``); each
    is written to ``tables/<i>.npy`` in packed form, ``chunk_rows`` rows
    at a time.  signature: at least ``model_def`` and ``model_params``;
    ``format`` and ``tables`` are filled in.
    """
    os.makedirs(os.path.join(out_dir, _TABLES_DIR), exist_ok=True)
    tree = _copy_tree(variables)
    tables_meta = []
    for i, (key, (spec, array)) in enumerate(sorted(tables.items())):
        rel = f"{_TABLES_DIR}/{i}.npy"
        rows = as_rows(spec, array)
        out = np.lib.format.open_memmap(
            os.path.join(out_dir, rel), mode="w+", dtype=np.float32,
            shape=spec.packed_shape,
        )
        flat_out = out.reshape(spec.rows_shape)
        for lo in range(0, spec.vocab_padded, chunk_rows):
            hi = min(spec.vocab_padded, lo + chunk_rows)
            flat_out[lo:hi] = rows[lo:hi]
        out.flush()
        del flat_out, out
        tables_meta.append(
            {
                "key": key,
                "file": rel,
                "vocab_size": spec.vocab_size,
                "dim": spec.dim,
                "packed_shape": list(spec.packed_shape),
            }
        )
        convert.set_in_tree(tree, ("params",) + tuple(key.split("/")), {_TABLE_REF: rel})
    with open(os.path.join(out_dir, _VARIABLES), "wb") as f:
        pickle.dump(tree, f)
    meta = {"format": FORMAT, "step": 0, **signature, "tables": tables_meta}
    meta.setdefault("model_zoo", "")
    with open(os.path.join(out_dir, _SIGNATURE), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def export_model(
    trainer,
    out_dir: str,
    model_zoo: str = "",
    model_def: str = "",
    model_params: str = "",
    chunk_rows: int = convert.CHUNK_ROWS,
) -> str:
    """Write the servable artifact of a trained
    ``parallel.ps_trainer.ShardedEmbeddingTrainer`` (or
    ``parallel.dp_trainer.DataParallelTrainer`` or
    ``worker.trainer.Trainer``, which have no tables) in the JAX
    package's format (its ``export_model``): the dense params in the flax
    layout with the ``batch_stats`` beside them (``variables.pkl`` holds
    ``{"params": ..., "batch_stats": ...}``, as JAX's ``save_model``
    writes), each table packed in ``tables/<i>.npy``, and the signature
    with the trainer's ``step``.  Both this package's
    ``load_for_serving`` and the JAX one read it.  On a process mesh every
    rank calls it (the tables are gathered) and rank 0 writes."""
    if trainer.state is None:
        raise ValueError("Cannot export: model was never initialized")
    if hasattr(trainer, "jax_variables"):
        variables, tables = trainer.jax_variables()  # whole tables (gathered over a mesh)
    else:  # dense params only, replicated on every rank
        variables, tables = convert.jax_variables_from_port(trainer.model)
    signature = {
        "model_zoo": model_zoo,
        "model_def": model_def,
        "model_params": model_params,
        "step": int(trainer.step),
    }
    mesh = trainer.mesh
    if mesh is None or mesh.in_process:
        return write_artifact(out_dir, variables, tables, signature, chunk_rows)
    if mesh.rank == 0:  # a process mesh: one writer, the others wait for it
        write_artifact(out_dir, variables, tables, signature, chunk_rows)
    dist.barrier()
    return out_dir


def _copy_tree(node):
    if isinstance(node, Mapping):
        return {k: _copy_tree(v) for k, v in node.items()}
    return np.asarray(node)
