"""The names a JAX-written checkpoint carries, read and written without JAX.

A pickled state of the JAX package (``elasticdl_tpu/checkpoint``) names a
few globals besides numpy's: the optax chain states of the zoo's dense
optimizers (``adam`` -> ``(ScaleByAdamState, EmptyState)``, ``adamw``
one ``EmptyState`` more, ``sgd`` -> ``(EmptyState, EmptyState)``, and
``(TraceState, EmptyState)`` with momentum), a
data-parallel ``state.pkl``'s ``elasticdl_tpu.worker.trainer.TrainState``
and a PS trainer's ``elasticdl_tpu.parallel.ps_trainer.PSTrainState``.
The port may import none of those modules, so it keeps NamedTuple
stand-ins of the same fields (below) and maps the names both ways:

- ``load``: a restricted ``Unpickler`` that resolves numpy's array
  globals and maps exactly the five JAX names onto the stand-ins; any
  other global raises ``RefusedGlobal``, a ``pickle.UnpicklingError``.
  ``load(f, jax_names=False)`` is the serving artifact's numpy-only
  reader.
- ``dump``: a subclass of the pure-Python ``pickle._Pickler`` whose
  ``save_global`` writes a stand-in class under its JAX name
  (``STACK_GLOBAL``) instead of importing the module to check it.  A
  stand-in instance pickles through ``NEWOBJ`` as the real NamedTuple
  does, so the JAX package's ``pickle.load`` builds the real class.  Any
  global that ``load`` would refuse raises ``pickle.PicklingError``
  here, so nothing is written that cannot be read back.  Protocol 4, the
  JAX package's ``pickle.dump`` default.
"""

from __future__ import annotations

import pickle
from typing import Any, NamedTuple


class ScaleByAdamState(NamedTuple):
    """``optax._src.transform.ScaleByAdamState``."""

    count: Any
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    """``optax.transforms._accumulation.TraceState`` (sgd's momentum)."""

    trace: Any


class EmptyState(NamedTuple):
    """``optax._src.base.EmptyState``."""


class TrainState(NamedTuple):
    """``elasticdl_tpu.worker.trainer.TrainState`` (a DP ``state.pkl``)."""

    step: Any
    params: Any
    opt_state: Any
    model_state: Any


class PSTrainState(NamedTuple):
    """``elasticdl_tpu.parallel.ps_trainer.PSTrainState``."""

    step: Any
    params: Any
    opt_state: Any
    model_state: Any
    tables: Any
    slots: Any


#: stand-in -> the (module, qualified name) the JAX package pickles.
JAX_NAMES = {
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    EmptyState: ("optax._src.base", "EmptyState"),
    TraceState: ("optax.transforms._accumulation", "TraceState"),
    TrainState: ("elasticdl_tpu.worker.trainer", "TrainState"),
    PSTrainState: ("elasticdl_tpu.parallel.ps_trainer", "PSTrainState"),
}
_BY_JAX_NAME = {name: cls for cls, name in JAX_NAMES.items()}

#: The numpy globals of a pickled array, a dtype and a numpy scalar
#: (``numpy.core`` under numpy 1.x, ``numpy._core`` under 2.x).
NUMPY_GLOBALS = frozenset(
    {
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
    }
)

PROTOCOL = 4


class RefusedGlobal(pickle.UnpicklingError):
    """A global outside the allowed set: the stream may be sound, the
    reader refuses it (a restore skips such a file, it does not
    quarantine it)."""


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, jax_names: bool, what: str):
        super().__init__(file)
        self._jax_names = jax_names
        self._what = what

    def find_class(self, module: str, name: str):
        if (module, name) in NUMPY_GLOBALS:
            return super().find_class(module, name)
        if self._jax_names and (module, name) in _BY_JAX_NAME:
            return _BY_JAX_NAME[(module, name)]
        allowed = ("numpy arrays, the JAX package's optax and trainer states"
                   if self._jax_names else "numpy arrays")
        raise RefusedGlobal(
            f"{self._what} names {module}.{name}; only {allowed} and containers of them "
            "may appear there"
        )


def load(file, jax_names: bool = True, what: str = "the checkpoint"):
    """Unpickle from an open binary ``file`` with the globals above
    (numpy only with ``jax_names=False``); ``what`` names the source in
    the refusal."""
    return _Unpickler(file, jax_names, what).load()


class _Pickler(pickle._Pickler):
    def save_global(self, obj, name=None):
        jax_name = JAX_NAMES.get(obj) if isinstance(obj, type) else None
        if jax_name is not None:
            module, qualname = jax_name
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        qualname = name or getattr(obj, "__qualname__", None)
        module = pickle.whichmodule(obj, qualname)
        if (module, qualname) not in NUMPY_GLOBALS:
            raise pickle.PicklingError(
                f"{module}.{qualname} has no JAX-readable name: a checkpoint holds numpy "
                "arrays, containers of them and the states in checkpoint._pickle"
            )
        super().save_global(obj, name)


def dump(obj, file) -> None:
    """Pickle ``obj`` (numpy leaves in dicts, lists, tuples and the
    stand-ins) to an open binary ``file`` under the JAX package's names."""
    _Pickler(file, protocol=PROTOCOL).dump(obj)
