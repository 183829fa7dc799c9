"""What no process of the port may load: the JAX package's stack (JAX,
flax, optax), its transport (gRPC, protobuf), the JAX package itself and
its model zoo, and ``tensorboard`` (``torch.utils.tensorboard``'s
backend; the port writes its event files itself).  The card's machine
has none of them.  The master, the
workers and the serving replica record ``forbidden_modules_loaded()`` in
their journals, and the tests hold it empty.

A user's model zoo is imported under ``refusing_forbidden_imports``
(``common/model_utils.load_module``): any import of a forbidden module
made while it loads raises, naming the importer and the module.  A zoo
whose package is itself named like a forbidden module (``zoo init``
scaffolds into ``model_zoo`` by default) is told apart from the JAX
package's zoo by its directory: it is admitted (``admit_user_zoo``) only
after it loaded without a forbidden import, and only the modules loaded
from that directory leave the census."""

from __future__ import annotations

import builtins
import contextlib
import os
import sys
from typing import Dict, Iterator, List

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "grpc", "google.protobuf",
                     "model_zoo", "elasticdl_tpu", "tensorboard")

#: Admitted user zoos: top-level package name -> its directory (real path).
_admitted: Dict[str, str] = {}


def is_forbidden(module: str) -> bool:
    """Whole dotted names: ``elasticdl_tpu_torch`` is not ``elasticdl_tpu``."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN_MODULES)


def module_directory(module) -> str:
    """The real path of the directory a loaded module or package came
    from ("" for a namespace-less built-in)."""
    path = getattr(module, "__file__", None)
    if path:
        return os.path.dirname(os.path.realpath(path))
    paths = list(getattr(module, "__path__", None) or ())
    return os.path.realpath(paths[0]) if paths else ""


def _admitted_module(name: str) -> bool:
    directory = _admitted.get(name.split(".")[0])
    if directory is None:
        return False
    found = module_directory(sys.modules.get(name))
    return found == directory or found.startswith(directory + os.sep)


def admit_user_zoo(package: str, directory: str) -> None:
    """Record ``package``, loaded from ``directory``, as a user's zoo: its
    modules from that directory are not the JAX package's."""
    _admitted[package] = os.path.realpath(directory)


def forbidden_modules_loaded() -> List[str]:
    """The forbidden modules this process has loaded, an admitted user
    zoo's own modules aside."""
    return sorted(m for m in list(sys.modules) if is_forbidden(m) and not _admitted_module(m))


def _absolute(name: str, globals_, level: int) -> str:
    if level == 0:
        return name
    package = (globals_ or {}).get("__package__") or ""
    base = package.rsplit(".", level - 1)[0] if level > 1 else package
    return f"{base}.{name}" if name else base


@contextlib.contextmanager
def refusing_forbidden_imports(own_package: str = "") -> Iterator[None]:
    """While active, an ``import`` statement that names a forbidden
    module raises ``ImportError`` (naming the importer and the module),
    also when the module is already loaded; ``own_package``'s modules
    are exempt.  Process-wide: meant for loading one user module."""
    original = builtins.__import__

    def guarded(name, globals=None, locals=None, fromlist=(), level=0):
        target = _absolute(name, globals, level)
        exempt = own_package and (target == own_package
                                  or target.startswith(own_package + "."))
        if target and is_forbidden(target) and not exempt:
            importer = (globals or {}).get("__name__", "?")
            raise ImportError(f"{importer} imports {target}, a module the port may not load "
                              f"({', '.join(FORBIDDEN_MODULES)})", name=target)
        return original(name, globals, locals, fromlist, level)

    builtins.__import__ = guarded
    try:
        yield
    finally:
        builtins.__import__ = original
