"""Structured logging helpers: the port's copy of
``elasticdl_tpu/common/log_utils.py``.  Every logger of the port hangs
under ``elasticdl_tpu_torch``, whose one stderr handler this module
installs on first use."""

import logging
import sys

_LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"

_initialized = False


def _init_root():
    global _initialized
    if _initialized:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_LOG_FORMAT))
    root = logging.getLogger("elasticdl_tpu_torch")
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    root.propagate = False
    _initialized = True


def get_logger(name: str, level=None) -> logging.Logger:
    _init_root()
    logger = logging.getLogger(f"elasticdl_tpu_torch.{name}")
    if level is not None:
        logger.setLevel(level)
    return logger

