"""numpy arrays <-> the wire's ``Tensor`` (``common/messages.py``): the
port's copy of the array half of ``elasticdl_tpu/common/tensor_utils.py``
(``ndarray_to_pb`` :48, ``pb_to_ndarray`` :67).  The bytes travel in
base64 inside the JSON body, so an array crosses bit for bit."""

from __future__ import annotations

import base64

import numpy as np

from elasticdl_tpu_torch.common.messages import Tensor

#: The dtypes the JAX package's proto enum carries, less bfloat16.
WIRE_DTYPES = tuple(np.dtype(t) for t in (np.float32, np.float64, np.int32, np.int64,
                                          np.bool_, np.uint8, np.int8, np.float16))


def ndarray_to_tensor(array, name: str = "") -> Tensor:
    array = np.asarray(array)
    if array.dtype not in WIRE_DTYPES:
        raise ValueError(f"Unsupported dtype for wire transfer: {array.dtype}")
    little = array.astype(array.dtype.newbyteorder("<"), copy=False)
    return Tensor(name=name, dims=list(array.shape), dtype=little.dtype.str,
                  content=base64.b64encode(little.tobytes()).decode("ascii"))


def tensor_to_ndarray(tensor: Tensor) -> np.ndarray:
    dtype = np.dtype(tensor.dtype)
    if dtype.newbyteorder("=") not in WIRE_DTYPES:
        raise ValueError(f"Unsupported wire dtype: {tensor.dtype}")
    # A copy: frombuffer is read-only, and consumers may update in place.
    array = np.frombuffer(base64.b64decode(tensor.content), dtype=dtype).astype(
        dtype.newbyteorder("="))
    return array.reshape(tuple(tensor.dims))
