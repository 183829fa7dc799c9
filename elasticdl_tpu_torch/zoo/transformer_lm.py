"""Transformer causal LM, the long-context configuration: the port of
``model_zoo/transformer/transformer_lm.py``.

A pre-LN decoder-only transformer.  Its causal self-attention runs the
flash-attention kernels (``ops/flash_attention.py``: K4 forward, K5 and
K6 backward) on the card, for every ``attn_impl``: the value is validated
as in JAX and selects nothing, since the port has one attention engine
(on the CPU the kernels' plain versions run).

Modules carry flax's names, so ``serving/convert.py`` maps the JAX
variables one to one: ``Embed_0`` (tokens) and ``Embed_1`` (positions),
``block_i`` with ``attn.qkv`` (the ``DenseGeneral`` kernel ``[e, 3, H,
D]``, bias ``[3, H, D]``), ``attn.proj``, ``LayerNorm_0/1``,
``Dense_0/1``, then ``LayerNorm_0`` and ``lm_head``.

The numerics are flax's.  Parameters are f32; with ``use_bf16`` every
layer computes in bf16: the embeddings are gathered and cast, ``tok +
pos`` and both residual adds are bf16, a Dense rounds its product to
bf16 before adding the bias.  LayerNorm takes its statistics in f32
(``E[x^2] - E[x]^2``, clipped at 0, epsilon 1e-6) and casts its output.
GELU is the tanh approximation.  The LM head is f32 (``f32 x f32``) by
default; ``logits_compute="bf16"`` takes JAX's ``_Bf16AccF32Head``
(``Bf16AccF32Head``): bf16 operands, f32 accumulation and f32 logits,
with the f32 head's parameter names.  The loss runs on f32 logits.

Context parallelism (JAX ``:107-168``): built with a
``parallel.mesh.Mesh`` whose ``model`` axis is larger than 1 and
``model_axis_mode="cp"``, attention runs as ring attention over that axis
(``parallel/ring_attention.py``: K7 forward, K8 and K9 backward).

- On an in-process mesh the model takes the whole sequence; with
  ``cp_layout="zigzag"`` it permutes x into the zigzag layout before
  ``qkv`` and the attention output back after it, as JAX does.
- On a process mesh each rank takes its own tokens and their global
  positions, ``forward(tokens, positions)`` (``sequence_positions`` gives
  them; ``Embed_1`` reads them), so the layouts differ only in which
  positions a rank holds and nothing is permuted.

The model-zoo contract of the JAX module: ``custom_model``, ``loss``
(mean next-token cross entropy), ``optimizer`` (AdamW 3e-3, weight decay
0.01), ``eval_metrics_fn``, ``dataset_fn`` and ``custom_data_reader``
(``synthetic://lm?...``, a reader).  What is not ported yet raises
``NotImplementedError``: ``model_axis_mode="tp"`` over a mesh, and a mesh
that is not a ``Mesh`` and holds more than one device.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from elasticdl_tpu_torch.common.device import TENSOR_PARALLEL_ITEM, resolve_device
from elasticdl_tpu_torch.data.reader import NumpyDataReader
from elasticdl_tpu_torch.data.synthetic import parse_synthetic_path, synthetic_lm_arrays
from elasticdl_tpu_torch.ops.flash_attention import flash_attention
from elasticdl_tpu_torch.parallel import optim
from elasticdl_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, resolve_mesh
from elasticdl_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    shard_positions,
    zigzag_orders,
)
from elasticdl_tpu_torch.zoo.deepfm import DenseGeneral, lecun_normal_

VOCAB = 256
SEQ_LEN = 128
LN_EPS = 1e-6

class Embed(nn.Embedding):
    """flax ``Embed``: an f32 table, gathered and cast to ``dtype``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype, device=None):
        super().__init__(num, features, device=device)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.to(torch.int64), self.weight).to(self.compute_dtype)

    def init_parameters(self, generator: torch.Generator) -> None:
        # flax default_embed_init: variance_scaling(1, fan_in, "normal",
        # out_axis=0) -> an untruncated normal of std 1/sqrt(features).
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(self.embedding_dim),
                        generator=generator)


class Dense(nn.Linear):
    """flax ``Dense``: ``x @ kernel`` in ``dtype``, then ``+ bias``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            # One f32 product, the bias added once: the same roundings.
            return F.linear(x.to(dt), self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)

    def init_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)


class _Bf16AccF32Matmul(torch.autograd.Function):
    """``x @ weight.T`` on bf16-rounded operands, accumulated and returned
    in f32 (JAX's ``dot_general(..., preferred_element_type=f32)``).

    The backward follows JAX's transpose rules for that ``dot_general``:
    each cotangent is the product of the f32 output cotangent with the
    other bf16 operand, computed in f32 and rounded to bf16 (the dtype of
    the operand it belongs to), then cast back through the ``astype``:
    ``dx = bf16(g @ wb)``, ``dweight = bf16(g.T @ xb)``.  On a CUDA tensor
    the forward is cuBLAS's bf16 product with an f32 output
    (``torch.mm(..., out_dtype=float32)``); the backward's products are
    f32 ones (TF32 stays off, PyTorch's default), as on the CPU, where
    every product upcasts the bf16 operands (their products are exact,
    so only the summation order differs from JAX)."""

    @staticmethod
    def forward(ctx, x, weight):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = weight.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.x_dtype, ctx.x_shape = x.dtype, x.shape
        if xb.is_cuda:
            out = torch.mm(xb, wb.t(), out_dtype=torch.float32)
        else:
            out = torch.mm(xb.float(), wb.float().t())
        return out.reshape(*x.shape[:-1], weight.shape[0])

    @staticmethod
    def backward(ctx, grad):
        xb, wb = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1]).to(torch.float32)
        dx = torch.mm(g, wb.float()).to(torch.bfloat16).to(ctx.x_dtype)
        dweight = torch.mm(g.t(), xb.float()).to(torch.bfloat16).to(torch.float32)
        return dx.reshape(ctx.x_shape), dweight


class Bf16AccF32Head(Dense):
    """JAX's ``_Bf16AccF32Head``: the LM head with bf16 operands and f32
    accumulation and logits.  Its parameters are f32 under ``nn.Dense``'s
    names, so checkpoints and ``serving/convert.py`` serve either head."""

    def __init__(self, in_features: int, vocab: int, device=None):
        super().__init__(in_features, vocab, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _Bf16AccF32Matmul.apply(x, self.weight) + self.bias


class QKVDense(DenseGeneral):
    """flax ``DenseGeneral((3, H, D))`` on ``[B, T, e]``: kernel ``[e, 3,
    H, D]``, bias ``[3, H, D]`` -> ``[B, T, 3, H, D]``."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype, device=None):
        super().__init__(d_model, (3, num_heads, d_model // num_heads), device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        e = self.kernel.shape[0]
        y = torch.matmul(x.to(dt), self.kernel.to(dt).reshape(e, -1))
        y = y + self.bias.to(dt).reshape(-1)
        return y.reshape(*x.shape[:-1], *self.kernel.shape[1:])


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: f32 statistics, epsilon 1e-6, output cast."""

    def __init__(self, features: int, dtype: torch.dtype, device=None):
        super().__init__(features, eps=LN_EPS, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(self.compute_dtype)

    def init_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


def cp_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when its ``model`` axis carries the sequence, else None."""
    return mesh if mesh is not None and mesh.shape[MODEL_AXIS] > 1 else None


class CausalSelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype, device=None,
                 mesh: Optional[Mesh] = None, cp_layout: str = "contiguous"):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of num_heads {num_heads}")
        self.qkv = QKVDense(d_model, num_heads, dtype, device)
        self.proj = Dense(d_model, d_model, dtype, device)
        self.mesh = cp_mesh(mesh)
        self.cp_layout = cp_layout
        # The ring's attention over the mesh's model axis, or None (one card).
        self._ring = None if self.mesh is None else make_ring_attention(
            self.mesh, causal=True, layout=cp_layout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        if self._ring is None:
            q, k, v = self.qkv(x).unbind(2)  # [B, T, H, D] each, views
            return self.proj(flash_attention(q, k, v, causal=True).reshape(b, t, e))
        # An in-process mesh holds the whole sequence: the zigzag layout
        # permutes x once before the position-wise qkv (JAX's order); a
        # process rank already holds its zigzag positions.
        inv = None
        if self.cp_layout == "zigzag" and self.mesh.in_process:
            order, inv = (torch.from_numpy(o).to(x.device)
                          for o in zigzag_orders(t, self.mesh.shape[MODEL_AXIS]))
            x = x[:, order]
        q, k, v = self.qkv(x).unbind(2)
        out = self._ring(q, k, v)
        if inv is not None:
            out = out[:, inv]
        return self.proj(out.reshape(b, t, e))

    def init_parameters(self, generator: torch.Generator) -> None:
        # DenseGeneral initialises its kernel as [e, 3*H*D]: fan_in e.
        self.qkv.init_parameters(generator)
        self.proj.init_parameters(generator)


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int, dtype, device=None,
                 **attn_kwargs):
        super().__init__()
        self.attn = CausalSelfAttention(d_model, num_heads, dtype, device, **attn_kwargs)
        self.LayerNorm_0 = LayerNorm(d_model, dtype, device)
        self.LayerNorm_1 = LayerNorm(d_model, dtype, device)
        self.Dense_0 = Dense(d_model, d_model * mlp_ratio, dtype, device)
        self.Dense_1 = Dense(d_model * mlp_ratio, d_model, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)

    def init_parameters(self, generator: torch.Generator) -> None:
        self.attn.init_parameters(generator)
        for layer in (self.LayerNorm_0, self.LayerNorm_1, self.Dense_0, self.Dense_1):
            layer.init_parameters(generator)


class TransformerLM(nn.Module):
    def __init__(
        self,
        vocab: int = VOCAB,
        d_model: int = 128,
        num_heads: int = 4,
        num_layers: int = 2,
        max_len: int = 4096,
        dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
        mlp_ratio: int = 4,
        device=None,
        mesh: Optional[Mesh] = None,
        cp_layout: str = "contiguous",
        logits_compute: str = "f32",
    ):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        self.mesh = cp_mesh(mesh)
        self.cp_layout = cp_layout
        self.Embed_0 = Embed(vocab, d_model, dtype, device)
        self.Embed_1 = Embed(max_len, d_model, dtype, device)
        for i in range(num_layers):
            setattr(self, f"block_{i}", Block(d_model, num_heads, mlp_ratio, dtype, device,
                                              mesh=mesh, cp_layout=cp_layout))
        self.LayerNorm_0 = LayerNorm(d_model, dtype, device)
        # Logits in f32 either way: the loss softmax wants full precision.
        self.lm_head = (Bf16AccF32Head(d_model, vocab, device) if logits_compute == "bf16"
                        else Dense(d_model, vocab, torch.float32, device))

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation, flax's defaults (draws in module order)."""
        self.Embed_0.init_parameters(generator)
        self.Embed_1.init_parameters(generator)
        for block in self.blocks():
            block.init_parameters(generator)
        self.LayerNorm_0.init_parameters(generator)
        self.lm_head.init_parameters(generator)

    def sequence_positions(self, seq_len: int, index: Optional[int] = None):
        """The global positions a rank of a process mesh holds of a
        ``seq_len`` sequence (int64 numpy; ``index``: its model index,
        default this rank's), or None when the model takes the whole
        sequence (one card, an in-process mesh)."""
        if self.mesh is None or self.mesh.in_process:
            return None
        n = self.mesh.shape[MODEL_AXIS]
        if seq_len % n or (self.cp_layout == "zigzag" and seq_len % (2 * n)):
            raise ValueError(f"seq_len {seq_len} does not shard over a model axis of {n} "
                             f"({self.cp_layout} layout)")
        index = self.mesh.model_index if index is None else index
        return shard_positions(index, seq_len // n, n, self.cp_layout)

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tokens ``[B, T]`` int -> logits ``[B, T, vocab]`` f32.
        ``positions`` ``[T]``: the tokens' global positions (default 0..T-1);
        a rank of a process mesh passes its own."""
        if positions is None:
            if self.mesh is not None and not self.mesh.in_process:
                raise ValueError("a rank of a process mesh passes its tokens' positions "
                                 "(sequence_positions)")
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.Embed_0(tokens) + self.Embed_1(positions[None, :])
        for block in self.blocks():
            if self.remat and torch.is_grad_enabled():
                # nn.remat: the block's activations are recomputed in the
                # backward (flash forward included).
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.lm_head(self.LayerNorm_0(x))


def custom_model(
    vocab: int = VOCAB,
    d_model: int = 128,
    num_heads: int = 4,
    num_layers: int = 2,
    max_len: int = 4096,
    use_bf16: bool = True,
    mesh: Optional[Any] = None,
    attn_impl: str = "auto",
    cp_layout: str = "contiguous",
    model_axis_mode: str = "cp",
    remat: bool = False,
    logits_compute: str = "f32",
    device=None,
) -> TransformerLM:
    """The JAX ``custom_model`` contract, built on ``device`` (None: the
    CUDA card, or the mesh's device; weights uninitialised).
    ``attn_impl``, ``cp_layout`` and ``model_axis_mode`` are validated as
    in JAX, ``attn_impl`` only here: it selects nothing (every value runs
    the kernels), so the model never sees it.  The other two act over a
    ``Mesh`` whose model axis is larger than 1: ``"cp"`` runs ring
    attention, ``"tp"`` raises."""
    if attn_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"attn_impl must be 'auto', 'pallas' or 'xla', got {attn_impl!r}")
    if model_axis_mode not in ("cp", "tp"):
        raise ValueError(f"model_axis_mode must be 'cp' or 'tp', got {model_axis_mode!r}")
    if cp_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"cp_layout must be 'contiguous' or 'zigzag', got {cp_layout!r}")
    if logits_compute not in ("f32", "bf16"):
        raise ValueError(f"logits_compute must be 'f32' or 'bf16', got {logits_compute!r}")
    mesh = resolve_mesh(mesh, "the port's transformer")
    if cp_mesh(mesh) is not None and model_axis_mode == "tp":
        raise NotImplementedError(
            f"model_axis_mode='tp' shards heads and the MLP over the model axis: "
            f"{TENSOR_PARALLEL_ITEM}"
        )
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        device = mesh.device
    return TransformerLM(
        vocab=vocab,
        d_model=d_model,
        num_heads=num_heads,
        num_layers=num_layers,
        max_len=max_len,
        dtype=torch.bfloat16 if use_bf16 else torch.float32,
        remat=remat,
        device=resolve_device(device),
        mesh=mesh,
        cp_layout=cp_layout,
        logits_compute=logits_compute,
    )


def loss(labels: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (``optax.
    softmax_cross_entropy_with_integer_labels`` on f32 logits, then the
    mean); labels ``[B, T]``, logits ``[B, T, V]``."""
    logits = predictions.to(torch.float32)
    shifted = logits - logits.amax(-1, keepdim=True).detach()
    label_logits = torch.gather(shifted, -1, labels.to(torch.int64)[..., None])[..., 0]
    return (torch.log(torch.exp(shifted).sum(-1)) - label_logits).mean()


def optimizer(lr: float = 3e-3) -> optim.DenseOptimizer:
    return optim.adamw(lr, weight_decay=0.01)


def eval_metrics_fn():
    def perplexity(outputs, labels):
        ce = float(loss(torch.as_tensor(np.asarray(labels)), torch.as_tensor(np.asarray(outputs))))
        return float(np.exp(min(ce, 20.0)))

    return {
        "perplexity": perplexity,
        "accuracy": lambda outputs, labels: float(
            np.mean(np.argmax(outputs, axis=-1) == labels)
        ),
    }


def dataset_fn(dataset, mode, metadata):
    """JAX ``transformer_lm.py:331``: each record to int32 ``(tokens,
    next_tokens)``, shuffled in training."""
    def parse(record):
        tokens, next_tokens = record
        return np.asarray(tokens, np.int32), np.asarray(next_tokens, np.int32)

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(1024, seed=0)
    return dataset


def custom_data_reader(data_path: str, **kwargs):
    """``synthetic://lm?n=&len=&vocab=&seed=`` -> a reader of the JAX zoo
    reader's records, ``(tokens, next_tokens)`` int32 rows; None for any
    other path."""
    name, params = parse_synthetic_path(data_path)
    if name != "lm":
        return None
    tokens, next_tokens = synthetic_lm_arrays(
        n=params.get("n", 2048),
        seq_len=params.get("len", SEQ_LEN),
        vocab=params.get("vocab", VOCAB),
        seed=params.get("seed", 0),
    )
    return NumpyDataReader(tokens, next_tokens, shard_name="lm-synth")
