"""The port's vision zoo (``zoo/{vision,mnist,cifar10,resnet50}.py``)
against the JAX package on the CPU: forwards, batch statistics, SAME
padding, the running variance and ResNet-50's variable tree
(``tests/test_torch_vision_training.py`` trains them).

Variables in the JAX layout drawn from a seed (batch-norm scales and
running averages drawn too, so no layer is the identity) go to JAX's
``apply`` and, carried across by ``serving.convert``, to the port; the
same numpy inputs go through both.
Tolerances:

- f32 logits in eval mode: ``|port - jax| <= 1e-5 + 1e-5 * max|jax
  logits|``;
- f32 logits in train mode: within that of the exact result, flax's own
  model run in f64, and of JAX's logits plus JAX's own distance from the
  exact result.  XLA sums a batch norm's ``E[x]`` and ``E[x^2]`` on the
  CPU less accurately than torch's pairwise sums: in train mode the
  small ResNet-50's logits sit 2.8e-5 from the exact result in JAX and
  6.3e-6 in the port, against a tolerance of 2.8e-5;
- ``batch_stats`` after one training forward: ``|port - jax| <= 1e-5 *
  max|leaf|`` per leaf (a running mean near zero has no relative scale
  of its own);
- bf16 logits: within 2% of the largest logit of JAX's in eval mode
  (bf16 roundings placed elsewhere); in train mode, of JAX's and of the
  exact result, plus JAX's own distance from the exact result, since
  statistics of a batch of 4 taken from bf16 activations through 17
  norms leave both packages 3-4% of the largest logit from it.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import cifar10, mnist, resnet50, vision
from model_zoo.cifar10 import cifar10_functional_api as jax_cifar10
from model_zoo.mnist import mnist_functional_api as jax_mnist
from model_zoo.mnist import mnist_subclass as jax_mnist_subclass
from model_zoo.resnet50 import resnet50_subclass as jax_resnet50

BATCH = 4
SMALL_STAGES = (1, 1, 1, 1)


def _input(name, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    if name.startswith("mnist"):
        return rng.random((batch, 28, 28)).astype(np.float32)
    if name.startswith("resnet20"):
        return rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
    # 64x64: the stem and pool leave 16x16, so stage 1's stride-2 3x3
    # conv sees an even input and pads (0, 1) by the SAME rule.
    return rng.integers(0, 256, (batch, 64, 64, 3)).astype(np.uint8)


def _models(name):
    """(JAX module, the port's module on the CPU) of a case."""
    bf16 = name.endswith("bf16")
    if name == "mnist_functional":
        return jax_mnist.custom_model(), mnist.custom_model(device="cpu")
    if name == "mnist_subclass":
        return jax_mnist_subclass.custom_model(), mnist.subclass_model(device="cpu")
    if name.startswith("resnet20"):
        return (jax_cifar10.custom_model(use_bf16=bf16),
                cifar10.custom_model(use_bf16=bf16, device="cpu"))
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    torch_dtype = torch.bfloat16 if bf16 else torch.float32
    return (jax_resnet50.ResNet50(num_classes=10, dtype=dtype, norm_dtype=dtype,
                                  stage_sizes=SMALL_STAGES),
            resnet50.ResNet50(10, torch_dtype, torch_dtype, SMALL_STAGES, device="cpu"))


def _variables(port_model, seed=1):
    """Seeded variables in the JAX layout (``convert.random_jax_variables``:
    conv kernels of lecun's variance, batch-norm scales and running
    variances in [0.5, 1.5), running means, dense kernels and biases in
    [-0.05, 0.05)), so no layer is the identity; drawn without JAX's
    init, whose compile would cost more than the comparisons."""
    return convert.random_jax_variables(port_model, seed)[0]


def _load(port_model, variables):
    convert.load_state(port_model, convert.state_dict_from_jax(variables, port_model))
    return port_model


def _close(got, want, what, rel=1e-5):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    tol = 1e-5 + rel * np.abs(want).max()
    assert err <= tol, f"{what}: max error {err} > {tol}"


def _f64_interceptor(next_fun, args, kwargs, context):
    """Makes every flax module whose ``dtype`` is f32 or bf16 (convs,
    batch norms, dense heads, the models themselves) compute in f64."""
    dtype = getattr(context.module, "dtype", None)
    if dtype is not None and jnp.dtype(dtype) in (jnp.dtype(jnp.float32),
                                                  jnp.dtype(jnp.bfloat16)):
        object.__setattr__(context.module, "dtype", jnp.float64)
    return next_fun(*args, **kwargs)


def _jax_logits(jax_model, variables, x, train, f64=False):
    """JAX's logits; with ``f64`` the exact result: the same flax model
    with its variables, input and every module in f64."""
    def apply(v, x):
        return jax_model.apply(v, x, train=train, mutable=["batch_stats"])[0]

    if not f64:
        return np.asarray(jax.jit(apply)(variables, x), np.float64)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        x = x if x.dtype == np.uint8 else x.astype(np.float64)

        def apply_f64(v, x):
            with fnn.intercept_methods(_f64_interceptor):
                return apply(v, x)

        out = jax.jit(apply_f64)(variables, x)
        assert out.dtype == jnp.float64
        return np.asarray(out)


def _close_to_jax(port_model, jax_model, variables, x, train, what, bf16=False):
    """The port's logits within ``tol`` (``1e-5 + 1e-5 * max|logit|``,
    or 2% of max|logit| in bf16) of JAX's in eval mode.  In train mode within
    ``tol`` of the exact result (f32) or ``tol`` plus JAX's own distance
    from it (bf16), and within that plus JAX's own distance of JAX's."""
    want = _jax_logits(jax_model, variables, x, train)
    got = port_model(torch.from_numpy(x), train=train).detach().float().numpy()
    tol = (0.02 if bf16 else 1e-5) * np.abs(want).max() + (0.0 if bf16 else 1e-5)
    if not train:
        assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(), tol)
        return
    exact = _jax_logits(jax_model, variables, x, train, f64=True)
    slack = np.abs(want - exact).max()
    to_exact = tol + (slack if bf16 else 0.0)
    assert np.abs(got - exact).max() <= to_exact, (what, np.abs(got - exact).max(), to_exact)
    assert np.abs(got - want).max() <= tol + slack, (what, np.abs(got - want).max(), tol + slack)


def _stats_close(port_model, new_stats, what):
    flat = convert.flatten_variables({"batch_stats": jax.device_get(new_stats)})
    buffers = dict(port_model.named_buffers())
    checked = 0
    for jax_key, port_key, kind, _ in convert._targets(port_model):
        if kind in convert.STAT_KINDS:
            want, got = flat[jax_key], buffers[port_key].numpy()
            err = np.abs(got - want).max()
            assert err <= 1e-5 * np.abs(want).max(), f"{what} {jax_key}: {err}"
            checked += 1
    assert checked == len(flat)


@pytest.mark.parametrize("name", ["mnist_functional", "mnist_subclass", "resnet20",
                                  "resnet50"])
def test_forward_and_batch_stats_match_jax(name):
    jax_model, port_model = _models(name)
    x = _input(name)
    variables = _variables(port_model)
    _load(port_model, variables)
    _close_to_jax(port_model, jax_model, variables, x, False, f"{name} eval")
    if "batch_stats" not in variables:
        assert vision.batch_stats(port_model) == {}
        return
    _close_to_jax(port_model, jax_model, variables, x, True, f"{name} train")
    _, new = jax.jit(lambda v, x: jax_model.apply(v, x, train=True,
                                                  mutable=["batch_stats"]))(variables, x)
    # one training forward, from the loaded statistics
    _load(port_model, variables)
    port_model(torch.from_numpy(x), train=True)
    _stats_close(port_model, new["batch_stats"], name)


@pytest.mark.parametrize("name", ["resnet20_bf16", "resnet50_bf16"])
def test_bf16_logits_within_two_percent(name):
    jax_model, port_model = _models(name)
    x = _input(name)
    variables = _variables(port_model)
    _load(port_model, variables)
    for train in (False, True):
        _close_to_jax(port_model, jax_model, variables, x, train, f"{name} train={train}",
                      bf16=True)
        _load(port_model, variables)


def test_same_padding_is_flax_asymmetric_rule():
    """A stride-2 3x3 conv on an even input pads (0, 1): the port's
    ``Conv`` matches flax's, and symmetric (1, 1) padding would not."""
    assert vision.same_pads(16, 3, 2) == (0, 1)
    assert vision.same_pads(15, 3, 2) == (1, 1)
    assert vision.same_pads(16, 3, 1) == (1, 1)
    assert vision.same_pads(16, 1, 2) == (0, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    flax_conv = fnn.Conv(7, (3, 3), strides=(2, 2), use_bias=False)
    variables = jax.device_get(flax_conv.init(jax.random.PRNGKey(0), x))
    want = np.asarray(flax_conv.apply(variables, x)).transpose(0, 3, 1, 2)
    conv = vision.Conv(5, 7, (3, 3), (2, 2), use_bias=False)
    kernel = torch.from_numpy(variables["params"]["kernel"].transpose(3, 2, 0, 1).copy())
    conv.weight.data.copy_(kernel)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(nchw).detach().numpy()
    assert got.shape == want.shape == (2, 7, 8, 8)
    _close(got, want, "SAME stride-2 conv")
    symmetric = F.conv2d(nchw, kernel, stride=2, padding=1).numpy()
    assert np.abs(symmetric - want).max() > 0.1


def test_running_variance_is_the_biased_batch_variance():
    """flax's running variance takes the biased batch variance; torch's
    ``nn.BatchNorm2d`` takes the unbiased one, which differs here by a
    factor of 8/7 on the batch's share of the update."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 2, 2, 6)) * 3 + 1).astype(np.float32)  # 8 rows a channel
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), x)
    _, new = flax_bn.apply(variables, x, mutable=["batch_stats"])
    want = np.asarray(new["batch_stats"]["var"])
    port = vision.BatchNorm(6)
    port.init_parameters(torch.Generator())
    port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(port.var.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    torch_bn = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1)
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(torch_bn.running_var.numpy(), want, rtol=1e-3)


def test_full_resnet50_variables_match_jax_init_shapes():
    """Every parameter and ``batch_stats`` path of the full ResNet-50 and
    its JAX-layout shape, against ``jax.eval_shape`` of JAX's init (no
    convolution runs)."""
    jax_model = jax_resnet50.custom_model()
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 224, 224, 3), jnp.uint8)))
    want = {k: (tuple(v.shape), np.dtype(v.dtype))
            for k, v in convert.flatten_variables(shapes).items()}
    model = resnet50.custom_model(device="meta")
    state = model.state_dict()
    got = {}
    for jax_key, port_key, kind, _ in convert._targets(model):
        shape = tuple(state[port_key].shape)
        if kind == "dense_kernel":
            shape = shape[::-1]
        elif kind == "conv_kernel":
            shape = (shape[2], shape[3], shape[1], shape[0])
        got[jax_key] = (shape, np.dtype(np.float32))
    assert got == want
    assert len([k for k in got if k.startswith("batch_stats/")]) == 2 * 53
    assert "batch_stats/BottleneckBlock_3/BatchNorm_2/var" in got
