"""K10, the block-gather probe (``ops/sparse_gather.py``), and the port of
its experiment script (``elasticdl_tpu_torch.bench.exp_sparse_gather``)
on the CPU.

``pallas_gather`` is a closure inside ``main`` of
``scripts/exp_sparse_gather.py`` (:154-172) and cannot be imported, so
this file carries a copy of those lines (``PALLAS_GATHER``), runs it in
Pallas interpret mode, and asserts that the script still contains them
word for word, so a drift there is caught.  The port's plain version
(what ``block_gather`` runs on a CPU tensor) must equal it bit for bit on
indices in range, past the end and negative: the interpret-mode kernel
clamps an index past the end to the last block, wraps ``b`` in
``[-nb8, 0)`` to ``b + nb8`` and clamps a lower one to block 0.
"""

import functools
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from elasticdl_tpu_torch.bench import exp_sparse_gather as bench
from elasticdl_tpu_torch.ops import sparse_gather as sg
from elasticdl_tpu_torch.parallel.packed import PackedSpec

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "exp_sparse_gather.py"

#: scripts/exp_sparse_gather.py:154-172, as written there (in ``main``).
PALLAS_GATHER = '''\
    def gather_kernel(ids_ref, rows_ref, out_ref):
        out_ref[...] = rows_ref[...].reshape(out_ref.shape)

    def pallas_gather(tb, block_ix):
        n = block_ix.shape[0]
        return pl.pallas_call(
            gather_kernel,
            grid_spec=pltpu.PrefetchScalarGridSpec(
                num_scalar_prefetch=1,
                grid=(n,),
                in_specs=[
                    pl.BlockSpec(
                        (8, spec.block_width),
                        lambda i, ids_pref: (ids_pref[i], 0),
                    ),
                ],
                out_specs=pl.BlockSpec(
                    (1, 8, spec.block_width), lambda i, ids_pref: (i, 0, 0)
                ),
            ),
            out_shape=jax.ShapeDtypeStruct(
                (n, 8, spec.block_width), tb.dtype
            ),
        )(block_ix, tb)
'''

#: 320 storage blocks of 128 lanes: 40 blocks of 8 (the Pallas reading).
SPEC = PackedSpec(2560, 16)


def _pallas_gather(spec):
    """The script's closure over ``spec``, its pallas_call in interpret
    mode (the JAX package's CPU route)."""
    namespace = {
        "jax": jax, "pltpu": pltpu, "spec": spec,
        "pl": SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                              BlockSpec=pl.BlockSpec),
    }
    exec(textwrap.dedent(PALLAS_GATHER), namespace)
    return namespace["pallas_gather"]


def test_script_still_holds_the_copied_kernel():
    assert PALLAS_GATHER in SCRIPT.read_text()


def test_block_gather_matches_the_pallas_kernel():
    nb8 = SPEC.num_blocks // 8
    table = np.random.RandomState(0).randn(*SPEC.packed_shape).astype(np.float32)
    b = np.array([0, 1, 5, nb8 - 1, nb8, nb8 + 5, 1000, 2**27, 2**28, 2**30, 2**31 - 1,
                  -1, -2, -3, -nb8 + 1, -nb8, -nb8 - 1, -nb8 - 2, -2 * nb8, -100, -1000,
                  -2**28, -2**28 - 1, -2**31], np.int32)
    want = np.asarray(_pallas_gather(SPEC)(jnp.asarray(table), jnp.asarray(b)))
    rows = torch.from_numpy(table).view(SPEC.rows_shape)
    got = sg.block_gather(rows, SPEC, torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sg.block_gather_plain(rows, SPEC, torch.from_numpy(b)).numpy(),
                                  want)
    # The readings the rule is named after: past the end clamps, -1 wraps.
    blocks = sg.block_index(SPEC, torch.from_numpy(b)).tolist()
    assert blocks[:6] == [0, 1, 5, nb8 - 1, nb8 - 1, nb8 - 1]
    assert blocks[11:19] == [nb8 - 1, nb8 - 2, nb8 - 3, 1, 0, 0, 0, 0]
    assert sg.launch_counts() == {"block_gather": 0}  # the plain version launches nothing


def test_block_gather_checks_operands():
    rows = torch.zeros(SPEC.rows_shape)
    b = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        sg.block_gather(rows, SPEC, b.long())
    with pytest.raises(ValueError, match="num_blocks % 8"):
        odd = PackedSpec(300, 16)  # 38 storage blocks
        sg.block_gather(torch.zeros(odd.rows_shape), odd, b)
    with pytest.raises(ValueError, match="128-lane"):
        wide = PackedSpec(64, 256)
        sg.block_gather(torch.zeros(wide.rows_shape), wide, b)
    with pytest.raises(ValueError, match="shape"):
        sg.block_gather(rows[:-8], SPEC, b)


def test_selftests_on_the_cpu():
    assert bench.selftest("cpu") == 0
    assert bench.selftest_shard_map("cpu") == 0
    cli = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.bench.exp_sparse_gather", "--shard_map",
         "--selftest", "--device", "cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert cli.returncode == 0, cli.stderr
    assert "shard_map selftest OK on cpu" in cli.stdout
