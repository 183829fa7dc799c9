#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elasticdl_tpu_torch``) on one
CUDA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  Phases, each fatal on failure:

1. The card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of the hand-written kernels from ``ops/csrc``.
2. Each kernel against its plain PyTorch version on the card, on a
   26M-row table (DeepFM's 26 fields x 1M ids, dim 1+8 -> [26M, 16]
   f32), generated on the device from a seeded ``torch.Generator``:
   exactness, then a median time per launch from CUDA events (L2
   flushed between launches), beside the plain version's time and the
   least time the card's memory rate allows for the same bytes.
3. Serving at full width: a merged-layout DeepFM artifact (vocab 1M per
   field, embedding_dim 8, hidden 128, seeded weights) written with
   ``write_artifact``, served by ``ServingReplica`` on the default
   device through ``MicroBatcher``; 8 client threads issue 200 requests
   of 8 rows, every response is checked against the same model's plain
   forward on the card, and QPS and p50/p99 latency are printed.
4. Hot swap to a ``split_tables`` artifact (the layout ``fused_lookup``
   serves), checked the same way; ``stats()`` must show generation 2.

Launch counts are zeroed just before each serving phase and read just
after it; a kernel of the path that did not launch there fails the run.
The line before the last holds the card's name and power limit, the
last line ``{"ok": true, "device": {...}}``.  It exits non-zero, with no
result, when no CUDA device is available or the port is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

#: Published H100 SXM peak memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
MODEL_DEF = "deepfm.deepfm_functional_api"
NUM_CAT, NUM_DENSE = 26, 13
SOURCE = "elasticdl_tpu_torch/ops/csrc/sparse_embedding.cu"
REPLACES = {
    "fused_lookup_fm": "elasticdl_tpu/ops/sparse_embedding.py:755",
    "fused_lookup": "elasticdl_tpu/ops/sparse_embedding.py:249",
}
#: Tolerance of the FM sums against the plain version: both add the
#: same F f32 terms, in another order (the kernel field by field,
#: torch.sum pairwise), so each lies within (F-1)*u*sum|terms| of the
#: exact sum (u = 2**-24) and they may differ by twice that, elementwise.
#: acts and lookups must match bit for bit.
SUM_ORDER_ULPS = 2.0 * 2.0 ** -24
#: Served logits against the plain forward: the hot-swap bar.
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def import_port():
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import elasticdl_tpu_torch
    except ImportError as exc:
        fail(f"elasticdl_tpu_torch is not importable beside {here}: {exc}")
    pkg = os.path.dirname(os.path.abspath(elasticdl_tpu_torch.__file__))
    if os.path.dirname(pkg) != here:
        fail(f"elasticdl_tpu_torch comes from {pkg}, not from this checkout")


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------


def median_ms(fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events), with the
    L2 cache flushed before each timed call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def gather_ms(table, rows, flush) -> float:
    """PyTorch's own row gather of the same (precomputed) rows: not the
    kernel's function (no clamp rule, no lane cut, no FM sums), so not a
    library_ms, but a yardstick of the gather that both kernels do."""
    return median_ms(lambda: table.index_select(0, rows), flush)


def lookup_bytes(n: int, dim: int) -> int:
    # ids read, the rows' dim lanes read, [n, dim] written.
    return n * 4 + 2 * n * dim * 4


def lookup_fm_bytes(batch: int, fields: int, dim: int, with_bet: bool) -> int:
    ids_valid = batch * fields * (4 + 1)
    rows_in = batch * fields * dim * 4
    bet = rows_in if with_bet else 0
    outs = batch * fields * dim * 4 + batch * 4 + 2 * batch * (dim - 1) * 4
    return ids_valid + rows_in + bet + outs


def bound_ms(nbytes: int) -> float:
    # Operations (a few f32 adds per element) are far below the card's
    # 67 TFLOP/s; the bytes bound.
    return nbytes / HBM_BYTES_PER_S * 1e3


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------


def bit_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    )


def check_lookup(ske, spec, table, ids):
    got = ske.fused_lookup(spec, table, ids)
    want = ske.fused_lookup_plain(spec, table, ids)
    if not bit_equal(got, want):
        fail(f"fused_lookup differs from its plain version on {ids.shape[0]} ids")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_lookup_fm(ske, spec, table, bet, ids, valid):
    import torch

    got = ske.fused_lookup_fm(spec, table, bet, ids, valid)
    want = ske.fused_lookup_fm_plain(spec, table, bet, ids, valid)
    torch.cuda.synchronize()
    if not bit_equal(got[0], want[0]):
        fail("fused_lookup_fm acts differ from the plain version's bits")
    acts = want[0]
    fields = acts.shape[1]
    terms = (acts[..., 0].abs().sum(-1), acts[..., 1:].abs().sum(1),
             (acts[..., 1:] * acts[..., 1:]).sum(1))
    for name, g, w, t in zip(("first", "sum_v", "sum_sq"), got[1:], want[1:], terms):
        excess = (g - w).abs() - SUM_ORDER_ULPS * fields * t
        if float(excess.max()) > 0.0:
            fail(f"fused_lookup_fm {name} differs from the plain version by more "
                 f"than the reduction-order bound (excess {float(excess.max())!r})")
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def kernel_phase(card: str, seed: int):
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.packed import PackedSpec, row_index

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    spec = PackedSpec(1_000_000 * NUM_CAT, 1 + 8)
    table = torch.empty(spec.rows_shape, dtype=torch.float32, device=dev)
    table.uniform_(-0.05, 0.05, generator=gen)
    table[:, spec.dim:] = 0.0
    table[spec.vocab_size:] = 0.0
    log(f"table: {tuple(table.shape)} f32, {table.numel() * 4 / 1e9:.2f} GB on the card")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)  # 512 MiB > L2

    def ids_in(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    results = {}
    # -- fused_lookup: 65,536 ids, negative and past the table included.
    n = 65_536
    ids = ids_in(n, -1000, spec.vocab_padded + 1000)
    err = check_lookup(ske, spec, table, ids)
    main_ids = ids_in(64 * NUM_CAT, 0, spec.vocab_size)  # a bucket-64 batch
    check_lookup(ske, spec, table, main_ids)
    results["fused_lookup"] = {
        "shape": f"ids [{n}], table {list(spec.rows_shape)}, dim {spec.dim}",
        "max_abs_err": err,
        "ms": median_ms(lambda: ske.fused_lookup(spec, table, ids), flush),
        "plain_ms": median_ms(lambda: ske.fused_lookup_plain(spec, table, ids), flush),
        "gather_ms": gather_ms(table, row_index(spec, ids), flush),
        "bound_ms": bound_ms(lookup_bytes(n, spec.dim)),
        "main_path_shape": f"ids [{main_ids.shape[0]}]",
        "main_path_shape_ms": median_ms(
            lambda: ske.fused_lookup(spec, table, main_ids), flush),
        "main_path_shape_bound_ms": bound_ms(lookup_bytes(main_ids.shape[0], spec.dim)),
    }

    # -- fused_lookup_fm: B=8192, F=26 (some ids invalid), bet None as
    # serving passes it; bet non-zero checked once for the training slice.
    batch = 8192
    cat = ids_in(batch * NUM_CAT, 0, spec.vocab_size).view(batch, NUM_CAT)
    valid = torch.rand((batch, NUM_CAT), generator=gen, device=dev) > 0.05
    bet = torch.randn((batch, NUM_CAT, spec.dim), generator=gen, device=dev)
    err = check_lookup_fm(ske, spec, table, None, cat, valid)
    err = max(err, check_lookup_fm(ske, spec, table, bet, cat, valid))
    main_cat, main_valid = cat[:64].contiguous(), valid[:64].contiguous()
    check_lookup_fm(ske, spec, table, None, main_cat, main_valid)
    results["fused_lookup_fm"] = {
        "shape": f"ids [{batch}, {NUM_CAT}], table {list(spec.rows_shape)}, dim {spec.dim}",
        "max_abs_err": err,
        "ms": median_ms(lambda: ske.fused_lookup_fm(spec, table, None, cat, valid), flush),
        "plain_ms": median_ms(
            lambda: ske.fused_lookup_fm_plain(spec, table, None, cat, valid), flush),
        "gather_ms": gather_ms(table, row_index(spec, cat.reshape(-1)), flush),
        "bound_ms": bound_ms(lookup_fm_bytes(batch, NUM_CAT, spec.dim, False)),
        "main_path_shape": f"ids [64, {NUM_CAT}]",
        "main_path_shape_ms": median_ms(
            lambda: ske.fused_lookup_fm(spec, table, None, main_cat, main_valid), flush),
        "main_path_shape_bound_ms": bound_ms(lookup_fm_bytes(64, NUM_CAT, spec.dim, False)),
    }
    for name, r in results.items():
        log(
            f"kernel {name}: {r['shape']}: max_abs_err {r['max_abs_err']!r}, "
            f"{r['ms']!r} ms (plain {r['plain_ms']!r} ms, index_select of the rows "
            f"{r['gather_ms']!r} ms, bound {r['bound_ms']!r} ms); "
            f"main-path shape {r['main_path_shape']}: {r['main_path_shape_ms']!r} ms "
            f"(bound {r['main_path_shape_bound_ms']!r} ms) [{card}]"
        )
    del table, flush
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# phases 3-4: the serving path
# ----------------------------------------------------------------------


def write_random_artifact(out_dir: str, params: str, seed: int) -> None:
    from elasticdl_tpu_torch.serving import convert
    from elasticdl_tpu_torch.serving.export import write_artifact
    from elasticdl_tpu_torch.zoo import build_model

    shapes_only = build_model(MODEL_DEF, params, device="meta")
    variables, tables = convert.random_jax_variables(shapes_only, seed)
    write_artifact(out_dir, variables, tables,
                   {"model_def": MODEL_DEF, "model_params": params})


def make_requests(rng, vocab: int, count: int, rows: int):
    import numpy as np

    out = []
    for _ in range(count):
        cat = rng.integers(0, vocab, size=(rows, NUM_CAT)).astype(np.int32)
        cat[rng.random((rows, NUM_CAT)) < 0.02] = -1        # padding ids
        cat[rng.random((rows, NUM_CAT)) < 0.02] = vocab + 7  # out of vocabulary
        out.append({
            "dense": rng.random((rows, NUM_DENSE), dtype=np.float32),
            "cat": cat,
        })
    return out


def plain_logits(served, features):
    """The served model's forward with the plain PyTorch lookups in place
    of the kernels, on the same card: the yardstick of the responses."""
    import torch

    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    with mock.patch.object(ske, "fused_lookup", ske.fused_lookup_plain), \
            mock.patch.object(ske, "fused_lookup_fm", ske.fused_lookup_fm_plain), \
            torch.inference_mode():
        return served.forward(features).cpu().numpy()


def drive(batcher, requests, clients: int = 8):
    """Closed loop: `clients` threads issue the requests back to back.
    Returns (responses, latencies_s, elapsed_s)."""
    responses = [None] * len(requests)
    latencies = [0.0] * len(requests)
    errors = []

    def client(w):
        try:
            for i in range(w, len(requests), clients):
                t0 = time.perf_counter()
                responses[i] = batcher.predict(requests[i])
                latencies[i] = time.perf_counter() - t0
        except Exception as exc:  # reported after join
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(w,), name=f"smoke-client-{w}")
               for w in range(clients)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            fail(f"client thread {t.name} did not finish")
    elapsed = time.perf_counter() - start
    if errors:
        fail(f"{len(errors)} client(s) failed: {errors[0]!r}")
    return responses, latencies, elapsed


def serve_phase(name, replica, batcher, requests, card, dispatches):
    import numpy as np

    from elasticdl_tpu_torch.ops import sparse_embedding as ske

    dispatches.clear()
    ske.reset_launch_counts()
    responses, latencies, elapsed = drive(batcher, requests)
    counts = ske.launch_counts()
    executes = sorted(seconds for seconds, _ in dispatches)
    rows_per_batch = sum(rows for _, rows in dispatches) / len(dispatches)
    served = replica.generation.served
    stacked = {k: np.concatenate([r[k] for r in requests]) for k in requests[0]}
    want = plain_logits(served, stacked)
    offset = 0
    for req, got in zip(requests, responses):
        rows = req["cat"].shape[0]
        if got.shape != (rows,) or not np.all(np.isfinite(got)):
            fail(f"{name}: response of shape {got.shape} / non-finite for {rows} rows")
        np.testing.assert_allclose(got, want[offset:offset + rows],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        offset += rows
    lat = sorted(latencies)
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3
    log(
        f"{name}: served {len(requests)} requests of {requests[0]['cat'].shape[0]} rows, "
        f"all within rtol {LOGIT_RTOL} of the plain forward; {len(requests) / elapsed!r} "
        f"requests/s, p50 {p50!r} ms, p99 {p99!r} ms, launches {counts}; "
        f"{len(dispatches)} dispatches of {rows_per_batch!r} rows on average, "
        f"execute (host wall, device sync included) median "
        f"{executes[len(executes) // 2] * 1e3!r} ms [{card}]"
    )
    return counts


def serving_phases(card: str, seed: int, workdir: str,
                   vocab1: int = 1_000_000, vocab2: int = 100_000):
    import numpy as np

    from elasticdl_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    merged = os.path.join(workdir, "gen1_merged")
    split = os.path.join(workdir, "gen2_split")
    t0 = time.perf_counter()
    write_random_artifact(
        merged, f"vocab_size={vocab1},embedding_dim=8,hidden=128,split_tables=false", seed)
    log(f"artifact 1 (merged, vocab {vocab1}/field) written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    replica = ServingReplica(merged)
    if replica.device.type != "cuda":
        fail(f"ServingReplica's default device is {replica.device}, not cuda")
    log(f"replica loaded generation 1 on {replica.device} in {time.perf_counter() - t0:.1f} s")
    config = BatcherConfig(max_batch_size=64, max_wait_us=2000, queue_limit=512)
    dispatches = []  # (execute seconds, real rows) per dispatch

    def timed_execute(features, n_valid):
        t0 = time.perf_counter()
        try:
            return replica.execute(features, n_valid)
        finally:
            dispatches.append((time.perf_counter() - t0, n_valid))

    batcher = MicroBatcher(timed_execute, config).start()
    rng = np.random.default_rng(seed)
    try:
        replica.warmup(make_requests(rng, vocab1, 1, 1)[0], batcher.buckets)
        counts1 = serve_phase("serve gen 1 (merged)", replica, batcher,
                              make_requests(rng, vocab1, 200, 8), card, dispatches)

        write_random_artifact(
            split, f"vocab_size={vocab2},embedding_dim=8,hidden=128,split_tables=true",
            seed + 1)
        replica.reload(split)
        stats = replica.stats()
        if stats["generation"] != 2 or not replica.generation.served.model.split:
            fail(f"hot swap did not reach the split-table generation 2: {stats}")
        log(f"hot swap: {stats}")
        replica.warmup(make_requests(rng, vocab2, 1, 1)[0], batcher.buckets)
        counts2 = serve_phase("serve gen 2 (split_tables)", replica, batcher,
                              make_requests(rng, vocab2, 200, 8), card, dispatches)
    finally:
        batcher.stop()
    return {"fused_lookup_fm": counts1["fused_lookup_fm"],
            "fused_lookup": counts2["fused_lookup"]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import_port()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    from elasticdl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for path in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    kernels = kernel_phase(card, args.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = serving_phases(card, args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was never launched on the serving path")

    line = []
    for name in ("fused_lookup_fm", "fused_lookup"):
        r = kernels[name]
        line.append({
            "name": name, "ok": True, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "gather_ms": r["gather_ms"],
            "shape": r["shape"], "main_path_shape": r["main_path_shape"],
            "main_path_shape_ms": r["main_path_shape_ms"],
            "main_path_shape_bound_ms": r["main_path_shape_bound_ms"],
            "card": card,
        })
    log(json.dumps({"kernels": line}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
