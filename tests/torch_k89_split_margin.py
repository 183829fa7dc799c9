"""How close the bf16 K8/K9's rounding design comes to phase 13's f32
gate at phase 13's ring shapes, emulated on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_k89_split_margin.py    # ~10 min on 4 CPU threads

For B=4, H=8, T_local=2048 (the CP LM's slot at D=64, ``RING_BENCH`` at
D=128), a ring of 4 in both layouts, every shard and every live step,
with a random f32 dO: the worst element of dq, dk and dv as a share of
``ATTN_F32_*`` (the limit takes the largest magnitude over the whole
tensor, as ``chip_smoke.ring_close`` does), for an f32 dO split into two
and into three bf16 parts (P and dS in two).  A CPU emulation, not a
card measurement: ``tests/test_torch_flash_mma_rounding.py`` holds the
same rules at reduced shapes in tier 1, and the kernels are held to the
gate on the card by ``chip_smoke.py``.  The work is done one (batch,
head) slice at a time to bound memory.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_flash_mma_rounding as rounding  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from elasticdl_tpu_torch.parallel import ring_attention as ring  # noqa: E402

B, H, T, N = 4, 8, 2048, 4
PARTS = (2, 3)


def worst_shares(d, layout, seed):
    """{dO parts: worst share of the gate} over every shard and live step."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, d), dtype=np.float32)).to(
        torch.bfloat16) for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((B, H, T, d), dtype=np.float32))
    pos = [torch.from_numpy(ring.shard_positions(i, T, N, layout).astype(np.int32))
           for i in range(N)]
    scale = fa.default_scale(d)
    slices = [(slice(b, b + 1), slice(h, h + 1)) for b in range(B) for h in range(H)]
    worst = dict.fromkeys(PARTS, 0.0)
    for my in range(N):
        steps = [pos[(my - s) % N] for s in range(N)]
        lse, delta = torch.empty(B, H, T), torch.empty(B, H, T)
        for sl in slices:
            lse[sl], delta[sl] = rounding._ring_stats(q[sl], k[sl], v[sl], do[sl], pos[my], steps,
                                                      scale, True)
        for k_pos in steps:
            if int(k_pos.min()) > int(pos[my].max()):
                continue  # fully masked: zeros on both sides
            want = [torch.empty(B, H, T, d) for _ in range(3)]
            got = {p: [torch.empty(B, H, T, d) for _ in range(3)] for p in PARTS}
            for sl in slices:
                args = (q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl], pos[my], k_pos)
                for i, x in enumerate(fa.flash_ring_step_bwd_plain(*args, causal=True,
                                                                   scale=scale)):
                    want[i][sl] = x
                for p in PARTS:
                    for i, x in enumerate(rounding.emulate_k8_k9(*args, scale, True, do_parts=p)):
                        got[p][i][sl] = x
            for p in PARTS:
                worst[p] = max([worst[p]] + [rounding._f32_share(g, w)
                                             for g, w in zip(got[p], want)])
    return worst


def main():
    for d in (64, 128):
        for layout in ring.LAYOUTS:
            worst = worst_shares(d, layout, seed=7 * d + len(layout))
            print(f"D={d} {layout}: worst share of the f32 gate, f32 dO in "
                  + ", ".join(f"{p} parts {worst[p]!r}" for p in PARTS), flush=True)


if __name__ == "__main__":
    main()
