"""Serving example on the port: the continuous-batching engine on N:M-packed
weights.

  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu] \
      [--tokens 24] [--slots 2] [--dense]

The port's counterpart of ``examples/serve_decode.py``, a thin client of
``repro_torch.serve.engine.ServeEngine`` on qwen3-8b SMOKE with 2:8
bdwp weights from a seed: three mixed-length requests share a 2-slot
engine, so the third joins mid-flight into the slot the first frees,
and every request's token stream must equal that request decoded alone
(the engine's per-slot positions and masks make the batch invisible to
a request).  By default decode runs from element-packed (vals, idx)
weights through ``kernels/nm_spmm`` (``--dense``: re-masked dense
weights).  Runs on the card unless ``--device`` names another.  Exits 1
when a stream parts from its solo stream.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import qwen3_8b  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig  # noqa: E402
from repro_torch.models import transformer_lm as T  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402

PROMPT_LENS = (5, 11, 14)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tokens", type=int, default=24,
                    help="max new tokens per request")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--dense", action="store_true",
                    help="serve re-masked dense weights instead of packed")
    args = ap.parse_args(argv)

    cfg = qwen3_8b.SMOKE
    sp_cfg = SparsityConfig(n=2, m=8, method="bdwp")
    params = T.init(cfg, seed=0, device=args.device, dtype=torch.bfloat16)
    serve_cfg = ServeConfig(n_slots=args.slots, prompt_bucket=16,
                            max_len=16 + args.tokens,
                            packed=not args.dense)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]

    # solo references: each request decoded alone (one engine, reused
    # sequentially: run() drains between submissions)
    engine = ServeEngine(params, cfg, sp_cfg, serve_cfg, device=args.device)
    solo = []
    for p in prompts:
        rid = engine.submit(p, max_new_tokens=args.tokens)
        solo.append(engine.run()[rid])

    # mixed workload: r2 joins mid-flight when r0's slot frees
    engine.reset()
    if engine.store is not None:
        r = engine.hbm_report()
        print(f"packed weights: {r['packed_weight_bytes'] / 1e6:.2f} MB vs "
              f"dense {r['dense_weight_bytes'] / 1e6:.2f} MB "
              f"({r['hbm_saving']:.2f}x smaller, {r['n_packed']} tensors "
              "packed)")
    r0 = engine.submit(prompts[0], max_new_tokens=args.tokens // 2)
    r1 = engine.submit(prompts[1], max_new_tokens=args.tokens)
    r2 = None
    t0 = time.perf_counter()
    while engine.n_running or engine.n_queued or r2 is None:
        events = engine.step()
        if r2 is None and r0 in events["finished"]:
            # the slot freed this step: the next step admits r2
            r2 = engine.submit(prompts[2], max_new_tokens=args.tokens)
    dt = time.perf_counter() - t0
    out = engine.harvest()

    ok = (out[r0] == solo[0][:len(out[r0])]
          and out[r1] == solo[1] and out[r2] == solo[2])
    for rid in (r0, r1, r2):
        print(f"req {rid}: {len(out[rid])} tokens, first 8 = "
              f"{out[rid][:8]}")
    st = engine.stats()
    print(f"decoded {st['decoded_tokens']} tokens in {dt:.2f} s on "
          f"{engine.device} ({st['decode_steps']} decode steps, "
          f"{args.slots} slots)")
    print("continuous-batching streams identical to solo decode:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
