#!/usr/bin/env python3
"""chip_smoke.py's phases 55 (tensor-parallel serving) and 56 (slot lanes
over the DP axes, build_lm_serve) rehearsed on the CPU.

    PYTHONPATH=src python3 tools/tp_serve_cpu.py [--width small|mid] [--dp]

Runs ``chip_smoke.phase_tp_serve`` with the device "cpu": the one-process
engine, then two gloo processes at the mesh data=1,model=2; with
``--dp`` then ``chip_smoke.phase_dp_serve`` on phase 55's one-process
run: four gloo processes, the engine at (pod, data, model) = (1, 2, 2)
and (2, 2, 1), build_lm_serve(packed=True) at (1, 2, 2) against the
one-process shared serve (its kernel timings skipped); on qwen3-8b's
structure (9 layers, its vocab, head width of 128, GQA ratio of 4, qk
norm and rope) at a cut width: "mid" d_model 512, 8 heads, 2 KV heads,
d_ff 1536; "small" the SMOKE config at 9 layers.  The kernels' counters stay 0 on the CPU
(the plain versions run), so the launch-count checks are reported, not
raised, and the kernel timings are skipped.  It prints each rank's
largest teacher-forced logit gap against the one-process run, whether
its streams equal the one-process streams, and where they part: phase
55's logit tolerance (``chip_smoke.TP_LOGIT_ATOL``) was set from it.
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", choices=("small", "mid"), default="mid")
    ap.add_argument("--dp", action="store_true", help="phase 56 too")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as CS
    from repro_torch.configs import qwen3_8b

    cfg = dataclasses.replace(qwen3_8b.SMOKE, n_layers=CS.SERVE_LAYERS)
    if args.width == "mid":
        cfg = dataclasses.replace(qwen3_8b.FULL, n_layers=CS.SERVE_LAYERS,
                                  d_model=512, n_heads=8, n_kv=2,
                                  d_ff=1536)
    failed = []
    CS.check = lambda cond, msg: cond or failed.append(msg)
    CS.TP_LOGIT_ATOL = float("inf")
    CS.card_line = lambda: "cpu"
    CS.spmm_case_checks = lambda *a, **k: ([], 0.0)
    CS.pack_timing = lambda *a, **k: ([], {})
    CS.dp_shared_kernels = lambda *a, **k: ([], 0.0)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.set_num_threads(2)
    report = CS.phase_tp_serve(torch.device("cpu"), CS.SEED, cfg)
    print("config " + json.dumps(dataclasses.asdict(cfg), default=str))
    for r, row in report["ranks"].items():
        print(f"rank {r}: max teacher-forced logit gap "
              f"{row['max_logit_gap']!r}; streams equal the one-process "
              f"streams: {row['streams_equal_one_process']}; parting "
              f"{row['parting']}")
    if args.dp:
        dp = CS.phase_dp_serve(torch.device("cpu"), CS.SEED, cfg,
                               report.pop("handoff"))
        for mesh, rows in dp["engines"].items():
            for r, row in rows.items():
                print(f"engine {mesh} rank {r}: max teacher-forced logit "
                      f"gap {row['max_logit_gap']!r}; streams equal the "
                      f"one-process streams: "
                      f"{row['streams_equal_one_process']}; parting "
                      f"{row['parting']}")
        for r, row in dp["lm_serve"].items():
            print(f"build_lm_serve rank {r}: max logit gap "
                  f"{row['max_logit_gap']!r}; tokens equal: "
                  f"{row['tokens_equal_one_process']}")
    print("checks not met on the CPU (launch counts stay 0 there):")
    for msg in failed:
        print(f"  {msg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
