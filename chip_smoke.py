#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--out details.json]

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  Phases, each of which fails the run on error:

  1. card       name and power limit from nvidia-smi, device count;
  2. build      every kernel source of the port, one nvcc each, started
                together;
  3. kernels    each kernel against its plain PyTorch version at the
                serving shapes of qwen3-8b (the seven projections, B in
                {4, 32}, u4 and u8 indices) and at ragged shapes, within
                |kernel - plain| <= 1e-5 * (|act| @ |W|): both sum the same
                exact bf16 products in fp32, in other orders; rows must
                also be bitwise independent of the batch and of the run;
  4. timing     device times (CUDA graph replay between CUDA events)
                with the weights cold in L2: kernel,
                its bound (bytes over 3.35 TB/s or operations over 989
                TFLOP/s bf16, whichever is larger), the plain version,
                and torch.matmul on the dense bf16 weight as a yardstick;
  5. small      the port at qwen3-8b SMOKE size on the card against the
                same port on the CPU (the plain path the CPU tests hold
                against the JAX reference): logits within 2e-2;
  6. serve      qwen3-8b FULL (36 layers, d_model 4096, vocab 151936),
                bf16 weights from a seed, drawn and 2:8 u4-packed layer by
                layer, served by ServeEngine(n_slots=4, prompt_bucket=32,
                max_len=96, packed=True) on six requests that join
                mid-flight; every batched stream must equal its solo
                stream and the nm_spmm launch count must be
                7 x 36 x (prefills + decode steps); then five decode
                steps under torch.profiler give the device's busy time
                and idle share per step and the top kernels and host ops.

It prints a JSON line with every kernel's numbers, the card line, and as
its last line {"ok": true, "device": {...}}.  With no card, or outside a
checkout, it exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
TOL = 1e-5                      # kernel vs plain, relative to |act| @ |W|
SMALL_ATOL = 2e-2               # card vs CPU logits at SMOKE size
L2_BYTES = 50 * 2**20
SEED = 0                        # weights, activations and prompts

# qwen3-8b projection shapes (K, F), in the order one layer runs them
PROJ = [("q_proj", 4096, 4096), ("k_proj", 4096, 1024), ("v_proj", 4096, 1024),
        ("o_proj", 4096, 4096), ("w_gate", 4096, 12288),
        ("w_up", 4096, 12288), ("w_down", 12288, 4096)]
# ragged cases: (name, B, K, F, n, m, idx_bits)
RAGGED = [("B=1", 1, 4096, 4096, 2, 8, 4), ("B=3", 3, 4096, 1024, 2, 8, 8),
          ("F=1000", 4, 512, 1000, 2, 8, 4), ("odd Kc u4", 5, 56, 20, 1, 8, 4),
          ("B=37", 37, 1024, 384, 2, 8, 4), ("2:4", 4, 256, 256, 2, 4, 4),
          ("4:16 F=130", 2, 512, 130, 4, 16, 4)]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def packed_case(gen, b, k, f, n, m, idx_bits, dev):
    from repro_torch.core import sparsity as S

    w = torch.randn((k, f), generator=gen, device=dev).to(torch.bfloat16)
    vals, idx = S.nm_pack(w, n, m, axis=0)
    if idx_bits == 4:
        idx = S.pack_idx_u4(idx, axis=0)
    act = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
    return act, vals, idx


def bound_ms(act, vals, idx, f):
    b = act.shape[0]
    moved = (act.numel() * 2 + vals.numel() * 2 + idx.numel() + b * f * 4)
    ops = 2 * b * vals.shape[0] * f
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, copies: int, iters: int = 20) -> float:
    """Device ms of one fn(i), cycling ``copies`` input sets so the
    weights come from device memory, not L2.

    The ``iters`` calls are captured in a CUDA graph and replayed between
    two CUDA events, so the time is the card's, not the host's launch
    overhead (eager launches of small kernels leave the card idle).
    """
    for i in range(copies):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % copies)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def phase_kernels(dev, gen):
    """Kernel vs plain at the serving shapes and the ragged ones."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    cases = [(f"{name} B={b} u{bits}", b, k, f, 2, 8, bits)
             for name, k, f in PROJ for b in (4, 32) for bits in (4, 8)]
    cases += [(f"ragged {name}", *rest) for name, *rest in RAGGED]
    worst = 0.0
    for label, b, k, f, n, m, bits in cases:
        act, vals, idx = packed_case(gen, b, k, f, n, m, bits, dev)
        out = K.nm_spmm(act, vals, idx, n, m, idx_bits=bits)
        again = K.nm_spmm(act, vals, idx, n, m, idx_bits=bits)
        row0 = K.nm_spmm(act[:1].contiguous(), vals, idx, n, m,
                         idx_bits=bits)
        plain = ref.ref_nm_spmm(act, vals, idx, n, m, idx_bits=bits)
        w = ref.decompress_nm(vals, idx, n, m, axis=0, idx_bits=bits)
        scale = act.float().abs() @ w.float().abs()
        torch.cuda.synchronize()
        err = (out - plain).abs()
        excess = float((err - TOL * scale).max())
        abs_err = float(err.max())
        rel_err = float((err / scale.clamp_min(1e-30)).max())
        worst = max(worst, abs_err)
        print(f"  {label:28s} max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel_err:.3e} (tol {TOL:g} x |act|@|W|)")
        check(excess <= 0, f"nm_spmm {label}: error above tolerance")
        check(torch.equal(out, again), f"nm_spmm {label}: not deterministic")
        check(torch.equal(out[:1], row0),
              f"nm_spmm {label}: row 0 depends on the batch")
    return worst


def phase_timing(dev, gen):
    """Per-projection times at B in {4, 32}, u4 (the serving default)."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    rows = []
    for b in (4, 32):
        for name, k, f in PROJ:
            act, vals, idx = packed_case(gen, b, k, f, 2, 8, 4, dev)
            dense_bytes = k * f * 2
            copies = max(2, -(-2 * L2_BYTES // dense_bytes))
            sets = [(vals, idx)] + [
                packed_case(gen, b, k, f, 2, 8, 4, dev)[1:]
                for _ in range(copies - 1)]
            dense = [ref.decompress_nm(v, i, 2, 8, axis=0, idx_bits=4)
                     for v, i in sets]
            t_k = time_ms(lambda i: K.nm_spmm(act, *sets[i], 2, 8, 4),
                          copies)
            t_p = time_ms(lambda i: ref.ref_nm_spmm(act, *sets[i], 2, 8, 4),
                          copies, iters=10)
            t_l = time_ms(lambda i: torch.matmul(act, dense[i]), copies)
            t_b, by = bound_ms(act, vals, idx, f)
            rows.append({"proj": name, "B": b, "K": k, "F": f, "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": t_b, "bound_by": by})
            print(f"  B={b:2d} {name:7s} {k:5d}x{f:<5d} kernel={t_k:.4f} ms "
                  f"bound={t_b:.4f} ms ({by}) plain={t_p:.4f} ms "
                  f"torch.matmul(dense bf16)={t_l:.4f} ms")
            del sets, dense
    return rows


def phase_small(dev, seed):
    """SMOKE-size model on the card vs the same port on the CPU."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.models import transformer_lm as T
    from repro_torch.serve.packed_params import pack_tree_element
    from repro_torch.train import step as ST

    cfg, sp = C.SMOKE, SparsityConfig(n=2, m=8, method="bdwp")
    params = T.init(cfg, seed=seed, device="cpu", dtype=torch.bfloat16)
    on = {d: pack_tree_element(params, sp, device=d)[0] for d in ("cpu", dev)}
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab, (2, 12)))
    last = [4, 8]
    worst = 0.0
    logits, caches = {}, {}
    for d, p in on.items():
        logits[d], caches[d] = ST.lm_prefill_step(
            p, {"tokens": toks.to(d)}, cfg=cfg, sp_cfg=sp, last_index=last)
    pos = torch.tensor([5, 9])
    for step in range(3):
        a, b = logits["cpu"], logits[dev].cpu()
        check(bool(torch.isfinite(b[..., :cfg.vocab]).all()),
              "small: non-finite logits on the card")
        worst = max(worst, float((a - b).abs().max()))
        if step == 2:
            break
        tok = torch.argmax(a[:, -1, :cfg.vocab], -1)[:, None]
        for d, p in on.items():
            logits[d], caches[d] = ST.lm_decode_step(
                p, caches[d], tok.to(d), (pos + step).to(d), cfg=cfg,
                sp_cfg=sp)
    print(f"  SMOKE prefill + 2 decode steps, card vs CPU: "
          f"max |dlogit| = {worst:.3e} (tol {SMALL_ATOL})")
    check(worst <= SMALL_ATOL, "small: card and CPU logits disagree")


def profile_decode(engine, prompts, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` engine decode steps with 4 running
    requests: device-busy ms per step (sum of kernel self times; one
    stream, so kernels do not overlap), host wall ms per step under the
    profiler, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    engine.reset()
    for p in prompts[:4]:
        engine.submit(p, max_new_tokens=steps + 2)
    engine.step()                 # admission: prefills + one decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run()
    kernels, host = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            kernels.append((us / steps / 1e3, e.count // steps, e.key))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total / steps / 1e3,
                         e.count // steps, e.key))
    kernels.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    spmm = sum(k[0] for k in kernels if "nm_spmm" in k[2])
    wall_ms = 1e3 * wall / steps
    print(f"  profiled {steps} decode steps: wall {wall_ms:.2f} ms/step "
          f"(profiler on), device busy {busy:.3f} ms/step, nm_spmm "
          f"{spmm:.3f} ms/step, device idle share "
          f"{(1 - busy / wall_ms) if busy else float('nan'):.3f}")
    for ms, count, key in kernels[:8]:
        print(f"    {ms:8.4f} ms/step  x{count:<5d} {key[:90]}")
    print(f"  host: {sum(h[0] for h in host):.2f} ms/step of self CPU time "
          f"in {sum(h[1] for h in host)} op calls; top:")
    for ms, count, key in host[:8]:
        print(f"    {ms:8.4f} ms/step  x{count:<5d} {key[:90]}")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "nm_spmm_ms_per_step": spmm,
            "top_kernels": [list(k) for k in kernels[:12]],
            "top_host_ops": [list(h) for h in host[:12]]}


def phase_serve(dev, seed):
    """qwen3-8b FULL, packed 2:8 u4, through the engine."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.models import transformer_lm as T
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.packed_params import PackedParamStore
    from repro_torch.train import step as ST

    cfg, sp = C.FULL, SparsityConfig(n=2, m=8, method="bdwp")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = T.generator(seed, dev)
    store = PackedParamStore.pack_layerwise(
        T.init_shell(cfg, gen, device=dev, dtype=torch.bfloat16),
        T.iter_blocks(cfg, gen, device=dev, dtype=torch.bfloat16),
        sp, idx_bits=4, device=dev)
    torch.cuda.synchronize()
    print(f"  init + pack {cfg.n_layers} layers: "
          f"{time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    engine = ServeEngine(store, cfg, sp, ServeConfig(
        n_slots=4, prompt_bucket=32, max_len=96, packed=True), device=dev)
    rng = np.random.default_rng(seed)
    lens, new = (5, 32, 17, 9, 26, 12), (8, 24, 16, 12, 20, 10)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]

    engine.submit(prompts[0][:3], max_new_tokens=2)      # warm-up
    engine.run()
    engine.reset()
    torch.cuda.synchronize()

    K.launches = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=m) for p, m in zip(prompts, new)]
    batched = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches
    st = engine.stats()
    want = 7 * cfg.n_layers * (st["prefill_steps"] + st["decode_steps"])
    print(f"  batched: {len(rids)} requests, {st['decoded_tokens']} tokens, "
          f"{st['prefill_steps']} prefills, {st['decode_steps']} decode "
          f"steps in {wall:.3f} s: {st['decoded_tokens'] / wall:.1f} tok/s, "
          f"{1e3 * wall / st['steps']:.2f} ms/step; nm_spmm launches "
          f"{launches} (want {want})")
    check(launches > 0 and launches == want, "serve: nm_spmm launch count")
    check([len(batched[r]) for r in rids] == list(new), "serve: lengths")

    for r, p, m in zip(rids, prompts, new):
        engine.reset()
        rid = engine.submit(p, max_new_tokens=m)
        check(engine.run()[rid] == batched[r],
              f"serve: request {r} batched stream != solo stream")
    print(f"  all {len(rids)} batched streams equal their solo streams")

    toks = torch.tensor([prompts[1]], device=dev)
    logits, _ = ST.lm_prefill_step(store.params, {"tokens": toks}, cfg=cfg,
                                   sp_cfg=sp, last_index=[len(prompts[1]) - 1])
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab), "serve: shape")
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "serve: non-finite logits")
    check(int(torch.argmax(logits[0, -1, :cfg.vocab])) == batched[rids[1]][0],
          "serve: prefill argmax != first streamed token")
    prof = profile_decode(engine, prompts)
    peak = torch.cuda.max_memory_allocated()
    report = engine.hbm_report()
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB")
    print("  hbm_report " + json.dumps(report))
    return {"launches": launches, "tok_per_s": st["decoded_tokens"] / wall,
            "ms_per_step": 1e3 * wall / st["steps"], "wall_s": wall,
            "stats": st, "max_memory_allocated": peak, "hbm_report": report,
            "profile": prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the measured details here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("[1] card")
    card = card_line()
    print(f"  {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    print("[2] build")
    t0 = time.perf_counter()
    built = build.build_all()
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.1f} s")
        print("    " + info["log"].strip().replace("\n", "\n    "))
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    print("[3] kernels vs plain versions")
    max_err = phase_kernels(dev, gen)
    print("[4] timing (cold L2)")
    rows = phase_timing(dev, gen)
    print("[5] SMOKE size: card vs CPU")
    phase_small(dev, SEED)
    print("[6] serve qwen3-8b FULL, packed 2:8 u4")
    serve = phase_serve(dev, SEED)

    decode = [r for r in rows if r["B"] == 4]
    kernels = [{
        "name": "nm_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nm_spmm.cu",
        "replaces": "src/repro/kernels/nm_spmm.py:71",
        "launches": serve["launches"], "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in decode),
        "plain_ms": sum(r["plain_ms"] for r in decode),
        "bound_ms": sum(r["bound_ms"] for r in decode),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in decode)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in decode),
        "at": "one decode layer: the 7 projections at B=4, 2:8 u4, summed",
    }]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": kernels, "timing": rows,
                       "serve": serve,
                       "seconds": time.perf_counter() - t_start}, fh,
                      indent=1, default=str)
    print(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
