"""Time variants of the fused_update kernel on the card.

    python3 tools/fused_update_variants.py [--out details.json]

Run from the root of a checkout on a machine with a Hopper card and the
CUDA toolkit.  Builds ``src/repro_torch/kernels/csrc/fused_update.cu``
as committed ("base") and variants of it made by substituting one
constant in its text (the columns a lane owns, the launch bounds, the
threads of a block, streaming cache hints on the global loads), each
with its own nvcc, all started together; then
checks every variant bitwise against the plain version on the ViT's 42
sites and one qwen3-8b layer's 7, and times each one's grouped launch
(CUDA graph replay between CUDA events, inputs cold in L2 by cycled
copies, two rounds in turns) at 2:8 bdwp with bf16 gradients: one
qwen3-8b layer, the ViT, ResNet9 and VGG19 steps, and single sites.
Prints the card and every time beside its byte bound (21.75 B per
element over 3.35 TB/s).  A design tool: no path of the port runs it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

BASE_COLS = "constexpr int kVecCols = M >= 8 ? 2 : 4;"
BOUNDS = "__global__ void __launch_bounds__(kThreads)"
THREADS = "constexpr int kThreads = 256;"
# the global loads of the three input streams, for the variant with
# streaming cache hints (ld.global.cs; the stores share their helpers
# with the shared-memory stage, which takes no such hint)
STREAMING = [
    ("= *reinterpret_cast<const float2*>(p);",
     "= __ldcs(reinterpret_cast<const float2*>(p));"),
    ("= *reinterpret_cast<const float4*>(p);",
     "= __ldcs(reinterpret_cast<const float4*>(p));"),
    ("= *reinterpret_cast<const uint2*>(p);",
     "= __ldcs(reinterpret_cast<const uint2*>(p));"),
]
VARIANTS = {   # name: [(text to replace, its replacement), ...]
    "base": [],
    "cols4": [(BASE_COLS, "constexpr int kVecCols = M == 16 ? 2 : 4;")],
    "cols1": [(BASE_COLS, "constexpr int kVecCols = M >= 8 ? 1 : 4;")],
    "min4blocks": [(BOUNDS, "__global__ void __launch_bounds__(kThreads, 4)")],
    "threads128": [(THREADS, "constexpr int kThreads = 128;")],
    "streaming": STREAMING,
}


def build_variants(out_dir):
    """One nvcc per variant, all started together: {name: library}."""
    from repro_torch.kernels import build

    csrc = build.CSRC
    text = (csrc / "fused_update.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        variant = text
        for old, new in subs:
            if old not in variant:
                raise RuntimeError(f"variant {name}: {old!r} not in the "
                                   "source")
            variant = variant.replace(old, new)
        src = os.path.join(out_dir, f"fu_{name}.cu")
        with open(src, "w") as fh:
            fh.write(variant)
        lib = os.path.join(out_dir, f"libfu_{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", lib,
               src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):   # the 2:8 bdwp bf16 kernel
            if "Compiling entry" in line and "ILi8ELb1E13__nv_bfloat16" in line:
                print(f"  {name}: " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x))
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the times here (JSON)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_update_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as K
    from repro_torch.kernels import ref
    from repro_torch.models import convnets as CN

    libs = build_variants(os.path.join(ROOT, "build", "variants"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    s = CS.UPDATE_SCALARS
    upd = (s["lr"], s["mu"], s["wd"], s["lam"], 2, 8, "bdwp")

    def views(name):
        master = CN.init(PM.image_model(name, CS.PAPER_WIDTH), seed=0,
                         device=dev)
        return [v for _, v in CS._site_views(master, sp)]

    cases = {"qwen3-8b layer (7 sites)": [(k, f) for _, k, f in CS.PROJ],
             "vit step (42 sites)": views("vit"),
             "resnet9 step (7 sites)": views("resnet9"),
             "vgg19 step (15 sites)": views("vgg19"),
             "one (384, 384) site": [(384, 384)],
             "one w_gate site": [(4096, 12288)]}
    data, bound = {}, {}
    for label, vs in cases.items():
        moved = sum(k * f * 10 for k, f in vs)
        copies = max(1, min(8, -(-2 * CS.L2_BYTES // moved)))
        data[label] = [[CS.update_case(gen, k, f, dev) for k, f in vs]
                       for _ in range(copies)]
        bound[label] = sum(CS.update_bound_ms(k, f, 2, 8) for k, f in vs)
    times = {}
    for rnd in range(2):
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            build.load = lambda _name, lib=lib: lib
            K._lib = None
            lib.fused_update_vec_cols.restype = ctypes.c_int
            K.VEC_COLS = {m: lib.fused_update_vec_cols(m)
                          for m in K.GROUP_SIZES}
            if rnd == 0:
                for label in ("vit step (42 sites)",
                              "qwen3-8b layer (7 sites)"):
                    sites = data[label][0]
                    for (w, g, v), got in zip(
                            sites, K.fused_update_sites(sites, *upd)):
                        want = ref.ref_fused_update(w, g, v, n=2, m=8,
                                                    axis=0, bp_mode="bdwp",
                                                    **s)
                        for a, b in zip(got, want):
                            CS.check(CS.bits_equal(a, b),
                                     f"{name} {label}: not bitwise equal")
            for label, sets in data.items():
                times.setdefault(label, {}).setdefault(name, []).append(
                    CS.time_ms(lambda i: K.fused_update_sites(sets[i], *upd),
                               len(sets), iters=max(10, len(sets))))
    card = CS.card_line()
    print(card)
    for label, per in times.items():
        print(f"{label:26s} bound {bound[label]:.4f} ms")
        for name, ts in per.items():
            print(f"    {name:11s} " + " ".join(f"{t:.4f}" for t in ts)
                  + f" ms  bound/kernel {bound[label] / min(ts):.2f}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "bound_ms": bound, "ms": times}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
