"""qwen3-8b FULL serving of two or more checkouts on one card, for an A/B.

  python3 tools/serve_ab.py ROOT [ROOT ...] [--out FILE]

Each ROOT is the root of a checkout of this repository ("." for this
one); they run in the order given, for example parent, change, change,
parent.  Each runs in a subprocess of its own, which builds that
checkout's kernels from its sources, imports its ``chip_smoke.py`` and
``src/``, and runs its phase 6 (the element 2:8 u4 ServeEngine run) and
phase 17 (shared-pattern 2:8 decode), checks included.  Prints one JSON
line per run with its decode tok/s and ms a step, then the card's name
and power limit.  Exits non-zero when a run fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

RUN = r"""
import json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
import chip_smoke as C
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
dev = torch.device("cuda", 0)
out = {}
for name, fn, ms in (("serve", C.phase_serve, "ms_per_step"),
                     ("shared_serve", C.phase_shared_serve,
                      "decode_ms_per_step")):
    r = fn(dev, C.SEED)
    out[name] = {"tok_per_s": r["tok_per_s"], "ms_per_step": r[ms]}
    torch.cuda.empty_cache()
print("AB " + json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", help="also write the runs here (JSON)")
    args = ap.parse_args(argv)
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, "-c", RUN, root],
                              capture_output=True, text=True, check=False)
        sys.stderr.write(proc.stderr[-2000:])
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:])
            print(f"serve_ab: {root} failed (rc {proc.returncode})")
            return 1
        run = {"root": root, **json.loads(lines[-1][3:])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "runs": runs}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
