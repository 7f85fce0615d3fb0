"""The port's training launcher, ``python -m repro_torch.launch.train``,
on the CPU (``--device cpu``), qwen3-8b SMOKE, compressed sync, 4 steps:

* ``--pods 2`` in one process and ``torchrun --nproc-per-node 2`` (one
  gloo process a pod) print the same losses and write bitwise the same
  final checkpoint (the residual rows gathered into its (2, width)
  ``err``);
* ``--watchdog`` supervises a run to its end and resumes it from the
  checkpoint (a second run of the same command takes no step);
* without ``--device`` on a machine with no card it refuses to start
  instead of running on the CPU.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as LT

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-8b", "--steps", "4", "--batch", "4", "--seq", "16",
        "--compress", "--device", "cpu", "--log-every", "1",
        "--ckpt-every", "2"]


def _run(argv, cwd, torchrun=False):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    head = ([sys.executable, "-m", "torch.distributed.run",
             "--standalone", "--nproc-per-node", "2"]
            if torchrun else [sys.executable])
    return subprocess.Popen([*head, "-m", "repro_torch.launch.train", *argv],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _done(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return out


def _losses(out):
    return [float(x) for x in re.findall(r"loss (\d+\.\d+) ", out)]


def _leaves(d):
    man = json.load(open(d / "manifest.json"))
    out = []
    for i, desc in enumerate(man["leaves"]):
        if desc["kind"] == "tensor":
            t = torch.load(d / f"leaf_{i:05d}.pt")
            out.append(t.view(torch.int16) if t.dtype == torch.bfloat16
                       else t)
        else:
            out.append(desc)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    procs = {"one": _run([*ARGS, "--pods", "2", "--ckpt-dir", "one"], d),
             "two": _run([*ARGS, "--ckpt-dir", "two"], d, torchrun=True),
             "dog": _run([*ARGS, "--pods", "2", "--ckpt-dir", "dog",
                          "--watchdog", "--heartbeat-timeout", "120"], d)}
    outs = {k: _done(p) for k, p in procs.items()}
    outs["dog_again"] = _done(_run([*ARGS, "--pods", "2", "--ckpt-dir",
                                    "dog", "--watchdog"], d))
    return d, outs


def test_two_processes_equal_two_pods_in_one(runs):
    d, outs = runs
    assert "2 processes, backend gloo" in outs["two"]
    one, two = _losses(outs["one"]), _losses(outs["two"])
    assert len(one) == 4 and one == two
    assert "done: 4 steps" in outs["two"]
    a, b = _leaves(d / "one" / "step_00000004"), \
        _leaves(d / "two" / "step_00000004")
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)
    err = [x for x in a if isinstance(x, torch.Tensor) and x.ndim == 2
           and x.shape[0] == 2 and x.dtype == torch.float32]
    assert err and float(err[-1].abs().sum()) > 0


def test_watchdog_runs_to_the_end_and_resumes(runs):
    d, outs = runs
    assert _losses(outs["dog"]) == _losses(outs["one"])
    assert "done: 4 steps" in outs["dog"]
    assert "done: 0 steps" in outs["dog_again"]
    assert (d / "dog" / "heartbeat.json").exists()


def test_refuses_to_run_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = LT.build_parser().parse_args(["--arch", "qwen3-8b", "--steps",
                                         "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.run_training(args)
