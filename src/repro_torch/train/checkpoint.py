"""Checkpoints of the port's train state: async, atomic, kept N deep.

Counterpart of ``src/repro/train/checkpoint.py`` (``CheckpointManager``)
with the same directory layout: ``step_XXXXXXXX/`` holds one file per
leaf and ``manifest.json`` (step, shapes, dtypes); a save writes
``step_XXXXXXXX.tmp`` and ``os.replace``s it into place, so a torn
write is never mistaken for a checkpoint; saves run on a background
thread (one in flight at a time, ``wait()`` joins it); only the newest
``keep`` checkpoints stay.

What differs: the files are the port's own (``torch.save`` of each
tensor leaf, dtype kept, bfloat16 included), not ``.npy``; the state is
the port's tree of dicts (biases and a tied table among them: plain
tensor leaves), per-layer lists, ``PregenOp`` leaves (their
``bp``, ``ff``, ``vals``, ``idx`` and ``mask`` tensors, absent ones as
None, so a transposable bp-only operand too) and Python ints (``step``),
with or without a compute tree (the legacy dataflow keeps none); the
snapshot is a copy on the host, because the port's update changes
master, momentum and the EF residual in place; ``restore`` loads onto
a device, the card unless the caller names another.

On a mesh (``shardings=``, a ``sharding.fsdp.StateSharding`` of more
than one rank, each holding its blocks of the state), a save streams:
leaf by leaf, the blocks are gathered to rank 0 alone
(``StateSharding.lazy``), which writes the leaf at once; the residual
goes into the one-process (P, width) layout.  A restore maps each file
into memory (``torch.load(mmap=True)``) and copies only the rank's
block of it to the device, so no rank ever holds the whole state.  The
files are those of a one-process run, so a checkpoint restores onto any
mesh the specs allow: saved at data=2 it restores at data=1 and the
reverse, bitwise, the residual's columns moved too (the reference's
elastic restore, ``restore(..., shardings=)``); a mesh of pods, one
process each, is the process form of the compressed sync.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Optional

import torch

from repro_torch.core.operand import PregenOp
from repro_torch.device import resolve_device

_PREGEN_FIELDS = ("bp", "ff", "vals", "idx", "mask")


def _flatten(node, out: list):
    """Leaves of a state tree, dict keys sorted: tensors, None, ints."""
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], out)
    elif isinstance(node, list):
        for v in node:
            _flatten(v, out)
    elif isinstance(node, PregenOp):
        out.extend(getattr(node, f) for f in _PREGEN_FIELDS)
    else:
        out.append(node)
    return out


def _unflatten(like, it):
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, list):
        return [_unflatten(v, it) for v in like]
    if isinstance(like, PregenOp):
        fields = {f: next(it) for f in _PREGEN_FIELDS}
        return PregenOp(**fields, cfg=like.cfg, idx_bits=like.idx_bits)
    return next(it)


def _describe(leaf) -> dict:
    if leaf is None:
        return {"kind": "none"}
    if isinstance(leaf, torch.Tensor):
        return {"kind": "tensor", "shape": list(leaf.shape),
                "dtype": str(leaf.dtype)}
    if isinstance(leaf, int):
        return {"kind": "int", "value": leaf}
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def state_fingerprint(tree) -> str:
    """A 128-bit fingerprint of every bit of ``tree`` (its leaves in
    checkpoint order, with their shapes and dtypes), computed where the
    tensors are: two position-weighted sums, mod 2^64, of each element's
    bit pattern.  Equal bits give equal fingerprints; a difference goes
    unseen only where it cancels in both sums.  On the card it reads a
    state of many GB in well under a second."""
    acc = [0, 0]
    for k, leaf in enumerate(_flatten(tree, [])):
        salt = zlib.crc32(repr(_describe(leaf)).encode())
        acc = [(a * 1000003 + salt + k) % 2 ** 64 for a in acc]
        if not isinstance(leaf, torch.Tensor) or leaf.numel() == 0:
            continue
        flat = leaf.detach().contiguous().view(-1)
        bits = flat.view(_INT_VIEW[flat.element_size()])
        for s in range(0, bits.numel(), 1 << 26):
            v = bits[s:s + (1 << 26)].to(torch.int64)
            i = torch.arange(s, s + v.numel(), dtype=torch.int64,
                             device=v.device)
            for j, (mul, add) in enumerate(((2654435761, 1),
                                            (40503, 0x5BD1E995))):
                part = int((v * (i * mul + add)).sum()) % 2 ** 64
                acc[j] = (acc[j] + part) % 2 ** 64
    return f"{acc[0]:016x}{acc[1]:016x}"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, shardings=None):
        self.dir = directory
        self.keep = keep
        self.shardings = shardings
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _sharded(self, shardings=None) -> bool:
        sh = shardings if shardings is not None else self.shardings
        return sh is not None and sh.sharded

    def _barrier(self):
        if self._sharded():
            import torch.distributed as dist

            dist.barrier()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state, blocking: bool = False):
        """Copy the state to host memory now and write it on a thread; on
        a mesh, gather and write it leaf by leaf on rank 0 before
        returning (every rank takes part)."""
        if self._thread is not None:
            self._thread.join()   # one in-flight save at a time
        if self._sharded():
            self._save_streamed(step, state)
            return
        host = [x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else x
                for x in _flatten(state, [])]
        self._thread = threading.Thread(
            target=self._write, args=(step, iter(host)), daemon=True)
        self._thread.start()
        if blocking:
            self._thread.join()

    def _save_streamed(self, step: int, state):
        leaves = (x() if callable(x) else x for x in _flatten(
            self.shardings.lazy(state), []))
        if self.shardings.mesh.rank == 0:
            self._write(step, leaves)
        else:
            for _ in leaves:   # this rank's part of each gather
                pass
        self._barrier()

    def _write(self, step: int, leaves):
        """Write ``leaves`` (checkpoint order) as ``step``, each as soon
        as it comes, then commit the directory atomically."""
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        described = []
        for i, a in enumerate(leaves):
            described.append(_describe(a))
            if isinstance(a, torch.Tensor):
                torch.save(a, os.path.join(tmp, f"leaf_{i:05d}.pt"))
        manifest = {"step": step, "n_leaves": len(described),
                    "leaves": described, "time": time.time()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)   # atomic commit
        self._gc()

    def wait(self):
        """Join the save in flight (on a mesh, on every rank)."""
        if self._thread is not None:
            self._thread.join()
        self._barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_state, step: Optional[int] = None, device=None,
                shardings=None, mmap: bool = False):
        """Restore into the structure of ``like_state``, every tensor on
        ``device`` (the card unless another is named), with the dtype it
        was saved with (on a mesh, ``shardings`` or the manager's, this
        rank's blocks of every leaf, ``like_state`` being blocks too).
        ``mmap`` (host tensors only): map the files rather than read them,
        so a leaf is read when it is used.  Raises on a structure, shape
        or dtype mismatch."""
        device = resolve_device(device)
        sh = shardings if shardings is not None else self.shardings
        if self._sharded(sh):
            full = self._restore(sh.full_like(like_state), step, "cpu",
                                 mmap=True)
            return sh.shard(full, to=device)
        if mmap and device.type != "cpu":
            raise ValueError("mmap maps the files into host memory: "
                             "restore onto the CPU")
        return self._restore(like_state, step, device, mmap=mmap)

    def _restore(self, like_state, step, device, mmap: bool = False):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like = _flatten(like_state, [])
        if manifest["n_leaves"] != len(like):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, state has "
                f"{len(like)}: structure mismatch")
        loaded = []
        for i, (desc, ref) in enumerate(zip(manifest["leaves"], like)):
            want = _describe(ref)
            if desc["kind"] != want["kind"] or (desc["kind"] == "tensor"
                                                and desc != want):
                raise ValueError(f"leaf {i}: checkpoint {desc} != state "
                                 f"{want}")
            if desc["kind"] == "tensor":
                loaded.append(torch.load(
                    os.path.join(path, f"leaf_{i:05d}.pt"),
                    map_location=device, weights_only=True, mmap=mmap))
            elif desc["kind"] == "int":
                loaded.append(desc["value"])
            else:
                loaded.append(None)
        return _unflatten(like_state, iter(loaded))
