"""Wrapper of the Hopper ``fused_update`` kernel (``csrc/fused_update.cu``).

Counterpart of ``src/repro/kernels/fused_update.py:fused_update_pallas``
and of the jnp lines after it in ``src/repro/optim/sgd.py`` (``pallas_upd``):
one pass over a fp32 master weight updates it and its momentum (SR-STE
decay from the pre-update N:M mask, momentum SGD), emits the SORE pack
of the new weight (bf16 vals, uint8 idx) and, on request, the bf16 BP
operand and the FF mask the next step reads.

What differs: the reference groups along the last axis of the
transposed master; here the master keeps its (K, F) layout, the FF
groups run along K (axis 0), vals/idx come out as (K*n/m, F), the layout
``nm_spmm`` reads, and the BP groups run along F.  ``fused_update_sites``
updates all of a step's sites in one launch: ``plan_sites`` (pure
Python) lays their tiles out in a table that the kernel receives by
value, up to ``PARAM_SITES`` sites, or for a larger launch (whisper's
512 sites a step) copied to device memory first.  The wrappers only launch: they check device, dtype, shape and
contiguity and raise on anything else; ``kernels.ops`` sends CPU
tensors to ``kernels.ref.ref_fused_update`` instead.  ``launches``
counts the launches made here and nowhere else, ``launched_sites`` the
sites they covered.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

launches = 0
launched_sites = 0
GROUP_SIZES = (2, 4, 8, 16)   # the m the kernel is instantiated for
BP_MODES = ("bdwp", "srste", None)
WARP = 32                     # lanes of a tile's columns
VEC_COLS = {2: 4, 4: 4, 8: 2, 16: 2}   # columns a lane owns (vector path)
PARAM_SITES = 256             # sites of a by-value table (kMaxSites)
MAX_SITES = 4096              # sites one launch takes

_lib = None


class _Site(ctypes.Structure):
    """``FuSite`` of ``csrc/fused_update.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("w", "g", "v", "w_out", "v_out", "vals", "idx", "bp",
                 "mask")] + [("first", ctypes.c_longlong),
                             ("K", ctypes.c_int), ("F", ctypes.c_int),
                             ("col_tiles", ctypes.c_int),
                             ("vec", ctypes.c_int)]


class Launch(NamedTuple):
    """One launch of ``plan_sites``: per site (its index in the list,
    its first tile, its tiles across F, the columns a lane owns), and
    the launch's tile count."""
    sites: list
    tiles: int


def _library():
    global _lib
    if _lib is None:
        lib = build.load("fused_update")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_update_sites_launch.argtypes = [
            ctypes.POINTER(_Site), i, ctypes.c_longlong, i, i, i, i, f, f,
            f, f, p]
        lib.fused_update_sites_launch.restype = i
        lib.fused_update_sites_launch_ref.argtypes = [
            p, i, ctypes.c_longlong, i, i, i, i, f, f, f, f, p]
        lib.fused_update_sites_launch_ref.restype = i
        for name in ("fused_update_max_sites", "fused_update_site_bytes"):
            getattr(lib, name).restype = i
        lib.fused_update_vec_cols.argtypes = [i]
        lib.fused_update_vec_cols.restype = i
        if (lib.fused_update_max_sites() != PARAM_SITES
                or lib.fused_update_site_bytes() != ctypes.sizeof(_Site)
                or any(lib.fused_update_vec_cols(m) != c
                       for m, c in VEC_COLS.items())):
            raise RuntimeError("fused_update: the built library's site "
                               "table differs from this wrapper's")
        _lib = lib
    return _lib


def plan_sites(shapes, m: int, vec=None, groups=None,
               max_sites: int | None = None) -> list:
    """The launches that cover the (K, F) views ``shapes``.

    A tile is one FF group (m rows) by WARP * C columns, C = VEC_COLS[m]
    where ``vec[i]`` (default all) and 1 elsewhere; a site's tiles run
    group-major, and the sites' tiles follow each other in list order.
    Sites of another ``groups`` key (the gradient's dtype) go to another
    launch; a launch holds at most ``max_sites`` (default ``MAX_SITES``)
    sites.
    """
    max_sites = max_sites or MAX_SITES
    vec = [True] * len(shapes) if vec is None else list(vec)
    groups = [None] * len(shapes) if groups is None else list(groups)
    plan = []
    for key in dict.fromkeys(groups):
        members = [i for i, gk in enumerate(groups) if gk == key]
        for lo in range(0, len(members), max_sites):
            entries, first = [], 0
            for i in members[lo:lo + max_sites]:
                k, f = shapes[i]
                cols = VEC_COLS[m] if vec[i] else 1
                col_tiles = -(-f // (WARP * cols))
                entries.append((i, first, col_tiles, cols))
                first += k // m * col_tiles
            plan.append(Launch(entries, first))
    return plan


def _vector_ok(tensors, f: int, cols: int) -> bool:
    """Every row of every tensor starts on a C-element boundary."""
    return f % cols == 0 and all(
        t.data_ptr() % (t.element_size() * cols) == 0 for t in tensors)


def _check(w, g, v, m, dev):
    for name, t in (("w", w), ("g", g), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"fused_update: {name} is on {t.device}, not CUDA")
        if t.device != dev:
            raise ValueError(f"fused_update: {name} is on {t.device}, the "
                             f"first site on {dev}")
        want = (torch.bfloat16, torch.float32) if name == "g" \
            else (torch.float32,)
        if t.dtype not in want:
            raise ValueError(f"fused_update: {name} must be "
                             f"{' or '.join(map(str, want))}, got {t.dtype}")
        if t.shape != w.shape or t.ndim != 2:
            raise ValueError(f"fused_update: {name} must be 2-D of w's shape "
                             f"{tuple(w.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_update: {name} must be contiguous")
    k, f = w.shape
    if k % m or k == 0 or f == 0:
        raise ValueError(f"fused_update: K={k} is not a positive multiple "
                         f"of m={m}, or F={f} is empty")


def fused_update_sites(sites, lr: float, mu: float, wd: float, lam: float,
                       n: int, m: int, bp_mode, *, inplace: bool = False):
    """Launch the kernel on every (w, g, v) of ``sites``: (K, F) fp32 w
    and v, g bf16 or fp32, all on one card.  Returns per site (w', v',
    vals (K*n/m, F) bf16, idx uint8), and with ``bp_mode`` "bdwp" or
    "srste" also (bp (K, F) bf16, FF mask (K, F) bool).  ``inplace``
    writes w' over w and v' over v.  One launch covers all sites of one
    gradient dtype, up to ``MAX_SITES``; a table of more than
    ``PARAM_SITES`` is copied to the card before its launch.  The
    scalars go as fp32."""
    global launches, launched_sites
    if m not in GROUP_SIZES or not 0 < n <= m:
        raise ValueError(f"fused_update: unsupported {n}:{m} (m in "
                         f"{GROUP_SIZES})")
    if bp_mode not in BP_MODES:
        raise ValueError(f"fused_update: bp_mode must be one of {BP_MODES}, "
                         f"got {bp_mode!r}")
    if not sites:
        return []
    for w, _, _ in sites:
        if bp_mode == "bdwp" and w.shape[-1] % m:
            raise ValueError(f"fused_update: bdwp selects the BP operand "
                             f"in groups of m={m} along F={w.shape[-1]}")
    dev = sites[0][0].device
    for w, g, v in sites:
        _check(w, g, v, m, dev)
    outs, table, vec = [], [], []
    for w, g, v in sites:
        k, f = w.shape
        kc = k // m * n
        out = [w if inplace else torch.empty_like(w),
               v if inplace else torch.empty_like(v),
               torch.empty((kc, f), dtype=torch.bfloat16, device=dev),
               torch.empty((kc, f), dtype=torch.uint8, device=dev)]
        if bp_mode is not None:
            out += [torch.empty((k, f), dtype=torch.bfloat16, device=dev),
                    torch.empty((k, f), dtype=torch.bool, device=dev)]
        outs.append(tuple(out))
        vec.append(_vector_ok((w, g, v, *out), f, VEC_COLS[m]))
        bp_mask = [t.data_ptr() for t in out[4:]] or [None, None]
        table.append([t.data_ptr() for t in (w, g, v, *out[:4])] + bp_mask
                     + [k, f])
    plan = plan_sites([tuple(w.shape) for w, _, _ in sites], m, vec,
                      [g.dtype for _, g, _ in sites])
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in plan:
        arr = (_Site * len(launch.sites))(*(
            _Site(*table[i][:9], first, *table[i][9:], col_tiles,
                  int(cols > 1))
            for i, first, col_tiles, cols in launch.sites))
        g_bf16 = sites[launch.sites[0][0]][1].dtype == torch.bfloat16
        args = (len(launch.sites), launch.tiles, n, m, int(g_bf16),
                int(bp_mode == "bdwp"), float(lr), float(mu), float(wd),
                float(lam), stream)
        with torch.cuda.device(dev):
            if len(launch.sites) <= PARAM_SITES:
                err = lib.fused_update_sites_launch(arr, *args)
            else:   # the table in device memory, freed after the launch
                # (the stream orders any reuse of it after the kernel)
                table_d = torch.frombuffer(bytearray(arr),
                                           dtype=torch.uint8).to(dev)
                err = lib.fused_update_sites_launch_ref(table_d.data_ptr(),
                                                        *args)
                del table_d
        if err != 0:
            raise RuntimeError(f"fused_update: kernel launch failed, CUDA "
                               f"error {err}")
        launches += 1
        launched_sites += len(launch.sites)
    return outs


def fused_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                 lr: float, mu: float, wd: float, lam: float, n: int,
                 m: int, bp_mode=None):
    """The kernel on one (K, F) site: (w', v', vals (K*n/m, F) bf16, idx
    uint8), with ``bp_mode`` also (bp, FF mask); out of place."""
    return fused_update_sites([(w, g, v)], lr, mu, wd, lam, n, m,
                              bp_mode)[0]
