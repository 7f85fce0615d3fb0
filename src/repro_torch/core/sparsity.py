"""N:M fine-grained structured sparsity primitives (PyTorch).

Counterpart of ``src/repro/core/sparsity.py``: ``SparsityConfig``,
``DENSE``, ``nm_mask``, ``nm_mask_pair``, ``nm_mask_transposable``,
``nm_mask_shared``, ``sparsify`` (element and shared granularity),
``nm_pack``, ``nm_pack_from_mask``, ``nm_unpack_n``, ``srste_decay`` and
the 4-bit index plane ``pack_idx_u4``/``unpack_idx_u4``.  Masks, indices
and packed values are bitwise equal to the reference's.

What differs:
  * selection is n rounds of masked ``argmax`` instead of
    ``lax.top_k``: ``torch.topk`` documents no tie order, while
    ``torch.argmax`` returns the first maximum, which is the reference's
    earliest-index tie-break;
  * ``nm_mask_transposable`` runs its repair and fallback phases on the
    tiles the greedy phase left short only (the others pass through
    both phases unchanged in the reference too), and stops repairing
    once no tile is short.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Static description of an N:M sparsity scheme (field-for-field the
    reference's ``repro.core.sparsity.SparsityConfig``)."""

    n: int = 2
    m: int = 8
    method: str = "bdwp"
    granularity: str = "element"
    tile: int = 128
    lam: float = 2e-4
    excluded: tuple = ("embed", "router", "norm", "frontend", "bias", "head0")
    transposable: bool = False

    def __post_init__(self):
        if not (0 < self.n <= self.m):
            raise ValueError(f"need 0 < n <= m, got {self.n}:{self.m}")
        if self.method not in ("dense", "srste", "sdgp", "sdwp", "bdwp"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.granularity not in ("element", "shared"):
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.transposable and (self.method != "bdwp"
                                  or self.granularity != "element"):
            raise ValueError(
                "transposable masks need method='bdwp' and element "
                f"granularity, got {self.method!r}/{self.granularity!r}")

    @property
    def is_dense(self) -> bool:
        return self.method == "dense" or self.n == self.m

    def prunes_ff_weights(self) -> bool:
        return self.method in ("srste", "bdwp") and not self.is_dense

    def prunes_bp_weights(self) -> bool:
        return self.method in ("sdwp", "bdwp") and not self.is_dense

    def prunes_bp_grads(self) -> bool:
        return self.method == "sdgp" and not self.is_dense


DENSE = SparsityConfig(method="dense")


def _move_axis_last(x: torch.Tensor, axis: int):
    """(x with ``axis`` moved last, the permutation that moves it back)."""
    axis = axis % x.ndim
    perm = [i for i in range(x.ndim) if i != axis] + [axis]
    inv = [perm.index(i) for i in range(x.ndim)]
    return x.permute(perm), inv


def _groups(x: torch.Tensor, m: int, axis: int):
    """x with ``axis`` moved last and split into (..., K/m, m) groups."""
    xt = torch.movedim(x, axis, -1)
    k = xt.shape[-1]
    if k % m != 0:
        raise ValueError(f"axis length {k} not divisible by {m}")
    return xt.reshape(*xt.shape[:-1], k // m, m)


def _topn_picks(g: torch.Tensor, n: int) -> torch.Tensor:
    """In-group offsets (..., n) of the n largest |g|, in pick order.

    n rounds of masked argmax: each round takes the first maximum, so
    among equal scores the earliest offset wins — the reference's
    ``_topn_group_mask``/``lax.top_k`` rule.  A mask needs no order, so
    only packing sorts (``_topn_offsets``).
    """
    score = g.abs().to(torch.float32)
    picks = []
    for _ in range(n):
        i = torch.argmax(score, dim=-1, keepdim=True)
        picks.append(i)
        score = score.scatter(-1, i, float("-inf"))
    return torch.cat(picks, dim=-1)


def _topn_offsets(g: torch.Tensor, n: int) -> torch.Tensor:
    """``_topn_picks`` in ascending offset order."""
    return torch.sort(_topn_picks(g, n), dim=-1).values


def nm_mask(x: torch.Tensor, n: int, m: int, axis: int = -1) -> torch.Tensor:
    """Boolean mask keeping the N largest-|x| of each consecutive M along
    ``axis``; the earlier index wins a tie."""
    if n == m:
        return torch.ones_like(x, dtype=torch.bool)
    g = _groups(x, m, axis)
    mask = torch.zeros(g.shape, dtype=torch.bool, device=x.device)
    mask.scatter_(-1, _topn_picks(g, n), True)
    return torch.movedim(mask.reshape(*g.shape[:-2], -1), -1, axis)


def nm_mask_pair(x: torch.Tensor, n: int, m: int, ff_axis: int,
                 bp_axis: int):
    """(FF mask, BP mask) of one tensor from a single selection: the
    groups along ``ff_axis`` and along ``bp_axis`` are scored as one
    (G_ff + G_bp, m) batch.  Equal to two ``nm_mask`` calls."""
    if n == m:
        ones = torch.ones_like(x, dtype=torch.bool)
        return ones, ones
    views = []
    for axis in (ff_axis, bp_axis):
        xt, inv = _move_axis_last(x, axis)
        if xt.shape[-1] % m:
            raise ValueError(f"axis length {xt.shape[-1]} not divisible by {m}")
        views.append((xt.shape, inv, xt.reshape(-1, m)))
    groups = torch.cat([v[2] for v in views], dim=0)
    mask = torch.zeros(groups.shape, dtype=torch.bool, device=x.device)
    mask.scatter_(-1, _topn_picks(groups, n), True)
    out, offset = [], 0
    for shape, inv, g in views:
        rows = g.shape[0]
        out.append(mask[offset:offset + rows].reshape(shape).permute(inv))
        offset += rows
    return tuple(out)


def nm_mask_transposable(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """One mask serving W and W^T: N:M along the rows and the columns of
    every m x m tile of the last two axes (arXiv 2102.08124).  Leading
    axes batch through; both trailing lengths must divide by m.

    The reference's three phases, vectorised over all tiles:
      1. greedy: cells largest-|x| first (a stable sort, so ties go to
         the earliest row-major cell), each accepted while its row and
         its column quota are both open;
      2. repair: while a quota is open, the best augmenting swap — add
         (r, c2) and (r', c), drop the selected (r', c2) with the
         largest score gain, for the first short row r and column c;
         at most n*m rounds;
      3. fallback: a tile still short gets the n cyclic diagonals of
         largest summed |x|, transposable by construction.
    """
    if n == m:
        return torch.ones_like(x, dtype=torch.bool)
    *lead, rdim, cdim = x.shape
    if rdim % m or cdim % m:
        raise ValueError(f"dims ({rdim}, {cdim}) not divisible by m={m}")
    rt, ct = rdim // m, cdim // m
    tiles = x.reshape(*lead, rt, m, ct, m).movedim(-3, -2)
    score = tiles.abs().to(torch.float32).reshape(-1, m * m)
    t = score.shape[0]
    # the k-th cells of all tiles, contiguous for each round k
    order = torch.argsort(-score, dim=-1, stable=True).t().contiguous()
    rows_of, cols_of = order // m, order % m
    mask = torch.zeros((t, m * m), dtype=torch.bool, device=x.device)
    rows = torch.zeros((t, m), dtype=torch.int32, device=x.device)
    cols = torch.zeros((t, m), dtype=torch.int32, device=x.device)
    for k in range(m * m):
        r, c = rows_of[k][:, None], cols_of[k][:, None]
        ok = (rows.gather(1, r) < n) & (cols.gather(1, c) < n)
        mask.scatter_(1, order[k][:, None], ok)
        rows.scatter_add_(1, r, ok.to(torch.int32))
        cols.scatter_add_(1, c, ok.to(torch.int32))
    mask = mask.view(t, m, m)
    short = torch.nonzero(((rows < n).any(-1)) | ((cols < n).any(-1)))[:, 0]
    if short.numel():
        sc = score.view(t, m, m).index_select(0, short)
        mask[short] = _transposable_repair(mask.index_select(0, short), sc,
                                           n, m)
    mask = mask.view(*lead, rt, ct, m, m).movedim(-3, -2)
    return mask.reshape(*lead, rdim, cdim)


def _transposable_repair(mask: torch.Tensor, sc: torch.Tensor, n: int,
                         m: int) -> torch.Tensor:
    """Phases 2 and 3 of ``nm_mask_transposable`` on (T, m, m) tiles."""
    t = mask.shape[0]
    slot = torch.arange(m, device=mask.device)
    tile = torch.arange(t, device=mask.device)
    neg_inf = torch.tensor(float("-inf"), device=mask.device)
    for _ in range(n * m):
        rows, cols = mask.sum(-1), mask.sum(-2)
        need = (rows < n).any(-1)
        if not bool(need.any()):
            break
        r = torch.argmax((rows < n).to(torch.uint8), dim=-1)
        c = torch.argmax((cols < n).to(torch.uint8), dim=-1)
        row_r, col_c = mask[tile, r], mask[tile, :, c]
        s_row, s_col = sc[tile, r], sc[tile, :, c]
        # swap candidates (r', c2): drop the selected (r', c2), add
        # (r, c2) and (r', c); c2 == c and r' == r exclude themselves
        valid = (mask & ~row_r[:, None, :] & ~col_c[:, :, None]
                 & need[:, None, None])
        gain = s_row[:, None, :] + s_col[:, :, None] - sc
        best = torch.argmax(torch.where(valid, gain, neg_inf).view(t, m * m),
                            dim=-1)
        rp, c2 = best // m, best % m
        apply = (need & valid.view(t, m * m).any(-1))[:, None, None]

        def hot(i):
            return slot[None, :] == i[:, None]

        add = ((hot(r)[:, :, None] & hot(c2)[:, None, :])
               | (hot(rp)[:, :, None] & hot(c)[:, None, :]))
        rem = hot(rp)[:, :, None] & hot(c2)[:, None, :]
        mask = (mask | (add & apply)) & ~(rem & apply)
    ok = (mask.sum(-1) == n).all(-1) & (mask.sum(-2) == n).all(-1)
    if bool(ok.all()):
        return mask
    # the fallback: diagonal d holds cells (i, (i + d) % m); its score is
    # summed from row 0 down, one term at a time
    diag = (slot[:, None] + slot[None, :]) % m          # (d, i) -> column
    cells = sc[:, slot[None, :].expand(m, m), diag]     # (T, d, i)
    dscore = cells[..., 0]
    for i in range(1, m):
        dscore = dscore + cells[..., i]
    dsel = nm_mask(dscore, n, m, axis=-1)                # (T, d)
    fallback = dsel[:, (slot[None, :] - slot[:, None]) % m]
    return torch.where(ok[:, None, None], mask, fallback)


def nm_mask_shared(x: torch.Tensor, n: int, m: int, axis: int,
                   share_axis: int, tile: int) -> torch.Tensor:
    """Mask with the N:M pattern along ``axis`` shared across tiles of
    ``tile`` entries of ``share_axis``: the group score is the fp32 sum
    of |x| over each tile (a ragged last tile zero-padded), so all
    columns of a tile keep the same K-slots."""
    if n == m:
        return torch.ones_like(x, dtype=torch.bool)
    axis = axis % x.ndim
    share_axis = share_axis % x.ndim
    if share_axis == axis:
        raise ValueError("share_axis must differ from group axis")
    s = x.shape[share_axis]
    absx = x.abs().to(torch.float32)
    pad = (-s) % tile
    if pad:
        shape = list(absx.shape)
        shape[share_axis] = pad
        absx = torch.cat([absx, absx.new_zeros(shape)], dim=share_axis)
    shape = list(absx.shape)
    shape[share_axis:share_axis + 1] = [shape[share_axis] // tile, tile]
    scores = absx.reshape(shape).sum(dim=share_axis + 1)
    mask = nm_mask(scores, n, m, axis=axis)
    return torch.repeat_interleave(mask, tile, dim=share_axis).narrow(
        share_axis, 0, s)


def sparsify(x: torch.Tensor, cfg: SparsityConfig, axis: int = -1,
             share_axis=None) -> torch.Tensor:
    """x * mask with cfg's N:M pattern along ``axis``; with shared
    granularity the pattern is shared across ``cfg.tile`` entries of
    ``share_axis`` (default: the axis before ``axis``, or the last axis
    when ``axis`` is the first)."""
    if cfg.is_dense:
        return x
    if cfg.granularity == "shared":
        if share_axis is None:
            a = axis % x.ndim
            share_axis = a - 1 if a else x.ndim - 1
        mask = nm_mask_shared(x, cfg.n, cfg.m, axis, share_axis, cfg.tile)
    else:
        mask = nm_mask(x, cfg.n, cfg.m, axis)
    return torch.where(mask, x, torch.zeros_like(x))


def nm_pack(x: torch.Tensor, n: int, m: int, axis: int = -1):
    """Pack x into N:M compact (values, uint8 in-group offsets) along
    ``axis``; survivors keep ascending offset order."""
    g = _groups(x, m, axis)
    idx = _topn_offsets(g, n)
    vals = torch.gather(g, -1, idx)
    lead = g.shape[:-2]
    kc = g.shape[-2] * n
    vals = torch.movedim(vals.reshape(*lead, kc), -1, axis)
    idx = torch.movedim(idx.reshape(*lead, kc).to(torch.uint8), -1, axis)
    return vals.contiguous(), idx.contiguous()


def nm_pack_from_mask(x: torch.Tensor, mask: torch.Tensor, n: int, m: int,
                      axis: int = -1):
    """Pack x into N:M compact (values, uint8 offsets) given its survivor
    mask, without a selection: survivors keep ascending offset order.
    Equal to ``nm_pack(x, n, m, axis)`` whenever ``mask == nm_mask(x, n,
    m, axis)``.  A group with fewer than n survivors pads with value 0 at
    offset 0, as the reference's scatter into a zero row does."""
    g = _groups(x, m, axis)
    gm = _groups(mask, m, axis)
    # a survivor's rank in its group, as m running sums: torch.cumsum
    # over a length-m innermost axis is a slow scan on the card (22 ms
    # for a 4096 x 12288 weight)
    run = torch.full(gm.shape[:-1], -1, dtype=torch.int64, device=x.device)
    ranks = []
    for j in range(m):
        run = run + gm[..., j]
        ranks.append(run)
    rank = torch.stack(ranks, dim=-1)
    slot = torch.where(gm, rank, n)     # pruned entries land in slot n
    pos = torch.arange(m, device=x.device).expand(g.shape)
    vals = torch.zeros((*g.shape[:-1], n + 1), dtype=x.dtype, device=x.device)
    idx = torch.zeros((*g.shape[:-1], n + 1), dtype=torch.int64,
                      device=x.device)
    vals.scatter_(-1, slot, g)
    idx.scatter_(-1, slot, pos)
    lead = g.shape[:-2]
    kc = g.shape[-2] * n
    vals = torch.movedim(vals[..., :n].reshape(*lead, kc), -1, axis)
    idx = torch.movedim(idx[..., :n].reshape(*lead, kc).to(torch.uint8), -1,
                        axis)
    return vals.contiguous(), idx.contiguous()


def nm_unpack_n(values: torch.Tensor, indices: torch.Tensor, n: int, m: int,
                axis: int = -1) -> torch.Tensor:
    """Scatter compact (values, indices) back to dense; axis length *m/n."""
    vt = torch.movedim(values, axis, -1)
    it = torch.movedim(indices, axis, -1)
    kn = vt.shape[-1]
    if kn % n != 0:
        raise ValueError(f"packed axis {kn} not divisible by n={n}")
    groups = kn // n
    gv = vt.reshape(*vt.shape[:-1], groups, n)
    gi = it.reshape(*it.shape[:-1], groups, n).to(torch.int64)
    dense = torch.zeros((*vt.shape[:-1], groups, m), dtype=vt.dtype,
                        device=vt.device)
    dense.scatter_(-1, gi, gv)
    return torch.movedim(dense.reshape(*vt.shape[:-1], groups * m), -1, axis)


def srste_decay(w: torch.Tensor, mask: torch.Tensor, lam: float) -> torch.Tensor:
    """SR-STE's sparse-refined term ``lam * (1 - mask) * w``: pruned
    weights decay toward zero (+0 where the mask keeps a weight)."""
    return torch.where(mask, torch.zeros_like(w), w) * lam


# 4-bit index plane: two in-group offsets (< 16) per byte along the
# compact axis, entry 2i in the low nibble and 2i+1 in the high nibble;
# an odd compact length zero-pads the final high nibble.


def pack_idx_u4(idx: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack uint8 in-group offsets (< 16) two-per-byte along ``axis``;
    the packed axis has length ``ceil(len/2)``."""
    it = torch.movedim(idx, axis, -1).to(torch.uint8)
    kc = it.shape[-1]
    if kc % 2:
        it = torch.nn.functional.pad(it, (0, 1))
    pairs = it.reshape(*it.shape[:-1], (kc + 1) // 2, 2)
    packed = pairs[..., 0] | (pairs[..., 1] << 4)
    return torch.movedim(packed, -1, axis).contiguous()


def unpack_idx_u4(packed: torch.Tensor, kc: int, axis: int = -1) -> torch.Tensor:
    """Unpack two-per-byte nibbles back to ``kc`` uint8 offsets along
    ``axis``."""
    pt = torch.movedim(packed, axis, -1)
    if pt.shape[-1] != (kc + 1) // 2:
        raise ValueError(
            f"packed axis {pt.shape[-1]} does not hold kc={kc} nibbles")
    lo = pt & 0x0F
    hi = pt >> 4
    idx = torch.stack([lo, hi], dim=-1).reshape(*pt.shape[:-1], -1)[..., :kc]
    return torch.movedim(idx, -1, axis).contiguous()
