"""Port parity: the fused WUVE + SORE update (``fused_update``).

The port's plain version ``kernels.ref.ref_fused_update`` is held
BITWISE to the reference's oracle ``repro.kernels.ref.ref_fused_update``
(run eagerly, one rounding per op as its source reads) on 2:8, 2:4 and
1:8, with random and heavy-tie inputs: w', v', vals and idx.

The reference's interpret-mode Pallas kernel (``ops.fused_update(...,
use_pallas=True)``) is compiled by XLA, which on the CPU contracts
``mu*v + g_eff`` and ``w - lr*v'`` into fused multiply-adds.  On
heavy-tie inputs built from small dyadic numbers every product and sum
is exact, so contraction changes nothing and all four outputs are
bitwise equal to the port's.  On random inputs the survivor offsets
are equal; v' and w' differ by at most 2^-22 of the magnitude of their
operands (``mu*|v| + |g_eff|`` and ``|w| + lr*|v'|``: a contracted
product skips one rounding, which moves the result by at most one ulp of
that product, more ulps of a result that cancels toward 0), and vals
(bf16 of w') by at most one bf16 ulp.  The port rounds every op, as the reference's source and the
port's CUDA kernel do (the kernel uses non-contracting ``_rn``
intrinsics).

The heavy-tie inputs hold no negative zeros: the reference kernel sums
a survivor into place and turns a -0 survivor into +0, its oracle keeps
-0, so no port can match both there.  The port keeps -0, on the card
and on the CPU.

The plain version's BP operand and FF mask (``bp_mode``) are held
bitwise to the reference's ``sgd.update(pregen=True, pack=True)`` run
eagerly (its jnp path derives them from one selection on the new fp32
master), for bdwp and srste, 2:8 and 1:4, normal and heavy-tie inputs:
the port's whole update of a one-site tree is compared, and the plain
call alone.  The tile planner of the grouped launch
(``kernels.fused_update.plan_sites``) must cover every element of every
site exactly once, and a bf16 gradient must give the bits of its fp32
cast.

The CUDA kernel against the plain version on the card (bitwise, single
site and grouped over the site lists of qwen3-8b at SMOKE width, ResNet9,
VGG19 and the ViT, in place and out of place) is marked ``gpu`` and
skips where there is no card:
``python -m pytest -m gpu tests/test_torch_fused_update.py``.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core.sparsity import SparsityConfig as JSparsity
    from repro.kernels import ops as JO
    from repro.kernels import ref as JR
    from repro.optim import sgd as JSGD
except ImportError:      # the card's machine: only the gpu test runs
    jax = jnp = JO = JR = JSGD = JSparsity = None

from repro_torch.core import bdwp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import fused_update as K
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.optim import sgd as TSGD

NM = [(2, 8), (2, 4), (1, 8)]
RANDOM = dict(lr=0.0123, mu=0.9, wd=5e-4, lam=2e-4)
DYADIC = dict(lr=0.25, mu=0.5, wd=0.25, lam=0.5)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _inputs(shape, kind, seed=0):
    """(w, g, v, scalars): normal draws, or small integers with random
    signs (many equal |w| and |w'|, no negative zeros)."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        w, g, v = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
        return w, g, v, RANDOM
    w, g, v = (rng.integers(0, 3, shape) * rng.choice([-1, 1], shape)
               for _ in range(3))
    return (w.astype(np.float32), g.astype(np.float32), v.astype(np.float32),
            DYADIC)


def _port(w, g, v, s, n, m, axis=-1):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (w, g, v)]
    return TR.ref_fused_update(*t, n=n, m=m, axis=axis, **s)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("n,m", NM)
def test_plain_matches_reference_oracle(n, m, kind):
    w, g, v, s = _inputs((64, 256), kind)
    ref = JR.ref_fused_update(jnp.asarray(w), jnp.asarray(g), jnp.asarray(v),
                              n=n, m=m, **s)
    port = _port(w, g, v, s, n, m)
    assert port[2].dtype == torch.bfloat16 and port[3].dtype == torch.uint8
    for name, r, p in zip(("w'", "v'", "vals", "idx"), ref, port):
        assert np.array_equal(_bits(r), _bits(p)), name


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("n,m", NM)
def test_plain_matches_interpret_kernel(n, m, kind):
    w, g, v, s = _inputs((64, 256), kind, seed=1)
    ref = jax.jit(lambda a, b, c, lr: JO.fused_update(
        a, b, c, lr, s["mu"], s["wd"], s["lam"], n, m, use_pallas=True))(
            w, g, v, jnp.float32(s["lr"]))
    port = _port(w, g, v, s, n, m)
    assert np.array_equal(_bits(ref[3]), _bits(port[3])), "idx"
    if kind == "ties":
        for name, r, p in zip(("w'", "v'", "vals"), ref, port):
            assert np.array_equal(_bits(r), _bits(p)), name
        return
    nv = port[1].numpy()
    scale_v = s["mu"] * np.abs(v) + np.abs(g) + (s["wd"] + s["lam"]) * np.abs(w)
    scale_w = np.abs(w) + s["lr"] * np.abs(nv)
    for r, p, scale in zip(ref[:2], port[:2], (scale_w, scale_v)):
        assert np.all(np.abs(np.asarray(r) - p.numpy()) <= 2.0 ** -22 * scale)
    vr, vp = (np.asarray(a, np.float32) for a in (ref[2], port[2].float()))
    assert np.all(np.abs(vr - vp) <= 2.0 ** -8 * np.abs(vr))


def test_ops_groups_along_k():
    """ops.fused_update on the CPU is the reference's function of w.T:
    groups along K, vals/idx in the (K*n/m, F) layout."""
    w, g, v, s = _inputs((32, 24), "normal", seed=2)
    got = TO.fused_update(*(torch.from_numpy(a) for a in (w, g, v)),
                          s["lr"], s["mu"], s["wd"], s["lam"], 2, 8)
    want = _port(w.T, g.T, v.T, s, 2, 8)
    assert got[2].shape == (8, 24)
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b).T)


def test_kernel_wrapper_refuses_what_it_cannot_run():
    w = torch.zeros((16, 8))
    with pytest.raises(ValueError, match="not CUDA"):
        K.fused_update(w, w, w, 0.1, 0.9, 0.0, 0.0, 2, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("n,m", NM + [(4, 16)])
def test_cuda_kernel_matches_plain(n, m, kind):
    """The kernel against the plain version on the card, bitwise, on
    even and ragged shapes, with negative zeros in the tie case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for k, f in [(64, 256), (48, 1000), (m, 1), (4096, 1024)]:
        w, g, v, s = _inputs((k, f), kind)
        if kind == "ties":
            odd = (np.arange(w.size).reshape(w.shape) % 2).astype(np.float32)
            w = -np.abs(w) * odd
        t = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for a in (w, g, v)]
        got = K.fused_update(*t, s["lr"], s["mu"], s["wd"], s["lam"], n, m)
        want = TR.ref_fused_update(*t, n=n, m=m, axis=0, **s)
        torch.cuda.synchronize()
        for name, a, b in zip(("w'", "v'", "vals", "idx"), got, want):
            assert np.array_equal(_bits(a), _bits(b)), (k, f, name)


# ---------------------------------------------------------------------------
# the BP operand and the FF mask (bp_mode), and the grouped launch
# ---------------------------------------------------------------------------

UPD_OPT = dict(lr=0.1, momentum=0.9, weight_decay=5e-4, warmup_steps=100)
UPD_STEP = 5


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 values rounded to bf16 and widened back (a WU gradient)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("n,m", [(2, 8), (1, 4)])
@pytest.mark.parametrize("method", ["bdwp", "srste"])
def test_bp_and_mask_match_reference_update(method, n, m, kind):
    """The reference's eager ``sgd.update(pregen=True, pack=True)`` on a
    one-site tree against the port's update (CPU: the plain version) and
    against ``ref_fused_update(bp_mode=...)`` alone: new master and
    momentum, vals, idx, the bf16 BP operand and the FF mask."""
    w, g, v, _ = _inputs((64, 256), kind, seed=3)
    g = _bf16(g)
    jsp = JSparsity(n=n, m=m, method=method, lam=2e-4)
    state = {"master": {"lin": {"w": jnp.asarray(w)}},
             "momentum": {"lin": {"w": jnp.asarray(v)}},
             "step": jnp.int32(UPD_STEP)}
    jnew, jcomp = JSGD.update(state, {"lin": {"w": jnp.asarray(
        g, jnp.bfloat16)}}, JSGD.SGDConfig(**UPD_OPT), jsp, pregen=True,
        pack=True, use_pallas=False)
    jop = jcomp["lin"]["w"]

    opt = TSGD.SGDConfig(**UPD_OPT)
    sp = SparsityConfig(n=n, m=m, method=method, lam=2e-4)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    tstate = {"master": {"lin": {"w": torch.from_numpy(w.copy())}},
              "momentum": {"lin": {"w": torch.from_numpy(v.copy())}},
              "step": UPD_STEP}
    tnew, tcomp = TSGD.update(tstate, {"lin": {"w": tg}}, opt, sp,
                              pack=True)
    top = tcomp["lin"]["w"]
    assert np.array_equal(_bits(jnew["master"]["lin"]["w"]),
                          _bits(tnew["master"]["lin"]["w"]))
    assert np.array_equal(_bits(jnew["momentum"]["lin"]["w"]),
                          _bits(tnew["momentum"]["lin"]["w"]))
    for fld in ("bp", "vals", "idx", "mask"):
        assert np.array_equal(_bits(getattr(jop, fld)),
                              _bits(getattr(top, fld))), fld

    lr = float(TSGD.lr_schedule(opt, UPD_STEP))
    plain = TR.ref_fused_update(
        torch.from_numpy(w), tg, torch.from_numpy(v), lr=lr,
        mu=opt.momentum, wd=opt.weight_decay, lam=sp.lam, n=n, m=m, axis=0,
        bp_mode=method)
    for name, fld, p in zip(("w'", "v'", "vals", "idx", "bp", "mask"),
                            ("w", "w", "vals", "idx", "bp", "mask"), plain):
        if name == "w'":
            r = jnew["master"]["lin"]["w"]
        elif name == "v'":
            r = jnew["momentum"]["lin"]["w"]
        else:
            r = getattr(jop, fld)
        assert np.array_equal(_bits(r), _bits(p)), name


def test_plain_bp_modes_keep_the_four_outputs():
    """``bp_mode`` adds two outputs and changes none of the four."""
    w, g, v, s = _inputs((32, 64), "normal", seed=4)
    t = [torch.from_numpy(a) for a in (w, g, v)]
    four = TR.ref_fused_update(*t, n=2, m=8, axis=0, **s)
    for mode in ("bdwp", "srste"):
        six = TR.ref_fused_update(*t, n=2, m=8, axis=0, bp_mode=mode, **s)
        assert len(six) == 6 and six[4].dtype == torch.bfloat16
        assert six[5].dtype == torch.bool and six[5].shape == (32, 64)
        for a, b in zip(four, six):
            assert np.array_equal(_bits(a), _bits(b))
    assert torch.equal(six[4], six[0].to(torch.bfloat16))   # srste: a cast


@pytest.mark.parametrize("mode", ["bdwp", "srste", None])
def test_bf16_gradient_gives_the_fp32_cast_bits(mode):
    w, g, v, s = _inputs((64, 128), "normal", seed=5)
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    sites = [(torch.from_numpy(w), g16, torch.from_numpy(v))]
    a = TO.fused_update_sites(sites, s["lr"], s["mu"], s["wd"], s["lam"], 2,
                              8, mode)[0]
    b = TO.fused_update_sites([(sites[0][0], g16.float(), sites[0][2])],
                              s["lr"], s["mu"], s["wd"], s["lam"], 2, 8,
                              mode)[0]
    assert len(a) == (4 if mode is None else 6)
    for x, y in zip(a, b):
        assert np.array_equal(_bits(x), _bits(y))


def test_bdwp_refuses_ragged_f():
    """BP groups are m columns of a row: bdwp with F % m != 0 raises, as
    plain ``nm_mask`` does; the FF-only and cast modes still run."""
    w, g, v, s = _inputs((16, 33), "normal", seed=6)
    sites = [tuple(torch.from_numpy(a) for a in (w, g, v))]
    args = (s["lr"], s["mu"], s["wd"], s["lam"], 2, 8)
    with pytest.raises(ValueError):
        TO.fused_update_sites(sites, *args, "bdwp")
    with pytest.raises(ValueError, match="bdwp"):
        K.fused_update_sites(sites, *args, "bdwp")
    for mode in ("srste", None):
        out = TO.fused_update_sites(sites, *args, mode)[0]
        assert out[2].shape == (4, 33)


def test_inplace_plain_writes_master_and_momentum():
    w, g, v, s = _inputs((16, 64), "normal", seed=7)
    tw, tv = torch.from_numpy(w.copy()), torch.from_numpy(v.copy())
    want = TR.ref_fused_update(tw.clone(), torch.from_numpy(g), tv.clone(),
                               n=2, m=8, axis=0, bp_mode="bdwp", **s)
    got = TO.fused_update_sites([(tw, torch.from_numpy(g), tv)], s["lr"],
                                s["mu"], s["wd"], s["lam"], 2, 8, "bdwp",
                                inplace=True)[0]
    assert got[0] is tw and got[1] is tv
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b))


PLAN_CASES = [
    ("ragged F", 8, [(8, 1), (16, 33), (8, 77), (64, 130), (48, 1000)]),
    ("single tiles", 8, [(8, 128), (8, 4), (8, 1)]),
    ("m=16 scalar and vector", 16, [(32, 64), (16, 33), (48, 200)]),
    ("m=2", 2, [(2, 2), (6, 130), (4, 258)]),
    ("m=4 mixed", 4, [(4, 512), (12, 5), (400, 96)]),
]


def _tile_span(entry, tile, m, f):
    """Rows [r0, r0 + m) and columns [c0, c1) of local ``tile`` of a plan
    entry (index, first, col_tiles, cols) in an F-wide site, as the
    kernel's warp walks them: FF group major, then 32 * cols columns."""
    _, _, col_tiles, cols = entry
    grp, ct = divmod(tile, col_tiles)
    c0 = ct * K.WARP * cols
    return grp * m, c0, min(c0 + K.WARP * cols, f)


@pytest.mark.parametrize("max_sites", [256, 2])
@pytest.mark.parametrize("label,m,shapes", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_covers_every_element_once(label, m, shapes, max_sites):
    """Walk every tile of every launch as the kernel's warps do (the site
    is the last whose first tile is <= the tile) and count the elements
    each covers: every element of every site exactly once."""
    vec = [f % K.VEC_COLS[m] == 0 and i % 2 == 0
           for i, (_, f) in enumerate(shapes)]
    groups = ["bf16" if i % 3 == 1 else "fp32" for i in range(len(shapes))]
    plan = K.plan_sites(shapes, m, vec, groups, max_sites=max_sites)
    seen = [np.zeros(s, np.int32) for s in shapes]
    placed = []
    for launch in plan:
        assert 0 < len(launch.sites) <= max_sites
        assert len({groups[e[0]] for e in launch.sites}) == 1
        firsts = [e[1] for e in launch.sites]
        assert firsts[0] == 0 and firsts == sorted(firsts)
        for tile in range(launch.tiles):
            s = max(j for j, fst in enumerate(firsts) if fst <= tile)
            entry = launch.sites[s]
            i = entry[0]
            r0, c0, c1 = _tile_span(entry, tile - entry[1], m, shapes[i][1])
            assert c0 < c1
            seen[i][r0:r0 + m, c0:c1] += 1
        placed += [e[0] for e in launch.sites]
    assert sorted(placed) == list(range(len(shapes)))
    for i, cover in enumerate(seen):
        assert (cover == 1).all(), (label, shapes[i])


def test_a_whisper_step_is_one_launch_past_the_by_value_table():
    """whisper's 32 SMOKE sites, and 600 small ones, each in one launch;
    600 is more than the kernel's by-value table holds, so that launch
    takes the table from device memory."""
    assert len(K.plan_sites(_model_sites("whisper SMOKE"), 8)) == 1
    plan = K.plan_sites(_model_sites("600 small sites"), 8)
    assert len(plan) == 1 and len(plan[0].sites) == 600 > K.PARAM_SITES


def test_plan_splits_by_capacity_and_dtype():
    plan = K.plan_sites([(8, 64)] * 5, 8, groups=["a", "a", "b", "a", "a"],
                        max_sites=3)
    assert [[e[0] for e in p.sites] for p in plan] == [[0, 1, 3], [4], [2]]
    one = K.plan_sites([(8, 64)] * 56, 8)
    assert len(one) == 1 and one[0].tiles == 56


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _site_views(master, sp):
    """(K, F) views of the pre-generated sites of a master tree."""
    out = []
    TSGD.tree_map(lambda name, w: out.append(w.shape) if bdwp.pregen_site(
        name, tuple(w.shape), sp) else None, master)
    return [(int(np.prod(s[:-1])), s[-1]) for s in out]


def _model_sites(name):
    from repro_torch.configs import paper_models as PM
    from repro_torch.configs import qwen3_8b as QC
    from repro_torch.models import convnets as CN
    from repro_torch.models import transformer_lm as TT

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    if name == "600 small sites":   # past the by-value table's 256
        return [(64, 128 + 64 * (i % 3)) for i in range(600)]
    if name == "qwen3-8b SMOKE":
        master = TT.init(QC.SMOKE, seed=0, device="cpu")
    elif name == "whisper SMOKE":
        from repro_torch.configs import whisper_large_v3 as W
        from repro_torch.models import encdec as E

        master = E.init(W.SMOKE, seed=0, device="cpu")
    else:
        master = CN.init(PM.image_model(name, 64), seed=0, device="cpu")
    return _site_views(master, sp)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bdwp", "srste"])
@pytest.mark.parametrize("model", ["qwen3-8b SMOKE", "resnet9", "vgg19",
                                   "vit", "whisper SMOKE",
                                   "600 small sites"])
def test_cuda_grouped_matches_plain_per_site(model, method):
    """One grouped launch over a model's site list (bf16 gradients, as
    the step hands them over) against per-site plain calls, bitwise, out
    of place and in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    views = _model_sites(model)
    gen = torch.Generator(device="cuda").manual_seed(len(views))
    sites = []
    for k, f in views:
        w = torch.randn((k, f), generator=gen, device="cuda") * k ** -0.5
        g = (torch.randn((k, f), generator=gen, device="cuda") * 1e-3).to(
            torch.bfloat16)
        v = torch.randn((k, f), generator=gen, device="cuda") * 1e-3
        sites.append((w, g, v))
    s = dict(lr=0.0123, mu=0.9, wd=5e-4, lam=2e-4)
    args = (s["lr"], s["mu"], s["wd"], s["lam"], 2, 8, method)
    K.launches = K.launched_sites = 0
    got = K.fused_update_sites(sites, *args)
    assert (K.launches, K.launched_sites) == (1, len(views))
    copies = [(w.clone(), g, v.clone()) for w, g, v in sites]
    inplace = K.fused_update_sites(copies, *args, inplace=True)
    for (w, g, v), a, b, (cw, _, cv) in zip(sites, got, inplace, copies):
        want = TR.ref_fused_update(w, g, v, n=2, m=8, axis=0,
                                   bp_mode=method, **s)
        torch.cuda.synchronize()
        assert b[0].data_ptr() == cw.data_ptr()
        assert b[1].data_ptr() == cv.data_ptr()
        for name, x, y, z in zip(("w'", "v'", "vals", "idx", "bp", "mask"),
                                 a, want, b):
            assert np.array_equal(_bits(x), _bits(y)), (model, name, w.shape)
            assert np.array_equal(_bits(z), _bits(y)), (model, name, w.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", NM + [(4, 16), (1, 2)])
def test_cuda_bp_and_mask_match_plain(n, m):
    """The BP operand and the FF mask on even, ragged and unaligned views
    (the scalar path), with negative zeros and ties, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for k, f, kind in [(64, 256, "normal"), (48, 1000, "ties"),
                       (m, 1, "normal"), (8 * m, 130, "ties"),
                       (16 * m, 77, "normal")]:
        w, g, v, s = _inputs((k, f), kind)
        if kind == "ties":
            w = np.where(w == 0, np.float32(-0.0), w)
        base = [torch.zeros(k * f + 1, device="cuda") for _ in range(3)]
        t = []
        for b, a in zip(base, (w, g, v)):   # one element off: scalar path
            view = b[1:].view(k, f)
            view.copy_(torch.from_numpy(a))
            t.append(view)
        for mode in ("bdwp", "srste", None):
            if mode == "bdwp" and f % m:
                continue
            for sites in ([tuple(t)],
                          [tuple(x.contiguous().clone() for x in t)]):
                got = K.fused_update_sites(sites, s["lr"], s["mu"], s["wd"],
                                           s["lam"], n, m, mode)[0]
                want = TR.ref_fused_update(*sites[0], n=n, m=m, axis=0,
                                           bp_mode=mode, **s)
                torch.cuda.synchronize()
                for x, y in zip(got, want):
                    assert np.array_equal(_bits(x), _bits(y)), (k, f, mode)
