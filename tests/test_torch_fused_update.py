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

The CUDA kernel against the plain version on the card (bitwise) is
marked ``gpu`` and skips where there is no card:
``python -m pytest -m gpu tests/test_torch_fused_update.py``.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as JO
    from repro.kernels import ref as JR
except ImportError:      # the card's machine: only the gpu test runs
    jax = jnp = JO = JR = None

from repro_torch.kernels import fused_update as K
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

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
