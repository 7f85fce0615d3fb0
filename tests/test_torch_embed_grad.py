"""The embedding table's gradient over repeated tokens (CPU).

The reference's compute tree holds the table in bf16
(``src/repro/optim/sgd.py`` casts every non-site float leaf) and takes
its rows with ``jnp.take`` (``layers.embed_apply``); its gradient is a
scatter-add into a bf16 table, which rounds at every repeat of a token.
The port's ``table[tokens]`` backward (an accumulating ``index_put_``)
does the same: for a table whose one row is looked up 1024 times, both
give the same bf16 gradient bit for bit, and both lie well off the fp32
sum of the same cotangents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

jax.config.update("jax_platform_name", "cpu")

VOCAB, D, N_TOKENS, REPEATED, ROW = 16, 64, 2048, 1024, 3


def _case(seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((VOCAB, D)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, N_TOKENS)
    tokens[rng.permutation(N_TOKENS)[:REPEATED]] = ROW
    cot = rng.standard_normal((N_TOKENS, D)).astype(np.float32)
    return table, tokens, cot


def _reference_grad(table, tokens, cot, jit):
    def f(t):
        return JL.embed_apply({"embed_table": t}, jnp.asarray(tokens))

    if jit:
        f = jax.jit(f)
    t = jnp.asarray(table, jnp.bfloat16)
    _, vjp = jax.vjp(f, t)
    (g,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    return np.asarray(g.astype(jnp.float32))


def _port_grad(table, tokens, cot):
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_()
    out = TL.embed_apply({"embed_table": t}, torch.from_numpy(tokens))
    out.backward(torch.from_numpy(cot).to(torch.bfloat16))
    assert t.grad.dtype == torch.bfloat16
    return t.grad.float().numpy()


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_repeated_rows_sum_in_bf16_as_reference(jit):
    table, tokens, cot = _case()
    assert (tokens == ROW).sum() >= REPEATED
    want = _reference_grad(table, tokens, cot, jit)
    got = _port_grad(table, tokens, cot)
    np.testing.assert_array_equal(got, want)
    # the fp32 sum of the same bf16 cotangents: the repeated row parts
    c = torch.from_numpy(cot).to(torch.bfloat16).float().numpy()
    exact = np.zeros_like(table)
    np.add.at(exact, tokens, c)
    rel = (np.linalg.norm(got[ROW] - exact[ROW])
           / np.linalg.norm(exact[ROW]))
    assert rel > 1e-2
