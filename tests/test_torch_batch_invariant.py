"""Batch invariance of the encoder-decoder's serving steps.

On the card a whisper row decoded alone (B = 1) parted from the same row
of a 4-row batch: cuBLAS takes another algorithm for the attention's
fp32 einsums at another batch count, and PyTorch's row reductions
(LayerNorm's mean and variance) split a row over more threads when there
are fewer rows (``chip_smoke.py`` phase 46 located both).  Under
``layers.batch_invariant`` those ops run on their operands padded to
``invariant_rows(B)`` rows (8, then the next power of two), so every B
of one bucket runs the same kernels: on the card the rows are bitwise
(phase 46; the gpu-marked test below).

On the CPU the steps ignore it (the CPU tests hold the reference's bits),
which the first test checks; the second forces the padding on the CPU
and checks the mechanism: a row's prefill logits and decode steps equal
at B = 1 and B = 4.
"""

import contextlib

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.train import step as TST

CFG = get_arch("whisper-large-v3").smoke
SP = SparsityConfig(n=2, m=8, method="bdwp")
STEPS = 4


def _greedy(params, frames, prompt, dev):
    with torch.no_grad():
        logits, cache, enc = TST.encdec_prefill_step(
            params, {"frames": frames, "tokens": prompt}, cfg=CFG, sp_cfg=SP)
        seated = TE.init_cache(CFG, prompt.shape[0], 16, device=dev)
        for dst, src in zip(seated["layers"], cache["layers"]):
            dst["k"][:, :prompt.shape[1]] = src["k"]
            dst["v"][:, :prompt.shape[1]] = src["v"]
            dst["pos"] = src["pos"]
        out = [logits]
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for s in range(STEPS):
            logits, seated = TST.encdec_decode_step(
                params, seated, enc, tok, prompt.shape[1] + s, cfg=CFG,
                sp_cfg=SP)
            out.append(logits)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
    return out


def _inputs(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    params = TE.init(CFG, seed=0, device=dev, dtype=torch.bfloat16)
    frames = torch.randn((4, 32, CFG.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
    prompt = torch.randint(0, CFG.vocab, (4, 3), generator=g, device=dev)
    return params, frames, prompt


def test_invariant_rows():
    assert [TL.invariant_rows(b) for b in (1, 4, 8, 9, 16, 17)] == \
        [8, 8, 8, 16, 16, 32]


def test_cpu_steps_ignore_it(monkeypatch):
    params, frames, prompt = _inputs("cpu")
    on = _greedy(params, frames, prompt, "cpu")
    monkeypatch.setattr(TL, "batch_invariant", contextlib.nullcontext)
    off = _greedy(params, frames, prompt, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def _rows_bitwise(dev):
    params, frames, prompt = _inputs(dev)
    four = _greedy(params, frames, prompt, dev)
    one = _greedy(params, frames[:1], prompt[:1], dev)
    return [torch.equal(a[:1], b) for a, b in zip(four, one)]


def test_padding_makes_a_row_independent_of_the_batch(monkeypatch):
    monkeypatch.setattr(TL, "_padding_on",
                        lambda x: TL._BATCH_INVARIANT[0])
    assert all(_rows_bitwise("cpu"))


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_rows_bitwise_on_the_card():
    torch.backends.cuda.matmul.allow_tf32 = False
    assert all(_rows_bitwise(torch.device("cuda", 0)))
