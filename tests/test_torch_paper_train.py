"""Port parity: BDWP 2:8 pre-generating training of the paper's image
models (``train.step.image_train_step``) and ResNet50 on the MaskedOp
path, against the JAX reference run in a subprocess
(``tests/jax_paper_reference.py``, which says why).

1. Three steps of ResNet9 (width 16) and of a 2-block ViT from the
   reference's initial state and the same image batches: the reference
   composes its step as ``tests/test_pregen.py`` does (jitted loss and
   gradients on the compute tree, then ``sgd.update(pregen=True,
   pack=True, use_pallas=True)``), the port runs ``train_steps`` over
   ``image_train_step``.  Losses within ``LOSS_ATOL``: steps 0 and 1 see
   the same weights (lr is 0 at step 0) and differ by at most 5e-7;
   step 2 carries step 1's gradient differences (up to 1.3% of a leaf's
   largest |gradient|, ``test_torch_convnets.py``) through lr 0.05:
   measured 5.7e-4 (ResNet9) and 3.9e-3 (ViT), held within 2e-2.
2. ResNet50 (width 8) on the MaskedOp path: logits and per-leaf
   gradients within the tolerances of ``test_torch_convnets.py`` (the
   bottleneck's 1x1 and 3x3/2 convs, the 1x1/2 projections).
3. ResNet18/50 on a pre-generated tree: their ``fc/w`` passes
   ``should_prune`` and becomes a ``PregenOp``; the reference fails on it
   (``AttributeError``), and the port raises ``TypeError`` at the same
   place, not a silent dense fallback.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax_paper_reference as JR
from test_torch_convnets import (MODELS, T_SP, assert_logits_and_grads_close,
                                 reference)

from repro_torch import convert
from repro_torch.data import synthetic as TD
from repro_torch.models import convnets as TC
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR

LOSS_ATOL = (1e-3, 1e-3, 2e-2)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(["resnet50", "train"], tmp_path_factory)


@pytest.mark.parametrize("name", ["resnet9", "vit"])
def test_three_step_losses_match_reference(ref, name):
    run = ref["train"][name]
    model = MODELS[name]
    _, _, classes, batch, image, _ = JR.MODELS[name]
    state = convert.train_state_from_jax(run["init"], device="cpu")
    opt = TSGD.SGDConfig(**dataclasses.asdict(JR.TRAIN_OPT))
    step = functools.partial(TST.image_train_step, model=model, sp_cfg=T_SP,
                             opt_cfg=opt)
    data = TD.image_stream(TD.ImageTaskConfig(
        image=image, num_classes=classes, batch=batch), device="cpu")
    final, hist = TTR.train_steps(step, state, data, JR.TRAIN_STEPS)
    port = np.array([float(h["loss"]) for h in hist])
    want = np.array(run["losses"])
    assert final["step"] == JR.TRAIN_STEPS
    assert np.all(np.isfinite(port))
    assert np.all(np.abs(port - want) <= np.array(LOSS_ATOL)), (port, want)


def test_resnet50_masked_logits_and_gradients_match_reference(ref):
    rec = ref["resnet50"]
    tree = convert.params_from_jax(rec["master"], device="cpu")
    assert_logits_and_grads_close(rec, MODELS["resnet50"], tree)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_on_pregen_tree_raises_as_the_reference_does(ref, name):
    assert "astype" in ref["resnet50"]["pregen_forward_error"]
    model = TC.ImageModel(name, 16, 8)
    params = TC.init(model, seed=0, device="cpu")
    compute = TSGD.pregen_tree(TSGD.init_state(params)["master"], T_SP,
                               pack=True)
    assert isinstance(compute["fc"]["w"], TC.O.PregenOp)
    x = torch.zeros((1, 32, 32, 3), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="MaskedOp path"):
        TC.apply(model, compute, x, T_SP)
