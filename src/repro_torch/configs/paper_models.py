"""The paper's own five benchmark models (Table I): ResNet9, ViT, VGG19,
ResNet18, ResNet50.

The port's own copy of ``src/repro/configs/paper_models.py``
(``PaperModel``, ``PAPER_MODELS``, ``VIT_PAPER``, same values), plus
``image_model``, which names one of them as ``models.convnets`` builds
it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.convnets import ImageModel, ViTConfig


@dataclasses.dataclass(frozen=True)
class PaperModel:
    name: str
    dataset: str
    image: int
    num_classes: int
    epochs: int
    batch: int
    lr: float
    wd: float
    # Table II training/inference FLOPs for the dense baseline (x1e9 fwd)
    table2_infer_gflops_dense: float = 0.0


PAPER_MODELS = {
    "resnet9": PaperModel("resnet9", "cifar10", 32, 10, 150, 512, 0.5, 5e-4, 1.16),
    "vit": PaperModel("vit", "cifar100", 32, 100, 150, 512, 0.1, 5e-4, 0.643),
    "vgg19": PaperModel("vgg19", "cifar100", 32, 100, 150, 512, 0.1, 5e-4, 0.4),
    "resnet18": PaperModel("resnet18", "tinyimagenet", 64, 200, 88, 512, 0.05, 5e-3, 1.83),
    "resnet50": PaperModel("resnet50", "imagenet", 224, 1000, 120, 256, 0.1, 5e-5, 4.14),
}

VIT_PAPER = ViTConfig(image=32, patch=4, d_model=384, n_layers=7, n_heads=6,
                      d_ff=1536, num_classes=100)


def image_model(name: str, width: int = 64) -> ImageModel:
    """Table I's ``name`` with its class count; the ViT is ``VIT_PAPER``,
    a ResNet has base ``width`` (64 in the paper)."""
    pm = PAPER_MODELS[name]
    return ImageModel(name, pm.num_classes, width,
                      VIT_PAPER if name == "vit" else None)
