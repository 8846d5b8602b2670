"""ResNet20 / CIFAR-10, the paper's own model (Tensil ResNet20-ZCU104), as
``repro.configs.resnet20_cifar`` describes it: three stages of three basic
blocks at widths 16, 32 and 64, 32x32x3 images, 10 classes."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet20-cifar"
    num_blocks: tuple = (3, 3, 3)     # ResNet20 = 3 stages x 3 basic blocks
    widths: tuple = (16, 32, 64)
    num_classes: int = 10
    image_size: int = 32
    in_channels: int = 3


CONFIG = ResNetConfig()
