"""regnet-y-128gf — the paper's image-classification model (Table 1 / Fig 6).

torchvision regnet_y_128gf: 644.8 M params, stem width 32,
stage widths (528, 1056, 2904, 7392), depths (2, 7, 17, 1), group width 264,
SE ratio 0.25.  Split points: stem / block1..4 / avgpool (paper Table 1).
Input 384x384 (SWAG e2e weights) -> stem output 32x192x192 as in the table.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RegNetConfig:
    name: str = "regnet-y-128gf"
    stem_width: int = 32
    widths: Tuple[int, ...] = (528, 1056, 2904, 7392)
    depths: Tuple[int, ...] = (2, 7, 17, 1)
    group_width: int = 264
    se_ratio: float = 0.25
    num_classes: int = 1000
    image_size: int = 384
    bottleneck_ratio: float = 1.0


CONFIG = RegNetConfig()


def reduced() -> RegNetConfig:
    """Tiny same-family config for CPU smoke tests."""
    return RegNetConfig(
        name="regnet-y-smoke",
        stem_width=8,
        widths=(16, 24, 32, 48),
        depths=(1, 1, 2, 1),
        group_width=8,
        num_classes=10,
        image_size=64,
    )
