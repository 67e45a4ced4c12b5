from .base import ArchConfig, ShapeConfig, SHAPES, shape_applicable  # noqa: F401
from .registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
