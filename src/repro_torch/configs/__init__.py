# Architecture registry of the port: the configurations it can serve, and
# the assigned input shapes.
from .registry import (ARCHS, SHAPES, ShapeSpec, cell_applicable, get_config,
                       get_smoke_config)

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "cell_applicable", "get_config",
           "get_smoke_config"]
