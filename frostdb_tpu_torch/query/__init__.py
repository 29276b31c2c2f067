"""Query engine: logical plan, optimizers, physical execution, facade.

Layer map (reference: query/ in polarsignals/frostdb):
- ``expr``      <- query/logicalplan/expr.go
- ``logical``   <- query/logicalplan/{logicalplan,builder}.go
- ``optimize``  <- query/logicalplan/optimize.go
- ``validate``  <- query/logicalplan/validate.go
- ``physical``  <- query/physicalplan/*
- ``engine``    <- query/engine.go, query/memory.go
"""

from .engine import NewEngine, LocalEngine  # noqa: F401
from . import expr as logicalplan  # noqa: F401
