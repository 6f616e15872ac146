"""The check that a run loaded neither JAX nor the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List

# compared with each loaded module's top-level name, whole: the port,
# `stark_brainfuck_tpu_torch`, starts with the JAX package's name and passes
FORBIDDEN = ("jax", "jaxlib", "flax", "stark_brainfuck_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (of `names`, or of `sys.modules`) whose top-level
    name is one of FORBIDDEN."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
