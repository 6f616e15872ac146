"""Pickle-compatible stand-ins for the reference implementation's classes.

The reference proof format is `pickle.dumps` of a list of objects of classes
`algebra.BaseFieldElement` / `algebra.BaseField` /
`extension_field.ExtensionFieldElement` / `extension_field.ExtensionField` /
`univariate.Polynomial` (ref ip.py:18-19). To produce and parse that format
WITHOUT the reference repo, these shims replicate the classes' pickle
surface exactly: same module names, class names, and `__dict__` attribute
layout (pickle stores instances as class-ref + attribute dict; methods are
irrelevant). Nothing is copied — these are attribute holders. A copy of
the JAX package's `interop/ref_shims.py`.

If the real reference modules are already importable (the reference
implementation's code directory on sys.path), those take precedence; the
shims are only registered for module names that cannot be imported.

`pickle.dumps` refuses an instance whose class is not the object found at
`module.qualname`, and a process may load this package beside the JAX
package, whose codec registers shims of its own under the same names. So
whichever registers first wins (`sys.modules.setdefault`), and every codec
takes its classes from `sys.modules`, never from a module-level copy.
"""

from __future__ import annotations

import sys
import types


def _build_modules():
    algebra = types.ModuleType("algebra")
    univariate = types.ModuleType("univariate")
    extension_field = types.ModuleType("extension_field")

    class BaseFieldElement:
        def __init__(self, value, field):
            self.value = value
            self.field = field

        def __repr__(self):
            return f"bfe({self.value})"

    class BaseField:
        def __init__(self, p):
            self.p = p

    class Polynomial:
        def __init__(self, coefficients):
            self.coefficients = [c for c in coefficients]

    class ExtensionFieldElement:
        def __init__(self, polynomial, field):
            self.polynomial = polynomial
            self.field = field

        def __repr__(self):
            return f"xfe({[c.value for c in self.polynomial.coefficients]})"

    class ExtensionField:
        def __init__(self, modulus):
            self.modulus = modulus

    for cls, mod in (
        (BaseFieldElement, "algebra"),
        (BaseField, "algebra"),
        (Polynomial, "univariate"),
        (ExtensionFieldElement, "extension_field"),
        (ExtensionField, "extension_field"),
    ):
        cls.__module__ = mod
        cls.__qualname__ = cls.__name__

    algebra.BaseFieldElement = BaseFieldElement
    algebra.BaseField = BaseField
    univariate.Polynomial = Polynomial
    extension_field.ExtensionFieldElement = ExtensionFieldElement
    extension_field.ExtensionField = ExtensionField
    return algebra, univariate, extension_field


def ensure_ref_modules():
    """Make `algebra` / `univariate` / `extension_field` importable,
    preferring the real reference modules when already available. Returns
    the three modules."""
    mods = {}
    for name in ("algebra", "univariate", "extension_field"):
        if name in sys.modules:
            mods[name] = sys.modules[name]
    if len(mods) == 3:
        return mods["algebra"], mods["univariate"], mods["extension_field"]
    # try plain import (works when the reference is on sys.path)
    try:
        import algebra as _a  # noqa: F401
        import extension_field as _e  # noqa: F401
        import univariate as _u  # noqa: F401

        return sys.modules["algebra"], sys.modules["univariate"], sys.modules[
            "extension_field"
        ]
    except ImportError:
        pass
    a, u, e = _build_modules()
    sys.modules.setdefault("algebra", a)
    sys.modules.setdefault("univariate", u)
    sys.modules.setdefault("extension_field", e)
    return (
        sys.modules["algebra"], sys.modules["univariate"],
        sys.modules["extension_field"],
    )
