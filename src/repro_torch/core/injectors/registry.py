"""Injector registry: ``Injection.kind`` -> injector class.

Mirrors the detector registry (``repro_torch.core.detectors.registry``):
built-ins self-register at import, third-party injectors register with
the same decorator, and the simulator resolves its ``injections`` list
through :func:`resolve_injections` — an unknown kind is a loud
:class:`UnknownInjectorError` naming what IS registered, never a fault
that silently fails to happen (which would corrupt every scenario score
built on top).

The port's copy of the JAX package's ``core/injectors/registry.py``:
stdlib and numpy only (no torch), with the reference's names and
semantics (its syntax tree is held to the reference's by
``tests/test_torch_simulator.py``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.injectors.base import FaultInjector, Injection


class InjectorError(ValueError):
    """Base for registry errors."""


class UnknownInjectorError(InjectorError):
    pass


class DuplicateInjectorError(InjectorError):
    pass


_REGISTRY: dict[str, type] = {}    # kind -> FaultInjector subclass


def register_injector(cls=None, *, name: Optional[str] = None,
                      replace: bool = False):
    """Class decorator (or direct call): register a FaultInjector subclass
    under ``cls.name``.  ``name=`` overrides the class attribute;
    ``replace=True`` allows overriding an existing registration (e.g. a
    site-specific variant of a built-in fault)."""
    def _register(c):
        key = name or getattr(c, "name", "")
        if not key:
            raise InjectorError(
                f"{c.__name__} has no injector name: set a class-level "
                "``name`` or pass register_injector(name=...)")
        if key in _REGISTRY and not replace:
            raise DuplicateInjectorError(
                f"injector {key!r} is already registered to "
                f"{_REGISTRY[key].__name__}; pass replace=True to "
                "override it")
        if name is not None:
            c.name = name
        _REGISTRY[key] = c
        return c
    return _register(cls) if cls is not None else _register


def unregister_injector(name: str) -> None:
    """Remove a registration (tests / plugin teardown)."""
    _REGISTRY.pop(name, None)


def injector_names() -> list[str]:
    return sorted(_REGISTRY)


def get_injector(kind: str) -> type:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise UnknownInjectorError(
            f"unknown injection kind {kind!r}; registered: "
            f"{injector_names()}") from None


def resolve_injections(entries) -> list[FaultInjector]:
    """Turn a simulator-level injection list into bound injector
    instances, preserving order (the order injections are listed is the
    order their hooks run — and therefore the RNG draw order).

    Each entry may be an :class:`Injection` (kind looked up in the
    registry) or an already-constructed :class:`FaultInjector` instance
    (used as-is — the escape hatch for one-off experiment faults that
    are not worth a registration)."""
    out: list[FaultInjector] = []
    for e in entries or ():
        if isinstance(e, Injection):
            out.append(get_injector(e.kind)(e))
        elif isinstance(e, FaultInjector):
            out.append(e)
        else:
            raise InjectorError(
                f"injection entry {e!r} is neither an Injection nor a "
                "FaultInjector")
    return out
