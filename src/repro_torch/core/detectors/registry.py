"""Detector registry: name -> detector class, per scope.

Mirrors the ``TraceCodec`` registry in ``repro_torch.store``: built-ins
self-register at import, third-party detectors register with the same
decorator, and ``EngineConfig.detectors`` / ``FleetConfig.fleet_detectors``
resolve through :func:`resolve_detectors` — the engine never hardcodes a
detector list again.

Names are namespaced by scope (``"job"`` for per-job detectors driven by
the engine, ``"fleet"`` for cross-job detectors driven by the
multiplexer), so a fleet detector may reuse a job detector's name without
clashing.  Registering an existing (scope, name) raises
:class:`DuplicateDetectorError` unless ``replace=True`` — silent
shadowing of a built-in is how diagnosis quietly changes meaning.

The port's copy of the JAX package's ``core/detectors/registry.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.detectors.base import Detector, DetectorSpec


class DetectorError(ValueError):
    """Base for registry errors."""


class UnknownDetectorError(DetectorError):
    pass


class DuplicateDetectorError(DetectorError):
    pass


_REGISTRY: dict[tuple[str, str], type] = {}    # (scope, name) -> class

#: The engine's default per-job set.  ORDER IS CONTRACT: it reproduces the
#: pre-registry engine's emission order per step (fail-slows first, then
#: regressions in paper order ②-⑤), which the byte-equivalence tests pin.
DEFAULT_DETECTORS: tuple[str, ...] = (
    "failslow", "issue_latency", "voids", "flops", "bandwidth", "hang")


def register_detector(cls=None, *, name: Optional[str] = None,
                      replace: bool = False):
    """Class decorator (or direct call): register a Detector subclass under
    ``cls.name``/``cls.scope``.  ``name=`` overrides the class attribute;
    ``replace=True`` allows overriding an existing registration (e.g. a
    site-specific variant of a built-in)."""
    def _register(c):
        key_name = name or getattr(c, "name", "")
        scope = getattr(c, "scope", "job")
        if not key_name:
            raise DetectorError(
                f"{c.__name__} has no detector name: set a class-level "
                "``name`` or pass register_detector(name=...)")
        key = (scope, key_name)
        if key in _REGISTRY and not replace:
            raise DuplicateDetectorError(
                f"detector {key_name!r} (scope {scope!r}) is already "
                f"registered to {_REGISTRY[key].__name__}; pass "
                "replace=True to override it")
        if name is not None:
            c.name = name
        _REGISTRY[key] = c
        return c
    return _register(cls) if cls is not None else _register


def unregister_detector(name: str, scope: str = "job") -> None:
    """Remove a registration (tests / plugin teardown)."""
    _REGISTRY.pop((scope, name), None)


def detector_names(scope: str = "job") -> list[str]:
    return sorted(n for (s, n) in _REGISTRY if s == scope)


def get_detector(name: str, scope: str = "job") -> type:
    try:
        return _REGISTRY[(scope, name)]
    except KeyError:
        raise UnknownDetectorError(
            f"unknown {scope} detector {name!r}; registered: "
            f"{detector_names(scope)}") from None


def resolve_detectors(entries, scope: str = "job") -> list[Detector]:
    """Turn a config-level detector list into fresh, unbound instances.

    Each entry may be a registry name (``"failslow"``), a
    :class:`DetectorSpec` (name + constructor options), a Detector
    subclass, or an already-constructed instance (used as-is — the caller
    owns cross-engine state sharing if it passes one instance twice).
    ``entries=None`` resolves the default set for the scope (the built-in
    five + hang for ``"job"``, empty for ``"fleet"``).
    """
    if entries is None:
        entries = DEFAULT_DETECTORS if scope == "job" else ()
    out: list[Detector] = []
    for e in entries:
        if isinstance(e, str):
            out.append(get_detector(e, scope)())
        elif isinstance(e, DetectorSpec):
            out.append(get_detector(e.name, scope)(**e.options))
        elif isinstance(e, type):
            out.append(e())
        else:
            out.append(e)                      # instance
        got = getattr(out[-1], "scope", "job")
        if got != scope:
            raise DetectorError(
                f"detector {getattr(out[-1], 'name', out[-1])!r} has scope "
                f"{got!r}, expected {scope!r}")
    return out
