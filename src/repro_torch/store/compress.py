"""Slab compression backends for FCS version-2 segments.

FCS v1 already removes per-row redundancy (dict/const/narrowed columns),
but the raw f8 timestamp slabs — the bulk of every archival segment —
still carry ~8 high-entropy-looking bytes per value.  They are not
actually high entropy: within a segment the timestamps are near-sorted,
so their high bytes barely change.  A byte-transpose ("shuffle", the
Blosc trick) groups byte 0 of every value, then byte 1, … — after which
a general-purpose compressor folds the nearly-constant high-byte runs.

Backends (one byte in the v2 column directory, per slab):

  ``stored``  (0)  slab kept verbatim — tiny slabs, or when compression
                   would not shrink it;
  ``zstd``    (1)  the ``zstandard`` package when importable — the
                   intended archival backend (fast decode);
  ``zlib``    (2)  stdlib fallback so v2 never needs a new dependency.

``zstandard`` is an OPTIONAL dependency: when it is absent, writers fall
back to zlib (an explicit ``compression="zstd"`` request warns once and
is counted in :data:`zstd_fallbacks`), and readers raise a clear
:class:`~repro.store.base.CodecError` only if they meet a slab that was
actually written with zstd.
"""
from __future__ import annotations

import warnings
import zlib
from typing import Optional

import numpy as np

from repro_torch.store.base import CodecError

try:                                    # optional: stdlib zlib is the floor
    import zstandard as _zstd
except ImportError:                     # pragma: no cover - env-dependent
    _zstd = None

COMP_STORED, COMP_ZSTD, COMP_ZLIB = 0, 1, 2
FLAG_SHUFFLE = 0x80                     # high bit of the dirent comp byte
COMP_MASK = 0x7F

_BACKEND_NAMES = {"stored": COMP_STORED, "zstd": COMP_ZSTD,
                  "zlib": COMP_ZLIB}
_NAME_BY_CODE = {v: k for k, v in _BACKEND_NAMES.items()}
_DEFAULT_LEVEL = {COMP_ZSTD: 3, COMP_ZLIB: 6}

# explicit "zstd" requests served by zlib because the package is absent
# (observability for the CI / requirements-dev story)
zstd_fallbacks = 0


def have_zstd() -> bool:
    return _zstd is not None


def resolve_backend(name: Optional[str]) -> int:
    """Backend code for a writer: ``None``/``"auto"`` picks zstd when the
    package is importable, else zlib.  An explicit ``"zstd"`` without the
    package falls back to zlib with one counted warning instead of
    failing the spill path at runtime."""
    global zstd_fallbacks
    if name is None or name == "auto":
        return COMP_ZSTD if _zstd is not None else COMP_ZLIB
    try:
        code = _BACKEND_NAMES[name]
    except KeyError:
        raise ValueError(f"unknown FCS compression backend {name!r}; "
                         f"known: {sorted(_BACKEND_NAMES)}") from None
    if code == COMP_ZSTD and _zstd is None:
        zstd_fallbacks += 1
        if zstd_fallbacks == 1:
            warnings.warn("zstandard is not installed; FCS v2 segments "
                          "will use the stdlib zlib backend instead",
                          stacklevel=2)
        return COMP_ZLIB
    return code


def shuffle(data: bytes, itemsize: int) -> bytes:
    """Byte-transpose a fixed-width slab: all byte-0s, then all byte-1s…
    Lossless for any ``len(data) % itemsize == 0`` buffer."""
    a = np.frombuffer(data, np.uint8).reshape(-1, itemsize)
    return a.T.tobytes()


def unshuffle(data: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(data, np.uint8).reshape(itemsize, -1)
    return a.T.tobytes()


def compress(data: bytes, backend: int, level: Optional[int] = None) -> bytes:
    lvl = _DEFAULT_LEVEL[backend] if level is None else level
    if backend == COMP_ZLIB:
        # clamp: a level tuned for zstd (1..22) must keep working after
        # the zlib fallback — zlib.error on every encode would silently
        # kill the daemon spill path for the job's whole lifetime
        return zlib.compress(data, max(-1, min(lvl, 9)))
    if backend == COMP_ZSTD:
        return _zstd.ZstdCompressor(level=lvl).compress(data)
    raise ValueError(f"cannot compress with backend code {backend}")


def decompress(data, backend: int, raw_len: int, *,
               path: Optional[str] = None,
               offset: Optional[int] = None) -> bytes:
    """Inflate one slab; every failure mode (bit-rot, unknown backend,
    missing zstandard) surfaces as :class:`CodecError` so the replay
    skip-and-count contract holds for v2 exactly as for v1."""
    if backend == COMP_ZLIB:
        try:
            out = zlib.decompress(bytes(data))
        except zlib.error as e:
            raise CodecError(f"corrupt zlib slab ({e})", path=path,
                             offset=offset) from e
    elif backend == COMP_ZSTD:
        if _zstd is None:
            raise CodecError(
                "segment slab is zstd-compressed but the zstandard "
                "package is not installed (pip install zstandard)",
                path=path, offset=offset)
        try:
            out = _zstd.ZstdDecompressor().decompress(
                bytes(data), max_output_size=raw_len)
        except _zstd.ZstdError as e:
            raise CodecError(f"corrupt zstd slab ({e})", path=path,
                             offset=offset) from e
    else:
        raise CodecError(f"unknown slab compression backend {backend}",
                         path=path, offset=offset)
    if len(out) != raw_len:
        raise CodecError(f"slab inflated to {len(out)} bytes, directory "
                         f"declares {raw_len}", path=path, offset=offset)
    return out
