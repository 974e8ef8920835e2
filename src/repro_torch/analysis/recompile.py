"""Signature tracker: assert each serving path keeps one call signature.

The counterpart of the JAX package's ``analysis/recompile.py``.  The
reference jits every serving path, and a jit compiles once per shape
signature: after warmup, a churn episode (attach/detach, ragged pools)
must hit the executable cache on every call, and a silent retrace is a
10x cliff.  The port runs eagerly, so the counterpart of a jit's cache
size is the number of distinct call signatures a serving path has seen.
A signature is the shapes, dtypes and devices of the tensor (and numpy)
arguments, plus the non-tensor arguments: a module by identity, a flag
or a string by value, a number by its type (a jit traces numbers, so a
position is not a new signature).  Graph capture of the serve step
(CUDA graphs, ROADMAP queue 2, held item 0) keys on these same
signatures: a new signature is a new capture.

Two independent signals, cross-checked:

* per path: ``SignaturePath`` records the signatures of the calls an
  engine makes (``ServeEngine.jitted_paths()``,
  ``CollaborativeEngine.jitted_paths()``); ``_cache_size()`` is their
  number.  Precise and attributable (the violation names the path).
* global: a process-wide count of what the port compiles or captures,
  the kernel builds (``kernels/build.py``) and the graph exports made
  through ``analysis`` (``count_export``), catching work in paths the
  guard was not told about.

``MonitorSession.arm_recompile_guard()`` arms a guard over the engine's
``jitted_paths()``; ``analysis.rules.run_recompile_rule`` drives it
through a real churn episode.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

# -- global counter ----------------------------------------------------------

_exports = 0


def count_export() -> None:
    """Count one graph export (``torch.export``) made by the port."""
    global _exports
    _exports += 1


def global_compile_count() -> int:
    """Kernel builds plus graph exports made in this process so far."""
    from repro_torch.kernels import build
    return build.builds() + _exports


# -- signatures --------------------------------------------------------------


def signature(value: Any) -> Any:
    """The hashable signature of an argument (see the module note)."""
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), str(value.dtype),
                str(value.device))
    if isinstance(value, np.ndarray):
        return ("ndarray", value.shape, str(value.dtype))
    if isinstance(value, torch.nn.Module):
        return ("module", id(value))
    if isinstance(value, (bool, str)) or value is None:
        return value
    if isinstance(value, (int, float, np.integer, np.floating)):
        return type(value).__name__
    if isinstance(value, dict):
        return ("dict",) + tuple((k, signature(v))
                                 for k, v in sorted(value.items(),
                                                    key=lambda kv: str(kv[0])))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__,) + tuple(signature(v) for v in value)
    return ("object", type(value).__name__)


class SignaturePath:
    """One serving path's distinct call signatures.  The engine notes each
    call (``note``); called directly it notes and runs ``fn``."""

    def __init__(self, name: str, fn: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self.seen: Set[Any] = set()

    def note(self, *args, **kwargs) -> None:
        self.seen.add(signature((args, kwargs)))

    def __call__(self, *args, **kwargs):
        self.note(*args, **kwargs)
        return self.fn(*args, **kwargs)

    def _cache_size(self) -> int:
        return len(self.seen)


def _cache_size(fn) -> Optional[int]:
    try:
        return int(fn._cache_size())
    except AttributeError:
        return None


class RecompileError(AssertionError):
    """A watched path saw a new call signature after the guard was armed."""


class RecompileGuard:
    """Snapshot the signature counts of a set of paths; assert they never
    grow.  Usage::

        guard = RecompileGuard(engine.jitted_paths()).arm()
        ... churn episode ...
        guard.assert_stable()          # raises RecompileError

    or as a context manager (asserts on clean exit).  Arm AFTER warmup:
    the first call on each signature is legitimately new.
    """

    def __init__(self, jits: Dict[str, Callable],
                 *, track_global: bool = True, warm_only: bool = False):
        self.jits = dict(jits)
        self.track_global = track_global
        # warm_only: watch only paths that have >= 1 signature at arm
        # time: an episode that never exercised a path should not count
        # that path's FIRST call as a new signature
        self.warm_only = warm_only
        self._baseline: Optional[Dict[str, Optional[int]]] = None
        self._global0 = 0

    @property
    def armed(self) -> bool:
        return self._baseline is not None

    def arm(self) -> "RecompileGuard":
        if self.warm_only:
            self.jits = {name: fn for name, fn in self.jits.items()
                         if (_cache_size(fn) or 0) > 0}
        self._baseline = {name: _cache_size(fn)
                          for name, fn in self.jits.items()}
        if self.track_global:
            self._global0 = global_compile_count()
        return self

    def violations(self) -> List[str]:
        """Watched paths whose signature count grew since ``arm()``."""
        if self._baseline is None:
            raise RuntimeError("guard not armed (call arm() after warmup)")
        out = []
        for name, fn in self.jits.items():
            before, now = self._baseline[name], _cache_size(fn)
            if before is not None and now is not None and now > before:
                out.append(f"{name}: {before} -> {now} call signatures")
        return out

    def global_compiles(self) -> int:
        """Kernel builds and exports ANYWHERE in the process since
        ``arm()``."""
        if self._baseline is None:
            raise RuntimeError("guard not armed (call arm() after warmup)")
        return global_compile_count() - self._global0 \
            if self.track_global else 0

    def assert_stable(self, *, allow_global: Optional[int] = None) -> None:
        """Raise ``RecompileError`` if any watched path saw a new
        signature.  With ``allow_global`` set, also bound the process-wide
        count (0 = nothing at all may have been built or exported)."""
        bad = self.violations()
        if bad:
            raise RecompileError(
                "serving paths saw new call signatures after warmup (each "
                "path must keep its signatures):\n  " + "\n  ".join(bad))
        if allow_global is not None and self.track_global:
            n = self.global_compiles()
            if n > allow_global:
                raise RecompileError(
                    f"{n} kernel builds or exports since the guard was "
                    f"armed (allowed {allow_global}): an unwatched path "
                    f"compiled")

    def __enter__(self) -> "RecompileGuard":
        return self.arm()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.assert_stable()
