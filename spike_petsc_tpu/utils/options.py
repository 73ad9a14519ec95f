"""PETSc-style options database.

The reference drives every component from a single string-keyed options
database with hierarchical prefixes (see /root/reference/src/testbed.c:41-53,
/root/reference/src/matbanded.c:278-281 ``banded_`` prefix,
/root/reference/src/kspreorder.c:218-221 ``reorder_`` prefix).  This module
provides the framework's equivalent: a plain dict-backed database with

* typed getters (`get_int`, `get_real`, `get_bool`, `get_string`),
* hierarchical prefixes so nested solvers are configurable by name
  (``-reorder_ksp_type gmres`` configures the inner KSP of a reordered solve),
* argv parsing compatible with the reference CLI flags (``-mat file``,
  ``-ksp_rtol 1e-8``, bare flags meaning true),
* "options left" diagnostics for typo detection.

This is deliberately *not* an OO registry of PETSc objects: solvers in this
framework are pure functions + pytrees, and the options database only shapes
how driver-level code composes them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _looks_like_value(tok: str) -> bool:
    """A token is a value unless it looks like a new ``-flag``."""
    if not tok.startswith("-"):
        return True
    # "-1.5" / "-3" are numeric values, not flags
    rest = tok[1:]
    if not rest:
        return False
    return rest[0].isdigit() or (rest[0] == "." and len(rest) > 1 and rest[1].isdigit())


class Options:
    """A flat string->string options database with prefix scoping.

    Mirrors the capability of the PETSc options database used throughout the
    reference (/root/reference/src/testbed.c:41-53) without its global state:
    instances are explicit and can be scoped with :meth:`scoped`.
    """

    def __init__(self, mapping: Optional[Dict[str, str]] = None, prefix: str = ""):
        self._db: Dict[str, str] = dict(mapping or {})
        self._used: set = set()
        self.prefix = prefix

    # -- construction -----------------------------------------------------
    @classmethod
    def from_argv(cls, argv: Iterable[str]) -> "Options":
        """Parse ``-key value`` / ``-flag`` pairs like PETSc's CLI."""
        db: Dict[str, str] = {}
        toks = list(argv)
        i = 0
        while i < len(toks):
            tok = toks[i]
            if tok.startswith("-") and not _looks_like_value(tok):
                key = tok.lstrip("-")
                if i + 1 < len(toks) and _looks_like_value(toks[i + 1]):
                    db[key] = toks[i + 1]
                    i += 2
                else:
                    db[key] = ""  # bare flag == true
                    i += 1
            else:
                i += 1
        return cls(db)

    @classmethod
    def from_file(cls, path: str) -> "Options":
        """Load options from a file of '-key value' lines (PETSc
        -options_file equivalent); '#' starts a comment."""
        toks: List[str] = []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    toks.extend(line.split())
        return cls.from_argv(toks)

    def scoped(self, prefix: str) -> "Options":
        """A view of the same database with ``prefix`` prepended to queries.

        Shares storage (and the used-keys set) with the parent, mirroring how
        PETSc appends options prefixes to nested objects
        (/root/reference/src/matbanded.c:281, /root/reference/src/kspreorder.c:221).
        """
        child = Options.__new__(Options)
        child._db = self._db
        child._used = self._used
        child.prefix = self.prefix + prefix
        return child

    # -- setting ----------------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        self._db[self.prefix + key.lstrip("-")] = str(value)

    def update(self, mapping: Dict[str, Any]) -> None:
        for k, v in mapping.items():
            self.set(k, v)

    # -- raw access ---------------------------------------------------------
    def _raw(self, key: str) -> Optional[str]:
        full = self.prefix + key.lstrip("-")
        if full in self._db:
            self._used.add(full)
            return self._db[full]
        return None

    def has(self, key: str) -> bool:
        return (self.prefix + key.lstrip("-")) in self._db

    # -- typed getters ------------------------------------------------------
    def get_string(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self._raw(key)
        return default if v is None else v

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self._raw(key)
        return default if v in (None, "") else int(v)

    def get_real(self, key: str, default: Optional[float] = None) -> Optional[float]:
        v = self._raw(key)
        return default if v in (None, "") else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._raw(key)
        if v is None:
            return default
        if isinstance(v, (bool, int)):     # Options({"flag": True}) — the
            return bool(v)                 # programmatic-dict construction
        if v == "":
            return True
        lv = v.lower()
        if lv in _TRUE:
            return True
        if lv in _FALSE:
            return False
        raise ValueError(f"Option -{key}: cannot parse boolean from {v!r}")

    def get_list(self, key: str, default: Optional[List[str]] = None) -> Optional[List[str]]:
        v = self._raw(key)
        if v is None:
            return default
        return [s for s in v.replace(",", " ").split() if s]

    # -- diagnostics --------------------------------------------------------
    def options_left(self) -> List[Tuple[str, str]]:
        """Unqueried options — the reference relies on PETSc's -options_left
        to flag typos; same capability here."""
        return sorted((k, v) for k, v in self._db.items() if k not in self._used)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Options(prefix={self.prefix!r}, db={self._db!r})"
