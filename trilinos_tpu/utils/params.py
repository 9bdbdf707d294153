"""Hierarchical, validated parameter lists.

JAX analogue of ``Teuchos::ParameterList``
(reference: packages/teuchos/parameterlist/src/Teuchos_ParameterList.hpp:133).
Every solver / preconditioner / partitioner in the framework takes one of
these; each component publishes ``valid_params()`` documenting its own
parameter surface, mirroring the reference's ``getValidParameters()``
discipline (e.g. packages/belos/src/BelosBlockGmresSolMgr.hpp:323-337).

Design differences from the reference (deliberate):
  * plain Python mapping + dataclass `Param` specs instead of `Teuchos::any`;
  * validation is eager (`validate`) rather than lazy sublist magic;
  * "used" tracking retained — unused-parameter reporting catches typos the
    same way Teuchos' ``unused()`` printout does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping


@dataclasses.dataclass(frozen=True)
class Param:
    """Specification of one valid parameter (name, default, doc, validator)."""

    name: str
    default: Any
    doc: str = ""
    validator: Callable[[Any], bool] | None = None
    # when set, value must be one of these (Teuchos StringValidator analogue)
    choices: tuple | None = None

    def check(self, value: Any) -> None:
        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"parameter {self.name!r}: value {value!r} not in {self.choices}"
            )
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"parameter {self.name!r}: invalid value {value!r}")


class ParameterList:
    """String-keyed hierarchical config with defaults + used-tracking."""

    def __init__(self, entries: Mapping[str, Any] | None = None, name: str = ""):
        self.name = name
        self._data: dict[str, Any] = {}
        self._used: set[str] = set()
        if entries:
            for k, v in entries.items():
                self[k] = v

    # -- mapping interface -------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ParameterList):
            value = ParameterList(value, name=key)
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        self._used.add(key)
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def copy(self) -> "ParameterList":
        """Shallow copy (fresh used-tracking) — for callers that must
        add defaults without mutating a user-supplied list."""
        out = ParameterList(name=self.name)
        out._data = dict(self._data)
        return out

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return f"ParameterList({self.name!r}, {self._data!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ParameterList):
            return self._data == other._data
        return NotImplemented

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        """Fetch ``key``; if absent, *record* and return the default.

        Like ``ParameterList::get(name, default)`` in the reference, the
        default is stored so a later dump shows the full effective config.
        """
        if key not in self._data:
            self._data[key] = default
        self._used.add(key)
        return self._data[key]

    def sublist(self, key: str) -> "ParameterList":
        if key not in self._data:
            self._data[key] = ParameterList(name=key)
        self._used.add(key)
        sub = self._data[key]
        if not isinstance(sub, ParameterList):
            raise TypeError(f"parameter {key!r} is not a sublist")
        return sub

    # -- validation --------------------------------------------------------
    def validate(self, specs: Mapping[str, Param], strict: bool = True) -> None:
        """Check types/choices and fill defaults.

        Analogue of ``validateParametersAndSetDefaults``; with ``strict``
        unknown top-level keys raise (catches typos).
        """
        for name, spec in specs.items():
            if name in self._data:
                spec.check(self._data[name])
            else:
                self._data[name] = spec.default
        if strict:
            unknown = [
                k
                for k in self._data
                if k not in specs and not isinstance(self._data[k], ParameterList)
            ]
            if unknown:
                raise ValueError(
                    f"unknown parameters {unknown} (valid: {sorted(specs)})"
                )

    def unused(self) -> list[str]:
        return [k for k in self._data if k not in self._used]

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ParameterList) else v
        return out


def make_params(p: "ParameterList | Mapping | None") -> ParameterList:
    """Coerce user input (dict / ParameterList / None) into a ParameterList."""
    if p is None:
        return ParameterList()
    if isinstance(p, ParameterList):
        return p
    return ParameterList(p)
