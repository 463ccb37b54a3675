"""Config model base (reference: deepspeed/runtime/config_utils.py).

The JAX package's ``DeepSpeedConfigModel`` is a pydantic model that warns
on unknown keys. The port runs where pydantic is absent, so its base is a
dataclass with the same field names and defaults that RAISES on unknown
keys: a key the port does not know is a feature it does not have, and
ignoring it would serve a different configuration than the one asked for.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import Any, ClassVar


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Base of every config block. Subclasses are ``@dataclass``es.

    ``ALIASES`` maps an accepted alternative key to its field name (the
    pydantic ``alias=``). Fields whose type is another config block take
    a nested dict and are converted in ``__post_init__``.
    """

    ALIASES: ClassVar[dict[str, str]] = {}

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            kind = hints.get(f.name)
            if typing.get_origin(kind) in (typing.Union, types.UnionType):
                # Optional[Block]: the block type among the union's members
                kind = next((k for k in typing.get_args(kind)
                             if isinstance(k, type)
                             and issubclass(k, DeepSpeedConfigModel)), None)
            value = getattr(self, f.name)
            if (isinstance(kind, type)
                    and issubclass(kind, DeepSpeedConfigModel)
                    and isinstance(value, dict)):
                setattr(self, f.name, kind.from_dict(value))

    @property
    def fields_set(self) -> frozenset[str]:
        """Field names the config dict gave explicitly (pydantic's
        ``model_fields_set``); empty for a block built in code."""
        return getattr(self, "_fields_set", frozenset())

    @classmethod
    def from_dict(cls, config: dict | None) -> "DeepSpeedConfigModel":
        """Build from a plain dict; unknown keys raise ``ValueError``."""
        config = dict(config or {})
        known = {f.name for f in dataclasses.fields(cls)}
        for alias, name in cls.ALIASES.items():
            if alias in config:
                if name in config:
                    raise ValueError(
                        f"{cls.__name__}: both {alias!r} and its alias "
                        f"target {name!r} are set")
                config[name] = config.pop(alias)
        unknown = sorted(set(config) - known)
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown config key(s) {unknown}; this "
                f"port accepts {sorted(known)}")
        block = cls(**config)
        block._fields_set = frozenset(config)
        return block

    def model_dump(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
