"""TF1-style hyperparameter object.

Copied from ``asr_study_tpu/utils/hparams.py`` so that the port imports
nothing of the JAX package; standard library only.

Mirrors the reference's ``HParams`` [ref: utils/hparams.py]: a bag of defaults
that can be overridden from the CLI either with a ``"key=val,key2=val2"``
string or a JSON object string, with values coerced to the default's type.
"""

from __future__ import annotations

import json
from typing import Any, Dict


def _coerce(value: str, like: Any) -> Any:
    if isinstance(like, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    if isinstance(like, (list, tuple)):
        parsed = json.loads(value) if value.startswith("[") else value.split(";")
        # the ';'-split spelling yields strings — coerce each element to
        # the default's element type like the scalar paths do (a default
        # of [512, 512] overridden with "256;256" must not become
        # ["256", "256"])
        if like and all(isinstance(x, str) for x in parsed):
            parsed = [_coerce(x, like[0]) for x in parsed]
        return type(like)(parsed)
    return value


class HParams:
    def __init__(self, **defaults: Any):
        self._values: Dict[str, Any] = dict(defaults)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def set(self, name: str, value: Any) -> None:
        self._values[name] = value

    def parse(self, spec: str | None) -> "HParams":
        """Override values from ``"k=v,k2=v2"`` or a JSON object string."""
        if not spec:
            return self
        spec = spec.strip()
        if spec.startswith("{"):
            overrides = json.loads(spec)
        else:
            overrides = {}
            for item in spec.split(","):
                if not item.strip():
                    continue
                key, _, val = item.partition("=")
                overrides[key.strip()] = val.strip()
        for key, val in overrides.items():
            if key in self._values and isinstance(val, str):
                val = _coerce(val, self._values[key])
            self._values[key] = val
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HParams":
        return cls(**d)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self._values.items()))
        return f"HParams({inner})"
