"""Config layer: env-file loader with APP_ENV overlays.

A copy of ``gofr_tpu/config/__init__.py``, whole: ``Config`` (``get``,
``get_or_default``, ``get_int``, ``get_float``, ``get_bool``), ``EnvFile``
(``<dir>/.env``, then ``.{APP_ENV}.env`` or ``.local.env`` over it, the
process environment over both), ``MockConfig`` and ``new_env_file``. Added
here: ``as_config``, which wraps the plain mapping the port's entry points
have always taken (``serve.build_engine(env)``, ``App(config=env)``).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Union


class Config:
    """Minimal read interface every component depends on."""

    def get(self, key: str) -> Optional[str]:  # pragma: no cover - interface
        raise NotImplementedError

    def get_or_default(self, key: str, default: str) -> str:
        val = self.get(key)
        return val if val not in (None, "") else default

    # typed getters: a value that does not parse reads as the default
    def get_int(self, key: str, default: int) -> int:
        val = self.get(key)
        if val in (None, ""):
            return default
        try:
            return int(val)
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        val = self.get(key)
        if val in (None, ""):
            return default
        try:
            return float(val)
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self.get(key)
        if val in (None, ""):
            return default
        return val.strip().lower() in ("1", "true", "yes", "on")


def _parse_env_file(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as fp:
            for line in fp:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key = key.strip()
                val = val.strip()
                if len(val) >= 2 and val[0] == val[-1] and val[0] in ("'", '"'):
                    val = val[1:-1]
                if key:
                    out[key] = val
    except OSError:
        pass
    return out


class EnvFile(Config):
    """Loads `<dir>/.env`, then overlays `.local.env` or `.{APP_ENV}.env`.

    If APP_ENV is set, `.{APP_ENV}.env` overrides; otherwise `.local.env`
    overrides when present. Real process env vars override everything.
    """

    def __init__(self, config_dir: str = "./configs",
                 environ: Optional[Mapping[str, str]] = None):
        self._environ = environ if environ is not None else os.environ
        self._values: Dict[str, str] = {}
        base = _parse_env_file(os.path.join(config_dir, ".env"))
        self._values.update(base)
        app_env = self._environ.get("APP_ENV", "") or base.get("APP_ENV", "")
        if app_env:
            overlay = _parse_env_file(os.path.join(config_dir, f".{app_env}.env"))
        else:
            overlay = _parse_env_file(os.path.join(config_dir, ".local.env"))
        self._values.update(overlay)

    def get(self, key: str) -> Optional[str]:
        if key in self._environ:
            return self._environ[key]
        return self._values.get(key)


class MockConfig(Config):
    """Map-backed Config for tests and for the plain mappings the port's
    entry points take."""

    def __init__(self, values: Optional[Mapping[str, str]] = None):
        self.values = dict(values or {})

    def get(self, key: str) -> Optional[str]:
        return self.values.get(key)


def new_env_file(config_dir: str = "./configs") -> EnvFile:
    return EnvFile(config_dir)


def as_config(config: Union[Config, Mapping[str, str], None]) -> Config:
    """A Config as is; a mapping (or None: empty) wrapped in a MockConfig."""
    if isinstance(config, Config):
        return config
    return MockConfig(config)
