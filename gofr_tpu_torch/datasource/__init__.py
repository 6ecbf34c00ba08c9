"""Datasource layer: health types shared by every backend.

Ports ``gofr_tpu/datasource/__init__.py`` whole: ``Health`` and the
status constants, which ``container`` re-exports.

Parity: reference pkg/gofr/datasource/health.go:3-11 (Health{Status, Details})
with statuses UP/DOWN/DEGRADED.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"
STATUS_DEGRADED = "DEGRADED"


@dataclass
class Health:
    status: str = STATUS_UP
    details: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"status": self.status, "details": self.details}
