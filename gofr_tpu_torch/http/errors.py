"""HTTP error types mapped to status codes by the Responder.

A copy of ``gofr_tpu/http/errors.py``, trimmed to what the port's servers
need.
"""

from __future__ import annotations

from typing import Optional, Sequence


class HTTPError(Exception):
    status_code = 500
    # when set (seconds), the Responder adds a Retry-After header
    retry_after_s: Optional[float] = None

    def __init__(self, message: str = "", status_code: Optional[int] = None):
        super().__init__(message or self.__class__.__name__)
        self.message = message or str(self)
        if status_code is not None:
            self.status_code = status_code


class MissingParam(HTTPError):
    status_code = 400

    def __init__(self, params: Sequence[str] = ()):
        self.params = list(params)
        super().__init__(f"Parameter(s) {','.join(self.params)} required for this request")


class InvalidParam(HTTPError):
    status_code = 400

    def __init__(self, params: Sequence[str] = ()):
        self.params = list(params)
        super().__init__(f"Incorrect value for parameter(s): {','.join(self.params)}")


class EntityNotFound(HTTPError):
    status_code = 404

    def __init__(self, name: str = "entity", value: str = ""):
        super().__init__(f"No entity found with {name}: {value}")


class RequestTimeout(HTTPError):
    status_code = 408

    def __init__(self):
        super().__init__("request timed out")


class PanicRecovery(HTTPError):
    status_code = 500

    def __init__(self):
        super().__init__("some unexpected error has occurred")


class ServiceUnavailable(HTTPError):
    status_code = 503

    def __init__(self, message: str = "service unavailable",
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        if retry_after_s is not None:
            self.retry_after_s = retry_after_s


def status_from_method(method: str) -> int:
    return 201 if method == "POST" else 200
