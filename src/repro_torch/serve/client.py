"""A small retrying HTTP client for the volume front door.

The front door sheds load with 503 + ``Retry-After`` when its admission
limiter is full; the polite client reaction — and the one the paper's
always-on service story assumes — is to back off and come again, not to
surface every shed as a failure.  :class:`RetryingClient` wraps stdlib
``urllib`` with exactly that loop:

* retries on 503 envelopes and on transport-level ``URLError``/timeouts,
* sleeps the server's ``Retry-After`` when one is present, else a
  seeded-jitter capped exponential backoff (full jitter: each delay is
  uniform in ``(0, min(cap, base * 2**attempt))``, so a thundering herd
  of shed clients decorrelates),
* gives up after ``retries`` attempts, re-raising/returning the last
  response so callers still see the terminal failure.

No third-party dependency, importable anywhere the repo runs;
``chip_smoke.py`` drives the front door on the card through it.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple


class RetryingClient:
    """Jittered-backoff HTTP client honouring ``Retry-After``.

    ``request`` returns ``(status, headers, payload)``; ``get_json`` /
    ``post_json`` decode the front door's JSON envelopes.  Retries are
    attempted only for 503 and transport errors — anything else (200,
    404, 400 …) is a real answer and returns immediately.
    """

    def __init__(
        self,
        base_url: str,
        retries: int = 5,
        backoff: float = 0.05,
        cap: float = 2.0,
        timeout: float = 30.0,
        seed: Optional[int] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.retries = max(1, int(retries))
        self.backoff = float(backoff)
        self.cap = float(cap)
        self.timeout = float(timeout)
        self._rng = random.Random(seed)
        self.attempts = 0
        self.retried = 0
        self.slept_s = 0.0

    # -- core loop ---------------------------------------------------------
    def _sleep_for(self, attempt: int, retry_after: Optional[str]) -> float:
        if retry_after:
            try:
                return max(0.0, float(retry_after))
            except ValueError:
                pass  # malformed header: fall through to backoff
        return self._rng.uniform(0.0, min(self.cap, self.backoff * (2 ** attempt)))

    def request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        url = self.base_url + path
        last_exc: Optional[Exception] = None
        for attempt in range(self.retries):
            self.attempts += 1
            req = urllib.request.Request(
                url, data=body, method=method, headers=dict(headers or {})
            )
            retry_after = None
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return resp.status, dict(resp.headers), resp.read()
            except urllib.error.HTTPError as e:
                payload = e.read()
                if e.code != 503:
                    return e.code, dict(e.headers), payload
                last_exc = e
                retry_after = e.headers.get("Retry-After")
            except urllib.error.URLError as e:
                last_exc = e
            if attempt + 1 >= self.retries:
                break
            delay = self._sleep_for(attempt, retry_after)
            self.retried += 1
            self.slept_s += delay
            time.sleep(delay)
        if isinstance(last_exc, urllib.error.HTTPError):
            return last_exc.code, dict(last_exc.headers), b""
        raise last_exc if last_exc is not None else RuntimeError("no attempts made")

    # -- JSON conveniences ---------------------------------------------------
    def get_json(self, path: str) -> Dict[str, Any]:
        status, _, payload = self.request("GET", path)
        return self._decode(status, payload)

    def post_json(self, path: str, body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        data = json.dumps(body or {}).encode("utf-8")
        status, _, payload = self.request(
            "POST", path, body=data, headers={"Content-Type": "application/json"}
        )
        return self._decode(status, payload)

    def get_raw(self, path: str) -> Tuple[int, Dict[str, str], bytes]:
        """Raw turn for binary verbs (cutouts return voxel payloads)."""
        return self.request("GET", path)

    def put_raw(
        self, path: str, payload: bytes, headers: Optional[Dict[str, str]] = None
    ) -> Dict[str, Any]:
        status, _, body = self.request("PUT", path, body=payload, headers=headers)
        return self._decode(status, body)

    @staticmethod
    def _decode(status: int, payload: bytes) -> Dict[str, Any]:
        try:
            out = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            out = {"status": status, "raw": payload}
        if isinstance(out, dict):
            out.setdefault("status", status)
            return out
        return {"status": status, "body": out}

    def counters(self) -> Dict[str, float]:
        return {
            "attempts": self.attempts,
            "retried": self.retried,
            "slept_s": self.slept_s,
        }
