"""Client for the sweep-farm HTTP API (stdlib urllib only).

Counterpart of ``repro.serve.client``; it talks to either package's
server.

``ServeClient`` discovers the endpoint from the farm directory's
``serve.json`` (or takes an explicit URL), and maps the server's typed
rejections back to the same exception types the in-process farm
raises -- a caller handles ``QueueFullError`` identically whether it
talks to a ``SweepFarm`` object or a server across a socket.

    client = ServeClient("results/farm")
    jid = client.submit({"spec": spec.to_dict(), "sweeps": 512})
    client.wait([jid], timeout=300)
    print(client.job(jid)["digest"])
"""
from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from typing import List, Optional

from .errors import (AdmissionError, DrainingError, QueueFullError,
                     ServeError)
from .server import ENDPOINT_NAME

#: HTTP status -> the typed exception the in-process farm would raise
_ERRORS = {400: AdmissionError, 429: QueueFullError,
           503: DrainingError}


class ServeClient:
    def __init__(self, directory_or_url: str,
                 timeout: float = 30.0):
        if directory_or_url.startswith("http://") \
                or directory_or_url.startswith("https://"):
            self.base = directory_or_url.rstrip("/")
        else:
            ep = os.path.join(directory_or_url, ENDPOINT_NAME)
            with open(ep) as f:
                d = json.load(f)
            self.base = f"http://{d['host']}:{d['port']}"
        self.timeout = timeout

    def _call(self, method: str, path: str,
              body: Optional[dict] = None) -> dict:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            doc = {}
            try:
                doc = json.loads(e.read())
            except (json.JSONDecodeError, ValueError):
                pass
            exc = _ERRORS.get(e.code, ServeError)
            raise exc(doc.get("detail",
                              f"HTTP {e.code} on {path}")) from e
        except urllib.error.URLError as e:
            raise ServeError(
                f"server unreachable at {self.base}: {e}") from e

    # -- the API -------------------------------------------------------------
    def submit(self, doc: dict) -> str:
        """Submit an envelope (``{"spec":..., "sweeps":...}``) or bare
        RunSpec document; returns the journaled job id."""
        return self._call("POST", "/v1/jobs", doc)["job"]

    def job(self, jid: str) -> dict:
        return self._call("GET", f"/v1/jobs/{jid}")

    def status(self) -> dict:
        return self._call("GET", "/v1/status")

    def drain(self) -> dict:
        """Ask the server to drain (stop admitting, checkpoint the
        in-flight batch, exit 3)."""
        return self._call("POST", "/v1/drain")

    def wait(self, jids: List[str], timeout: float = 300.0,
             poll: float = 0.25) -> List[dict]:
        """Poll until every listed job is terminal; returns their
        final records (order preserved).  Raises on timeout."""
        deadline = time.monotonic() + timeout
        while True:
            docs = [self.job(j) for j in jids]
            if all(d["status"] in ("completed", "failed")
                   for d in docs):
                return docs
            if time.monotonic() > deadline:
                pend = [d["id"] for d in docs
                        if d["status"] not in ("completed", "failed")]
                raise ServeError(
                    f"timeout waiting for jobs {pend}")
            time.sleep(poll)
