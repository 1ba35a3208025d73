"""URL-routed v1 API: the paper's RESTful paths over the verb handlers.

The paper's Web services address data by *path* —

    /<dataset>/cutout/<r>/<x0>,<x1>/<y0>,<y1>/<z0>,<z1>
    /<project>/objects/<id>/boundingbox

— while `repro_torch.cluster.handlers` speaks flat verb strings over request
dicts.  This module is the translation layer, still transport-free: it
parses a ``(method, path)`` pair into ``(verb, params)`` and
:func:`url_dispatch` merges the params into the request dict and routes
through the same ``HANDLERS`` table, so an HTTP shim needs no routing
logic of its own and the old verb-dict :func:`~.handlers.dispatch` shim
and this router can never disagree about behaviour.

Routes (``[/v1]`` prefix optional everywhere; ``<box>`` is one
``<lo>,<hi>`` path segment per axis):

====== ============================================== ======================
method path                                           verb
====== ============================================== ======================
GET    /<dataset>/cutout/<r>/<box...>                 GET /cutout
PUT    /<dataset>/cutout/<r>/<box...>                 PUT /cutout
GET    /<dataset>/(xy|xz|yz)/<r>/<box...>             GET /projection
GET    /<project>/objects/<id>/boundingbox[/<r>]      GET /objects/boundingbox
GET    /<project>/objects/<id>/cutout[/<r>[/<box...>]] GET /objects/cutout
POST   /<dataset>/batch/cutout                        POST /batch/cutout
POST   /<dataset>/flush  (or bare /flush)             POST /flush
POST   /<dataset>/compact  (or bare /compact)         POST /compact
GET    /<dataset>/stats                               GET /stats
GET    /<dataset>/metrics  (or bare /metrics)         GET /metrics
GET    /trace/<id>                                    GET /trace
GET    /<dataset>/topology                            GET /topology
POST   /<dataset>/rebalance                           POST /rebalance
POST   /<dataset>/nodes                               POST /nodes/add
DELETE /<dataset>/nodes/<i>                           POST /nodes/remove
====== ============================================== ======================

Errors follow the uniform envelope: 404 for an unroutable path (or an
unknown dataset, from the handler), 400 for a malformed resolution/box,
405 for a known resource with the wrong method.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .handlers import HANDLERS, Request, Response, VolumeService, _error

# Planes are named from the paper's tile service; the projected axis is
# the one *missing* from the plane name (axes ordered x=0, y=1, z=2).
_PLANE_AXIS = {"xy": 2, "xz": 1, "yz": 0}


class ApiError(Exception):
    """A path that cannot be routed; carries the envelope status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _int(text: str, what: str) -> int:
    try:
        return int(text)
    except ValueError:
        raise ApiError(400, f"bad {what} {text!r} (expected an integer)") from None


def _parse_box(parts: List[str]) -> Tuple[List[int], List[int]]:
    """``["x0,x1", "y0,y1", ...]`` -> (lo, hi), one segment per axis."""
    if not parts:
        raise ApiError(400, "missing box (expected <lo>,<hi> per axis)")
    lo, hi = [], []
    for seg in parts:
        pieces = seg.split(",")
        if len(pieces) != 2:
            raise ApiError(400, f"bad box segment {seg!r} (expected <lo>,<hi>)")
        a, b = (_int(p, "box bound") for p in pieces)
        if a > b:
            raise ApiError(400, f"bad box segment {seg!r} (lo > hi)")
        lo.append(a)
        hi.append(b)
    return lo, hi


def parse_url(method: str, path: str) -> Tuple[str, Request]:
    """Parse a ``(method, path)`` pair into ``(verb, params)``.

    Raises :class:`ApiError` with 404 (no such route) or 400 (malformed
    resolution / box / id).  The query string is the caller's problem —
    strip it first and merge its values into the request dict.
    """
    method = method.upper()
    parts = [p for p in path.split("/") if p]
    if parts and parts[0] == "v1":
        parts = parts[1:]
    if not parts:
        raise ApiError(404, "no route for /")

    if parts in (["flush"], ["compact"]):
        if method != "POST":
            raise ApiError(405, f"{method} not allowed on /{parts[0]}")
        return f"POST /{parts[0]}", {}

    # Observability surface.  Bare /metrics scrapes every dataset (the
    # Prometheus convention); /trace is cluster-wide by construction —
    # the span ring is per-process, not per-dataset.
    if parts[0] == "metrics" and len(parts) == 1:
        if method != "GET":
            raise ApiError(405, f"{method} not allowed on /metrics")
        return "GET /metrics", {}
    if parts[0] == "trace":
        if method != "GET":
            raise ApiError(405, f"{method} not allowed on /trace")
        if len(parts) != 2:
            raise ApiError(404, "trace needs /trace/<id>")
        return "GET /trace", {"trace": parts[1]}

    name, rest = parts[0], parts[1:]
    if not rest:
        raise ApiError(404, f"no route for /{name}")
    head = rest[0]

    if head == "cutout":
        if method not in ("GET", "PUT"):
            raise ApiError(405, f"{method} not allowed on cutout")
        if len(rest) < 2:
            raise ApiError(400, "cutout needs /<resolution>/<box...>")
        lo, hi = _parse_box(rest[2:])
        return (
            f"{method} /cutout",
            {"dataset": name, "resolution": _int(rest[1], "resolution"), "lo": lo, "hi": hi},
        )

    if head in _PLANE_AXIS:
        if method != "GET":
            raise ApiError(405, f"{method} not allowed on {head} projection")
        if len(rest) < 2:
            raise ApiError(400, f"{head} projection needs /<resolution>/<box...>")
        lo, hi = _parse_box(rest[2:])
        return (
            "GET /projection",
            {
                "dataset": name,
                "resolution": _int(rest[1], "resolution"),
                "lo": lo,
                "hi": hi,
                "axis": _PLANE_AXIS[head],
            },
        )

    if head == "objects":
        if len(rest) < 3:
            raise ApiError(404, f"no route for /{name}/objects (need /<id>/<query>)")
        if method != "GET":
            raise ApiError(405, f"{method} not allowed on objects")
        params: Request = {"project": name, "id": _int(rest[1], "object id")}
        query = rest[2]
        if query == "boundingbox":
            if len(rest) > 4:
                raise ApiError(404, f"no route for trailing {'/'.join(rest[4:])!r}")
            if len(rest) == 4:
                params["resolution"] = _int(rest[3], "resolution")
            return "GET /objects/boundingbox", params
        if query == "cutout":
            if len(rest) >= 4:
                params["resolution"] = _int(rest[3], "resolution")
            if len(rest) >= 5:
                params["lo"], params["hi"] = _parse_box(rest[4:])
            return "GET /objects/cutout", params
        raise ApiError(404, f"no route for objects query {query!r}")

    if head == "batch":
        if rest[1:] != ["cutout"]:
            raise ApiError(404, f"no route for /{name}/batch/{'/'.join(rest[1:])}")
        if method != "POST":
            raise ApiError(405, f"{method} not allowed on batch/cutout")
        return "POST /batch/cutout", {"dataset": name}

    if head == "nodes":
        if method == "POST" and len(rest) == 1:
            return "POST /nodes/add", {"dataset": name}
        if method == "DELETE" and len(rest) == 2:
            return "POST /nodes/remove", {"dataset": name, "node": _int(rest[1], "node index")}
        raise ApiError(405, f"{method} /{'/'.join(parts)} not allowed on nodes")

    if head in ("stats", "metrics", "topology", "flush", "compact", "rebalance") and len(rest) == 1:
        expected = "POST" if head in ("flush", "compact", "rebalance") else "GET"
        if method != expected:
            raise ApiError(405, f"{method} not allowed on {head} (use {expected})")
        return f"{expected} /{head}", {"dataset": name}

    raise ApiError(404, f"no route for {method} /{'/'.join(parts)}")


def url_dispatch(
    service: VolumeService,
    method: str,
    path: str,
    request: Optional[Request] = None,
) -> Response:
    """Route one request by URL path (the v1 contract).

    Path-derived params override the request dict (the path *is* the
    address); everything else — payload, ``encode``, ``level``,
    ``channel``, ``sync`` — rides in ``request``.  Always returns the
    uniform ``{status, error?, ...}`` envelope, never raises for a bad
    route or bad input.
    """
    try:
        verb, params = parse_url(method, path)
    except ApiError as e:
        return _error(e.status, e.message)
    merged: Dict[str, Any] = dict(request or {})
    merged.update(params)
    return HANDLERS[verb](service, merged)
