"""Fabric topologies behind one string-keyed registry.

The fabric model is a first-class :class:`Topology`: core/link identity,
deterministic routing (``route`` / ``route_avoiding``), incidence queries
(``links_of_router`` / ``neighbours``), geometric distance (``hops``), the
EM path matrix (``path_matrix``) and a per-core ``rate_class`` vector of
baseline-capacity multipliers (all-ones on homogeneous fabrics).  Link
indexing is shared by the simulator, the link-level EM detector and the MCG
builder, so a physical link has one identity everywhere.  Links are
directed: ``(u, v)`` with u, v core ids.

Built-in fabrics (registered under the same string-keyed registry idiom as
``core/detectors.py`` and ``mitigate/policy.py``):

``mesh``
    W×H 2-D mesh with directed links between 4-neighbours and XY
    (dimension-ordered) routing — the reference fabric; bit-identical to
    the historical ``Mesh2D``.
``torus``
    The mesh plus wrap-around links in both dimensions.  Routing is
    shortest-direction DOR: X first then Y, each dimension walked in the
    direction with fewer hops, ties broken towards increasing coordinates.
``systolic``
    Unidirectional row/column dataflow links (east and south only, per
    Liu's systolic-array model, arXiv 2311.16594) with edge injection:
    traffic that would have to flow backwards drains off the array edge
    and re-enters at the opposite edge's row/column head, modelled as a
    unidirectional wrap link.
``het``
    The mesh with a heterogeneous ``rate_class`` vector: a
    ``fast<A>slow<B>`` pattern assigns repeating blocks of A full-rate
    cores followed by B half-rate cores (``HET_SLOW_RATE``).

Campaign-facing spec grammar (see :func:`parse_topology_spec`)::

    4 | (4, 4) | "4x4"        -> mesh          (historical spellings)
    "mesh:8x8"                -> mesh
    "torus:8x8"               -> torus
    "systolic:8x8"            -> systolic
    "het:4x4:fast2slow1"      -> het, variant "fast2slow1"
"""

from __future__ import annotations

import re

import numpy as np

# capacity multiplier of a 'slow'-class core on heterogeneous fabrics
HET_SLOW_RATE = 0.5


class Topology:
    """Base fabric: link tables, BFS detours and the EM path matrix.

    Subclasses define the fabric by yielding directed ``(u, v)`` pairs
    from ``_enumerate_links`` (self-loops and duplicates are dropped, so
    degenerate 1- or 2-wide wrap fabrics stay well-formed) and by
    implementing ``route`` and ``hops``.  Everything else — link-id
    bijection, precomputed router incidence, deterministic
    ``route_avoiding`` BFS, ``path_matrix`` — is shared.
    """

    def __init__(self, width: int, height: int | None = None):
        self.width = int(width)
        self.height = int(height if height is not None else width)
        if self.width < 1 or self.height < 1:
            raise ValueError(f"bad fabric dims {self.width}x{self.height}")
        self.n_cores = self.width * self.height
        self._link_ids: dict[tuple[int, int], int] = {}
        links: list[tuple[int, int]] = []
        for u, v in self._enumerate_links():
            if u == v or (u, v) in self._link_ids:
                continue
            self._link_ids[(u, v)] = len(links)
            links.append((u, v))
        self.links: list[tuple[int, int]] = links
        self.n_links = len(links)
        # adjacency in link-id order: _adj[u] = [(v, link_id), ...] — the
        # deterministic exploration order for route_avoiding's BFS.
        self._adj: list[list[tuple[int, int]]] = \
            [[] for _ in range(self.n_cores)]
        # router incidence (in + out, ascending link id), precomputed so
        # links_of_router is O(degree) in the simulator/judge hot loops.
        self._incident: list[list[int]] = [[] for _ in range(self.n_cores)]
        for lid, (u, v) in enumerate(links):
            self._adj[u].append((v, lid))
            self._incident[u].append(lid)
            self._incident[v].append(lid)
        # per-core baseline-capacity multipliers (all-ones when homogeneous)
        self.rate_class: np.ndarray = self._rate_classes()

    # -- fabric definition (subclass hooks) --------------------------------
    def _enumerate_links(self):
        raise NotImplementedError

    def _rate_classes(self) -> np.ndarray:
        return np.ones(self.n_cores, dtype=np.float64)

    def route(self, src: int, dst: int) -> list[int]:
        raise NotImplementedError

    def hops(self, src: int, dst: int) -> int:
        raise NotImplementedError

    # -- coordinates -------------------------------------------------------
    def core_id(self, x: int, y: int) -> int:
        return y * self.width + x

    def coords(self, core: int) -> tuple[int, int]:
        return core % self.width, core // self.width

    def link_id(self, u: int, v: int) -> int:
        return self._link_ids[(u, v)]

    def links_of_router(self, core: int) -> list[int]:
        """All links adjacent to ``core``'s router (in and out)."""
        return list(self._incident[core])

    def neighbours(self, core: int) -> list[int]:
        """Downstream neighbour core ids, ascending (on bidirectional
        fabrics this is the full neighbour set)."""
        return sorted(v for v, _ in self._adj[core])

    def mean_degree(self) -> float:
        """Mean router incidence (in + out links per router)."""
        return 2.0 * self.n_links / max(self.n_cores, 1)

    # -- routing -----------------------------------------------------------
    def route_avoiding(self, src: int, dst: int,
                       avoid: frozenset[int] | set[int]) -> list[int] | None:
        """Shortest link-id path from ``src`` to ``dst`` avoiding ``avoid``.

        Deterministic breadth-first search: neighbours are explored in
        link-id order and each core keeps its first-discovered predecessor,
        so ties between equal-length detours always break the same way.
        Returns ``None`` when ``avoid`` disconnects the pair.
        """
        if src == dst:
            return []
        prev: dict[int, tuple[int, int] | None] = {src: None}
        frontier = [src]
        while frontier and dst not in prev:
            nxt = []
            for u in frontier:
                for v, lid in self._adj[u]:
                    if lid in avoid or v in prev:
                        continue
                    prev[v] = (u, lid)
                    nxt.append(v)
            frontier = nxt
        if dst not in prev:
            return None
        path: list[int] = []
        c = dst
        while prev[c] is not None:
            u, lid = prev[c]        # type: ignore[misc]
            path.append(lid)
            c = u
        path.reverse()
        return path

    def path_matrix(self, pairs: list[tuple[int, int]]) -> np.ndarray:
        """A[e, l] = 1 if event e's route traverses link l (EM's A matrix)."""
        A = np.zeros((len(pairs), self.n_links), dtype=np.float64)
        for i, (s, d) in enumerate(pairs):
            for lid in self.route(s, d):
                A[i, lid] = 1.0
        return A


class Mesh2D(Topology):
    """W×H core mesh with directed links between 4-neighbours and
    deterministic XY (dimension-ordered) routing."""

    def _enumerate_links(self):
        for y in range(self.height):
            for x in range(self.width):
                u = self.core_id(x, y)
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nx_, ny_ = x + dx, y + dy
                    if 0 <= nx_ < self.width and 0 <= ny_ < self.height:
                        yield u, self.core_id(nx_, ny_)

    def route(self, src: int, dst: int) -> list[int]:
        """XY route: walk X first, then Y.  Returns the link-id path."""
        if src == dst:
            return []
        x0, y0 = self.coords(src)
        x1, y1 = self.coords(dst)
        path = []
        x, y = x0, y0
        while x != x1:
            nx_ = x + (1 if x1 > x else -1)
            path.append(self.link_id(self.core_id(x, y),
                                     self.core_id(nx_, y)))
            x = nx_
        while y != y1:
            ny_ = y + (1 if y1 > y else -1)
            path.append(self.link_id(self.core_id(x, y),
                                     self.core_id(x, ny_)))
            y = ny_
        return path

    def hops(self, src: int, dst: int) -> int:
        x0, y0 = self.coords(src)
        x1, y1 = self.coords(dst)
        return abs(x1 - x0) + abs(y1 - y0)


def _wrap_step(cur: int, tgt: int, size: int) -> int:
    """Shortest wrap direction from ``cur`` to ``tgt`` on a ring of
    ``size``: +1 or -1, ties broken towards increasing coordinates."""
    fwd = (tgt - cur) % size
    bwd = (cur - tgt) % size
    return 1 if fwd <= bwd else -1


class Torus2D(Topology):
    """W×H torus: the mesh plus wrap-around links, with deterministic
    shortest-direction dimension-ordered (X then Y) routing."""

    def _enumerate_links(self):
        for y in range(self.height):
            for x in range(self.width):
                u = self.core_id(x, y)
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    yield u, self.core_id((x + dx) % self.width,
                                          (y + dy) % self.height)

    def route(self, src: int, dst: int) -> list[int]:
        if src == dst:
            return []
        x0, y0 = self.coords(src)
        x1, y1 = self.coords(dst)
        path = []
        x, y = x0, y0
        while x != x1:
            nx_ = (x + _wrap_step(x, x1, self.width)) % self.width
            path.append(self.link_id(self.core_id(x, y),
                                     self.core_id(nx_, y)))
            x = nx_
        while y != y1:
            ny_ = (y + _wrap_step(y, y1, self.height)) % self.height
            path.append(self.link_id(self.core_id(x, y),
                                     self.core_id(x, ny_)))
            y = ny_
        return path

    def hops(self, src: int, dst: int) -> int:
        x0, y0 = self.coords(src)
        x1, y1 = self.coords(dst)
        dx, dy = abs(x1 - x0), abs(y1 - y0)
        return min(dx, self.width - dx) + min(dy, self.height - dy)


class Systolic2D(Topology):
    """W×H systolic array: unidirectional east/south dataflow links with
    edge injection.  A transfer that cannot flow forwards drains off the
    right/bottom edge and re-enters at the row/column head — the
    unidirectional wrap link models that drain + re-injection hop."""

    def _enumerate_links(self):
        for y in range(self.height):
            for x in range(self.width):
                u = self.core_id(x, y)
                yield u, self.core_id((x + 1) % self.width, y)
                yield u, self.core_id(x, (y + 1) % self.height)

    def route(self, src: int, dst: int) -> list[int]:
        if src == dst:
            return []
        x0, y0 = self.coords(src)
        x1, y1 = self.coords(dst)
        path = []
        x, y = x0, y0
        while x != x1:
            nx_ = (x + 1) % self.width
            path.append(self.link_id(self.core_id(x, y),
                                     self.core_id(nx_, y)))
            x = nx_
        while y != y1:
            ny_ = (y + 1) % self.height
            path.append(self.link_id(self.core_id(x, y),
                                     self.core_id(x, ny_)))
            y = ny_
        return path

    def hops(self, src: int, dst: int) -> int:
        x0, y0 = self.coords(src)
        x1, y1 = self.coords(dst)
        return (x1 - x0) % self.width + (y1 - y0) % self.height


_HET_PATTERN = re.compile(r"^fast(\d+)slow(\d+)$")


class HetMesh2D(Mesh2D):
    """The mesh fabric with heterogeneous baseline capacities.

    ``pattern`` is ``fast<A>slow<B>``: repeating blocks of A full-rate
    cores followed by B slow-class cores (rate ``HET_SLOW_RATE``), in
    core-id order.
    """

    def __init__(self, width: int, height: int | None = None,
                 pattern: str = "fast1slow1"):
        m = _HET_PATTERN.match(str(pattern))
        if not m or (int(m.group(1)) + int(m.group(2))) == 0:
            raise ValueError(
                f"bad het rate-class pattern {pattern!r}: use 'fast<A>slow<B>'"
                " with A+B >= 1 (e.g. 'fast2slow1')")
        self.pattern = str(pattern)
        self._n_fast, self._n_slow = int(m.group(1)), int(m.group(2))
        super().__init__(width, height)

    def _rate_classes(self) -> np.ndarray:
        period = self._n_fast + self._n_slow
        rates = np.ones(self.n_cores, dtype=np.float64)
        rates[np.arange(self.n_cores) % period >= self._n_fast] = \
            HET_SLOW_RATE
        return rates


class DetourTopology:
    """A fabric whose ``route()`` detours around a set of avoided links.

    Wraps any base :class:`Topology` by delegation: link identities (ids,
    count, ``links_of_router``) are the base fabric's — only path
    selection differs, so the simulator, recorder and detectors keep one
    shared link numbering across the un-mitigated and mitigated
    deployments.  Pairs that the avoided set disconnects fall back to the
    base route (the traffic still has to flow; it just keeps paying the
    slow link).
    """

    def __init__(self, base: Topology, avoid_links=()):
        self.base = base
        self.avoid: frozenset[int] = frozenset(int(l) for l in avoid_links)
        self._route_cache: dict[tuple[int, int], list[int]] = {}

    def __getattr__(self, name):
        return getattr(self.base, name)

    def route(self, src: int, dst: int) -> list[int]:
        if src == dst:
            return []
        key = (src, dst)
        path = self._route_cache.get(key)
        if path is None:
            path = self.base.route_avoiding(src, dst, self.avoid)
            if path is None:
                path = self.base.route(src, dst)
            self._route_cache[key] = path
        return path

    def path_matrix(self, pairs: list[tuple[int, int]]) -> np.ndarray:
        A = np.zeros((len(pairs), self.base.n_links), dtype=np.float64)
        for i, (s, d) in enumerate(pairs):
            for lid in self.route(s, d):
                A[i, lid] = 1.0
        return A


# back-compat spelling: the historical mesh-only detour wrapper
DetourMesh = DetourTopology


# ---------------------------------------------------------------------------
# topology registry (string-keyed, mirroring core/detectors.py)
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}
_BUILTIN_ORDER: list[str] = []


def register_topology(name: str, topo_cls: type, *,
                      overwrite: bool = False) -> None:
    """Register a topology class under a campaign-facing name.

    ``topo_cls(width, height)`` (plus an optional trailing variant
    argument, e.g. ``HetMesh2D``'s rate-class pattern) must build the
    fabric.  Registering an existing name raises unless ``overwrite``.
    """
    key = str(name).lower()
    if not key.isidentifier():
        raise ValueError(f"bad topology name {name!r}: "
                         "use an identifier-like key (no ':' or 'WxH')")
    if not overwrite and key in _REGISTRY and _REGISTRY[key] is not topo_cls:
        raise ValueError(f"topology {key!r} already registered "
                         f"({_REGISTRY[key].__name__})")
    _REGISTRY[key] = topo_cls


def _register_builtin_topology(name: str, topo_cls: type) -> None:
    if _REGISTRY.setdefault(name, topo_cls) is topo_cls \
            and name not in _BUILTIN_ORDER:
        _BUILTIN_ORDER.append(name)


def get_topology(name: str) -> type:
    """Resolve a registered topology class by name (sans variant)."""
    key = str(name).lower().split(":", 1)[0]
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(f"unknown topology {key!r}; available: "
                       f"{available_topologies()}") from None


def available_topologies() -> tuple[str, ...]:
    """Registered topology names, built-ins first, extensions appended in
    registration order."""
    rest = [k for k in _REGISTRY if k not in _BUILTIN_ORDER]
    return tuple(_BUILTIN_ORDER) + tuple(rest)


def build_topology(topology: str, width: int,
                   height: int | None = None) -> Topology:
    """Build a fabric from a ``name`` or ``name:variant`` key and dims.

    ``build_topology('mesh', 4, 4)`` is the historical ``Mesh2D(4, 4)``;
    ``build_topology('het:fast2slow1', 4, 4)`` passes the variant through
    to the registered class.
    """
    name, _, variant = str(topology).lower().partition(":")
    cls = get_topology(name)
    if variant:
        return cls(width, height, variant)
    return cls(width, height)


def _parse_dims(spec: str, what: str) -> tuple[int, int]:
    parts = spec.lower().split("x")
    if len(parts) == 1:
        parts = parts * 2
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise ValueError(f"bad {what} {spec!r}: use 'W' or 'WxH'")
    w, h = (int(p) for p in parts)
    if w < 1 or h < 1:
        raise ValueError(f"bad {what} {spec!r}: dims must be >= 1")
    return w, h


def parse_topology_spec(spec) -> tuple[str, int, int]:
    """Normalise a campaign fabric spec to ``(topology, width, height)``.

    ``topology`` is a registry key, optionally ``name:variant``.  Accepted
    spellings: ``4`` | ``(4, 4)`` | ``'4x4'`` (the historical mesh
    spellings), ``'mesh:8x8'``, ``'torus:8x8'``, ``'systolic:8x8'`` and
    ``'het:4x4:fast2slow1'``.
    """
    if isinstance(spec, str) and ":" in spec:
        name, dims, *variant = (p.strip() for p in spec.split(":"))
        if len(variant) > 1:
            raise ValueError(f"bad topology spec {spec!r}: "
                             "use 'name:WxH' or 'name:WxH:variant'")
        get_topology(name)      # fail fast on unknown names
        w, h = _parse_dims(dims, "topology spec dims")
        topo = name.lower() + (f":{variant[0]}" if variant else "")
        if variant:
            # validate the variant eagerly (e.g. the het rate-class pattern)
            build_topology(topo, 1, 1)
        return topo, w, h
    if isinstance(spec, str):
        return ("mesh",) + _parse_dims(spec, "mesh spec")
    if isinstance(spec, (int, np.integer)):
        if int(spec) < 1:
            raise ValueError(f"bad mesh spec {spec!r}: dims must be >= 1")
        return "mesh", int(spec), int(spec)
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        w, h = (int(p) for p in spec)
        if w < 1 or h < 1:
            raise ValueError(f"bad mesh spec {spec!r}: dims must be >= 1")
        return "mesh", w, h
    raise ValueError(f"bad mesh spec {spec!r}: "
                     "use W, (W, H), 'WxH' or 'name:WxH[:variant]'")


def topology_spec(topology: str, width: int, height: int) -> str:
    """Canonical fabric label for one deployment: ``'mesh:4x4'``,
    ``'torus:8x8'``, ``'het:4x4:fast2slow1'``."""
    name, _, variant = str(topology).partition(":")
    label = f"{name}:{width}x{height}"
    return f"{label}:{variant}" if variant else label


def mesh_mean_degree(width: int, height: int) -> float:
    """Mean router incidence of the same-dims reference mesh — the degree
    baseline that the fabric-aware flag thresholds are calibrated on."""
    n_links = 2 * ((width - 1) * height + width * (height - 1))
    return 2.0 * n_links / max(width * height, 1)


_register_builtin_topology("mesh", Mesh2D)
_register_builtin_topology("torus", Torus2D)
_register_builtin_topology("systolic", Systolic2D)
_register_builtin_topology("het", HetMesh2D)
