"""Prometheus metrics, name-compatible with the reference catalog
(reference docs/prometheus.md:17-43), with their own text exposition.

The port of `gubernator_tpu/metrics.py`. The JAX package renders its
gauges and summaries through prometheus_client; this module keeps the
same catalog and renders the same Prometheus text with no library: a
family's `# HELP` and `# TYPE` lines, the label escaping, a summary's
`_count` / `_sum` with its `_created` gauge family, and the value
format (Go's, `_go_float`). The reference's functional tests poll these
metrics as their synchronization API, so sample names match exactly.

- Counter-style metrics are `_BareCounter`s: exposed under the bare Go
  name (`gubernator_getratelimit_counter`, no `_total`) with a
  `# TYPE <name> counter` line.
- `Gauge` and `Summary` are small registry families (`CollectorRegistry`)
  rendered after the bare counters and the histograms, as the JAX
  package renders its prometheus_client registry after them.
- `render(openmetrics=True)` is valid OpenMetrics (parsed by
  prometheus_client's OpenMetrics parser, `# EOF` last): a bare
  counter's samples end `_total` there, as Go's client writes a counter
  whose name lacks the suffix, and a summary's `_created` samples stay
  in its family. The plain text render is the JAX package's.

Each daemon owns one Metrics (one registry, like the reference's
per-daemon registry, daemon.go:91-103). No device work happens here:
the engine feeds the histograms on the host, and the sync bridges read
host counters and TTL-cached snapshots.
"""

from __future__ import annotations

import logging
import math
import threading
import time

log = logging.getLogger("gubernator_tpu_torch.metrics")

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(doc: str, openmetrics: bool = False) -> str:
    """HELP text escaping: backslash and newline (Prometheus text), and
    the double quote too in OpenMetrics."""
    out = doc.replace("\\", "\\\\").replace("\n", "\\n")
    return out.replace('"', '\\"') if openmetrics else out


def _go_float(d) -> str:
    """A sample value as Go (and prometheus_client) formats it: Python's
    repr, but positive values with more than six integer digits in
    exponent form (1792298183.0 -> 1.792298183e+09)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _label_str(labelnames, key) -> str:
    return ",".join(f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, key))


class _BareChild:
    __slots__ = ("_parent", "_key")

    def __init__(self, parent: "_BareCounter", key: tuple):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1) -> None:
        p = self._parent
        with p._lock:
            p._values[self._key] = p._values.get(self._key, 0.0) + amount

    def set(self, value: float) -> None:
        """Monotonic set — bridges externally-accumulated engine counters
        at scrape time."""
        p = self._parent
        with p._lock:
            p._values[self._key] = float(value)

    def get(self) -> float:
        p = self._parent
        with p._lock:
            return p._values.get(self._key, 0.0)


class _BareCounter:
    """Monotonic counter exposed under its bare Go name with a correct
    `# TYPE <name> counter` line (a `_total` suffix on its samples in
    OpenMetrics only)."""

    def __init__(self, name: str, doc: str, labelnames=()):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._values: dict = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._values[()] = 0.0

    def labels(self, *values) -> _BareChild:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label values"
            )
        return _BareChild(self, tuple(str(v) for v in values))

    # unlabeled convenience (mirrors prometheus_client's API shape)
    def inc(self, amount: float = 1) -> None:
        _BareChild(self, ()).inc(amount)

    def set(self, value: float) -> None:
        _BareChild(self, ()).set(value)

    def render_lines(self, openmetrics: bool = False) -> list:
        out = [f"# HELP {self.name} {_escape_help(self.doc) if openmetrics else self.doc}",
               f"# TYPE {self.name} counter"]
        sample = f"{self.name}_total" if openmetrics else self.name
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            if key:
                out.append(f"{sample}{{{_label_str(self.labelnames, key)}}} {v}")
            else:
                out.append(f"{sample} {v}")
        return out


# -- the registry's families (prometheus_client's Gauge and Summary) ---------


class CollectorRegistry:
    """The Metrics instance's gauge and summary families, rendered in
    registration order. `names` holds every sample name a family
    exposes, as prometheus_client's registry does; a duplicate is a
    registration-time error."""

    def __init__(self):
        self._families: list = []
        self.names: set = set()
        self._lock = threading.Lock()

    def register(self, family) -> None:
        names = family.sample_names()
        with self._lock:
            dup = self.names.intersection(names)
            if dup:
                raise ValueError(f"Duplicated timeseries in CollectorRegistry: {sorted(dup)}")
            self.names.update(names)
            self._families.append(family)

    def families(self) -> list:
        with self._lock:
            return list(self._families)

    def render_lines(self, openmetrics: bool = False) -> list:
        out = []
        for fam in self.families():
            out.extend(fam.render_lines(openmetrics))
        return out


class _Family:
    """A labeled family of children (insertion order, as
    prometheus_client keeps them); an unlabeled family is its one
    child."""

    _type = ""

    def __init__(self, name: str, documentation: str, labelnames=(), registry=None):
        self.name = name
        self.doc = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values):
        if len(values) != len(self.labelnames) or not self.labelnames:
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label values"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _one(self):
        if self.labelnames:
            raise ValueError(f"{self.name}: a labeled metric needs labels()")
        return self._children[()]

    def _items(self) -> list:
        with self._lock:
            return list(self._children.items())

    def _head(self, openmetrics: bool) -> list:
        return [f"# HELP {self.name} {_escape_help(self.doc, openmetrics)}",
                f"# TYPE {self.name} {self._type}"]


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self._value += float(amount)

    def dec(self, amount: float = 1) -> None:
        with self._lock:
            self._value -= float(amount)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Family):
    """A gauge family: `Gauge(name, doc, labelnames, registry=r)`, then
    `inc` / `dec` / `set` on it or on `labels(...)`."""

    _type = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def inc(self, amount: float = 1) -> None:
        self._one().inc(amount)

    def dec(self, amount: float = 1) -> None:
        self._one().dec(amount)

    def set(self, value: float) -> None:
        self._one().set(value)

    def get(self) -> float:
        return self._one().get()

    def sample_names(self) -> list:
        return [self.name]

    def render_lines(self, openmetrics: bool = False) -> list:
        out = self._head(openmetrics)
        for key, child in self._items():
            lbl = f"{{{_label_str(self.labelnames, key)}}}" if key else ""
            out.append(f"{self.name}{lbl} {_go_float(child.get())}")
        return out


class _SummaryChild:
    __slots__ = ("_lock", "count", "sum", "created")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0.0
        self.sum = 0.0
        self.created = time.time()

    def observe(self, amount: float) -> None:
        with self._lock:
            self.count += 1.0
            self.sum += float(amount)

    def get(self) -> tuple:
        with self._lock:
            return self.count, self.sum


class Summary(_Family):
    """A summary family without quantiles (count and sum, as the
    reference's Go summaries render here): `observe` on it or on
    `labels(...)`."""

    _type = "summary"

    def _new_child(self):
        return _SummaryChild()

    def observe(self, amount: float) -> None:
        self._one().observe(amount)

    def sample_names(self) -> list:
        return [self.name, f"{self.name}_count", f"{self.name}_sum",
                f"{self.name}_created"]

    def render_lines(self, openmetrics: bool = False) -> list:
        out = self._head(openmetrics)
        created = []
        for key, child in self._items():
            lbl = f"{{{_label_str(self.labelnames, key)}}}" if key else ""
            count, total = child.get()
            out.append(f"{self.name}_count{lbl} {_go_float(count)}")
            out.append(f"{self.name}_sum{lbl} {_go_float(total)}")
            line = f"{self.name}_created{lbl} {_go_float(child.created)}"
            if openmetrics:
                out.append(line)  # a sample of the summary's own family
            else:
                created.append(line)
        if created:
            # the Prometheus text format has no _created sample: it goes
            # into a gauge family of its own after the summary
            out.append(f"# HELP {self.name}_created {_escape_help(self.doc)}")
            out.append(f"# TYPE {self.name}_created gauge")
            out.extend(created)
        return out


class _HistChild:
    __slots__ = ("_parent", "_key")

    def __init__(self, parent: "Log2Histogram", key: tuple):
        self._parent = parent
        self._key = key

    def observe(self, value: float, trace_id: str = "") -> None:
        self._parent._observe(self._key, value, trace_id)


class Log2Histogram:
    """Fixed-bucket power-of-two histogram, exposed as real Prometheus
    histogram series (`<name>_bucket{le=...}` / `_sum` / `_count`).

    The reference catalog only ships Summaries; histograms are what the
    device tier needs — cross-process aggregatable latency/shape
    distributions for the engine flush path (docs/monitoring.md).
    Bucket upper bounds are `scale * 2**i` for i in [0, n_buckets);
    observe() is O(1) (one frexp + one lock hold, no allocation), cheap
    enough to run per FLUSH / per sync TICK — it is never called per
    request."""

    def __init__(
        self,
        name: str,
        doc: str,
        scale: float = 1.0,
        n_buckets: int = 24,
        labelnames=(),
    ):
        self.name = name
        self.doc = doc
        self.scale = float(scale)
        self.n_buckets = int(n_buckets)
        self.labelnames = tuple(labelnames)
        self._les = [self.scale * (1 << i) for i in range(self.n_buckets)]
        self._lock = threading.Lock()
        # key -> [bucket counts (n_buckets + 1, last = +Inf), sum,
        #         {bucket index -> (trace_id, value, unix_ts) exemplar}]
        # Exemplar memory is bounded: one (the latest) per bucket per
        # label set, populated only when observe() is handed a sampled
        # trace id (docs/monitoring.md "Tracing the pipeline").
        self._series: dict = {}
        if not self.labelnames:
            self._series[()] = [[0] * (self.n_buckets + 1), 0.0, {}]

    def sample_names(self) -> list:
        return [self.name, f"{self.name}_bucket",
                f"{self.name}_sum", f"{self.name}_count"]

    def labels(self, *values) -> _HistChild:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label values"
            )
        return _HistChild(self, tuple(str(v) for v in values))

    def observe(self, value: float, trace_id: str = "") -> None:
        self._observe((), value, trace_id)

    def _bucket_index(self, value: float) -> int:
        if value <= self.scale:
            return 0
        m, e = math.frexp(value / self.scale)  # value/scale = m * 2**e
        i = e - 1 if m == 0.5 else e  # smallest i with value <= scale*2**i
        return min(i, self.n_buckets)  # n_buckets = the +Inf bucket

    def _observe(self, key: tuple, value: float, trace_id: str = "") -> None:
        v = float(value)
        i = self._bucket_index(v)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (self.n_buckets + 1), 0.0, {}]
            s[0][i] += 1
            s[1] += v
            if trace_id:
                s[2][i] = (trace_id, v, time.time())

    def render_lines(self, openmetrics: bool = False) -> list:
        """Prometheus text lines; with openmetrics=True each bucket that
        holds an exemplar gets the OpenMetrics `# {trace_id="..."}`
        suffix (exemplars are an OpenMetrics-only construct — plain
        Prometheus text exposition stays byte-identical to before)."""
        out = [f"# HELP {self.name} {self.doc}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(
                (k, list(s[0]), s[1], dict(s[2]))
                for k, s in self._series.items()
            )
        for key, counts, total, exemplars in items:
            lbl = ",".join(
                f'{n}="{_escape_label(v)}"'
                for n, v in zip(self.labelnames, key)
            )
            sep = "," if lbl else ""
            cum = 0
            for i, (le, c) in enumerate(zip(self._les, counts)):
                cum += c
                line = f'{self.name}_bucket{{{lbl}{sep}le="{le:.12g}"}} {cum}'
                if openmetrics and i in exemplars:
                    tid, v, ts = exemplars[i]
                    line += (
                        f' # {{trace_id="{tid}"}} {v:.9g} {ts:.3f}'
                    )
                out.append(line)
            cum += counts[-1]
            inf_line = f'{self.name}_bucket{{{lbl}{sep}le="+Inf"}} {cum}'
            if openmetrics and self.n_buckets in exemplars:
                tid, v, ts = exemplars[self.n_buckets]
                inf_line += f' # {{trace_id="{tid}"}} {v:.9g} {ts:.3f}'
            out.append(inf_line)
            suffix = f"{{{lbl}}}" if lbl else ""
            out.append(f"{self.name}_sum{suffix} {total}")
            out.append(f"{self.name}_count{suffix} {cum}")
        return out

    def summary(self, qs=(0.5, 0.99)) -> dict:
        """Aggregate distribution summary across all label sets: count,
        sum, and linearly-interpolated quantiles (bench ledger rows and
        the /debug/engine snapshot)."""
        with self._lock:
            counts = [0] * (self.n_buckets + 1)
            total = 0.0
            for buckets, s, _exemplars in self._series.values():
                total += s
                for i, c in enumerate(buckets):
                    counts[i] += c
        n = sum(counts)
        out = {"count": n, "sum": total}
        if n == 0:
            for q in qs:
                out[f"p{int(q * 100)}"] = 0.0
            return out
        for q in qs:
            rank = q * n
            cum = 0
            val = float(self._les[-1] * 2)  # +Inf estimate: one octave up
            for i, c in enumerate(counts):
                if c == 0:
                    continue
                if cum + c >= rank:
                    hi = (
                        self._les[i]
                        if i < self.n_buckets
                        else self._les[-1] * 2
                    )
                    lo = 0.0 if i == 0 else self._les[i - 1]
                    val = lo + (hi - lo) * max(rank - cum, 0.0) / c
                    break
                cum += c
            out[f"p{int(q * 100)}"] = val
        return out

    def label_summaries(self, qs=(0.5, 0.99)) -> dict:
        """Per-label-set summaries: {label_values_tuple: summary_dict}.
        The bench ledger uses this to break the stage-duration histogram
        out per stage instead of blending all stages into one blob."""
        with self._lock:
            keys = list(self._series)
        out = {}
        for key in keys:
            # Reuse summary()'s interpolation over a single series by
            # projecting through a temporary view of the counts.
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    continue
                counts = list(s[0])
                total = s[1]
            n = sum(counts)
            summ = {"count": n, "sum": total}
            for q in qs:
                summ[f"p{int(q * 100)}"] = self._quantile(counts, n, q)
            out[key] = summ
        return out

    def _quantile(self, counts, n, q) -> float:
        if n == 0:
            return 0.0
        rank = q * n
        cum = 0
        val = float(self._les[-1] * 2)
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                hi = self._les[i] if i < self.n_buckets else self._les[-1] * 2
                lo = 0.0 if i == 0 else self._les[i - 1]
                val = lo + (hi - lo) * max(rank - cum, 0.0) / c
                break
            cum += c
        return val


# Log2-ms bin count of the table census (ops/census.py CENSUS_BUCKETS;
# mirrored literally so that this module imports nothing of ops/).
CENSUS_BUCKETS = 32


class CensusSnapshotHistogram:
    """Table-census age/idle distribution as Prometheus histogram series.

    Unlike Log2Histogram this is a SNAPSHOT, not an event stream: each
    census publishes the full per-bin slot counts (how many resident
    slots currently have age/idle in [2^(i-1), 2^i) ms), and render
    replaces — never accumulates — the series. `le` bounds are seconds
    (0.001 * 2**i); the last census bin is the +Inf bucket; `_count` is
    the live slot population and `_sum` the total age/idle seconds.
    Registered through Metrics.register_renderable like the engine's
    Log2Histograms, fed by engine_sync from the TTL-cached census."""

    def __init__(self, name: str, doc: str):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._hist_ms: list = [0] * CENSUS_BUCKETS
        self._sum_ms = 0

    def sample_names(self) -> list:
        return [self.name, f"{self.name}_bucket",
                f"{self.name}_sum", f"{self.name}_count"]

    def update(self, hist_ms, sum_ms) -> None:
        with self._lock:
            self._hist_ms = list(hist_ms)
            self._sum_ms = int(sum_ms)

    def render_lines(self, openmetrics: bool = False) -> list:
        with self._lock:
            counts = list(self._hist_ms)
            total_s = self._sum_ms / 1000.0
        out = [f"# HELP {self.name} {self.doc}",
               f"# TYPE {self.name} histogram"]
        cum = 0
        for i, c in enumerate(counts[:-1]):
            cum += c
            le = 0.001 * (1 << i)
            out.append(f'{self.name}_bucket{{le="{le:.12g}"}} {cum}')
        cum += counts[-1] if counts else 0
        out.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum {total_s}")
        out.append(f"{self.name}_count {cum}")
        return out


# Log2-hit bin count of the admission scan (ops/admission.py
# ADMISSION_BUCKETS; mirrored literally for the same reason).
ADMISSION_BUCKETS = 32


class AdmissionExcessHistogram:
    """Per-window admission-excess distribution as Prometheus histogram
    series. Same snapshot-replace contract as CensusSnapshotHistogram,
    but the `le` bounds are HITS (2**i), not seconds: bucket i counts
    resident keys whose hits-admitted-beyond-limit falls in
    [2^(i-1), 2^i); `_count` is the excess-key population and `_sum`
    the total excess hits. Fed from the TTL-cached admission snapshot
    by engine_sync — a scrape never runs device work."""

    def __init__(self, name: str, doc: str):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._hist: list = [0] * ADMISSION_BUCKETS
        self._sum_hits = 0

    def sample_names(self) -> list:
        return [self.name, f"{self.name}_bucket",
                f"{self.name}_sum", f"{self.name}_count"]

    def update(self, hist, sum_hits) -> None:
        with self._lock:
            self._hist = list(hist)
            self._sum_hits = int(sum_hits)

    def render_lines(self, openmetrics: bool = False) -> list:
        with self._lock:
            counts = list(self._hist)
            total = self._sum_hits
        out = [f"# HELP {self.name} {self.doc}",
               f"# TYPE {self.name} histogram"]
        cum = 0
        for i, c in enumerate(counts[:-1]):
            cum += c
            out.append(f'{self.name}_bucket{{le="{1 << i}"}} {cum}')
        cum += counts[-1] if counts else 0
        out.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum {total}")
        out.append(f"{self.name}_count {cum}")
        return out


class HotKeySketch:
    """Top-K hot-key attribution via a weighted space-saving (Misra-
    Gries) sketch: at most `k` tracked keys, each entry carrying its
    estimated hit count, the over-estimate bound `err` inherited at
    insertion, and an over-limit tally. Guarantees (classic space-
    saving): every key with true weight > total/k is tracked, and each
    entry's estimate overshoots its true weight by at most its `err`
    (<= total/k) — property-tested against an exact counter in
    tests/test_observability.py.

    Updated at the flush boundary where keys are already on host (the
    engine object path's placements and the columnar edge's hash
    columns); keyed by the 128-bit key hash pair so the columnar path
    never has to decode key strings, with display names attached
    opportunistically (object-path requests carry them) and bounded to
    the tracked set. k=0 disables the sketch entirely — update() is one
    attribute read, no allocation."""

    def __init__(self, name: str, doc: str, k: int = 128):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._k = int(k)
        # (hi, lo) -> [count, err, over_limit]
        self._entries: dict = {}
        self._names: dict = {}  # (hi, lo) -> display string (tracked only)
        self._total = 0
        self._resolver = None  # fallback (hi, lo) -> Optional[str]

    @property
    def k(self) -> int:
        return self._k

    def configure(self, k: int) -> None:
        with self._lock:
            self._k = int(k)
            if self._k <= 0:
                self._entries.clear()
                self._names.clear()

    def set_resolver(self, fn) -> None:
        """Fallback display-name resolver ((hi, lo) -> str or None),
        e.g. DeviceEngine.key_string — used at snapshot/render time for
        keys whose strings never crossed an update()."""
        self._resolver = fn

    def update(self, rows) -> None:
        """Apply one flush's aggregated per-key rows:
        [(hi, lo), weight, over_limit_count, name-or-None]. Caller
        pre-aggregates per flush so the O(k) eviction scan runs per
        distinct new key, not per request."""
        if self._k <= 0:
            return
        with self._lock:
            e = self._entries
            k = self._k
            names = self._names
            for key, w, over, name in rows:
                if w <= 0 and not over:
                    continue
                w = max(int(w), 0)
                self._total += w
                ent = e.get(key)
                if ent is not None:
                    ent[0] += w
                    ent[2] += over
                elif len(e) < k:
                    e[key] = [w, 0, over]
                else:
                    # Space-saving eviction: the minimum-count entry is
                    # replaced; the newcomer inherits its count as err.
                    victim = min(e, key=lambda kk: e[kk][0])
                    floor = e[victim][0]
                    del e[victim]
                    names.pop(victim, None)
                    e[key] = [floor + w, floor, over]
                if name is not None and key not in names:
                    names[key] = name

    def _display(self, key, names) -> str:
        """Display name from a names SNAPSHOT (never the live dict: the
        resolver may take the engine key lock, which the flush path
        acquires BEFORE metrics.hotkeys — resolving under our lock
        would invert that order)."""
        name = names.get(key)
        if name is None and self._resolver is not None:
            try:
                name = self._resolver(key[0], key[1])
            except Exception:
                name = None
        return name if name is not None else f"hash:{key[0]:x}:{key[1]:x}"

    def _sorted_copy(self) -> tuple:
        """(entries, names) copied under the lock: entry VALUE lists are
        copied too, so a concurrent update() (or one re-entered through
        the display resolver) can't mutate the rows a snapshot already
        sorted — pre-fix, a /debug/hotkeys row could report more hits
        than the payload's own total_hits."""
        entries = sorted(
            ((key, list(ent)) for key, ent in self._entries.items()),
            key=lambda kv: -kv[1][0],
        )
        return entries, dict(self._names)

    def snapshot(self) -> dict:
        """JSON payload for /debug/hotkeys: entries sorted hottest-
        first, with the sketch's global error bound (total/k)."""
        with self._lock:
            entries, names = self._sorted_copy()
            total = self._total
            k = self._k
        return {
            "k": k,
            "total_hits": total,
            "max_error": (total // k) if k else 0,
            "entries": [
                {
                    "key": self._display(key, names),
                    "key_hash": [key[0], key[1]],
                    "hits": ent[0],
                    "err": ent[1],
                    "over_limit": ent[2],
                }
                for key, ent in entries
            ],
        }

    # -- renderable protocol (Metrics.register_renderable) -------------------

    def sample_names(self) -> list:
        return [self.name]

    def render_lines(self, openmetrics: bool = False) -> list:
        """Top-K gauge series, one per tracked key — cardinality is
        bounded by k by construction (and counts can fall on eviction,
        hence gauge, not counter)."""
        out = [f"# HELP {self.name} {self.doc}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            entries, names = self._sorted_copy()
        for key, ent in entries:
            out.append(
                f'{self.name}'
                f'{{key="{_escape_label(self._display(key, names))}"}} '
                f"{ent[0]}"
            )
        return out

    def summary(self) -> dict:
        """Debug-snapshot shape (the /debug/engine histogram map calls
        summary() on every engine renderable)."""
        with self._lock:
            return {
                "count": len(self._entries),
                "k": self._k,
                "total_hits": self._total,
            }


# The device-tier histogram families (single source of truth: the engine
# tier instantiates exactly these via EngineMetrics, Metrics exposes them
# through register_renderable, and tools/check_metrics_names.py audits
# the names against docs/monitoring.md).
def engine_histograms() -> dict:
    us, cnt = 1e-6, 1.0
    return {
        "flush_duration": Log2Histogram(
            "gubernator_engine_flush_duration",
            "Engine flush wall time in seconds (host assembly + device "
            "waves + response demux), by serving path.",
            scale=us, n_buckets=24, labelnames=("path",),
        ),
        "device_sync": Log2Histogram(
            "gubernator_engine_device_sync_duration",
            "Device wave execution + host materialization time per flush "
            "in seconds, by serving path.",
            scale=us, n_buckets=24, labelnames=("path",),
        ),
        "queue_wait": Log2Histogram(
            "gubernator_engine_queue_wait_duration",
            "Time queue entries waited before a pump flush picked them "
            "up, in seconds.",
            scale=us, n_buckets=24,
        ),
        "flush_waves": Log2Histogram(
            "gubernator_engine_flush_waves",
            "Sequential decide() waves per engine flush.",
            scale=cnt, n_buckets=12,
        ),
        "batch_width": Log2Histogram(
            "gubernator_engine_batch_width",
            "Requests served per engine flush, by serving path.",
            scale=cnt, n_buckets=16, labelnames=("path",),
        ),
        "pipeline_inflight": Log2Histogram(
            "gubernator_engine_pipeline_inflight",
            "In-flight flush tickets observed at each pump dispatch "
            "(dispatched, not yet completed; bounded by "
            "GUBER_PIPELINE_DEPTH — pinned at 1 in serial mode).",
            scale=cnt, n_buckets=6,
        ),
        "pipeline_overlap": Log2Histogram(
            "gubernator_engine_pipeline_overlap_ratio",
            "Per-flush host/device overlap: host dispatch work done for "
            "OTHER flushes while this one was in flight, as a fraction "
            "of its in-flight window (0 = serial pump, ~1 = host encode "
            "fully hidden behind device execution).",
            scale=1 / 256, n_buckets=10,
        ),
        "collective_tick": Log2Histogram(
            "gubernator_collective_tick_duration",
            "Per-flush collective tick wall time in seconds on "
            "multi-device topologies: device execution + host "
            "materialization of the sharded decide, whose psum merge "
            "rendezvouses every shard — one slow shard stretches every "
            "tick (docs/monitoring.md \"SLOs & burn rates\").",
            scale=us, n_buckets=24,
        ),
        "ici_tick_duration": Log2Histogram(
            "gubernator_ici_tick_duration",
            "ICI GLOBAL sync tick wall time in seconds (collective "
            "dispatch + device sync).",
            scale=us, n_buckets=24,
        ),
        "ici_tick_groups": Log2Histogram(
            "gubernator_ici_tick_groups",
            "Groups merged per ICI GLOBAL sync tick.",
            scale=cnt, n_buckets=26,
        ),
        "stage_duration": Log2Histogram(
            "gubernator_engine_stage_duration",
            "Per-stage request-lifecycle latency in seconds, by stage: "
            "intake (submit-side validation until enqueue), assemble "
            "(flush pull to kernel launch), dispatch (async kernel "
            "launch), inflight_wait (dispatched, waiting for the "
            "completion stage), device_sync (host materialization of "
            "device results), resolve (telemetry + write-behind + "
            "future resolution).",
            scale=us, n_buckets=24, labelnames=("stage",),
        ),
        "transfer_duration": Log2Histogram(
            "gubernator_transfer_duration",
            "Accounted host<->device transfer wall time in seconds, by "
            "direction (h2d/d2h) and purpose (serve/snapshot/inject/"
            "warmup/census). d2h materializations block, so their time "
            "is the real copy (+ any compute it waits on); h2d puts are "
            "async on accelerators, so their time is dispatch cost "
            "(utils/transfer.py).",
            scale=us, n_buckets=24, labelnames=("direction", "purpose"),
        ),
        "transfer_bytes": Log2Histogram(
            "gubernator_transfer_bytes",
            "Bytes moved per accounted host<->device transfer, by "
            "direction and purpose — with transfer_duration, the "
            "sustainable-bandwidth envelope the paged table's "
            "promote/demote path will ride (ROADMAP item 1).",
            scale=64.0, n_buckets=26, labelnames=("direction", "purpose"),
        ),
        "hotkeys": HotKeySketch(
            "gubernator_hotkey_hits",
            "Estimated hits for the top-K hottest keys (weighted "
            "space-saving sketch, GUBER_HOTKEYS_K entries max; see "
            "/debug/hotkeys for error bounds and over-limit counts).",
        ),
    }


class Metrics:
    def __init__(self, registry: "CollectorRegistry | None" = None):
        self.registry = registry or CollectorRegistry()
        r = self.registry
        self._bare: list[_BareCounter] = []
        self._renderables: list = []  # Log2Histogram-shaped (render_lines)
        self._claimed: set = set()  # sample names owned outside the registry
        self._sync_fail_counts: dict = {}

        counter = self.bare_counter

        # Core serving metrics (reference gubernator.go:60-111)
        self.getratelimit_counter = counter(
            "gubernator_getratelimit_counter",
            "The count of getLocalRateLimit() calls.",
            ["calltype"],  # local | forward | global
        )
        self.func_duration = Summary(
            "gubernator_func_duration",
            "The timings of key functions in seconds.",
            ["name"],
            registry=r,
        )
        self.over_limit_counter = counter(
            "gubernator_over_limit_counter",
            "The number of rate limit checks that are over the limit. "
            "The bare sample is the engine's total; {path=...} children "
            "split over-limit answers by the serving path that produced "
            "them (decision provenance, docs/monitoring.md "
            '"Admission").',
            ["path"],
        )
        self.concurrent_checks = Gauge(
            "gubernator_concurrent_checks_counter",
            "The number of concurrent GetRateLimits API calls.",
            registry=r,
        )
        self.check_error_counter = counter(
            "gubernator_check_error_counter",
            "The number of errors while checking rate limits.",
            ["error"],
        )

        # Engine (replaces worker-pool metrics, reference gubernator.go:86-93)
        self.worker_queue_length = Gauge(
            "gubernator_worker_queue_length",
            "Requests queued for the device engine.",
            registry=r,
        )
        self.command_counter = counter(
            "gubernator_command_counter",
            "The count of commands processed by the device engine.",
        )

        # Cache (reference lrucache.go:48-59)
        self.cache_access_count = counter(
            "gubernator_cache_access_count",
            "Cache access counts during rate checks.",
            ["type"],  # 'hit' | 'miss'
        )
        self.cache_size = Gauge(
            "gubernator_cache_size",
            "The number of live entries in the counter table.",
            registry=r,
        )
        self.unexpired_evictions = counter(
            "gubernator_unexpired_evictions_count",
            "Count of evictions of unexpired entries (capacity pressure).",
        )

        # Batch behavior (reference gubernator.go:96-110)
        self.batch_send_duration = Summary(
            "gubernator_batch_send_duration",
            "The timings of batch sends to a remote peer in seconds.",
            registry=r,
        )
        self.batch_queue_length = Gauge(
            "gubernator_batch_queue_length",
            "Rate checks queued for batching to remote peers.",
            registry=r,
        )
        self.batch_send_retries = counter(
            "gubernator_batch_send_retries",
            "Retries while forwarding requests to another peer.",
        )

        # Fault domain (docs/robustness.md; no reference analog — the
        # reference burns 5 serial timeouts per request on a dead owner)
        self.circuit_state = Gauge(
            "gubernator_circuit_state",
            "Per-peer circuit breaker state: 0 closed, 1 half-open, "
            "2 open.",
            ["peer"],
            registry=r,
        )
        self.circuit_transitions = counter(
            "gubernator_circuit_transitions",
            "Circuit breaker state transitions, by peer and target state.",
            ["peer", "to"],
        )
        self.degraded_local_answers = counter(
            "gubernator_degraded_local_answers",
            "Forwarded checks answered from local state because the "
            "owner's circuit was open (GUBER_OWNER_UNREACHABLE=local).",
        )
        self.forward_deadline_exceeded = counter(
            "gubernator_forward_deadline_exceeded",
            "Forwarded checks that exhausted their deadline budget "
            "before any peer answered.",
        )
        self.edge_call_timeouts = counter(
            "gubernator_edge_call_timeouts",
            "Edge-tier frame calls that timed out waiting on the device "
            "daemon (edge processes expose this on their own /metrics).",
        )
        self.forward_queue_full = counter(
            "gubernator_forward_queue_full",
            "Forwarded checks shed before leaving this node, by reason: "
            "'queue_full' — the target peer's batch queue was full "
            "(producers never block on a full queue); 'brownout' — the "
            "overload ladder reached degraded-local and answered "
            "locally instead of forwarding.",
            ["reason"],
        )

        # Zero-loss elasticity (docs/robustness.md "Rolling restarts &
        # handover"; no reference analog — the reference accepts counter
        # loss whenever ownership moves)
        self.handover_keys_sent = counter(
            "gubernator_handover_keys_sent",
            "Keys shipped to their new owners during ring-change or "
            "drain handover (TransferSnapshots sender side).",
        )
        self.handover_keys_received = counter(
            "gubernator_handover_keys_received",
            "Handover keys merged into the local table "
            "(TransferSnapshots receiver side, after last-writer-wins).",
        )
        self.handover_keys_dropped = counter(
            "gubernator_handover_keys_dropped",
            "Handover keys NOT transferred, by reason: max_keys (over "
            "GUBER_HANDOVER_MAX_KEYS), circuit_open (target breaker "
            "open), deadline (budget exhausted), send_error (transport "
            "failure), stale (receiver had a newer stamp).",
            ["reason"],
        )
        self.handover_duration = Summary(
            "gubernator_handover_duration",
            "Wall time of one handover pass (snapshot gather + chunked "
            "transfer legs) in seconds.",
            registry=r,
        )

        # Crash-tolerant ownership (docs/robustness.md "Standby
        # replication & crash recovery"; no reference analog — the
        # reference loses every counter an owner holds on hard kill)
        self.standby_loss_bound_hits = Gauge(
            "gubernator_standby_loss_bound_hits",
            "The published hard-kill loss bound: hits dirtied on this "
            "owner since the last ACKED standby delta ship (unacked "
            "pending plus not-yet-drained engine dirt). Killing this "
            "node now loses at most this many hits.",
            registry=r,
        )
        self.standby_keys_shipped = counter(
            "gubernator_standby_keys_shipped",
            "Snapshot rows shipped to ring successors by the standby "
            "replication loop, by mode: delta (dirtied keys), full "
            "(ring-change bootstrap), repair (anti-entropy region "
            "re-ship), legacy (v=1 full-image fallback to a pre-standby "
            "receiver).",
            ["mode"],
        )
        self.standby_ship_errors = counter(
            "gubernator_standby_ship_errors",
            "Standby replication legs that failed, by reason: "
            "circuit_open, deadline, send_error.",
            ["reason"],
        )
        self.standby_shadow_keys = Gauge(
            "gubernator_standby_shadow_keys",
            "Shadow rows this node currently holds for upstream owners "
            "it stands by for (non-serving until promotion).",
            registry=r,
        )
        self.standby_promotions = counter(
            "gubernator_standby_promotions",
            "Standby promotions executed, by reason: breaker_open "
            "(upstream owner's circuit open past "
            "GUBER_STANDBY_PROMOTE_AFTER), ring_removed (owner left the "
            "ring without retiring its shadow).",
            ["reason"],
        )
        self.standby_promoted_keys = counter(
            "gubernator_standby_promoted_keys",
            "Shadow rows replayed at promotion, by destination: local "
            "(merged into this node's table last-writer-wins), "
            "forwarded (shipped to the key's current owner).",
            ["dest"],
        )
        self.standby_anti_entropy_repairs = counter(
            "gubernator_standby_anti_entropy_repairs",
            "Regions re-shipped because the owner/standby digest "
            "exchange found a mismatch (also counted in "
            "gubernator_consistency_divergence kind=standby).",
        )

        # GLOBAL behavior (reference global.go:50-67)
        self.broadcast_duration = Summary(
            "gubernator_broadcast_duration",
            "The timings of GLOBAL broadcasts to peers in seconds.",
            registry=r,
        )
        self.broadcast_counter = counter(
            "gubernator_broadcast_counter",
            "The count of GLOBAL broadcasts.",
        )
        self.global_send_duration = Summary(
            "gubernator_global_send_duration",
            "The timings of GLOBAL hit-update sends to owners in seconds.",
            registry=r,
        )
        self.global_queue_length = Gauge(
            "gubernator_global_queue_length",
            "Requests queued for GLOBAL broadcast.",
            registry=r,
        )
        self.global_send_queue_length = Gauge(
            "gubernator_global_send_queue_length",
            "Requests queued for GLOBAL hit-update send.",
            registry=r,
        )
        # Failure visibility for the async GLOBAL legs: the reference logs
        # every failed send/broadcast leg (global.go:180-186, 278-281);
        # these counters make a persistently failing leg observable at
        # /metrics too.
        self.global_send_errors = counter(
            "gubernator_global_send_errors",
            "Failed GLOBAL hit-update sends to owners.",
        )
        self.global_broadcast_errors = counter(
            "gubernator_global_broadcast_errors",
            "Failed GLOBAL broadcast pushes to peers.",
        )
        self.global_send_dropped = counter(
            "gubernator_global_send_dropped",
            "Aggregated GLOBAL hits dropped from the hit-update queue, "
            "by reason: no_peer (picker raised) or requeue_cap (aged "
            "past the redelivery bound).",
            ["reason"],
        )
        self.global_requeued_hits = counter(
            "gubernator_global_requeued_hits",
            "Aggregated GLOBAL hits merged back into the hit-update "
            "queue after a failed flush leg (redelivered once the "
            "owner recovers).",
        )
        # ICI replica-tier overflow (no reference analog: its owner cache
        # is LRU-unbounded-by-group, lrucache.go; a W-way replica table
        # needs the degraded regime to be observable — see
        # docs/architecture.md "Overflow and drift bounds")
        self.global_overflow_keys = Gauge(
            "gubernator_global_overflow_keys",
            "GLOBAL entries currently degraded to per-replica counting "
            "(owner group full; summed across mesh devices).",
            registry=r,
        )
        self.global_overflow_drops = counter(
            "gubernator_global_overflow_drops_count",
            "Overflow entries dropped at sync under full-group pressure "
            "(local counter and un-synced deltas lost).",
        )
        self.global_sync_backlog = Gauge(
            "gubernator_global_sync_backlog",
            "Active groups beyond the per-tick sync cap "
            "(GUBER_ICI_SYNC_GROUPS) carried to the next tick; sustained "
            "nonzero means GLOBAL convergence is running behind the "
            "sync cadence.",
            registry=r,
        )

        # MULTI_REGION behavior (no reference analog — the reference's
        # RegionPicker ships unimplemented, region_picker.go:19-103;
        # these observe the DCN-tier async replication this framework
        # adds on top: parallel/region_sync.py)
        self.region_send_duration = Summary(
            "gubernator_multiregion_send_duration",
            "The timings of MULTI_REGION hit-delta sends to the home "
            "region in seconds.",
            registry=r,
        )
        self.region_broadcast_duration = Summary(
            "gubernator_multiregion_broadcast_duration",
            "The timings of MULTI_REGION authoritative broadcasts to "
            "other regions in seconds.",
            registry=r,
        )
        self.region_broadcast_counter = counter(
            "gubernator_multiregion_broadcast_counter",
            "The count of MULTI_REGION authoritative broadcasts.",
        )
        self.region_send_errors = counter(
            "gubernator_multiregion_send_errors",
            "Failed MULTI_REGION hit-delta sends to the home region.",
        )
        self.region_broadcast_errors = counter(
            "gubernator_multiregion_broadcast_errors",
            "Failed MULTI_REGION broadcast pushes to other regions.",
        )

        # gRPC stats (reference grpc_stats.go:51-62)
        self.grpc_request_counts = counter(
            "gubernator_grpc_request_counts",
            "The count of gRPC requests.",
            ["method", "status"],
        )
        self.grpc_request_duration = Summary(
            "gubernator_grpc_request_duration",
            "The timings of gRPC requests in seconds.",
            ["method"],
            registry=r,
        )

        # Device-tier telemetry (docs/monitoring.md; no reference analog:
        # the engine below the Go-shaped service tier is this port's
        # addition, and its invariants need first-class observability).
        self.engine_cold_compiles = counter(
            "gubernator_engine_cold_compile_count",
            "Serving-path kernel dispatches that triggered a compile. "
            "The serving path is warmed at startup and must never "
            "compile; nonzero means the invariant broke.",
        )
        # Device-resource observatory (docs/monitoring.md "Device
        # resources"): HBM accounting gauges fed from the engine's
        # device_memory() snapshot at scrape time — real allocator
        # stats on TPU/GPU, the geometry-estimated fallback on CPU
        # (utils/devicemem.py; the snapshot schema is identical).
        self.device_bytes_in_use = Gauge(
            "gubernator_device_bytes_in_use",
            "Device (HBM) bytes in use: the allocator's number when the "
            "backend reports one, else the sum of the subsystem "
            "estimates.",
            registry=r,
        )
        self.device_bytes_limit = Gauge(
            "gubernator_device_bytes_limit",
            "Device memory capacity in bytes (allocator limit, or the "
            "documented single-chip assumption on stat-less backends).",
            registry=r,
        )
        self.device_headroom_bytes = Gauge(
            "gubernator_device_headroom_bytes",
            "Device memory headroom: bytes_limit - bytes_in_use, "
            "floored at 0 — what the paged table can still grow into.",
            registry=r,
        )
        self.device_subsystem_bytes = Gauge(
            "gubernator_device_subsystem_bytes",
            "Estimated resident device bytes attributed to each named "
            "engine subsystem (slot_table, ici_replicas, census, "
            "pipeline_ring, snapshot_staging).",
            ["subsystem"],
            registry=r,
        )
        self.device_unattributed_bytes = Gauge(
            "gubernator_device_unattributed_bytes",
            "Device bytes in use beyond the subsystem attribution "
            "(allocator overhead, temporaries; 0 on the estimated "
            "fallback by construction).",
            registry=r,
        )
        # Compile telemetry (docs/monitoring.md "Device resources"):
        # the JAX package's process-wide compile counters. The port
        # compiles nothing while it serves (its kernels build once, at
        # first use), so these stay 0.
        self.compile_cache_hits = counter(
            "gubernator_compile_cache_hits",
            "Persistent-compilation-cache hits (a compile satisfied by "
            "deserializing a cached executable; utils/compilecache.py).",
        )
        self.compile_count = counter(
            "gubernator_compile_count",
            "XLA backend compiles observed process-wide — cache misses "
            "plus uncached programs (every one is a retrace; see "
            "/debug/device for per-program attribution).",
        )
        self.compile_duration_seconds = counter(
            "gubernator_compile_duration_seconds",
            "Cumulative wall seconds spent in XLA backend compiles.",
        )
        # Decide-kernel backend (docs/monitoring.md "Device resources"):
        # which decide program serves: the hand-written CUDA kernels on
        # a card, torch ops otherwise (the plain version on the CPU, the
        # wide and packed layouts anywhere); and the team kernel's lanes
        # per block.
        self.kernel_backend_info = Gauge(
            "gubernator_kernel_backend",
            "Active decide-kernel backend: 1 for the serving backend "
            "label (cuda = the hand-written Hopper decide kernels, "
            "torch = torch ops: the plain version on the CPU, the wide "
            "and packed layouts on either device), 0 otherwise.",
            ["backend"],
            registry=r,
        )
        self.pallas_block_lanes = Gauge(
            "gubernator_pallas_block_lanes",
            "Lanes per block of the team decide kernel on this engine "
            "(128 threads over the team's width); 0 when the plain "
            "version serves.",
            registry=r,
        )
        self.pallas_tune_cache_hits = counter(
            "gubernator_pallas_tune_cache_hits",
            "Engine boots that reused a persisted Pallas lane-tile "
            "choice (pallas_tune.json beside the compile cache) "
            "instead of re-running autotune trials.",
        )
        self.engine_table_occupancy = Gauge(
            "gubernator_engine_table_occupancy",
            "Fraction of device slot-table slots occupied (0-1), "
            "sampled at scrape time.",
            registry=r,
        )
        self.engine_full_group_ratio = Gauge(
            "gubernator_engine_full_group_ratio",
            "Probe pressure: fraction of slot-table groups with every "
            "way occupied (an insert into a full group must evict).",
            registry=r,
        )
        # Table-census families (docs/monitoring.md "Table census"):
        # residency/coldness/churn telemetry for the paged-table roadmap,
        # fed from the engine's TTL-cached table_census() at scrape time.
        self.table_slots = Gauge(
            "gubernator_table_slots",
            "Total device slot-table capacity in slots (all tiers).",
            registry=r,
        )
        self.table_waste_slots = Gauge(
            "gubernator_table_waste_slots",
            "Expired-but-still-resident slots: used slots whose rate "
            "window has fully elapsed (reclaimable without eviction).",
            registry=r,
        )
        self.table_waste_ratio = Gauge(
            "gubernator_table_waste_ratio",
            "gubernator_table_waste_slots as a fraction of capacity.",
            registry=r,
        )
        self.table_cold_slots = Gauge(
            "gubernator_table_cold_slots",
            "Used slots idle for more than `multiplier` x their own "
            "duration — the cold set a paged table would demote.",
            ["multiplier"],
            registry=r,
        )
        self.table_cold_reclaimable_bytes = Gauge(
            "gubernator_table_cold_reclaimable_bytes",
            "HBM a cold tier would reclaim at this idleness multiplier "
            "(cold slots x bytes_per_slot).",
            ["multiplier"],
            registry=r,
        )
        self.table_heatmap_region_min = Gauge(
            "gubernator_table_heatmap_region_min",
            "Used slots in the least-occupied census heatmap region "
            "(the future page axis; full vector at /debug/table).",
            registry=r,
        )
        self.table_heatmap_region_max = Gauge(
            "gubernator_table_heatmap_region_max",
            "Used slots in the most-occupied census heatmap region.",
            registry=r,
        )
        self.table_max_full_run = Gauge(
            "gubernator_table_max_full_run",
            "Longest run of consecutive completely-full groups (probe "
            "pressure hotspot; inserts there must evict).",
            registry=r,
        )
        self.table_churn_inserts_per_s = Gauge(
            "gubernator_table_churn_inserts_per_s",
            "Census churn ledger: slot insertions per second over the "
            "last census interval.",
            registry=r,
        )
        self.table_churn_evictions_per_s = Gauge(
            "gubernator_table_churn_evictions_per_s",
            "Census churn ledger: unexpired evictions per second over "
            "the last census interval.",
            registry=r,
        )
        self.table_churn_recycles_per_s = Gauge(
            "gubernator_table_churn_recycles_per_s",
            "Census churn ledger: overwrite-recycles per second "
            "(inserts that reclaimed an expired/freed resident slot).",
            registry=r,
        )
        # Paged-table residency (docs/architecture.md "Paged table"):
        # fed from the census snapshot's "pages" section, present only
        # when GUBER_TABLE_PAGE_GROUPS enables paging.
        self.table_page_count = Gauge(
            "gubernator_table_page_count",
            "Paged-table pages by state: resident (bound to a physical "
            "HBM frame), demoted (in the host-DRAM cold tier), free "
            "(unbound physical frames).",
            ["state"],
            registry=r,
        )
        self.table_page_moves = Gauge(
            "gubernator_table_page_moves",
            "Cumulative page residency transitions: demote (d2h "
            "evacuation to the host tier), promote (h2d refill from the "
            "host tier), bind (fresh zeroed frame for a never-resident "
            "page).",
            ["kind"],
            registry=r,
        )
        self.table_page_host_bytes = Gauge(
            "gubernator_table_page_host_bytes",
            "Host-DRAM bytes held by demoted pages (wide slot rows).",
            registry=r,
        )
        self.table_slot_age_seconds = CensusSnapshotHistogram(
            "gubernator_table_slot_age_seconds",
            "Census snapshot: resident slots by age (now - stamp; time "
            "since the counter window was created/updated).",
        )
        self.register_renderable(self.table_slot_age_seconds)
        self.table_slot_idle_seconds = CensusSnapshotHistogram(
            "gubernator_table_slot_idle_seconds",
            "Census snapshot: resident slots by idle time (now - lru; "
            "time since the slot last served a request).",
        )
        self.register_renderable(self.table_slot_idle_seconds)
        self.global_broadcast_keys = Log2Histogram(
            "gubernator_global_broadcast_keys",
            "Keys per GLOBAL authoritative broadcast flush.",
            scale=1.0, n_buckets=16,
        )
        self.register_renderable(self.global_broadcast_keys)
        self.global_send_keys = Log2Histogram(
            "gubernator_global_send_keys",
            "Keys per GLOBAL hit-update flush to owners.",
            scale=1.0, n_buckets=16,
        )
        self.register_renderable(self.global_send_keys)

        # Consistency observatory (docs/monitoring.md "Consistency"; no
        # reference analog — the reference takes GLOBAL reconvergence on
        # faith, global.go has no propagation telemetry at all).
        self.global_propagation_lag = Log2Histogram(
            "gubernator_global_propagation_lag",
            "End-to-end GLOBAL propagation lag in seconds: origin stamp "
            "at the hit's enqueue (one sampled probe per flush) to the "
            "replica applying the owner's broadcast. Cross-node wall "
            "clocks; read alongside gubernator_peer_clock_skew_ms.",
            scale=1e-3, n_buckets=24,
        )
        self.register_renderable(self.global_propagation_lag)
        self.global_sync_leg_duration = Log2Histogram(
            "gubernator_global_sync_leg_duration",
            "Per-leg GLOBAL sync timings in seconds: hit_queue_wait "
            "(enqueue to hit-update flush), owner_apply (owner engine "
            "apply of a relayed batch), broadcast_fanout (owner enqueue "
            "to broadcast push done), replica_inject (replica applying "
            "an UpdatePeerGlobals push).",
            scale=1e-6, n_buckets=24, labelnames=("leg",),
        )
        self.register_renderable(self.global_sync_leg_duration)
        self.global_requeue_age = Log2Histogram(
            "gubernator_global_requeue_age",
            "Redelivery attempts at each GLOBAL hit-update requeue — "
            "pressure before GUBER_GLOBAL_REQUEUE_LIMIT drops begin.",
            scale=1.0, n_buckets=8,
        )
        self.register_renderable(self.global_requeue_age)
        self.consistency_divergence = counter(
            "gubernator_consistency_divergence",
            "Owner-vs-replica divergences found by the background "
            "auditor, by kind: lag (replica missed the owner's last "
            "broadcast past the grace window), "
            "lost (owner key absent at the replica past the grace "
            "window), conflict (transport current and stamps match but "
            "remaining differs).",
            ["kind"],
        )
        self.consistency_max_staleness = Gauge(
            "gubernator_consistency_max_staleness_ms",
            "Max owner-vs-replica staleness (ms) observed in the last "
            "audit pass; falls back toward 0 after reconvergence.",
            registry=r,
        )
        self.peer_clock_skew = Gauge(
            "gubernator_peer_clock_skew_ms",
            "Estimated wall-clock skew to each peer (remote now minus "
            "local RPC midpoint, ms) — the honesty bound for the "
            "stamp-based propagation-lag histogram.",
            ["peer"],
            registry=r,
        )
        self.ici_full_ticks = counter(
            "gubernator_ici_full_ticks",
            "Forced full-table ICI sync ticks (the fingerprint-collision "
            "backstop, every GUBER_ICI_FULL_TICK_EVERY capped ticks).",
        )

        # Cooperative token leases (docs/monitoring.md "Leases";
        # GUBER_LEASES — all zero when leases are off).
        self.lease_grants = counter(
            "gubernator_lease_grants",
            "Lease grant decisions by result: granted, rejected "
            "(ineligible / over limit / table full), revoked (key is "
            "under an active revocation window).",
            ["result"],
        )
        self.lease_hits = counter(
            "gubernator_lease_hits",
            "Lease ledger flows in hit units: granted (carved from the "
            "slot), returned (slice came back — renew or final), "
            "credited (unused tokens restored to the slot), expired "
            "(reclaimed by the sweep or a revocation; unused tokens are "
            "forfeit). Conservation: granted - returned - expired == "
            "outstanding.",
            ["kind"],
        )
        self.lease_outstanding_hits = Gauge(
            "gubernator_lease_outstanding_hits",
            "Hits currently out on lease (granted - returned - expired) "
            "— the fleet-wide over-admission bound during a partition; "
            "its return to 0 after heal is the lease reconvergence "
            "signal (auditor lease pass).",
            registry=r,
        )
        self.lease_revocations = counter(
            "gubernator_lease_revocations",
            "Lease revocations broadcast by this owner (an over-limit "
            "re-read found outstanding slices on the key).",
        )
        self.lease_local_answers = counter(
            "gubernator_lease_local_answers",
            "Checks answered entirely from a local lease slice (zero "
            "RPCs) by a holder-side cache colocated with this registry "
            "(edge tier).",
        )

        # Admission observatory (docs/monitoring.md "Admission"):
        # decision provenance + ground-truth enforcement-error SLIs.
        self.admission_decisions = counter(
            "gubernator_admission_decisions",
            "Rate-limit answers by the serving path that produced them "
            "(owner | replica | degraded_local | lease | fastpath | "
            "forwarded) and resulting status (under_limit | over_limit "
            "| error).",
            ["path", "status"],
        )
        self.admission_excess_ratio = Gauge(
            "gubernator_admission_excess_ratio",
            "Over-admission SLI for this node: hits admitted beyond "
            "configured limits per configured limit hit, from the "
            "TTL-cached admission scan reconciled with the lease "
            "ledger's outstanding slices and this node's un-relayed "
            "GLOBAL hits; falls back to 0 after heal.",
            registry=r,
        )
        self.admission_audit_max_excess_ratio = Gauge(
            "gubernator_admission_audit_max_excess_ratio",
            "Max over-admission ratio seen in the last audit pass "
            "across this owner and the sampled replica (auditor "
            "admission pass); re-set every cycle, so its return to 0 "
            "after heal is the enforcement reconvergence signal.",
            registry=r,
        )
        self.admission_false_over_limit = Gauge(
            "gubernator_admission_false_over_limit_keys",
            "Under-admission SLI: sampled keys the last audit pass saw "
            "refused (OVER_LIMIT) at a transport-current replica while "
            "the owner still had remaining budget; re-set every pass, "
            "falls back to 0 after reconvergence.",
            registry=r,
        )
        self.admission_excess_hits = AdmissionExcessHistogram(
            "gubernator_admission_excess_hits",
            "Per-window excess snapshot: resident keys by hits "
            "admitted beyond their configured limit (log2 hit buckets; "
            "re-published per admission scan — the CURRENT population, "
            "not a cumulative event stream).",
        )
        self.register_renderable(self.admission_excess_hits)

        # SLO observatory (docs/monitoring.md "SLOs & burn rates",
        # service/slo.py): multi-window burn rates per SLO spec, error
        # budget remaining over each spec's budget window, and the
        # alert state machine (0 ok | 1 slow_burn | 2 fast_burn |
        # 3 exhausted). All set by the _slo_sync scrape bridge from the
        # observatory's host-side rings — zero device work.
        self.slo_burn_rate = Gauge(
            "gubernator_slo_burn_rate",
            "Error-budget burn rate per SLO and evaluation window: "
            "bad-event fraction over the window divided by the SLO's "
            "error budget (1 - objective). 1.0 = burning exactly at "
            "budget; the fast-burn alert fires around 14.4x.",
            ["slo", "window"],
            registry=r,
        )
        self.slo_error_budget_remaining = Gauge(
            "gubernator_slo_error_budget_remaining",
            "Fraction of the SLO's error budget left over its budget "
            "window (1.0 = untouched, 0 = exhausted, clamped at 0).",
            ["slo"],
            registry=r,
        )
        self.slo_alert_state = Gauge(
            "gubernator_slo_alert_state",
            "SLO alert state machine: 0 ok, 1 slow_burn (both "
            "slow-burn windows over threshold), 2 fast_burn (both "
            "fast-burn windows over), 3 exhausted (budget fully "
            "burned).",
            ["slo"],
            registry=r,
        )
        # Self-watchdog (runtime/watchdog.py): per-loop stall flags,
        # set by the _slo_sync bridge from the watchdog's heartbeat
        # table. A serving loop's stall also burns the availability
        # SLO — this gauge is the per-loop attribution.
        self.thread_stalled = Gauge(
            "gubernator_thread_stalled",
            "1 when the named long-lived loop's heartbeat is older "
            "than its stall deadline (GUBER_WATCHDOG_STALL_MS + the "
            "loop's declared period), else 0.",
            ["loop"],
            registry=r,
        )
        # Shard-skew attribution (mesh topologies): max/mean imbalance
        # across per-shard decisions / occupancy / resident frames —
        # 1.0 is perfectly balanced; feeds the shard-balance SLO and
        # the future PodSliceTopology placement work (ROADMAP item 1).
        self.shard_imbalance_ratio = Gauge(
            "gubernator_shard_imbalance_ratio",
            "Worst max/mean imbalance across shards of the mesh "
            "(decisions served, census occupancy, resident page "
            "frames); 1.0 = balanced, absent on single-device "
            "topologies.",
            registry=r,
        )

        # Overload control plane (service/overload.py; GUBER_OVERLOAD —
        # docs/robustness.md "Overload control & brownout").
        self.overload_level = Gauge(
            "gubernator_overload_level",
            "Brownout ladder level: 0 normal, 1 shed observability "
            "extras, 2 answer would-be peer forwards locally "
            "(degraded-local), 3 shed heavy-hitter tenants outright.",
            registry=r,
        )
        self.overload_transitions = counter(
            "gubernator_overload_transitions",
            "Brownout ladder transitions, labeled with the level "
            "ENTERED (escalations and recoveries both count).",
            ["level"],
        )
        self.intake_shed_counter = counter(
            "gubernator_intake_shed_counter",
            "Requests refused by the intake governor before any device "
            "work, by reason: queue_full (depth >= GUBER_INTAKE_LIMIT), "
            "deadline_expired (caller deadline passed at admit or "
            "pickup), codel (standing queue above GUBER_INTAKE_TARGET_MS), "
            "tenant (same controller, dominant-tenant multiplier), "
            "brownout (ladder level 3 heavy-tenant shed).",
            ["reason"],
        )

        self._syncs = []

    # -- registration --------------------------------------------------------

    def _claim_names(self, names) -> None:
        """Reject sample names that collide with the registry or with
        already-registered bare counters / renderables: duplicate sample
        names corrupt the scrape (two families with the same name parse
        as one), so collision is a registration-time error, never a
        runtime surprise."""
        existing = set(self._claimed) | set(self.registry.names)
        for n in names:
            if n in existing:
                raise ValueError(
                    f"duplicate metric sample name {n!r}: already "
                    "registered with this Metrics registry"
                )
        self._claimed.update(names)

    def bare_counter(self, name, doc, labels=()) -> _BareCounter:
        """A counter exposed under its bare Go name (see _BareCounter);
        name-guarded against the whole registry."""
        self._claim_names([name])
        c = _BareCounter(name, doc, labels)
        self._bare.append(c)
        return c

    def register_renderable(self, h) -> None:
        """Register an externally-owned series (engine Log2Histograms)
        for exposition through render(); name-guarded like bare
        counters."""
        self._claim_names(h.sample_names())
        self._renderables.append(h)

    def sample_family_names(self) -> set:
        """Every sample FAMILY this Metrics instance exposes — the audit
        surface of docs/monitoring.md."""
        names = {c.name for c in self._bare}
        names |= {h.name for h in self._renderables}
        names |= {f.name for f in self.registry.families()}
        return names

    def add_sync(self, fn) -> None:
        """Register a callback run before each exposition (bridges engine
        counters into the registry at scrape time)."""
        self._syncs.append(fn)

    def sync(self) -> None:
        for i, fn in enumerate(self._syncs):
            try:
                fn(self)
            except Exception:
                # A broken bridge must be diagnosable, not a silent
                # flatline — log the first failure per callback (and
                # every 1000th, in case the cause changes later).
                n = self._sync_fail_counts.get(i, 0) + 1
                self._sync_fail_counts[i] = n
                if n == 1 or n % 1000 == 0:
                    log.exception(
                        "metrics sync callback %r failed (failure %d; "
                        "its series are stale until it recovers)", fn, n,
                    )

    def render(self, openmetrics: bool = False) -> bytes:
        """The exposition: the bare counters, the histograms and the
        sketch, then the registry's gauges and summaries; with
        `openmetrics`, OpenMetrics text ending `# EOF`."""
        self.sync()
        lines = []
        for c in self._bare:
            lines.extend(c.render_lines(openmetrics))
        for h in self._renderables:
            lines.extend(h.render_lines(openmetrics=openmetrics))
        lines.extend(self.registry.render_lines(openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return ("\n".join(lines) + "\n").encode() if lines else b""

    def render_negotiated(self, accept: str = "") -> tuple:
        """(body, content_type) for one scrape, honoring OpenMetrics
        content negotiation: exemplars are an OpenMetrics construct, so
        they render ONLY when the scraper asks for
        application/openmetrics-text (Prometheus does once exemplar
        storage is enabled). Plain scrapes stay byte-stable."""
        if OPENMETRICS_CONTENT_TYPE.split(";")[0] in (accept or ""):
            return self.render(openmetrics=True), OPENMETRICS_CONTENT_TYPE
        return self.render(), CONTENT_TYPE_LATEST

    content_type = CONTENT_TYPE_LATEST


OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

# The port's decide backends, the label values of gubernator_kernel_backend:
# the hand-written kernels on a card, torch ops otherwise.
KERNEL_BACKENDS = ("cuda", "torch")


def engine_sync(engine):
    """Sync callback exporting the engine's counters under the
    reference's cache/worker metric names (reference lrucache.go:48-59,
    gubernator.go:86-93), plus the device-tier gauges (occupancy, probe
    pressure, the table-census families, device memory, the decide
    backend). Table residency reads the engine's TTL-cached
    table_census(): a scrape never triggers device work itself
    (docs/monitoring.md "Table census")."""

    def _sync(m: "Metrics") -> None:
        em = engine.metrics
        m.cache_access_count.labels("hit").set(em.cache_hits)
        m.cache_access_count.labels("miss").set(em.cache_misses)
        m.unexpired_evictions.set(em.unexpired_evictions)
        m.over_limit_counter.set(em.over_limit)
        m.command_counter.set(em.requests)
        m.worker_queue_length.set(engine.queue_depth())
        m.engine_cold_compiles.set(getattr(em, "cold_compiles", 0))
        if hasattr(engine, "table_census"):
            c = engine.table_census()
            m.cache_size.set(c["live"])
            m.engine_table_occupancy.set(c["occupancy"])
            m.engine_full_group_ratio.set(c["full_group_ratio"])
            m.table_slots.set(c["slots"])
            m.table_waste_slots.set(c["waste"])
            m.table_waste_ratio.set(c["waste_frac"])
            for entry in c["cold"]:
                mult = str(entry["multiplier"])
                m.table_cold_slots.labels(mult).set(entry["slots"])
                m.table_cold_reclaimable_bytes.labels(mult).set(
                    entry["reclaimable_bytes"]
                )
            heat = c["heatmap"]
            if heat:
                m.table_heatmap_region_min.set(min(heat))
                m.table_heatmap_region_max.set(max(heat))
            m.table_max_full_run.set(c["max_full_run"])
            churn = c.get("churn") or {}
            m.table_churn_inserts_per_s.set(churn.get("insert_per_s", 0.0))
            m.table_churn_evictions_per_s.set(churn.get("evict_per_s", 0.0))
            m.table_churn_recycles_per_s.set(churn.get("recycle_per_s", 0.0))
            m.table_slot_age_seconds.update(c["age_ms_hist"], c["age_ms_sum"])
            m.table_slot_idle_seconds.update(
                c["idle_ms_hist"], c["idle_ms_sum"]
            )
            # Admission accounting rides the same scrape bridge: the
            # TTL-cached snapshot feeds the excess histogram (the
            # reconciled SLI gauge is set by the service-level sync).
            if hasattr(engine, "admission_snapshot"):
                a = engine.admission_snapshot()
                m.admission_excess_hits.update(
                    a["excess_hist"], a["excess_hits"]
                )
            pages = c.get("pages")
            if pages:
                m.table_page_count.labels("resident").set(pages["resident"])
                m.table_page_count.labels("demoted").set(pages["host"])
                m.table_page_count.labels("free").set(pages["free"])
                m.table_page_moves.labels("demote").set(pages["demotes"])
                m.table_page_moves.labels("promote").set(pages["promotes"])
                m.table_page_moves.labels("bind").set(pages["binds"])
                m.table_page_host_bytes.set(pages["host_bytes"])
        else:
            m.cache_size.set(engine.live_count())
        if hasattr(engine, "shard_stats"):
            # Shard-skew attribution (mesh topologies only): host
            # counters + the ALREADY-CACHED census — shard_stats never
            # scans.
            ss = engine.shard_stats()
            if ss is not None and ss.get("imbalance_ratio") is not None:
                m.shard_imbalance_ratio.set(ss["imbalance_ratio"])
        if hasattr(engine, "overflow_keys"):  # mesh engines only
            m.global_overflow_keys.set(engine.overflow_keys)
            m.global_overflow_drops.set(engine.overflow_drops)
            m.global_sync_backlog.set(getattr(engine, "sync_backlog", 0))
            m.ici_full_ticks.set(getattr(engine, "full_ticks", 0))
        if hasattr(engine, "device_memory"):
            # Host-side arithmetic over static geometry + one allocator
            # stats query — no device program runs.
            d = engine.device_memory()
            m.device_bytes_in_use.set(d["bytes_in_use"])
            m.device_bytes_limit.set(d["bytes_limit"])
            m.device_headroom_bytes.set(d["headroom_bytes"])
            m.device_unattributed_bytes.set(d["unattributed_bytes"])
            for name, b in d["subsystems"].items():
                m.device_subsystem_bytes.labels(name).set(b)
        # The compile families stay 0 (the port compiles nothing while
        # it serves): set, so that they render as the JAX package's do.
        m.compile_cache_hits.set(0)
        m.compile_count.set(0)
        m.compile_duration_seconds.set(0)
        # Decide-backend provenance, pinned on the engine at build time:
        # pure host attribute reads.
        kb = getattr(engine, "kernel_backend", "torch")
        for backend in KERNEL_BACKENDS:
            m.kernel_backend_info.labels(backend).set(
                1 if backend == kb else 0
            )
        m.pallas_block_lanes.set(getattr(engine, "pallas_block", 0) or 0)

    return _sync


def wire_engine_telemetry(metrics: "Metrics", engine) -> None:
    """Attach an engine to a Metrics instance: register its device-tier
    histogram series for exposition and add the scalar sync bridge.
    The daemon's composition root calls this once per engine."""
    em = engine.metrics
    for h in getattr(em, "histograms", lambda: ())():
        metrics.register_renderable(h)
    metrics.add_sync(engine_sync(engine))


def catalog_names() -> set:
    """Every sample family a default-configured daemon can expose at
    /metrics: the Metrics catalog and the engine's histogram families."""
    names = Metrics().sample_family_names()
    names |= {h.name for h in engine_histograms().values()}
    return names
