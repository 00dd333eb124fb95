"""Fleet-wide SLO verdict engine: scrape every node, judge one verdict.
The port of celestia_app_tpu/tools/fleetmon.py (host code, copied).

The observability plane produces numbers per node (/metrics,
/consensus/status, /das/availability); nothing so far judges the FLEET.
This tool closes that loop the way the reference's testnet tooling
asserts on scraped Prometheus state after an e2e run: scrape every node
of a devnet (or adapt an in-process sim registry), merge per metric
family, and evaluate a declarative SLO rule file into ONE deterministic
verdict JSON — counter pins (``edscache.host_crossings == 0``,
``commitment.recomputes == 0`` on warmed nodes), p99 latency budgets
(histogram buckets re-quantiled with the registry's own ladder), gauge
ceilings (open breakers), and status-document field checks.

Three layers, split so the verdict is reproducible:

- **Scrape adapters** (non-deterministic edge): ``scrape_fleet(urls)``
  pulls the Prometheus text exposition + status docs over HTTP and
  parses them back into metric families; ``registry_node(base=…)``
  builds the same shape straight from the in-process telemetry registry
  (``telemetry.export()``), optionally as a DELTA against a baseline
  export — the sim scenario op uses that so telemetry accumulated by
  earlier cells in the same process never leaks into a verdict.
- **The rule evaluator** (pure): ``evaluate(rules, fleet)`` is a
  deterministic function of its inputs — no clocks, no rounding noise
  (values round to 9 places), rule order preserved, node labels sorted.
  Two calls against the same fleet state produce byte-identical
  ``verdict_bytes``.
- **The CLI** (``python -m
  celestia_app_tpu_torch.tools.fleetmon``): prints the verdict JSON and exits
  0 on pass, 2 on SLO violation — CI wires it after a devnet soak.

Rule file: JSON ``{"slo": [rule, …]}`` (a bare list also works). Each
rule (docs/FORMATS.md §22.1):

    {"name":   "no-unmediated-crossings",     # verdict key, required
     "source": "metrics",                     # metrics|status|availability
     "metric": "edscache.host_crossings",     # dotted registry name
     "kind":   "counter",                     # counter|gauge|p50|p95|p99|
                                              #   count|sum|max (timer kinds)
     "labels": {"site": "edscache.eds"},      # optional label selector
     "op": "==", "value": 0,                  # comparison
     "agg": "each"}                           # each|sum|max|min across nodes

``source: "status"`` / ``"availability"`` rules use ``"path"`` (a dotted
path into the scraped JSON document, e.g. ``"reactor.height"``) instead
of metric/kind. Absent counters/histograms evaluate as 0 — in this
registry absence means never incremented. An unreachable node fails
every ``each`` rule (observed ``null``), which is the right default for
an SLO: a node you cannot see is a node out of budget.
"""

from __future__ import annotations

import json
import re

from celestia_app_tpu_torch.utils.telemetry import (
    BUCKET_BOUNDS,
    _quantile,
)

PREFIX = "celestia"
SCHEMA = "fleetmon/1"

_OPS = ("==", "!=", "<=", "<", ">=", ">")
_KINDS = ("counter", "gauge", "p50", "p95", "p99", "count", "sum", "max")
_AGGS = ("each", "sum", "max", "min")
_SOURCES = ("metrics", "status", "availability")

#: le label values in the exposition, in ladder order (telemetry formats
#: bounds with %.9g); index of a bucket line is looked up here
_LE_INDEX = {f"{b:.9g}": i for i, b in enumerate(BUCKET_BOUNDS)}
_LE_INDEX["+Inf"] = len(BUCKET_BOUNDS)

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _san(name: str) -> str:
    """The registry's family-name sanitizer (dots -> underscores): rule
    metric names and exposition family names meet in this space."""
    return "".join(ch if ch.isalnum() or ch == "_" else "_"
                   for ch in name)


def _label_str(labels: dict) -> str:
    return ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))


def _parse_labels(inner: str) -> dict:
    return {m.group(1): m.group(2) for m in _LABEL_RE.finditer(inner)}


def _empty_node() -> dict:
    return {"counter": {}, "gauge": {}, "hist": {}}


def _hist_cell(fam: dict, label_str: str) -> dict:
    return fam.setdefault(label_str, {
        "buckets": [0] * (len(BUCKET_BOUNDS) + 1),
        "count": 0, "sum": 0.0, "max": 0.0,
    })


# ---------------------------------------------------------------------------
# scrape adapters
# ---------------------------------------------------------------------------

def parse_prometheus(text: str, prefix: str = PREFIX) -> dict:
    """Parse the registry's own text exposition back into metric
    families: {"counter"|"gauge": {family: {label_str: value}},
    "hist": {family: {label_str: {"buckets": per-bucket counts,
    "count": n, "sum": s, "max": m}}}} — family names sanitized
    (underscores), suffix/prefix stripped, cumulative bucket lines
    de-cumulated so quantiles recompute with the registry's ladder."""
    out = _empty_node()
    types: dict[str, str] = {}   # exposition metric name -> type
    p = prefix + "_"
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, typ = line.split(None, 3)
            types[name] = typ
            continue
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            name, inner = line[:brace], line[brace + 1:close]
            value = line[close + 1:].strip()
        else:
            name, _sp, value = line.partition(" ")
            inner = ""
        try:
            v = float(value)
        except ValueError:
            continue
        labels = _parse_labels(inner)
        # histogram member lines carry the base-name suffixes
        base, suffix = name, ""
        for s in ("_bucket", "_sum", "_count"):
            if name.endswith(s) and types.get(name[:-len(s)]) == "histogram":
                base, suffix = name[:-len(s)], s
                break
        typ = types.get(base)
        if typ == "histogram" and base.startswith(p) \
                and base.endswith("_seconds"):
            fam = base[len(p):-len("_seconds")]
            le = labels.pop("le", None)
            cell = _hist_cell(out["hist"].setdefault(fam, {}),
                              _label_str(labels))
            if suffix == "_bucket" and le in _LE_INDEX:
                # exposition is cumulative; store and de-cumulate below
                cell["buckets"][_LE_INDEX[le]] = int(v)
            elif suffix == "_sum":
                cell["sum"] = v
            elif suffix == "_count":
                cell["count"] = int(v)
        elif typ == "counter" and name.startswith(p) \
                and name.endswith("_total"):
            fam = name[len(p):-len("_total")]
            out["counter"].setdefault(fam, {})[_label_str(labels)] = v
        elif typ == "gauge" and name.startswith(p):
            gname = name[len(p):]
            if gname.endswith("_seconds_max"):
                # the per-timer max rides a separate gauge family; fold
                # it back into its histogram cell
                fam = gname[:-len("_seconds_max")]
                cell = _hist_cell(out["hist"].setdefault(fam, {}),
                                  _label_str(labels))
                cell["max"] = v
            else:
                out["gauge"].setdefault(gname, {})[_label_str(labels)] = v
    for fam in out["hist"].values():
        for cell in fam.values():
            cum, per = 0, []
            for c in cell["buckets"]:
                per.append(max(int(c) - cum, 0))
                cum = max(cum, int(c))
            cell["buckets"] = per
    return out


def registry_node(base: dict | None = None) -> dict:
    """Build one node's metric families straight from the in-process
    registry (`telemetry.export()`), bypassing HTTP. With `base` (a
    prior `telemetry.export()`), counters and histograms are the DELTA
    since that export — the sim scenario op pins rules against only the
    activity of ITS run. Gauges (and timer max) stay absolute: they are
    levels, not flows."""
    from celestia_app_tpu_torch.utils import telemetry

    exp = telemetry.export()
    series = exp["series"]
    base = base or {"counters": {}, "gauges": {}, "timers": {}}

    def split(key: str) -> tuple[str, str]:
        if key in series:
            name, labels = series[key]
            return _san(name), _label_str(labels)
        return _san(key), ""

    out = _empty_node()
    for key, v in exp["counters"].items():
        fam, ls = split(key)
        d = v - base["counters"].get(key, 0)
        out["counter"].setdefault(fam, {})[ls] = float(d)
    for key, v in exp["gauges"].items():
        fam, ls = split(key)
        out["gauge"].setdefault(fam, {})[ls] = float(v)
    for key, t in exp["timers"].items():
        fam, ls = split(key)
        b0 = base["timers"].get(key)
        cell = _hist_cell(out["hist"].setdefault(fam, {}), ls)
        if b0 is None:
            cell["buckets"] = list(t["buckets"])
            cell["count"], cell["sum"] = t["count"], t["total_s"]
        else:
            cell["buckets"] = [a - b for a, b in
                               zip(t["buckets"], b0["buckets"])]
            cell["count"] = t["count"] - b0["count"]
            cell["sum"] = t["total_s"] - b0["total_s"]
        cell["max"] = t["max_s"]
    return out


def scrape_node(url: str, client=None, with_availability: bool = True) -> dict:
    """One node's fleet-state entry: parsed /metrics (required — an
    unparseable node yields metrics None and fails its rules), the
    status doc (/consensus/status, node /status fallback), and the
    /das/availability record at the status height (both optional)."""
    from celestia_app_tpu_torch.net import transport

    client = client or transport.DEFAULT
    url = url.rstrip("/")
    node: dict = {"metrics": None, "status": None, "availability": None}
    try:
        body = client.get(url, "/metrics", raw=True)
        node["metrics"] = parse_prometheus(body.decode("utf-8", "replace"))
    except Exception as e:  # noqa: BLE001 — any scrape failure = node dark
        node["error"] = type(e).__name__
        return node
    for path in ("/consensus/status", "/status"):
        try:
            node["status"] = client.get(url, path)
            break
        except Exception:  # noqa: BLE001
            continue
    if with_availability and isinstance(node["status"], dict):
        h = node["status"].get("height")
        if isinstance(h, int) and h > 0:
            try:
                node["availability"] = client.get(
                    url, f"/das/availability?height={h}")
            except Exception:  # noqa: BLE001
                pass
    return node


def scrape_fleet(urls: list[str], client=None,
                 with_availability: bool = True) -> dict:
    """{"nodes": {url: node_state}} for every given node URL."""
    return {"nodes": {
        u.rstrip("/"): scrape_node(u, client=client,
                                   with_availability=with_availability)
        for u in urls
    }}


# ---------------------------------------------------------------------------
# the rule evaluator (pure, deterministic)
# ---------------------------------------------------------------------------

def normalize_rules(doc) -> list[dict]:
    """Validate + default-fill a rule file ({"slo": [...]} or a bare
    list). Raises ValueError on a malformed rule — a typo'd SLO file
    must fail loudly, not pass vacuously."""
    rules = doc.get("slo") if isinstance(doc, dict) else doc
    if not isinstance(rules, list) or not rules:
        raise ValueError("rule file needs a non-empty 'slo' rule list")
    out = []
    for i, r in enumerate(rules):
        if not isinstance(r, dict) or "name" not in r:
            raise ValueError(f"rule #{i}: not a dict with a 'name'")
        rule = {
            "name": str(r["name"]),
            "source": r.get("source", "metrics"),
            "op": r.get("op", "=="),
            "value": r.get("value", 0),
            "agg": r.get("agg", "each"),
        }
        if rule["source"] not in _SOURCES:
            raise ValueError(f"rule {rule['name']}: unknown source "
                             f"{rule['source']!r}")
        if rule["op"] not in _OPS:
            raise ValueError(f"rule {rule['name']}: unknown op "
                             f"{rule['op']!r}")
        if rule["agg"] not in _AGGS:
            raise ValueError(f"rule {rule['name']}: unknown agg "
                             f"{rule['agg']!r}")
        if not isinstance(rule["value"], (int, float)) \
                or isinstance(rule["value"], bool):
            raise ValueError(f"rule {rule['name']}: value must be a number")
        if rule["source"] == "metrics":
            if "metric" not in r:
                raise ValueError(f"rule {rule['name']}: metrics rules "
                                 "need 'metric'")
            rule["metric"] = str(r["metric"])
            rule["kind"] = r.get("kind", "counter")
            if rule["kind"] not in _KINDS:
                raise ValueError(f"rule {rule['name']}: unknown kind "
                                 f"{rule['kind']!r}")
            labels = r.get("labels")
            if labels is not None:
                if not isinstance(labels, dict):
                    raise ValueError(f"rule {rule['name']}: labels must "
                                     "be a dict")
                rule["labels"] = {str(k): str(v)
                                  for k, v in labels.items()}
        else:
            if "path" not in r:
                raise ValueError(f"rule {rule['name']}: {rule['source']} "
                                 "rules need 'path'")
            rule["path"] = str(r["path"])
        out.append(rule)
    return out


def _labels_match(label_str: str, sel: dict) -> bool:
    have = _parse_labels(label_str)
    return all(have.get(k) == v for k, v in sel.items())


def _path_get(doc, path: str):
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return cur


def _round(v: float):
    """Canonical numeric form for the verdict: ints stay ints, floats
    round to 9 places (kills accumulation-order repr noise)."""
    if isinstance(v, int):
        return v
    r = round(v, 9)
    return int(r) if r == int(r) else r


def _node_value(rule: dict, node: dict):
    """One rule's observed value on one node; None = unobservable
    (dark node, missing status field) which fails the rule."""
    if rule["source"] != "metrics":
        doc = node.get(rule["source"])
        v = _path_get(doc, rule["path"]) if doc is not None else None
        return None if v is None else _round(v)
    m = node.get("metrics")
    if m is None:
        return None
    fam = _san(rule["metric"])
    sel = rule.get("labels") or {}
    kind = rule["kind"]
    if kind in ("counter", "gauge"):
        table = m["counter" if kind == "counter" else "gauge"].get(fam, {})
        # absent family = never written = 0 in this registry; labeled
        # series matching the selector sum into one observed value
        return _round(sum(v for ls, v in table.items()
                          if _labels_match(ls, sel)))
    cells = [c for ls, c in m["hist"].get(fam, {}).items()
             if _labels_match(ls, sel)]
    if kind == "count":
        return _round(sum(c["count"] for c in cells))
    if kind == "sum":
        return _round(sum(c["sum"] for c in cells))
    if kind == "max":
        return _round(max((c["max"] for c in cells), default=0.0))
    q = {"p50": 0.5, "p95": 0.95, "p99": 0.99}[kind]
    buckets = [0] * (len(BUCKET_BOUNDS) + 1)
    count = 0
    for c in cells:
        count += c["count"]
        for i, n in enumerate(c["buckets"]):
            buckets[i] += n
    return _round(_quantile(buckets, count, q))


def _cmp(op: str, observed, target) -> bool:
    if observed is None:
        return False
    if op == "==":
        return abs(observed - target) < 1e-9
    if op == "!=":
        return abs(observed - target) >= 1e-9
    if op == "<=":
        return observed <= target
    if op == "<":
        return observed < target
    if op == ">=":
        return observed >= target
    return observed > target


def evaluate(rules: list[dict], fleet: dict) -> dict:
    """The deterministic core: normalized rules x fleet state -> one
    verdict dict. Carries no clocks or scrape metadata, so two
    evaluations of the same fleet state are byte-identical through
    `verdict_bytes`."""
    nodes = fleet.get("nodes", {})
    labels = sorted(nodes)
    out_rules = []
    failed = []
    for rule in rules:
        observed = {lbl: _node_value(rule, nodes[lbl]) for lbl in labels}
        row = {k: v for k, v in rule.items()}
        row["observed"] = observed
        if rule["agg"] == "each":
            row["pass"] = bool(labels) and all(
                _cmp(rule["op"], observed[lbl], rule["value"])
                for lbl in labels)
        else:
            vals = [observed[lbl] for lbl in labels]
            if not vals or any(v is None for v in vals):
                agg_v = None
            elif rule["agg"] == "sum":
                agg_v = _round(sum(vals))
            elif rule["agg"] == "max":
                agg_v = _round(max(vals))
            else:
                agg_v = _round(min(vals))
            row["aggregate"] = agg_v
            row["pass"] = _cmp(rule["op"], agg_v, rule["value"])
        if not row["pass"]:
            failed.append(rule["name"])
        out_rules.append(row)
    return {
        "schema": SCHEMA,
        "nodes": labels,
        "dark_nodes": sorted(lbl for lbl in labels
                             if nodes[lbl].get("metrics") is None),
        "rules": out_rules,
        "failed": failed,
        "pass": not failed and bool(labels),
    }


def verdict_bytes(verdict: dict) -> bytes:
    """Canonical byte form — the determinism contract: same fleet state
    in, same bytes out."""
    return json.dumps(verdict, sort_keys=True,
                      separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """`fleetmon --nodes url1,url2 --rules slo.json` — scrape, judge,
    print the verdict JSON; exit 0 pass / 2 SLO violation / 1 usage."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="fleetmon")
    ap.add_argument("--nodes", required=True,
                    help="comma-separated node/validator service URLs")
    ap.add_argument("--rules", required=True,
                    help="SLO rule file (JSON, FORMATS §22.1)")
    ap.add_argument("--no-availability", action="store_true",
                    help="skip the /das/availability scrape")
    ap.add_argument("--out", default=None,
                    help="also write the verdict JSON to this file")
    args = ap.parse_args(argv)
    try:
        with open(args.rules, encoding="utf-8") as f:
            rules = normalize_rules(json.load(f))
    except (OSError, ValueError) as e:
        print(f"ERROR: bad rule file: {e}", file=sys.stderr)
        return 1
    urls = [u for u in args.nodes.split(",") if u]
    fleet = scrape_fleet(urls,
                         with_availability=not args.no_availability)
    verdict = evaluate(rules, fleet)
    body = json.dumps(verdict, indent=2, sort_keys=True)
    print(body)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(body + "\n")
    return 0 if verdict["pass"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
