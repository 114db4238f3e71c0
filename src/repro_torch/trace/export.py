"""Host-side consumers of a captured flight-recorder ring (port of
``repro.trace.export``; :class:`~repro_torch.trace.buffer.TraceBuf`):
the modeled-cycle timeline mapping, Chrome/Perfetto trace JSON export, a
JSONL event stream, and the utilization / work-imbalance / queue-depth
summary the CLI prints.

Timeline mapping.  The engine prices every round on the perf model's
cycle clock (``Stats.cycles``); the recorder stores each traced round's
increment (``cyc``) *and* the post-round running total (``cyc_total``),
so round ``r`` occupies the interval ``[cyc_total - cyc, cyc_total]`` in
modeled cycles — exact even when ``trace_every > 1`` leaves gaps, and the
last slot's ``cyc_total`` is bitwise ``Stats.cycles`` when the ring did
not wrap.  The Perfetto export writes modeled cycles as the trace's
microsecond ticks (1 cycle == 1 us tick; at the default 1 GHz tile clock
a displayed "us" is a real microsecond of modeled machine time * 1e3).

Track schema (Chrome trace-event JSON, loadable at ui.perfetto.dev):

* pid 0 "engine"   — one "X" slice per traced round (dur = the round's
  modeled cycles) + counters: frontier, pending, src_budget, launches,
  hbm_windows.
* pid 1 "tiles"    — one thread per tile; per round one "X" busy slice
  (dur = that tile's compute cycles — the gap to the round envelope IS
  the idle time the utilization figure plots), the critical-path tile's
  slice tagged ``crit=1``.
* pid 2 "channels" — per-channel counters: msgs, spills, qdepth (+ the
  TSU's granted budget).
* pid 3 "fabric"   — per-link-class flit counters (local / ruche / wrap /
  port / die).

Everything here is numpy-only and runs on the host after the run
returns (a ring's tensors, on any device, are read through
:func:`host`); nothing feeds back into the engine.  The functions take a
ring of either package, so an export of the port's ring can be held
against the reference's.
"""
from __future__ import annotations

import json

import numpy as np

# Link-class display names, indexed by the CLASS_* constants.
LINK_CLASS_NAMES = ("local", "ruche", "wrap", "port", "die")

PHASE_NAMES = ("ramp", "steady", "drain")


def host(x) -> np.ndarray:
    """A ring field as a numpy array on the host (a tensor on any device,
    an array, or a number)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def lane_trace(tbuf, lane: int):
    """Slice one lane out of a lane-led ``(B, ...)`` serving ring: the
    per-query trace is exactly a solo trace."""
    return type(tbuf)(*(x[lane] for x in tbuf))


def trace_arrays(tbuf) -> dict:
    """De-ring a TraceBuf into round-ordered numpy arrays.

    Returns ``{field: (n, ...) array}`` over the valid slots (``round_id
    >= 0``), sorted by round index — the ring keeps the LAST ``R``
    recorded rounds, so sorting by ``round_id`` restores time order —
    plus ``n_recorded`` (slots present) and ``n_seen`` (rounds ever
    recorded; ``n_seen > n_recorded`` means the ring wrapped and the
    oldest rounds were overwritten).
    """
    rid = host(tbuf.round_id)
    if rid.ndim != 1:
        raise ValueError(
            f"trace_arrays wants a single trace (round_id shape "
            f"{rid.shape}); slice serving lanes with lane_trace() first")
    valid = rid >= 0
    order = np.argsort(rid[valid], kind="stable")
    out = {"n_recorded": int(valid.sum()),
           "n_seen": int(host(tbuf.cursor))}
    out["round_id"] = rid[valid][order]
    for f in tbuf._fields:
        if f in ("cursor", "round_id"):
            continue
        v = host(getattr(tbuf, f))
        out[f] = v[valid][order]
    return out


def utilization(tr: dict) -> np.ndarray:
    """Per-round mean tile utilization: the fraction of the round's
    critical-path envelope the average tile spent computing,
    ``busy.sum() / (T * cyc_round)`` (0 where the round cost nothing)."""
    busy = tr["tile_busy"].astype(np.float64)
    cyc = tr["cyc"].astype(np.float64)
    T = busy.shape[1]
    denom = np.where(cyc > 0, T * cyc, 1.0)
    return np.where(cyc > 0, busy.sum(axis=1) / denom, 0.0)


def work_cov(tr: dict) -> np.ndarray:
    """Per-round work-imbalance coefficient of variation across tiles:
    ``std(tile_busy) / mean(tile_busy)`` (0 where no tile worked)."""
    busy = tr["tile_busy"].astype(np.float64)
    mean = busy.mean(axis=1)
    std = busy.std(axis=1)
    return np.where(mean > 0, std / np.where(mean > 0, mean, 1.0), 0.0)


def trace_metrics(tbuf) -> dict:
    """The two additive figure columns: mean utilization and mean work
    CoV over the recorded rounds (``derived_metrics``/``stats_row`` merge
    these when a trace is present)."""
    tr = trace_arrays(tbuf)
    if tr["n_recorded"] == 0:
        return {"util_mean": 0.0, "work_cov": 0.0}
    return {"util_mean": round(float(utilization(tr).mean()), 4),
            "work_cov": round(float(work_cov(tr).mean()), 4)}


def _starts(tr: dict) -> np.ndarray:
    return tr["cyc_total"].astype(np.float64) - tr["cyc"].astype(np.float64)


def summarize(tbuf) -> dict:
    """Utilization, work-imbalance and queue-depth statistics, overall
    and per execution phase (the recorded rounds split into ramp / steady
    / drain thirds by round order — the time-resolved split the run-level
    ``Stats`` aggregates away)."""
    tr = trace_arrays(tbuf)
    n = tr["n_recorded"]
    out = {"rounds_recorded": n, "rounds_seen": tr["n_seen"],
           "ring_wrapped": tr["n_seen"] > n}
    if n == 0:
        return out
    util = utilization(tr)
    cov = work_cov(tr)
    qd = tr["qdepth"]
    out.update(
        cycles_traced=float(tr["cyc"].astype(np.float64).sum()),
        util_mean=float(util.mean()),
        util_min=float(util.min()), util_max=float(util.max()),
        work_cov=float(cov.mean()),
        crit_tile_mode=int(np.bincount(tr["crit_tile"]).argmax()),
    )
    K = qd.shape[1]
    out["channels"] = [
        {"chan": k,
         "msgs": int(tr["msgs"][:, k].sum()),
         "spills": int(tr["spills"][:, k].sum()),
         "q_p50": float(np.percentile(qd[:, k], 50)),
         "q_p90": float(np.percentile(qd[:, k], 90)),
         "q_max": int(qd[:, k].max()),
         "q_tile_max": int(tr["qdepth_max"][:, k].max())}
        for k in range(K)]
    bounds = [0, n // 3, (2 * n) // 3, n]
    phases = []
    for p, name in enumerate(PHASE_NAMES):
        lo, hi = bounds[p], bounds[p + 1]
        if hi <= lo:
            continue
        sl = slice(lo, hi)
        phases.append({
            "phase": name, "rounds": hi - lo,
            "util_mean": float(util[sl].mean()),
            "work_cov": float(cov[sl].mean()),
            "q_p50": float(np.percentile(qd[sl].sum(axis=1), 50)),
            "q_p90": float(np.percentile(qd[sl].sum(axis=1), 90)),
            "q_max": int(qd[sl].sum(axis=1).max()),
            "spills": int(tr["spills"][sl].sum()),
        })
    out["phases"] = phases
    return out


def format_summary(s: dict) -> str:
    """The CLI table for a :func:`summarize` dict."""
    lines = [f"rounds recorded {s['rounds_recorded']} "
             f"(seen {s['rounds_seen']}"
             + (", ring wrapped)" if s.get("ring_wrapped") else ")")]
    if s["rounds_recorded"] == 0:
        return "\n".join(lines)
    lines.append(
        f"util mean {s['util_mean']:.3f} "
        f"[{s['util_min']:.3f}..{s['util_max']:.3f}]  "
        f"work CoV {s['work_cov']:.3f}  "
        f"critical-path tile (mode) {s['crit_tile_mode']}")
    lines.append(f"{'phase':8s} {'rounds':>7s} {'util':>6s} {'cov':>6s} "
                 f"{'q_p50':>7s} {'q_p90':>7s} {'q_max':>7s} {'spills':>7s}")
    for p in s["phases"]:
        lines.append(f"{p['phase']:8s} {p['rounds']:7d} "
                     f"{p['util_mean']:6.3f} {p['work_cov']:6.3f} "
                     f"{p['q_p50']:7.0f} {p['q_p90']:7.0f} "
                     f"{p['q_max']:7d} {p['spills']:7d}")
    lines.append(f"{'chan':8s} {'msgs':>9s} {'spills':>7s} {'q_p50':>7s} "
                 f"{'q_p90':>7s} {'q_max':>7s}")
    for c in s["channels"]:
        lines.append(f"{c['chan']:<8d} {c['msgs']:9d} {c['spills']:7d} "
                     f"{c['q_p50']:7.0f} {c['q_p90']:7.0f} {c['q_max']:7d}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Chrome/Perfetto trace JSON.
# --------------------------------------------------------------------------

PID_ENGINE, PID_TILES, PID_CHANNELS, PID_FABRIC = 0, 1, 2, 3


def to_perfetto(tbuf, meta: dict | None = None) -> dict:
    """Build the Chrome trace-event JSON dict (see module docstring for
    the track schema).  ``meta`` lands in ``otherData``."""
    tr = trace_arrays(tbuf)
    ev = []

    def m(pid, name, tid=None):
        e = {"ph": "M", "pid": pid, "name": "process_name",
             "args": {"name": name}}
        if tid is not None:
            e["name"] = "thread_name"
            e["tid"] = tid
        ev.append(e)

    m(PID_ENGINE, "engine")
    m(PID_TILES, "tiles")
    m(PID_CHANNELS, "channels")
    m(PID_FABRIC, "fabric")
    n = tr["n_recorded"]
    T = tr["tile_busy"].shape[1] if n else 0
    for t in range(T):
        m(PID_TILES, f"tile {t}", tid=t)
    starts = _starts(tr)
    for r in range(n):
        rid = int(tr["round_id"][r])
        ts = float(starts[r])
        dur = float(tr["cyc"][r])
        ev.append({"ph": "X", "pid": PID_ENGINE, "tid": 0, "ts": ts,
                   "dur": dur, "name": f"round {rid}",
                   "args": {"round": rid,
                            "pending": int(tr["pending"][r]),
                            "frontier": int(tr["frontier"][r])}})
        for name, key in (("frontier", "frontier"), ("pending", "pending"),
                          ("src_budget", "src_budget"),
                          ("launches", "launches"),
                          ("hbm_windows", "hbm_windows")):
            ev.append({"ph": "C", "pid": PID_ENGINE, "tid": 0, "ts": ts,
                       "name": name, "args": {name: int(tr[key][r])}})
        crit = int(tr["crit_tile"][r])
        for t in range(T):
            busy = float(tr["tile_busy"][r, t])
            args = {"round": rid}
            if t == crit:
                args["crit"] = 1
            ev.append({"ph": "X", "pid": PID_TILES, "tid": t, "ts": ts,
                       "dur": busy, "name": "busy", "args": args})
        for k in range(tr["msgs"].shape[1]):
            ev.append({"ph": "C", "pid": PID_CHANNELS, "tid": k, "ts": ts,
                       "name": f"chan{k}",
                       "args": {"msgs": int(tr["msgs"][r, k]),
                                "spills": int(tr["spills"][r, k]),
                                "qdepth": int(tr["qdepth"][r, k]),
                                "budget": int(tr["chan_budget"][r, k])}})
        for c, cname in enumerate(LINK_CLASS_NAMES):
            flits = int(tr["link_cls"][r, c])
            if tr["link_cls"][:, c].any():
                ev.append({"ph": "C", "pid": PID_FABRIC, "tid": c, "ts": ts,
                           "name": f"flits_{cname}",
                           "args": {"flits": flits}})
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"clock": "modeled cycles (1 cycle = 1 us tick)",
                          **(meta or {})}}


def write_perfetto(tbuf, path: str, meta: dict | None = None) -> dict:
    doc = to_perfetto(tbuf, meta)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def jsonl_rows(tbuf) -> list:
    """One JSON-able event dict per recorded round (the stream form of
    the same data the Perfetto export plots)."""
    tr = trace_arrays(tbuf)
    starts = _starts(tr)
    util = utilization(tr) if tr["n_recorded"] else np.zeros(0)
    cov = work_cov(tr) if tr["n_recorded"] else np.zeros(0)
    rows = []
    for r in range(tr["n_recorded"]):
        rows.append({
            "round": int(tr["round_id"][r]),
            "cycle_start": float(starts[r]),
            "cycles": float(tr["cyc"][r]),
            "cycle_total": float(tr["cyc_total"][r]),
            "util": round(float(util[r]), 6),
            "work_cov": round(float(cov[r]), 6),
            "crit_tile": int(tr["crit_tile"][r]),
            "tile_busy": [round(float(x), 2) for x in tr["tile_busy"][r]],
            "msgs": tr["msgs"][r].tolist(),
            "spills": tr["spills"][r].tolist(),
            "qdepth": tr["qdepth"][r].tolist(),
            "qdepth_max": tr["qdepth_max"][r].tolist(),
            "chan_budget": tr["chan_budget"][r].tolist(),
            "src_budget": int(tr["src_budget"][r]),
            "link_cls": {n: int(tr["link_cls"][r, c])
                         for c, n in enumerate(LINK_CLASS_NAMES)
                         if tr["link_cls"][:, c].any()},
            "launches": int(tr["launches"][r]),
            "hbm_windows": int(tr["hbm_windows"][r]),
            "frontier": int(tr["frontier"][r]),
            "pending": int(tr["pending"][r]),
        })
    return rows


def write_jsonl(tbuf, path: str) -> int:
    rows = jsonl_rows(tbuf)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)


def reconcile_cycles(tbuf, stats_cycles: float) -> dict:
    """Check the trace's cycle totals against the accumulated
    ``Stats.cycles``: when the ring did not wrap and every round was
    traced (``trace_every == 1``), the last slot's running total is the
    SAME f32 the engine accumulated (bitwise), and the per-round
    increments sum to it up to f32 rounding.  Returns the comparison."""
    tr = trace_arrays(tbuf)
    if tr["n_recorded"] == 0:
        return {"exact": False, "n": 0}
    last_total = float(tr["cyc_total"][-1])
    inc_sum = float(tr["cyc"].astype(np.float64).sum())
    exact = (not tr["n_seen"] > tr["n_recorded"]) and \
        last_total == float(stats_cycles)
    rel = abs(inc_sum - float(stats_cycles)) / max(float(stats_cycles), 1.0)
    return {"exact": bool(exact), "n": tr["n_recorded"],
            "last_total": last_total, "increment_sum": inc_sum,
            "stats_cycles": float(stats_cycles), "increment_rel_err": rel}
