"""The flight recorder's ring buffer (port of ``repro.trace.buffer``).

:class:`TraceBuf` holds per-round series, each a ``(R, ...)`` ring of ``R
= EngineConfig.trace_rounds`` slots on the engine's device.  The host
drives the rounds here, so the cadence test (``round % trace_every``)
and the slot (``cursor % R``) are host integers: a recorded round writes
its slot by slice assignment of device tensors (no host sync), and a
round off the cadence adds no operation at all.  When the traversal
outlives the ring the oldest slots are overwritten: the ring holds the
last ``R`` recorded rounds, identified by their ``round_id``.

The recording contract: trace-off adds nothing to the round, and
trace-on never perturbs values or ``Stats`` (every recorded value is a
read of telemetry the round already computed, or a reduction of it).
All recorded values are global, as ``Stats`` are.

The serving lanes (:mod:`repro_torch.serve`) keep a lane-led ring
(:func:`zero_lane_trace`): every field gains a leading ``(B,)`` axis and
the cursor is a ``(B,)`` device tensor, since a lane records on its own
round count (a recycled lane starts over) and that count lives on the
device.  :func:`record_lanes` writes each lane's slot under a mask; one
lane of the ring (``export.lane_trace``) is its solo run's ring.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.noc.topology import N_LINK_CLASSES


class TraceBuf(NamedTuple):
    """Per-round series, each a ring of ``R`` slots (leading axis).

    ``cursor`` (a host int) counts the rounds recorded (``min(cursor, R)``
    slots are valid; ``cursor > R`` means the ring wrapped).
    ``round_id`` holds each slot's engine round index (-1 = never
    written), so the host can re-order the ring and place each slot on
    the modelled-cycle timeline by ``cyc_total`` (the post-round
    ``Stats.cycles``: the round occupies ``[cyc_total - cyc, cyc_total]``).
    """

    cursor: int                 # rounds recorded so far ((B,) i32
                                # tensor in a lane-led ring)
    round_id: torch.Tensor      # (R,) i32 engine round index per slot
    cyc: torch.Tensor           # (R,) f32 modelled cycles of the round
    cyc_total: torch.Tensor     # (R,) f32 Stats.cycles after the round
    tile_busy: torch.Tensor     # (R, T) f32 per-tile compute cycles
    crit_tile: torch.Tensor     # (R,) i32 the round's critical-path tile
    msgs: torch.Tensor          # (R, K) i32 delivered messages per channel
    spills: torch.Tensor        # (R, K) i32 spill-and-replay per channel
    qdepth: torch.Tensor        # (R, K) i32 total queue occupancy
    qdepth_max: torch.Tensor    # (R, K) i32 max single-tile occupancy
    chan_budget: torch.Tensor   # (R, K) i32 TSU pop budgets granted (sum)
    src_budget: torch.Tensor    # (R,) i32 frontier-source budget granted
    link_cls: torch.Tensor      # (R, C) i32 flits per link class
    launches: torch.Tensor      # (R,) i32 kernel calls this round
    hbm_windows: torch.Tensor   # (R,) i32 windows streamed this round
    frontier: torch.Tensor      # (R,) i32 global frontier population
    pending: torch.Tensor       # (R,) i32 global pending work after round


# Fields written by record_round (all but the bookkeeping pair).
SERIES_FIELDS = tuple(f for f in TraceBuf._fields
                      if f not in ("cursor", "round_id"))


def zero_trace(cfg, T: int, alg=None, device="cuda") -> TraceBuf:
    """A fresh ring on ``device`` sized for ``cfg`` (R, cadence), a
    ``T``-tile grid and the program's channel count (``alg`` an AlgSpec or
    Program; the classic program's 2 channels by default)."""
    from repro_torch.core.program import as_program
    R = int(cfg.trace_rounds)
    assert R >= 1, f"trace_rounds={R} must be >= 1"
    assert int(cfg.trace_every) >= 1, \
        f"trace_every={cfg.trace_every} must be >= 1"
    K = len(as_program(alg).channels) if alg is not None else 2
    C = N_LINK_CLASSES

    def zi(*s):
        return torch.zeros(s, dtype=torch.int32, device=device)

    def zf(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)
    return TraceBuf(
        cursor=0,
        round_id=torch.full((R,), -1, dtype=torch.int32, device=device),
        cyc=zf(R), cyc_total=zf(R),
        tile_busy=zf(R, T), crit_tile=zi(R),
        msgs=zi(R, K), spills=zi(R, K),
        qdepth=zi(R, K), qdepth_max=zi(R, K),
        chan_budget=zi(R, K), src_budget=zi(R),
        link_cls=zi(R, C), launches=zi(R),
        hbm_windows=zi(R), frontier=zi(R), pending=zi(R),
    )


def on_cadence(round_ix: int, every: int) -> bool:
    """Whether engine round ``round_ix`` (host int) is recorded."""
    return round_ix % every == 0


def record_round(tbuf: TraceBuf, row: dict, round_ix: int, every: int
                 ) -> TraceBuf:
    """Write one round's values into the ring, in place.

    ``row`` maps :data:`SERIES_FIELDS` to this round's values (tensors on
    the ring's device shaped like one slot, or Python numbers).  The slot
    is written, and the cursor advanced, only when ``round_ix % every ==
    0``; otherwise the ring is returned untouched.
    """
    if not on_cadence(round_ix, every):
        return tbuf
    assert set(row) == set(SERIES_FIELDS), (
        f"record_round row keys {sorted(row)} != {sorted(SERIES_FIELDS)}")
    slot = tbuf.cursor % tbuf.round_id.shape[0]
    for name, v in row.items():
        getattr(tbuf, name)[slot] = v
    tbuf.round_id[slot] = round_ix
    return tbuf._replace(cursor=tbuf.cursor + 1)


def zero_lane_trace(cfg, T: int, alg, lanes: int, device="cuda") -> TraceBuf:
    """A fresh lane-led ring: :func:`zero_trace`'s fields with a leading
    ``(lanes,)`` axis, and a ``(lanes,)`` int32 cursor on ``device``."""
    tb = zero_trace(cfg, T, alg, device)
    return TraceBuf(
        torch.zeros((lanes,), dtype=torch.int32, device=device),
        *(x[None].expand((lanes,) + tuple(x.shape)).clone()
          for x in tb[1:]))


def record_lanes(tbuf: TraceBuf, row: dict, rounds: torch.Tensor,
                 active: torch.Tensor, every: int) -> TraceBuf:
    """Write one shared round into a lane-led ring, in place: lane ``b``
    writes slot ``cursor[b] % R`` (and advances its cursor) where it is
    ``active`` and its own pre-round count ``rounds[b]`` is on the
    cadence, the round index it records; the other lanes' slots keep
    their values.  ``row`` maps :data:`SERIES_FIELDS` to lane-led values
    (or Python numbers, the same for every lane, which ``torch.where``
    takes as kernel arguments: no host-to-device copy a round)."""
    assert set(row) == set(SERIES_FIELDS), (
        f"record_lanes row keys {sorted(row)} != {sorted(SERIES_FIELDS)}")
    B, R = tbuf.round_id.shape
    do = active & (rounds % every == 0)
    slot = (tbuf.cursor % R).to(torch.int64)
    lane = torch.arange(B, device=slot.device)

    def write(buf, v):
        old = buf[lane, slot]
        if isinstance(v, torch.Tensor):
            v = v.to(buf.dtype).expand(old.shape)
        m = do.reshape((B,) + (1,) * (old.ndim - 1))
        buf[lane, slot] = torch.where(m, v, old)
    for name, v in row.items():
        write(getattr(tbuf, name), v)
    write(tbuf.round_id, rounds)
    return tbuf._replace(cursor=tbuf.cursor + do.to(torch.int32))
