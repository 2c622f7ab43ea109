"""What decides ``correct``: the served outputs of sampled blocks held
to the plain reference, number by number, each against its limit.

The reference computes in float64, the program in float32, so the
program's audio differs from the reference's by a few units of the
wire's last bit on loud lanes, and by more on lanes whose audio is a
faint residue beside a strong carrier.  The numbers of a run:

- ``audio``: the worst s16 or IQ lane and block: max |served -
  reference| over the block, over the reference's RMS;
- ``adpcm``: the worst ADPCM lane and block: the share of its codes that
  no sample within 1 LSB of the reference's gets from the state the
  served stream reached;
- ``smeter``: SND headers whose S-meter field is more than one unit
  (0.1 dB) off the reference's block peak (a count);
- ``wf``: waterfall pixels more than one unit off the reference's row
  (ADPCM rows: codes no value within one unit gets; a count);
- ``state``: the program's state after each sampled block against the
  reference's step from the program's state before it: the worst, over
  the state's real and complex fields and the listened channels, of a
  channel's gap in norm over that channel's norm (an angle's gap taken
  modulo 2 pi).  Integer and boolean fields (squelch gates, tails,
  counters) are decisions on nearly equal floats, and are left out; the
  SAM PLL's carries count only on lanes in SAM mode (the PLL runs on
  every channel, and on a channel of noise it wanders chaotically,
  feeding nothing that channel serves);
- ``phase``: channels whose 48-bit rotator word after the block is not
  the reference's;
- ``carry``: rotator words and ADC-tail samples in the program's state
  entering a sampled block (or the first block after a retune) that are
  not what the reference works out from the stream alone (the DDC's and
  the passband FIR's carries have a finite memory:
  :func:`.receiver.stream_carries`); their float carries' gaps count in
  ``state``, and the reference steps from its own carries.  In a run
  with a clock correction it also counts the listened channels whose
  stage-1 bank column, before and after the block, is not the one of
  the clock the block's words were placed under (:func:`bank_off`);
- ``init``: the largest gap between the program's state entering the
  stream's first block and where a stream starts;
- ``missing``: sampled deliveries that never reached their listener.

A clock correction (``StreamEngine.retune_all(clock)``) retunes every
channel to the words of a new clock.  The probes record each call's
clock and the engine's block count when it was entered and when it
returned; the reference then runs every block under the words of the
clock that block ran under (:func:`placements`).  Nothing of that is
read from the program's state: the words and phases are the
reference's own, from the recorded clocks.

A configuration that states ``adc_ppm`` also gives ``clock_error_ppm``
(:func:`clock_error_ppm`): how far the recorded clocks lie from the
ADC's true clock.  It needs a limit in the cell's file, like a part's
numbers.

A deployment's parts (``benchmark/parts/``) add numbers of their own,
each held to a limit of the cell like the numbers above; for those a
missing reading or a missing limit is not correct (:func:`verdict`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import codec
from . import design as dz
from . import receiver as rxr
from . import waterfall as wfr

LIMITS = os.path.join(os.path.dirname(__file__), "limits")


def limits(cell: str) -> dict:
    """{number: limit} of a cell, from ``limits/<cell>.json`` (a number
    the file lists under ``not_compared`` has no limit there: the control
    does not read three times the program's highest reading)."""
    with open(os.path.join(LIMITS, cell + ".json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def served_lane(kind: str, pkt: dict | None, adpcm_state) -> dict | None:
    """What one listener got for one block, decoded."""
    if pkt is None:
        return None
    out = dict(kind=kind, smeter_u16=pkt["smeter_u16"])
    if kind == "adpcm":
        out["codes"] = codec.nibbles(pkt["payload"])
        out["state"] = adpcm_state
    else:
        out["samples"] = codec.s16(pkt["payload"], pkt["flags"])
    return out


def control_lane(kind: str, taps: dict, j: int, adpcm_state) -> dict:
    """What the control would have served on lane ``j``."""
    out = dict(kind=kind, smeter_u16=codec.smeter_u16(taps["smeter_dbm"][j]))
    if kind == "iq":
        iq = taps["iq"][:, j]
        out["samples"] = codec.audio_s16(
            np.stack([iq.real, iq.imag], 1).reshape(-1).astype(np.float32))
    elif kind == "adpcm":
        want = codec.audio_s16(taps["audio"][:, j].astype(np.float32))
        out["codes"] = codec.encode(want, *adpcm_state)
        out["state"] = adpcm_state
    else:
        out["samples"] = codec.audio_s16(taps["audio"][:, j].astype(np.float32))
    return out


def lane_numbers(got: dict, taps: dict, j: int) -> dict:
    """The counts of one lane and block against the reference's taps."""
    want_sm = codec.smeter_u16(taps["smeter_dbm"][j])
    out = {"smeter": float(abs(got["smeter_u16"] - want_sm) > 1)}
    if got["kind"] == "iq":
        iq = taps["iq"][:, j]
        want = codec.audio_s16(np.stack([iq.real, iq.imag], 1).reshape(-1))
    else:
        want = codec.audio_s16(taps["audio"][:, j])
    if got["kind"] == "adpcm":
        bad, _, _ = codec.code_mismatch(got["codes"], want, *got["state"])
        out["adpcm"] = bad / len(want)
    else:
        s = got["samples"]
        if len(s) != len(want):
            out["audio"] = float("inf")
        else:
            rms = max(float(np.sqrt(np.mean(want.astype(np.float64) ** 2))),
                      1.0)
            out["audio"] = float(np.max(np.abs(s - want))) / rms
    return out


ANGLES = ("sam.phase",)


SAM_FIELDS = ("sam.phase", "sam.freq", "sam.dc")


def state_gaps(prog: dict, ref: dict, sam_lanes=None) -> dict:
    """{field: each channel's gap in norm over that channel's norm} (a
    field without a channel axis counts as one channel; an angle's gap
    is taken modulo 2 pi; a field of another shape reads inf)."""
    out = {}
    lanes = np.asarray(ref["ddc.phi1"]).shape[-1]
    for k, r in ref.items():
        if k == "ddc.phi1":
            continue
        if k not in prog:               # a field the program lost
            out[k] = np.array([np.inf])
            continue
        a, b = np.asarray(prog[k]), np.asarray(r)
        if a.dtype.kind in "biu":
            continue
        a, b = a.astype(np.complex128), b.astype(np.complex128)
        if a.shape != b.shape:
            out[k] = np.array([np.inf])
            continue
        d = a - b
        if k in ANGLES:
            d = np.angle(np.exp(1j * d.real))
        if b.ndim == 0 or b.shape[-1] != lanes or k == "ddc.x_tail":
            d, b = d.reshape(-1, 1), b.reshape(-1, 1)
        gap = np.sqrt(np.sum(np.abs(d.reshape(-1, d.shape[-1])) ** 2, 0))
        norm = np.sqrt(np.sum(np.abs(b.reshape(-1, b.shape[-1])) ** 2, 0))
        rel = np.where(gap > 0, gap / np.maximum(norm, 1e-30), 0.0)
        if k in SAM_FIELDS and sam_lanes is not None:
            rel = np.where(sam_lanes, rel, 0.0)
        out[k] = rel
    return out


def state_number(prog: dict, ref: dict, sam_lanes=None
                 ) -> tuple[float, int]:
    """(the worst channel's gap over its norm, over every field; channels
    whose rotator word differs).  ``sam_lanes``: (lanes,) bool, the lanes
    in SAM mode."""
    gaps = state_gaps(prog, ref, sam_lanes)
    worst = max((float(g.max()) for g in gaps.values()), default=0.0)
    if "ddc.phi1" not in prog:
        return worst, len(ref["ddc.phi1"])
    phase = int(np.sum(np.asarray(prog["ddc.phi1"]).astype(np.int64)
                       != np.asarray(ref["ddc.phi1"]).astype(np.int64)))
    return worst, phase


def carry_numbers(prog: dict, held: dict) -> tuple[float, int]:
    """(the worst channel's gap of the program's float carries entering
    a block over the reference's, as ``state`` reads a gap; rotator
    words and ADC-tail samples that differ).  ``held``: the carries the
    reference works out from the stream."""
    gaps = state_gaps(prog, {k: v for k, v in held.items()
                             if k != "ddc.x_tail"})
    worst = max((float(g.max()) for g in gaps.values()), default=0.0)
    off = 0
    for k in ("ddc.phi1", "ddc.x_tail"):
        if k not in prog or np.shape(prog[k]) != np.shape(held[k]):
            off += np.size(held[k])
            continue
        a = np.asarray(prog[k])
        b = np.asarray(held[k])
        if k == "ddc.phi1":
            off += int(np.sum(a.astype(np.int64) != b.astype(np.int64)))
        else:
            off += int(np.sum(a.astype(np.float64) != b.astype(np.float64)))
    return worst, off


def init_number(p: dz.Plan, prog: dict) -> float:
    """Largest gap between the program's state at the stream's start and
    where a stream starts, in the program's own types."""
    want = rxr.init_state(p, np.asarray(prog["ddc.phi1"]).shape[-1])
    worst = 0.0
    for k, w in want.items():
        if k not in prog:
            return float("inf")
        a = np.asarray(prog[k])
        w = np.asarray(w).astype(a.dtype)
        if a.shape != w.shape:
            return float("inf")
        if a.size:
            worst = max(worst, float(np.max(np.abs(
                a.astype(np.complex128) - w.astype(np.complex128)))))
    return worst


def wf_number(got: dict, want_u8: np.ndarray) -> float:
    """Pixels (or ADPCM codes) of a row more than one unit off."""
    if got["compressed"]:
        codes = codec.nibbles(got["payload"])
        want = np.concatenate([np.full(codec.WF_PAD, want_u8[0]), want_u8])
        bad, _, _ = codec.code_mismatch(codes, want.astype(np.int64), 0, 0,
                                        u8=True)
        return float(bad)
    row = np.frombuffer(got["payload"], np.uint8).astype(np.int64)
    if len(row) != len(want_u8):
        return float(len(want_u8))
    return float(np.sum(np.abs(row - want_u8.astype(np.int64)) > 1))


def control_wf(zoom: int, want_u8: np.ndarray, ctl_u8: np.ndarray) -> dict:
    """The row the control would have served, as a packet's fields."""
    if zoom == 0:
        return dict(compressed=False, payload=ctl_u8.tobytes())
    pad = np.concatenate([np.full(codec.WF_PAD, ctl_u8[0]), ctl_u8])
    codes = codec.encode(pad.astype(np.int64), 0, 0, u8=True)
    packed = (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8)
    return dict(compressed=True, payload=packed.tobytes())


def verdict(numbers: dict, lim: dict, required=()) -> tuple[bool, list]:
    """Each number beside its limit; correct when none is over.  A number
    named in ``required`` (a part's) with no reading or no limit is not
    correct, and stands in the rows with None in place of what it
    lacks; any other number without a reading or a limit is left out."""
    rows, ok = [], True
    for k in sorted(set(lim) | set(required)):
        v = numbers.get(k)
        if k in required and (v is None or k not in lim):
            ok = False
            rows.append((k, None if v is None else float(v), lim.get(k)))
            continue
        if v is None or k not in lim:
            continue
        good = bool(np.isfinite(v) and v <= lim[k])
        ok &= good
        rows.append((k, float(v), lim[k]))
    return ok, rows


def placements(lanes: rxr.Lanes, retunes: list, phases: dict
               ) -> tuple[dict, int]:
    """The clock every block up to the last compared one ran under.

    ``retunes``: the engine's clock corrections in call order, each
    (clock, a, b): the block count when the call was entered and when
    it returned.  Blocks before ``a`` had been dispatched before the
    call and ran under the clock before it; blocks after ``b`` were
    dispatched after it returned and ran under its clock; the blocks a
    to b were dispatched while it ran, and may have read either clock's
    words (the program orders the tuning's copy against a step in
    flight on the card's stream, which the host cannot see).  So a
    retune first takes effect at some block s in [a, b + 1], and every
    block from s on reads its words, on every lane.

    ``phases``: {block n: (the program's rotator words of the listened
    lanes entering n, after n or None)}, at each sampled block and at
    the first block dispatched after each retune returned.  At each of
    them, in order, the placements the record allows are held to those
    words, and the ones under which the fewest lanes are off are kept:
    a block that read neither clock's words, or the old words on some
    lanes and the new on others, leaves lanes off under every
    placement.  The words compared are the reference's own, from the
    recorded clocks, never the program's.

    Returns ({n: the kept placement's :class:`.receiver.Clocks`}, the
    lanes off at the blocks after a retune that no sampled block
    compares)."""
    kept: list[tuple] = [()]
    taken = off = 0
    chosen = {}

    def clocks(h):
        return rxr.Clocks(lanes.clock, [(s, retunes[r][0])
                                        for r, s in enumerate(h)])

    def lanes_off(h, n, before, after):
        cl = clocks(h)
        bad = int(np.sum(rxr.phase_entering(lanes, cl, n)
                         != np.asarray(before, np.int64)))
        if after is not None:
            bad += int(np.sum(rxr.phase_entering(lanes, cl, n + 1)
                              != np.asarray(after, np.int64)))
        return bad

    for n in sorted(phases):
        while taken < len(retunes) and retunes[taken][1] <= n:
            _clock, a, b = retunes[taken]
            kept = [h + (s,) for h in kept
                    for s in range(max([a] + list(h[-1:])), b + 2)]
            taken += 1
        before, after = phases[n]
        scores = [lanes_off(h, n, before, after) for h in kept]
        best = min(scores)
        kept = [h for h, v in zip(kept, scores) if v == best]
        chosen[n] = clocks(kept[0])
        if after is None:
            off += best
    return chosen, off


# A bank column more than this share of its largest tap away from the
# reference's, under the clock placed for its block, counts in ``carry``.
# The program builds its bank in float64 on the host and keeps it in
# complex64: 4.1e-8 - 5.1e-8 off the reference's (three lanes, 0.5 - 14.2
# MHz); under the other clock of a 0.4 ppm correction the same lanes read
# 1.0e-5 - 2.9e-4 (benchmark/tests/test_bench_retune.py).
BANK_GAP = 1e-6


def bank_off(lanes: rxr.Lanes, cols: list) -> int:
    """The lanes whose stage-1 bank column is more than ``BANK_GAP`` off
    the reference's of ``lanes``' clock in every one of ``cols`` (the
    listened columns, (L1, lanes), as the probes copied them before the
    step and after it: the step read one of them)."""
    want = lanes.bank
    scale = np.abs(want).max(axis=0)
    good = np.zeros(want.shape[1], bool)
    for col in cols:
        gap = np.abs(np.asarray(col, np.complex128) - want).max(axis=0)
        good |= gap <= BANK_GAP * scale
    return int(np.sum(~good))


def clock_error_ppm(true_clock: float, nominal: float, clocks) -> float:
    """The worst offset, in ppm of the ADC's true clock, of the clocks
    the engine was retuned to (``clocks``; the nominal one when there
    were none): what a clock correction has to bring near zero."""
    return max(abs(c / true_clock - 1.0) * 1e6
               for c in (list(clocks) or [nominal]))


WORST_OF = ("audio", "adpcm", "state")


def worst(acc: dict, new: dict) -> None:
    """Fold one block's numbers into a run's: counts add up, the others
    keep their largest."""
    for k, v in new.items():
        acc[k] = max(acc.get(k, 0.0), v) if k in WORST_OF else \
            acc.get(k, 0.0) + v
