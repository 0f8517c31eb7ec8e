"""Session reports — merge per-process traces, render post-mortems.

Two subcommands (stdlib only, no engine import):

  python -m gol_tpu_torch.obs.report merge SERVER.json CLIENT.json -o OUT.json
      Join two (or more) Chrome-trace dumps (`Tracer.dump` / the
      `/trace` endpoint) into ONE Chrome-trace file on the corrected
      timebase: each input's `metadata.clock_offset_seconds` — the
      handshake-estimated offset to the session's reference clock,
      measured by the wire clock probe (docs/OBSERVABILITY.md) — shifts
      its events before the union, so a server-emit span and its
      client-apply span for the same turn (both carry `args.turn`) line
      up on one timeline even across hosts with skewed clocks. Load the
      output in Perfetto / chrome://tracing.

  python -m gol_tpu_torch.obs.report render FLIGHT.json
      Human post-mortem of a flight-recorder dump (`gol_tpu_torch.obs.flight`):
      why/when it dumped, the state it died in, a turn-rate curve from
      the recorded dispatch commits, stall windows, reconnect storms,
      eviction and invariant-violation history, and the biggest metric
      deltas. `render` on a bare path is the default subcommand.

  python -m gol_tpu_torch.obs.report usage LEDGER-DIR [DIR ...]
      Aggregate the accounting plane's crash-safe usage ledgers
      (`gol_tpu_torch.obs.accounting`): every `usage-*.jsonl` segment under
      the given directories — across rollovers, process generations
      and a torn tail from a SIGKILL mid-append — summed into one
      per-principal bill. Intact records all count, corrupt lines are
      skipped, the command never raises on a damaged ledger; `--json`
      emits the machine form, `--sort` picks the ranking resource.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


# --- merge ---------------------------------------------------------------


def load_trace(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError(f"{path}: not a Chrome-trace dump "
                         "(no traceEvents key)")
    return data


def merge_traces(dumps: list, labels: Optional[list] = None) -> dict:
    """Union the dumps' traceEvents on the corrected timebase. Each
    dump's `metadata.clock_offset_seconds` (offset TO the reference
    clock: ref_time ≈ local_time + offset; None/absent means this dump
    IS the reference, e.g. the server) shifts its events. Distinct pids
    keep the processes apart in the viewer; a process_name metadata
    event labels each."""
    events = []
    offsets = {}
    used_pids = set()
    for i, dump in enumerate(dumps):
        meta = dump.get("metadata") or {}
        off_us = (meta.get("clock_offset_seconds") or 0.0) * 1e6
        pid = orig_pid = meta.get("pid", i)
        # Two containerized processes are routinely both PID 1: a
        # shared pid would interleave both sides into ONE viewer track
        # (with conflicting labels) — remap the later dump instead.
        while pid in used_pids:
            pid = pid * 1000 + i + 1
        used_pids.add(pid)
        label = (labels[i] if labels and i < len(labels) else None) \
            or meta.get("process_label") or f"proc{i}"
        offsets[str(pid)] = {"label": label, "source_pid": orig_pid,
                             "clock_offset_seconds": off_us / 1e6}
        if meta.get("profile_dir"):
            # The device plane's --profile-dir capture: name it next to
            # the merged timeline so the post-mortem links to the full
            # XLA trace.
            offsets[str(pid)]["profile_dir"] = meta["profile_dir"]
        seen_name = False
        for ev in dump.get("traceEvents", []):
            ev = dict(ev)
            if ev.get("ph") == "M":
                seen_name = ev.get("name") == "process_name" or seen_name
            elif "ts" in ev:
                ev["ts"] = ev["ts"] + off_us
            ev["pid"] = pid
            events.append(ev)
        if not seen_name:
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": label}})
    events.sort(key=lambda e: (e.get("ph") == "M" and -1 or 0,
                               e.get("ts", 0)))
    return {
        "traceEvents": events,
        "metadata": {"merged_from": offsets,
                     "timebase": "reference (server) wall clock, "
                                 "clock-probe corrected"},
    }


def hop_legs(merged: dict) -> dict:
    """Per-hop lag attribution over a merged trace (freshness plane,
    docs/OBSERVABILITY.md): every tier marks each turn on the SAME
    root-corrected timebase — `turn.emit` at the root, `turn.forward`
    (with `args.depth`) at each relay hop, `turn.apply` at the leaf
    client — so the end-to-end emit→apply time of a turn decomposes
    EXACTLY into per-hop legs by differencing successive marks. The
    legs sum to the end-to-end number by construction (it is the same
    telescoping difference); clock skew cancels because each dump's
    own measured offset already shifted it onto the root timebase
    (the per-hop snap-to-zero rules apply before that offset is
    ever published).

    Returns {"turns": N, "end_to_end_mean_s": ..., "legs": [{"leg":
    label, "mean_s": ..., "max_s": ...}, ...]} over every turn that
    has both an emit and an apply mark (reconnect replays keep the
    earliest mark per stage, like turn_pairs)."""
    stages: dict = {}
    for ev in merged.get("traceEvents", []):
        name = ev.get("name")
        if name not in ("turn.emit", "turn.forward", "turn.apply"):
            continue
        args = ev.get("args") or {}
        turn = args.get("turn")
        if turn is None:
            continue
        ts = ev.get("ts", 0.0)
        slot = stages.setdefault(int(turn), {})
        if name == "turn.forward":
            depth = args.get("depth")
            if depth is None:
                continue
            key = ("fwd", int(depth))
        else:
            key = (name.split(".")[1],)
        if key not in slot or ts < slot[key]:
            slot[key] = ts
    legs: dict = {}
    e2e = []
    for slot in stages.values():
        emit = slot.get(("emit",))
        apply_ts = slot.get(("apply",))
        if emit is None or apply_ts is None or apply_ts < emit:
            continue
        hops = sorted(
            (key[1], ts) for key, ts in slot.items()
            if key[0] == "fwd" and emit <= ts <= apply_ts
        )
        chain = [("emit", emit)] + [
            (f"hop{d}", ts) for d, ts in hops
        ] + [("apply", apply_ts)]
        e2e.append(apply_ts - emit)
        for (a, ta), (b, tb) in zip(chain, chain[1:]):
            legs.setdefault(f"{a}→{b}", []).append(tb - ta)
    return {
        "turns": len(e2e),
        "end_to_end_mean_s": (sum(e2e) / len(e2e) / 1e6) if e2e else None,
        "legs": [
            {"leg": name,
             "mean_s": sum(vals) / len(vals) / 1e6,
             "max_s": max(vals) / 1e6}
            for name, vals in sorted(legs.items())
        ],
    }


def turn_pairs(merged: dict) -> dict:
    """{turn: {"emit": ts_us, "apply": ts_us}} from a merged trace —
    the per-turn wire correlation the acceptance ordering is judged on
    (first emit / first apply per turn; reconnect replays keep the
    earliest)."""
    pairs: dict = {}
    for ev in merged.get("traceEvents", []):
        name = ev.get("name")
        if name not in ("turn.emit", "turn.apply"):
            continue
        turn = (ev.get("args") or {}).get("turn")
        if turn is None:
            continue
        side = "emit" if name == "turn.emit" else "apply"
        slot = pairs.setdefault(int(turn), {})
        ts = ev.get("ts", 0.0)
        if side not in slot or ts < slot[side]:
            slot[side] = ts
    return pairs


def replay_summary(log_dir: str, turn: int,
                   board_out: Optional[str] = None) -> dict:
    """Join the timeline with EXACT board history (gol_tpu_torch.replay,
    docs/REPLAY.md): decode the recording at the nearest state <= turn
    and summarize it — landed turn, alive count, a board digest (the
    bit-identity anchor two post-mortems can compare), optionally the
    raster itself as a PGM. The one numpy-touching corner of this
    otherwise-stdlib module, imported only when --replay-to is asked
    for."""
    import hashlib

    import numpy as np

    from gol_tpu_torch.replay.log import board_at, last_turn

    got = board_at(log_dir, int(turn))
    if got is None:
        return {"requested_turn": int(turn), "error": "no usable "
                f"recording under {log_dir}"}
    landed, board = got
    mask = np.ascontiguousarray((board != 0).astype(np.uint8))
    out = {
        "requested_turn": int(turn),
        "turn": int(landed),
        "recorded_last_turn": int(last_turn(log_dir)),
        "alive": int(np.count_nonzero(mask)),
        "width": int(board.shape[1]),
        "height": int(board.shape[0]),
        "board_sha256": hashlib.sha256(mask.tobytes()).hexdigest(),
        "log_dir": str(log_dir),
    }
    if board_out:
        from gol_tpu_torch.io.pgm import write_pgm

        write_pgm(board_out, board)
        out["board_pgm"] = str(board_out)
    return out


def _cmd_merge(args) -> int:
    dumps = [load_trace(p) for p in args.paths]
    merged = merge_traces(dumps, labels=args.label)
    if args.hops:
        hops = hop_legs(merged)
        merged["metadata"]["hops"] = hops
        if not hops["turns"]:
            print("hops: no turn with both an emit and an apply mark "
                  "(merge a root, its relays and a leaf client)",
                  file=sys.stderr)
        else:
            print(f"hops: {hops['turns']} turns decomposed, "
                  f"end-to-end mean "
                  f"{hops['end_to_end_mean_s'] * 1e3:.2f}ms")
            for leg in hops["legs"]:
                print(f"  {leg['leg']:<16} mean "
                      f"{leg['mean_s'] * 1e3:8.2f}ms   max "
                      f"{leg['max_s'] * 1e3:8.2f}ms")
    if args.replay_to is not None:
        if not args.replay_log:
            print("error: --replay-to needs --replay-log LOG-DIR",
                  file=sys.stderr)
            return 2
        rp = replay_summary(args.replay_log, args.replay_to,
                            board_out=args.replay_board)
        merged["metadata"]["replay"] = rp
        if "error" in rp:
            print(f"replay: {rp['error']}", file=sys.stderr)
        else:
            print(f"replay: turn {rp['turn']} (asked {rp['requested_turn']}"
                  f", recording ends {rp['recorded_last_turn']}), "
                  f"{rp['alive']} alive, board sha256 "
                  f"{rp['board_sha256'][:16]}…"
                  + (f", raster -> {rp['board_pgm']}"
                     if rp.get("board_pgm") else ""))
    out = json.dumps(merged, indent=1)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        pairs = turn_pairs(merged)
        matched = sum(1 for v in pairs.values()
                      if "emit" in v and "apply" in v)
        print(f"merged {len(args.paths)} dumps -> {args.output} "
              f"({len(merged['traceEvents'])} events, "
              f"{matched} turns matched emit<->apply)")
        for pid, info in merged["metadata"]["merged_from"].items():
            if info.get("profile_dir"):
                print(f"  {info['label']}: profiler capture at "
                      f"{info['profile_dir']}")
    else:
        sys.stdout.write(out + "\n")
    return 0


# --- render --------------------------------------------------------------


def _fmt_ts(ts: Optional[float]) -> str:
    if not ts:
        return "?"
    import datetime

    return datetime.datetime.fromtimestamp(ts).strftime("%H:%M:%S")


def _sparkline(values: list) -> str:
    if not values:
        return ""
    blocks = " ▁▂▃▄▅▆▇█"
    top = max(values) or 1
    return "".join(blocks[min(8, int(v / top * 8))] for v in values)


def render_flight(dump: dict, out=None) -> None:
    """Print the human post-mortem of one flight-recorder payload."""
    out = out or sys.stdout
    w = out.write
    if not dump.get("enabled", True):
        w("flight recorder: DISABLED — %s\n"
          % dump.get("reason", "no reason recorded"))
        return
    w("flight recorder post-mortem\n")
    w("  reason:   %s\n" % (dump.get("reason") or "live snapshot"))
    w("  process:  pid %s%s\n" % (
        dump.get("pid"),
        " (%s)" % dump["process_label"] if dump.get("process_label") else "",
    ))
    w("  dumped:   %s\n" % _fmt_ts(dump.get("dumped_at")))
    off = dump.get("clock_offset_seconds")
    if off is not None:
        w("  clock:    %+.6fs offset to the session reference\n" % off)
    state = dump.get("state")
    if state:
        w("  state:    %s\n" % json.dumps(state, sort_keys=True))

    entries = dump.get("entries", [])
    commits = [e for e in entries if e.get("kind") == "engine.commit"]
    if commits:
        last = commits[-1]
        w("  last committed turn recorded: %s at %s\n"
          % (last.get("turn"), _fmt_ts(last.get("ts"))))
        # Turn-rate curve: turns advanced per wall-second bucket over
        # the recorded window.
        t0, t1 = commits[0]["ts"], commits[-1]["ts"]
        span = max(t1 - t0, 1e-9)
        buckets = min(60, max(1, int(span) + 1))
        rate = [0.0] * buckets
        prev = commits[0].get("turn", 0)
        for e in commits[1:]:
            i = min(buckets - 1, int((e["ts"] - t0) / span * buckets))
            rate[i] += max(0, e.get("turn", prev) - prev)
            prev = e.get("turn", prev)
        w("  turn rate (%.1fs window, %d buckets): |%s|\n"
          % (span, buckets, _sparkline(rate)))
        # Stalls: inter-commit gaps far beyond the typical cadence.
        gaps = [(b["ts"] - a["ts"], a) for a, b in zip(commits, commits[1:])]
        if gaps:
            typical = sorted(g for g, _ in gaps)[len(gaps) // 2]
            thresh = max(1.0, 5.0 * typical)
            stalls = [(g, a) for g, a in gaps if g > thresh]
            if stalls:
                w("  stalls (> %.2fs between dispatch commits):\n" % thresh)
                for g, a in stalls[:10]:
                    w("    %.2fs after turn %s (%s)\n"
                      % (g, a.get("turn"), _fmt_ts(a.get("ts"))))
            else:
                w("  stalls: none (max gap %.3fs)\n"
                  % max(g for g, _ in gaps))

    by_kind: dict = {}
    for e in entries:
        by_kind.setdefault(e.get("kind"), []).append(e)
    lifecycle = [k for k in by_kind
                 if k and not k.startswith("engine.commit")]
    if lifecycle:
        w("  lifecycle events:\n")
        for k in sorted(lifecycle):
            evs = by_kind[k]
            w("    %-28s x%-4d last %s\n"
              % (k, len(evs), _fmt_ts(evs[-1].get("ts"))))
    storms = [e["ts"] for e in entries
              if e.get("kind") in ("client.reconnected", "server.evict")]
    # A storm is a RATE, not a lifetime count: three benign reconnects
    # hours apart (nightly restarts) must not cry wolf. Flag >= 3
    # events inside any sliding 5-minute window.
    STORM_N, STORM_WINDOW = 3, 300.0
    worst = None
    for i in range(len(storms) - STORM_N + 1):
        span_s = storms[i + STORM_N - 1] - storms[i]
        if span_s <= STORM_WINDOW and (worst is None or span_s < worst):
            worst = span_s
    if worst is not None:
        w("  RECONNECT STORM: %d+ reconnect/eviction events within "
          "%.1fs\n" % (STORM_N, worst))
    violations = [e for e in entries
                  if e.get("kind") == "invariant.violation"]
    if violations:
        w("  INVARIANT VIOLATIONS: %d (latest: %s)\n"
          % (len(violations), violations[-1]))

    deltas = dump.get("metric_deltas") or {}
    moved = sorted(
        ((k, v) for k, v in deltas.items()
         if isinstance(v, (int, float)) and v),
        key=lambda kv: -abs(kv[1]),
    )
    if moved:
        w("  top metric deltas since armed:\n")
        for k, v in moved[:12]:
            w("    %-58s %+g\n" % (k, v))
    if dump.get("dropped"):
        w("  (%d older notes evicted from the ring)\n" % dump["dropped"])


def _cmd_render(args) -> int:
    with open(args.path) as f:
        dump = json.load(f)
    render_flight(dump)
    return 0


# --- usage ---------------------------------------------------------------


def _cmd_usage(args) -> int:
    """Offline twin of the console's TOP-by-cost view, fed by ledger
    segments instead of live sidecars — the bill survives every crash
    the processes did."""
    from gol_tpu_torch.obs.accounting import RESOURCES, read_ledger

    totals: dict = {}
    for d in args.dirs:
        for p, res in read_ledger(d).items():
            dst = totals.setdefault(p, {})
            for k, v in res.items():
                dst[k] = dst.get(k, 0.0) + v
    if args.as_json:
        print(json.dumps({"principals": totals, "sort": args.sort},
                         indent=1, sort_keys=True))
        return 0
    ranked = sorted(totals,
                    key=lambda p: (-totals[p].get(args.sort, 0.0), p))
    print(f"usage ledger — {len(ranked)} principals over "
          f"{len(args.dirs)} dir(s), sorted by {args.sort}")
    hdr = f"{'PRINCIPAL':<21}  " + "  ".join(
        f"{r:>19}" for r in RESOURCES
    )
    print(hdr)
    rows = list(ranked) + ["TOTAL"]
    grand = {r: sum(t.get(r, 0.0) for t in totals.values())
             for r in RESOURCES}
    for p in rows:
        res = grand if p == "TOTAL" else totals[p]
        cells = "  ".join(f"{res.get(r, 0.0):>19.6g}" for r in RESOURCES)
        print(f"{p[:21]:<21}  {cells}")
    return 0


# --- entry ---------------------------------------------------------------


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Bare-path convenience: `report FLIGHT.json` renders it.
    if argv and argv[0] not in ("merge", "render", "usage",
                                "-h", "--help"):
        argv.insert(0, "render")
    ap = argparse.ArgumentParser(
        prog="python -m gol_tpu_torch.obs.report",
        description="Merge per-process trace dumps / render "
                    "flight-recorder post-mortems",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="join trace dumps onto one "
                                      "clock-corrected timeline")
    mp.add_argument("paths", nargs="+",
                    help="Chrome-trace dumps (server first is "
                         "conventional; offsets come from each dump's "
                         "own metadata)")
    mp.add_argument("-o", "--output", default=None,
                    help="write the merged trace here (default stdout)")
    mp.add_argument("-l", "--label", action="append", default=None,
                    metavar="NAME",
                    help="override process labels, in input order "
                         "(repeatable — useful when merging N relays "
                         "that all call themselves 'connect')")
    mp.add_argument("--hops", action="store_true",
                    help="per-hop lag attribution (freshness plane): "
                         "decompose each turn's emit→apply time into "
                         "per-hop legs from the merged turn.emit / "
                         "turn.forward / turn.apply marks — the legs "
                         "sum to the end-to-end number exactly; the "
                         "table prints and the breakdown lands in "
                         "metadata.hops")
    mp.add_argument("--replay-to", type=int, default=None,
                    dest="replay_to", metavar="TURN",
                    help="time-travel debugging (gol_tpu_torch.replay): "
                         "decode the --replay-log recording at TURN "
                         "and join the exact board state (landed "
                         "turn, alive count, sha256 digest) into the "
                         "merged metadata")
    mp.add_argument("--replay-log", default=None, dest="replay_log",
                    metavar="LOG-DIR",
                    help="the recording to decode for --replay-to (a "
                         "session's replay/ directory)")
    mp.add_argument("--replay-board", default=None, dest="replay_board",
                    metavar="OUT.pgm",
                    help="with --replay-to: also write the decoded "
                         "raster as a PGM snapshot")
    mp.set_defaults(fn=_cmd_merge)
    rp = sub.add_parser("render", help="human post-mortem of a "
                                       "flight-recorder dump")
    rp.add_argument("path")
    rp.set_defaults(fn=_cmd_render)
    up = sub.add_parser("usage", help="aggregate crash-safe usage "
                                      "ledger segments into one "
                                      "per-principal bill")
    up.add_argument("dirs", nargs="+", metavar="LEDGER-DIR",
                    help="directories holding usage-*.jsonl segments "
                         "(the CLI writes <out>/usage/)")
    up.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable totals instead of the table")
    up.add_argument("--sort", default="flops",
                    choices=("flops", "dispatch_seconds", "host_seconds",
                             "wire_bytes", "queue_frame_seconds",
                             "turns"),
                    help="resource the table ranks on (default flops)")
    up.set_defaults(fn=_cmd_usage)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
