"""Seeded chaos harness for the multi-session serving plane.

The counterpart of `gol_tpu.testing.chaos`: its scenario, seeds,
oracles and report, with three differences kept on purpose —

- `ChaosRunner` spawns `python -m gol_tpu_torch` with `--platform
  gpu` by default (its `platform` argument; the CPU tests pass "cpu"),
  so the server's session buckets step on the card, a packable bucket's
  chunk one launch of kernel A's batched entry;
- `oracle_board` and the observers' incremental oracle step the recipe
  with this package's single-board stepper on an explicit
  `device="cpu"`: the plain version, an independent computation that
  the card's batched kernel is judged against;
- the runner keeps each boot's wall (`boot_walls`) and the server's
  `/metrics` text just before each SIGKILL (`metrics_before_kill`) and
  at the judgement (`metrics_after`), beside the report, which stays
  gol_tpu's.

The fault harness (`gol_tpu_torch.testing.faults`) proves ONE planned
failure at a time. Production dies messier: a server SIGKILLed in the
middle of a verb storm while an observer's reader is wedged and three
control clients are retrying creates through the restart. This module
is the scenario runner for that shape of chaos (docs/RESILIENCE.md
"Chaos harness"): every source of disorder draws from ONE seed, so a
failing scenario replays bit-for-bit, and the end state is judged
against exact oracles —

- **bit-identity**: every surviving session's board must equal the
  fused single-board stepper run of its creation recipe to the same
  turn (`oracle_board`) — i.e. identical to an unfaulted run;
- **ledger consistency**: the live session set must be exactly
  created-minus-destroyed (retried creates never double-create,
  destroyed sessions never resurrect across `--resume latest`);
- **invariant counters at zero**: the runtime checkers must not
  have seen a single violation anywhere in the process mesh.

Building blocks (composable in-process — `tests/test_torch_chaos.py`
wires them against a `SessionServer` thread and emulates the crash; the
subprocess `ChaosRunner` adds the real SIGKILL and is what
`python -m gol_tpu_torch.testing.chaos --seed N` drives):

- `VerbStorm`: a thread issuing a seeded create/checkpoint/destroy
  sequence over its own session-id namespace through the idempotent
  retrying `SessionControl`, keeping the ledger of what must exist
  afterwards;
- `ShadowObserver`: a raw-socket watcher of one session that applies
  flips/syncs to a shadow raster, *stalls its reader* on a seeded
  schedule (driving the server's slow-consumer degradation), verifies
  every BoardSync bit-exactly against the oracle, and re-dials
  through crashes;
- `oracle_board`: the unfaulted reference — the creation recipe
  stepped by the single-board stepper on the CPU (bit-equality of that
  stepper vs the session layer is pinned by
  `tests/test_torch_sessions.py`).
"""

from __future__ import annotations

import contextlib
import random
import socket
import threading
import time
from typing import Optional

import numpy as np

__all__ = [
    "ChaosError",
    "ChaosRunner",
    "Recipe",
    "ShadowObserver",
    "VerbStorm",
    "oracle_board",
    "parse_metric",
]


class ChaosError(AssertionError):
    """A chaos scenario ended in a state the contract forbids."""


class Recipe:
    """One session's creation recipe — everything needed to rebuild
    its turn-0 board and judge any later state bit-exactly. Life-like
    two-state rules only (the session layer's own restriction)."""

    def __init__(self, sid: str, width: int = 64, height: int = 64,
                 seed: int = 0, density: float = 0.25,
                 rule: str = "B3/S23"):
        self.sid = sid
        self.width = width
        self.height = height
        self.seed = seed
        self.density = density
        self.rule = rule

    def board0(self) -> np.ndarray:
        from gol_tpu_torch.sessions.manager import seeded_board

        return seeded_board(self.height, self.width, self.seed,
                            self.density)

    def create_kwargs(self) -> dict:
        return {"width": self.width, "height": self.height,
                "rule": self.rule, "seed": self.seed,
                "density": self.density}


#: States the oracle remembers while it looks for the board's period;
#: past this many turns it steps on without looking.
ORACLE_MEMORY = 1 << 16


def oracle_board(recipe: Recipe, turn: int) -> np.ndarray:
    """The unfaulted run's board at `turn`: the recipe's soup stepped
    by the single-board stepper on the CPU (the plain version; bit-equal
    to the session layer by the pinned oracle tests). A server on the
    card free-runs its idle sessions through millions of turns, so the
    oracle remembers every state it passes: once a state repeats (a
    finite torus is eventually periodic), the remaining turns collapse
    modulo the period — the same exact argument as the engine's cycle
    fast-forward, each repeat confirmed on the full state. Returns a
    {0,255} uint8 (H, W) raster."""
    from gol_tpu_torch.parallel.stepper import make_stepper

    s = make_stepper(threads=1, height=recipe.height,
                     width=recipe.width, rule=recipe.rule, device="cpu")
    w = s.put(recipe.board0())
    turn = int(turn)
    seen: dict = {}
    t = 0
    while t < turn and len(seen) < ORACLE_MEMORY:
        state = w.numpy().tobytes()
        if state in seen:
            t = turn - (turn - t) % (t - seen[state])
            break
        seen[state] = t
        w = s.step(w)
        t += 1
    if t < turn:
        w, _ = s.step_n(w, turn - t)
    return np.asarray(s.fetch(w), np.uint8)


def parse_metric(text: str, name: str) -> float:
    """Sum every sample of `name` in a Prometheus-text exposition
    (labeled children sum; absent series is 0.0)."""
    total, seen = 0.0, False
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest[:1] not in ("", " ", "{"):
            continue  # a longer name sharing the prefix
        try:
            total += float(line.rsplit(None, 1)[1])
            seen = True
        except (IndexError, ValueError):
            continue
    return total if seen else 0.0


class VerbStorm(threading.Thread):
    """One seeded storm of idempotent session verbs over a private id
    namespace. Every verb goes through `SessionControl`'s retrying
    path, so the storm survives server crashes mid-verb — the ledger
    it keeps is therefore EXACT: after `run` returns without error,
    `alive` names precisely the sessions that must exist (with their
    recipes) and `destroyed` the ones that must never come back."""

    #: Verb mix per step (seeded choice): mostly creates/destroys —
    #: the lifecycle verbs whose idempotency chaos exists to test.
    _OPS = ("create", "create", "destroy", "checkpoint", "list")

    def __init__(self, address, *, seed: int, prefix: str,
                 verbs: int = 24, board_side: int = 64,
                 secret: Optional[str] = None,
                 retry_window: float = 60.0,
                 on_verb=None):
        super().__init__(name=f"chaos-storm-{prefix}", daemon=True)
        self._address = address
        self._rng = random.Random(seed)
        self._prefix = prefix
        self._verbs = verbs
        self._side = board_side
        self._secret = secret
        self._window = retry_window
        #: Called after every completed verb (the runner's SIGKILL
        #: trigger counts these across storms).
        self._on_verb = on_verb or (lambda: None)
        self.alive: "dict[str, Recipe]" = {}
        self.destroyed: "set[str]" = set()
        self.completed = 0
        self.error: Optional[BaseException] = None

    def _recipe(self, i: int) -> Recipe:
        return Recipe(f"{self._prefix}-{i}", width=self._side,
                      height=self._side,
                      seed=self._rng.randrange(2 ** 31),
                      density=0.2 + 0.2 * self._rng.random())

    def run(self) -> None:
        from gol_tpu_torch.distributed.client import SessionControl

        try:
            ctl = SessionControl(*self._address, secret=self._secret,
                                 timeout=15.0,
                                 retry_window=self._window,
                                 retry_seed=self._rng.randrange(2 ** 31))
        except BaseException as e:
            self.error = e
            return
        try:
            ids = [self._recipe(i) for i in range(4)]
            for _ in range(self._verbs):
                op = self._rng.choice(self._OPS)
                r = ids[self._rng.randrange(len(ids))]
                try:
                    if op == "create" and r.sid not in self.alive:
                        ctl.create(r.sid, **r.create_kwargs())
                        self.alive[r.sid] = r
                        self.destroyed.discard(r.sid)
                    elif op == "destroy" and r.sid in self.alive:
                        ctl.destroy(r.sid)
                        del self.alive[r.sid]
                        self.destroyed.add(r.sid)
                    elif op == "checkpoint" and r.sid in self.alive:
                        ctl.checkpoint(r.sid)
                    else:
                        ctl.list()
                except ValueError as e:
                    # SessionError without a ConnectionError pedigree:
                    # max-sessions past the retry window is legal
                    # under admission chaos; anything else is a bug.
                    if str(e) != "max-sessions":
                        raise
                self.completed += 1
                self._on_verb()
        except BaseException as e:
            self.error = e
        finally:
            with contextlib.suppress(Exception):
                ctl.close()


class ShadowObserver(threading.Thread):
    """Raw-socket watcher of one session: maintains a shadow raster
    from syncs + flips (synced_turn-gated, exactly the client
    contract), STALLS its own reader on a seeded schedule to drive the
    server's slow-consumer degradation, verifies every BoardSync
    bit-exactly against the incremental oracle, and re-dials through
    server crashes. `errors` collects contract violations (a non-empty
    list fails the scenario)."""

    def __init__(self, address, recipe: Recipe, *, seed: int,
                 secret: Optional[str] = None,
                 stall_secs: float = 1.0, stall_every: int = 40,
                 rcvbuf: int = 4096):
        super().__init__(name=f"chaos-observe-{recipe.sid}", daemon=True)
        self._address = address
        self._recipe = recipe
        self._rng = random.Random(seed)
        self._secret = secret
        self._stall_secs = stall_secs
        self._stall_every = max(1, stall_every)
        self._rcvbuf = rcvbuf
        self._halt = threading.Event()
        self.errors: "list[str]" = []
        self.syncs = 0
        self.verified_turn = 0
        self.stalls = 0
        # Incremental oracle: the recipe's board stepped to
        # `self._oracle_turn` by the fused stepper (cheap deltas).
        self._stepper = None
        self._oracle_w = None
        self._oracle_turn = 0
        self._shadow: Optional[np.ndarray] = None
        self._shadow_turn = -1

    def stop(self) -> None:
        self._halt.set()

    # --- oracle ---

    def _oracle_at(self, turn: int) -> np.ndarray:
        from gol_tpu_torch.parallel.stepper import make_stepper

        r = self._recipe
        if self._stepper is None:
            self._stepper = make_stepper(threads=1, height=r.height,
                                         width=r.width, rule=r.rule,
                                         device="cpu")
            self._oracle_w = self._stepper.put(r.board0())
            self._oracle_turn = 0
        if turn < self._oracle_turn:  # restart (resumed below a peak)
            self._oracle_w = self._stepper.put(r.board0())
            self._oracle_turn = 0
        if turn > self._oracle_turn:
            self._oracle_w, _ = self._stepper.step_n(
                self._oracle_w, turn - self._oracle_turn
            )
            self._oracle_turn = turn
        return np.asarray(self._stepper.fetch(self._oracle_w), np.uint8)

    def _check(self, turn: int, what: str) -> None:
        want = self._oracle_at(turn) != 0
        if not np.array_equal(self._shadow != 0, want):
            self.errors.append(
                f"{self._recipe.sid}: {what} at turn {turn} diverges "
                f"from the unfaulted oracle"
            )
        else:
            self.verified_turn = max(self.verified_turn, turn)

    # --- the watching loop ---

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                self._watch_once()
            except (OSError, ConnectionError, TimeoutError):
                # Server down (crash window) or our stall got us
                # evicted past the drain deadline: re-dial.
                time.sleep(0.2 + 0.3 * self._rng.random())
            except Exception as e:  # contract bug, not chaos
                self.errors.append(
                    f"{self._recipe.sid}: observer died: {e!r}"
                )
                return

    def _watch_once(self) -> None:
        from gol_tpu_torch.distributed import wire

        sock = socket.create_connection(self._address, timeout=10)
        try:
            # A small receive buffer makes reader stalls reach the
            # server's writer queue quickly (the kernel can't absorb
            # the backlog for us).
            with contextlib.suppress(OSError):
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                self._rcvbuf)
            sock.settimeout(10)
            hello = {"t": "hello", "want_flips": True,
                     "role": "observe", "session": self._recipe.sid}
            if self._secret is not None:
                hello["secret"] = self._secret
            wire.send_msg(sock, hello)
            msgs = 0
            while not self._halt.is_set():
                msg = wire.recv_msg(sock, allow_binary=False)
                if msg is None:
                    return
                t = msg.get("t")
                if t == "error":
                    # unknown-session right after a crash restart —
                    # resume may still be materializing it.
                    return
                if t == "bye":
                    return
                if t == "board":
                    turn, board = wire.msg_to_board(msg)
                    self._shadow = np.array(board, np.uint8)
                    self._shadow_turn = turn
                    self.syncs += 1
                    self._check(turn, "BoardSync")
                elif t == "flips" and self._shadow is not None:
                    turn, coords = wire.msg_flips_array(msg)
                    if turn > self._shadow_turn and len(coords):
                        xy = np.asarray(coords).reshape(-1, 2)
                        self._shadow[xy[:, 1], xy[:, 0]] ^= np.uint8(255)
                        self._shadow_turn = turn
                msgs += 1
                if msgs % self._stall_every == 0:
                    # The chaos ingredient: wedge our own reader. The
                    # server must degrade us (shed + coalesce), never
                    # corrupt us — the next BoardSync's bit-check is
                    # the judge.
                    self.stalls += 1
                    if self._halt.wait(
                        self._stall_secs * (0.5 + self._rng.random())
                    ):
                        return
        finally:
            with contextlib.suppress(OSError):
                sock.close()

    def final_check(self) -> None:
        """Verify the last applied state once more (call after stop;
        flips-built states between syncs get judged too)."""
        if self._shadow is not None and self._shadow_turn >= 0:
            self._check(self._shadow_turn, "final shadow")


class ChaosRunner:
    """The full subprocess scenario: a REAL `--serve --sessions`
    process, seeded verb storms + stalled observers against it,
    SIGKILL at a seeded verb count (mid-storm, so verbs are genuinely
    in flight), restart with `--resume latest` on the same port, and
    the end-state judgement. One seed drives every draw. Returns the
    report dict on success; raises ChaosError with the full complaint
    list otherwise.

    `tests/test_torch_chaos.py::test_chaos_sigkill_storm_resume` runs
    it small on the CPU (`platform="cpu"`); `python -m
    gol_tpu_torch.testing.chaos` runs it as a shell-visible smoke, its
    server on the card."""

    def __init__(self, *, seed: int, workdir: str,
                 image_dir: str = "fixtures/images",
                 storms: int = 2, verbs_per_storm: int = 12,
                 kills: int = 1, stall_secs: float = 1.0,
                 fault_spec: Optional[str] = None,
                 max_sessions: Optional[int] = None,
                 boot_timeout: float = 120.0,
                 settle_timeout: float = 240.0,
                 platform: str = "gpu"):
        import os

        self._rng = random.Random(seed)
        self.seed = seed
        self.workdir = workdir
        self.out_dir = os.path.join(workdir, "out")
        self.image_dir = os.path.abspath(image_dir)
        self.storms_n = storms
        self.verbs_per_storm = verbs_per_storm
        self.kills = kills
        self.stall_secs = stall_secs
        self.fault_spec = fault_spec
        self.max_sessions = max_sessions
        self.boot_timeout = boot_timeout
        self.settle_timeout = settle_timeout
        self._proc = None
        self._log_path = None
        self._boot = 0
        self._verb_count = 0
        self._verb_lock = threading.Lock()
        self.metrics_port: Optional[int] = None
        self.platform = platform
        #: Seconds from each server spawn to its banners.
        self.boot_walls: "list[float]" = []
        #: The server's /metrics text just before each SIGKILL, and at
        #: the judgement.
        self.metrics_before_kill: "list[str]" = []
        self.metrics_after = ""

    # --- server process management ---

    def _spawn_server(self, port: int, resume: bool):
        import os
        import subprocess
        import sys

        self._boot += 1
        self._log_path = f"{self.workdir}/server-{self._boot}.log"
        cmd = [sys.executable, "-m", "gol_tpu_torch",
               "-w", "64", "-h", "64", "-t", "1", "-noVis",
               "--platform", self.platform,
               "--serve", f"127.0.0.1:{port}", "--sessions",
               "--images", self.image_dir, "--out", self.out_dir,
               "--autosave-turns", "64",
               "--hb-secs", "0.5", "--metrics-port", "0",
               "--check-invariants",
               "--high-water", "24", "--drain-secs", "6"]
        if self.max_sessions is not None:
            cmd += ["--max-sessions", str(self.max_sessions)]
        if resume:
            cmd += ["--resume", "latest"]
        env = dict(os.environ)
        # The child runs with cwd=workdir (its out/ tree must not
        # litter the repo): put the repo on its import path instead.
        import gol_tpu_torch

        repo = os.path.dirname(os.path.dirname(
            os.path.abspath(gol_tpu_torch.__file__)
        ))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        # Chaos always runs with the deadlock/leak detector armed: a
        # fault schedule that drives the server into a lock-order cycle
        # or a held-too-long stall must fail the run, not hang it.
        env.setdefault("GOL_TPU_LOCKCHECK", "1")
        if self.fault_spec:
            env["GOL_TPU_FAULTS"] = self.fault_spec
        t0 = time.monotonic()
        with open(self._log_path, "w") as log:
            self._proc = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=self.workdir,
            )
        self._await_banner()
        self.boot_walls.append(time.monotonic() - t0)

    def _await_banner(self) -> None:
        deadline = time.monotonic() + self.boot_timeout
        serving = mport = None
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise ChaosError(
                    f"server died during boot — see {self._log_path}"
                )
            with open(self._log_path) as f:
                for line in f:
                    if "session engine serving on" in line:
                        serving = line
                    if "metrics serving on" in line:
                        mport = int(
                            line.rsplit(":", 1)[1].split("/", 1)[0]
                        )
            if serving and mport:
                self.metrics_port = mport
                return
            time.sleep(0.2)
        raise ChaosError(f"server never bound — see {self._log_path}")

    def _sigkill_server(self) -> None:
        import signal

        self._proc.send_signal(signal.SIGKILL)
        self._proc.wait(timeout=30)

    def _stop_server(self) -> None:
        import signal

        if self._proc is None or self._proc.poll() is not None:
            return
        self._proc.send_signal(signal.SIGTERM)
        try:
            self._proc.wait(timeout=30)
        except Exception:
            self._proc.kill()
            self._proc.wait(timeout=10)

    def _fetch_metrics(self) -> str:
        import urllib.request

        with urllib.request.urlopen(
            f"http://127.0.0.1:{self.metrics_port}/metrics", timeout=10
        ) as r:
            return r.read().decode()

    # --- the scenario ---

    def _count_verb(self) -> None:
        with self._verb_lock:
            self._verb_count += 1

    def run(self) -> dict:
        from gol_tpu_torch.distributed.client import SessionControl
        from gol_tpu_torch.io.pgm import read_pgm

        port = _free_port()
        address = ("127.0.0.1", port)
        self._spawn_server(port, resume=False)
        complaints: "list[str]" = []
        report: dict = {"seed": self.seed, "kills": 0}
        storms: "list[VerbStorm]" = []
        observers: "list[ShadowObserver]" = []
        try:
            # Pinned sessions: never destroyed, watched by the
            # stalled observers — the degradation + bit-identity
            # probes of the scenario.
            # Fat boards for the pinned pair: their per-turn flip
            # frames are big enough that a stalled reader reaches the
            # writer-queue high-water mark (drives degradation).
            pinned = [
                Recipe(f"pin-{i}", width=192, height=192,
                       seed=self._rng.randrange(2 ** 31),
                       density=0.25 + 0.1 * self._rng.random())
                for i in range(2)
            ]
            boot_ctl = SessionControl(*address, timeout=15.0,
                                      retry_window=60.0,
                                      retry_seed=self.seed)
            for r in pinned:
                boot_ctl.create(r.sid, **r.create_kwargs())
            for i, r in enumerate(pinned):
                ob = ShadowObserver(address, r,
                                    seed=self._rng.randrange(2 ** 31),
                                    stall_secs=self.stall_secs,
                                    stall_every=30 + 10 * i)
                ob.start()
                observers.append(ob)
            for i in range(self.storms_n):
                st = VerbStorm(address,
                               seed=self._rng.randrange(2 ** 31),
                               prefix=f"storm{i}",
                               verbs=self.verbs_per_storm,
                               retry_window=120.0,
                               on_verb=self._count_verb)
                st.start()
                storms.append(st)

            # SIGKILL at a seeded verb count — genuinely mid-storm.
            total_verbs = self.storms_n * self.verbs_per_storm
            for k in range(self.kills):
                lo = (k + 1) * total_verbs // (self.kills + 1)
                kill_at = max(1, lo - self._rng.randrange(3))
                deadline = time.monotonic() + self.settle_timeout
                while (self._verb_count < kill_at
                       and any(s.is_alive() for s in storms)
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                if not any(s.is_alive() for s in storms):
                    break  # storms already done: kill would be idle
                with contextlib.suppress(OSError):
                    self.metrics_before_kill.append(self._fetch_metrics())
                self._sigkill_server()
                report["kills"] += 1
                self._spawn_server(port, resume=True)

            deadline = time.monotonic() + self.settle_timeout
            for s in storms:
                s.join(max(1.0, deadline - time.monotonic()))
                if s.is_alive():
                    complaints.append(f"storm {s.name} never finished")
                elif s.error is not None:
                    complaints.append(
                        f"storm {s.name} failed: {s.error!r}"
                    )
            for ob in observers:
                ob.stop()
            for ob in observers:
                ob.join(15.0)

            # --- judgement ---
            ctl = SessionControl(*address, timeout=15.0,
                                 retry_window=60.0,
                                 retry_seed=self.seed + 1)
            live = {s["id"] for s in ctl.list()}
            expected: "dict[str, Recipe]" = {
                r.sid: r for r in pinned
            }
            destroyed: "set[str]" = set()
            for s in storms:
                expected.update(s.alive)
                destroyed |= s.destroyed
            destroyed -= set(expected)
            if live != set(expected):
                complaints.append(
                    f"live sessions {sorted(live)} != ledger "
                    f"{sorted(expected)} (duplicates or losses)"
                )
            resurrected = live & destroyed
            if resurrected:
                complaints.append(
                    f"destroyed sessions resurrected: "
                    f"{sorted(resurrected)}"
                )
            verified = 0
            for sid in sorted(live & set(expected)):
                r = expected[sid]
                cp = ctl.checkpoint(sid)
                got = read_pgm(cp["path"])
                want = oracle_board(r, int(cp["turn"]))
                if not np.array_equal(got != 0, want != 0):
                    complaints.append(
                        f"{sid}: board at turn {cp['turn']} differs "
                        f"from the unfaulted run"
                    )
                else:
                    verified += 1
            for ob in observers:
                ob.final_check()
                complaints.extend(ob.errors)
            metrics = self.metrics_after = self._fetch_metrics()
            violations = parse_metric(
                metrics, "gol_tpu_invariant_violations_total"
            )
            if violations:
                complaints.append(
                    f"{int(violations)} invariant violation(s) on the "
                    f"server"
                )
            lock_reports = parse_metric(
                metrics, "gol_tpu_lockcheck_violations_total"
            )
            if lock_reports:
                complaints.append(
                    f"{int(lock_reports)} lockcheck report(s) on the "
                    f"server (lock-order cycle or held-too-long)"
                )
            report.update(
                verbs=self._verb_count,
                sessions_verified=verified,
                live=sorted(live),
                destroyed=sorted(destroyed),
                observer_syncs=sum(ob.syncs for ob in observers),
                observer_stalls=sum(ob.stalls for ob in observers),
                observer_verified_turn=max(
                    (ob.verified_turn for ob in observers), default=0
                ),
                degradations=parse_metric(
                    metrics, "gol_tpu_server_degradations_total"
                ),
                recoveries=parse_metric(
                    metrics, "gol_tpu_server_degraded_recoveries_total"
                ),
                invariant_violations=int(violations),
                lockcheck_violations=int(lock_reports),
            )
            ctl.close()
            boot_ctl.close()
        finally:
            for ob in observers:
                ob.stop()
            self._stop_server()
        if complaints:
            raise ChaosError(
                f"chaos seed {self.seed}: " + "; ".join(complaints)
            )
        return report


def _free_port() -> int:
    s = socket.create_server(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None) -> int:
    """`python -m gol_tpu_torch.testing.chaos --seed N` — the shell
    entry; prints the report as JSON (its server on the card unless
    `--platform cpu`)."""
    import argparse
    import json
    import tempfile

    ap = argparse.ArgumentParser(prog="gol_tpu_torch.testing.chaos")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--storms", type=int, default=2)
    ap.add_argument("--verbs", type=int, default=12)
    ap.add_argument("--kills", type=int, default=1)
    ap.add_argument("--faults", default=None,
                    help="GOL_TPU_FAULTS spec for the server process")
    ap.add_argument("--max-sessions", type=int, default=None)
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                    help="where the server steps its sessions")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="gol-chaos-")
    runner = ChaosRunner(seed=args.seed, workdir=workdir,
                         storms=args.storms,
                         verbs_per_storm=args.verbs,
                         kills=args.kills, fault_spec=args.faults,
                         max_sessions=args.max_sessions,
                         platform=args.platform)
    report = runner.run()
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
