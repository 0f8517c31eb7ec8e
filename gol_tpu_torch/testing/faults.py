"""Deterministic fault injection for the controller ⇄ engine link.

The resilience layer (heartbeats, auto-reconnect, crash-restart — see
docs/RESILIENCE.md) is only trustworthy if every failure mode it claims
to survive is *reproducibly exercised*, not hoped for. This module is
that harness: a socket proxy that injects a planned fault at exactly
the Nth send/recv operation of a role's sockets — no randomness in
when a fault fires, so a failing test replays bit-for-bit.

Plans come from the `GOL_TPU_FAULTS` environment variable (picked up by
the server's accept path and the client's dial path) or from
`install()` in-process (tests). Spec grammar, rules joined with ';':

    ROLE:KIND@OP:NTH[:ARG]

    ROLE  "client" (sockets the Controller dials) or
          "server" (sockets the EngineServer accepts)
    KIND  reset    hard-RST the connection and raise (both ops)
          delay    sleep ARG seconds before the op (both ops)
          drop     swallow the payload, report success   (send only)
          dup      transmit the payload twice            (send only)
          partial  transmit half the payload, then RST   (send only)
    OP    "send" or "recv"
    NTH   1-based operation count, per (role, op), across every socket
          wrapped for that role in this process
    ARG   kind-specific float (delay seconds)

Examples:

    GOL_TPU_FAULTS="client:reset@recv:40"
        the client's 40th socket read resets the connection mid-stream
        (the auto-reconnect acceptance scenario)
    GOL_TPU_FAULTS="server:delay@send:3:0.25;client:dup@send:7"
        the server's 3rd write stalls 250 ms and the client's 7th
        write is duplicated on the wire

Operation counts are deterministic because the wire protocol is: one
`sendall` per frame, two `recv` syscall-batches per frame (length
header, then payload). Each rule fires exactly once.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "FaultPlan",
    "FaultRule",
    "FaultSpecError",
    "FaultySocket",
    "active_plan",
    "clear",
    "install",
    "wrap",
]

_ROLES = ("client", "server")
_OPS = ("send", "recv")
_KINDS = ("reset", "delay", "drop", "dup", "partial")
_SEND_ONLY = ("drop", "dup", "partial")


class FaultSpecError(ValueError):
    """A GOL_TPU_FAULTS spec that does not parse."""


class FaultRule:
    """One planned fault: fire `kind` at the `nth` `op` of `role`."""

    def __init__(self, role: str, kind: str, op: str, nth: int,
                 arg: float = 0.0):
        if role not in _ROLES:
            raise FaultSpecError(f"unknown role {role!r} (want client|server)")
        if kind not in _KINDS:
            raise FaultSpecError(f"unknown fault kind {kind!r}")
        if op not in _OPS:
            raise FaultSpecError(f"unknown op {op!r} (want send|recv)")
        if kind in _SEND_ONLY and op != "send":
            raise FaultSpecError(f"fault {kind!r} applies to send only")
        if nth < 1:
            raise FaultSpecError(f"nth must be >= 1, got {nth}")
        self.role, self.kind, self.op, self.nth, self.arg = (
            role, kind, op, nth, arg
        )
        self.fired = False

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"FaultRule({self.role}:{self.kind}@{self.op}:"
                f"{self.nth}:{self.arg})")


class FaultPlan:
    """A set of rules plus the per-(role, op) operation counters they
    fire against. One plan is active per process; counters are shared
    across every socket wrapped under it, which is what makes the Nth
    operation well-defined for a multi-connection run."""

    def __init__(self, rules: List[FaultRule]):
        self.rules = list(rules)
        self._counts: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules = []
        for raw in spec.replace(",", ";").split(";"):
            part = raw.strip()
            if not part:
                continue
            try:
                role, rest = part.split(":", 1)
                kind_op, tail = rest.split(":", 1)
                kind, op = kind_op.split("@", 1)
                bits = tail.split(":")
                nth = int(bits[0])
                arg = float(bits[1]) if len(bits) > 1 else 0.0
            except (ValueError, IndexError):
                raise FaultSpecError(
                    f"bad fault rule {part!r} — want ROLE:KIND@OP:NTH[:ARG]"
                ) from None
            rules.append(FaultRule(role.strip(), kind.strip(), op.strip(),
                                   nth, arg))
        if not rules:
            raise FaultSpecError(f"no rules in fault spec {spec!r}")
        return cls(rules)

    def next_fault(self, role: str, op: str) -> Optional[FaultRule]:
        """Count one (role, op) operation; the rule to fire now, if any."""
        with self._lock:
            key = (role, op)
            self._counts[key] = n = self._counts.get(key, 0) + 1
            for rule in self.rules:
                if (not rule.fired and rule.role == role and rule.op == op
                        and rule.nth == n):
                    rule.fired = True
                    return rule
        return None

    def counts(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._counts)


#: Process-global active plan. `wrap()` consults it (falling back to
#: GOL_TPU_FAULTS) so production call sites stay one-liners.
_ACTIVE: Optional[FaultPlan] = None
_ENV_SPEC: Optional[str] = None  # spec the env-derived plan was built from


def install(plan: FaultPlan) -> FaultPlan:
    """Activate a plan programmatically (tests). Pair with `clear()`.
    Clears the env-spec marker so a later GOL_TPU_FAULTS change can
    never silently replace or deactivate the installed plan — install
    wins until clear(), as documented."""
    global _ACTIVE, _ENV_SPEC
    _ACTIVE = plan
    _ENV_SPEC = None
    return plan


def clear() -> None:
    global _ACTIVE, _ENV_SPEC
    _ACTIVE = None
    _ENV_SPEC = None


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one lazily built from GOL_TPU_FAULTS.
    An env-derived plan is rebuilt whenever the variable's value
    changes (each test/subprocess run gets fresh counters); a plan
    `install()`ed programmatically wins over the environment until
    `clear()`."""
    global _ACTIVE, _ENV_SPEC
    if _ACTIVE is not None and _ENV_SPEC is None:
        return _ACTIVE  # programmatic install
    spec = os.environ.get("GOL_TPU_FAULTS")
    if not spec:
        _ACTIVE = _ENV_SPEC = None
        return None
    if spec != _ENV_SPEC:
        _ACTIVE = FaultPlan.parse(spec)
        _ENV_SPEC = spec
    return _ACTIVE


def wrap(role: str, sock: socket.socket) -> socket.socket:
    """The one production entry point: proxy `sock` under the active
    plan's rules for `role`, or return it untouched when no plan is
    active — the happy path pays a None check and nothing else."""
    plan = active_plan()
    if plan is None or not any(r.role == role for r in plan.rules):
        return sock
    return FaultySocket(sock, role, plan)


class FaultySocket:
    """Socket proxy injecting planned faults on send/recv.

    Everything not intercepted (settimeout, setsockopt, shutdown,
    close, getsockname, ...) delegates to the real socket, so the
    proxy drops into any call site that holds a socket."""

    def __init__(self, sock: socket.socket, role: str, plan: FaultPlan):
        self._sock = sock
        self._role = role
        self._plan = plan

    def __getattr__(self, name):
        return getattr(self._sock, name)

    def _hard_reset(self) -> None:
        """Close with SO_LINGER 0 so the peer sees an RST, not FIN —
        the abrupt-death shape (power loss, SIGKILL'd kernel peer)."""
        try:
            self._sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0),
            )
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def sendall(self, data, *args):
        rule = self._plan.next_fault(self._role, "send")
        if rule is not None:
            if rule.kind == "delay":
                time.sleep(rule.arg)
            elif rule.kind == "drop":
                return None  # swallowed: the peer sees a framing hole
            elif rule.kind == "dup":
                self._sock.sendall(data, *args)
            elif rule.kind == "partial":
                half = bytes(data)[: max(1, len(data) // 2)]
                try:
                    self._sock.sendall(half, *args)
                finally:
                    self._hard_reset()
                raise ConnectionResetError(
                    "injected fault: partial write then reset"
                )
            elif rule.kind == "reset":
                self._hard_reset()
                raise ConnectionResetError("injected fault: send reset")
        return self._sock.sendall(data, *args)

    def send(self, data, *args):
        # Routed through sendall accounting so N counts whole-frame
        # writes however the caller spells them.
        self.sendall(data, *args)
        return len(data)

    def recv(self, *args):
        rule = self._plan.next_fault(self._role, "recv")
        if rule is not None:
            if rule.kind == "delay":
                time.sleep(rule.arg)
            elif rule.kind == "reset":
                self._hard_reset()
                raise ConnectionResetError("injected fault: recv reset")
        return self._sock.recv(*args)
