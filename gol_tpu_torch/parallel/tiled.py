"""Activity-driven tiled stepping — macro-tiles, light-cone skips, a
host-resident universe, and the batched kernel A on the card.

The counterpart of `gol_tpu.parallel.tiled`. Real Life boards are
mostly settled space, and a dense dispatch pays for every cell every
turn anyway. This backend tiles the packed universe into fixed
TILE x TILE macro-tiles and steps, per k-turn chunk, ONLY the tiles
whose halo-depth light cone touched a live change:

- **Geometry.** The world stays in the packed word layout — (H/32, W)
  words, 32 vertically-packed cells per word — but lives in HOST memory
  as one numpy uint32 array, byte for byte gol_tpu's `TiledWorld.words`
  (a 32768² board is 128 MiB of host words and never needs to fit the
  card). A macro-tile is a (TILE/32, TILE) word sub-array; its
  ghost-extended block adds `g` word-rows above and below and 32*g
  columns left and right: one g-word ghost slab buys 32*g exact local
  turns.

- **Light-cone skip.** After a k-turn chunk each tile records whether
  its interior changed (chunk-boundary compare on the fused path;
  any-turn compare on the per-turn diff path, where a mid-chunk
  oscillation must keep emitting flips). A tile is dispatched next
  chunk only when a change landed in its 8-neighbourhood (k <= 32*g <=
  TILE, so the light cone of any change is contained in the adjacent
  tiles) AND its neighbourhood holds a live cell (an all-zero
  ghost-extended block stays zero under any rule without birth on 0,
  which is why B0 rules are rejected). Skipping is exact: an unchanged
  ghost-extended input re-stepped the same k turns gives the same
  output. A chunk-size change invalidates the flags (a period-2 island
  is "unchanged" at k=32 but not at k=31), so the first chunk at a new
  (mode, k) re-steps every tile near a live cell.

- **Per-tile ride cache.** On the fused path each dispatched tile's
  ghost-extended input is digested (16-byte blake2b) and mapped to its
  stepped interior. An oscillating island revisits the same inputs
  every period, so after one warm period its tiles replay from the
  cache with no launch. The cache has a byte budget with FIFO
  eviction; a digest collision is the only approximation. The per-turn
  diff path never consults it (a replay cannot rebuild the turns
  between two chunk boundaries).

- **The slab on the card.** Only the dispatched set ever lives on the
  device: the active ghost-extended blocks are gathered on the host
  into a pinned staging buffer, uploaded as int32 in one copy, stepped
  by ONE launch of kernel A over the whole slab
  (`ops.cuda_bitlife.step_n_packed_batch_cuda_raw`: each block is one
  thread-block cluster, the grid's z index the block), and only the
  interiors come back, in one copy. gol_tpu steps the same slab as one
  `jax.vmap` of the plain packed step, which is no Pallas kernel; the
  batched kernel A is its counterpart. A block that no cluster plan
  fits (T >= 3072: two copies of the ext block exceed one block's
  shared memory) is stepped by kernel B's 2-D entry instead, one
  launch per block — chosen from the geometry when the stepper is
  built and reported by `activity()` as the `route`, never as a
  fallback after a failure. On the CPU (`device="cpu"`) the same
  wrapper runs the batched plain step.

- **Paging.** The slab's capacity grows in powers of two up to
  `max_resident` (`obs.device.max_resident_tiles`, the same
  `tile_ext_bytes` x working-set arithmetic `fits(resident_tiles=...)`
  prices) and never shrinks. An active set larger than the bound pages
  through in several slabs, all gathered from the chunk-start state
  first, so sub-batches stay exact. The staging and device buffers are
  allocated once per capacity and reused; a slab launches only its
  filled slots (gol_tpu pads its jitted slab with zero tiles — the
  padding is why its `paged_bytes{dir="in"}` counts whole slabs, where
  this port counts the slots it uploads).

Event-plane contract: `step_n_with_diffs` emits the same packed
(k, H/32, W) uint32 XOR stack as gol_tpu's tiled stepper (skipped tiles
contribute zero rows — exact, since they did not change), fetched by
`fetch_diffs`, so the engine takes its unpipelined `_run_diff_chunk`
branch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from gol_tpu_torch import obs
from gol_tpu_torch.models.rules import LIFE, GenRule, Rule, get_rule
from gol_tpu_torch.obs import device as obs_device
from gol_tpu_torch.obs import tracing
from gol_tpu_torch.ops import bitlife
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.ops.bitlife import WORD

#: Slab bound when there is no device memory budget (the CPU): 256 ext
#: tiles of the default 1024 geometry is ~38 MB per buffer.
DEFAULT_MAX_RESIDENT = 256

#: Ride-cache byte budget (host memory holding memoized tile
#: interiors); GOL_TPU_TILE_RIDE_BUDGET_BYTES overrides, 0 disables.
RIDE_BUDGET_BYTES = 64 * 1024 * 1024

#: Board rows packed or unpacked at a time on the host: the uint32
#: temporaries of `put` / `fetch` stay a few bands' bytes (a 32768²
#: board packed in one piece takes 8 GiB of them).
HOST_BAND_ROWS = 1024

#: The legs of one chunk's wall (`TiledStepper.last_split`, kept when
#: `time_split` is set): host selection of the dispatch set, the
#: ext-block gather, the ride digests, the slab's upload, its launch,
#: the interiors' download, and the commit of interiors, flags and
#: counts.
SPLIT_LEGS = ("select", "gather", "digest", "upload", "launch", "download",
              "commit")


def _no_clock() -> float:
    return 0.0


class _LegTimer:
    """Marks between the device legs of one slab: CUDA events on the
    card (device time), host clocks on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def add(self, split: dict, legs: tuple) -> None:
        """Add the seconds between consecutive marks to `legs`; waits
        for the last mark."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            self.marks[-1].synchronize()
            secs = [a.elapsed_time(b) / 1e3 for a, b in pairs]
        else:
            secs = [b - a for a, b in pairs]
        for leg, sec in zip(legs, secs):
            split[leg] += sec


class _TiledMetrics:
    """Registry handles for the activity plane — gol_tpu's names and
    labels. The per-TILE children ride a TopKGauge: one registry entry
    whose exposition is O(cap) however many tiles a 32k² board holds."""

    def __init__(self):
        self.active = obs.gauge(
            "gol_tpu_engine_active_tiles",
            "Macro-tiles dispatched (stepped or ridden) in the last "
            "activity chunk",
        )
        self.tiles = obs.gauge(
            "gol_tpu_engine_tiles_total",
            "Macro-tiles the current tiled world is split into",
        )
        self.resident = obs.gauge(
            "gol_tpu_engine_resident_tiles",
            "Device tile slots the warm dispatch slab currently holds "
            "(the residency the paging policy priced via fits())",
        )
        self.dispatches = obs.counter(
            "gol_tpu_tiled_dispatches_total",
            "Vmapped tile-slab device dispatches",
        )
        self.tile_steps = obs.counter(
            "gol_tpu_tiled_tile_steps_total",
            "Tile chunks stepped on device",
        )
        self.tile_skips = obs.counter(
            "gol_tpu_tiled_tile_skips_total",
            "Tile chunks skipped as settled (outside every light cone)",
        )
        self.tile_rides = obs.counter(
            "gol_tpu_tiled_tile_rides_total",
            "Tile chunks replayed from the per-tile ride cache "
            "(zero device dispatches)",
        )
        self.paged = {
            d: obs.counter(
                "gol_tpu_tiled_paged_bytes_total",
                "Bytes paged between the host universe and the device "
                "slab (in = ghost-extended uploads, out = interiors "
                "fetched back)",
                {"dir": d},
            ) for d in ("in", "out")
        }
        self.per_tile = obs.registry().topk_gauge(
            "gol_tpu_engine_tile_active_chunks",
            "Consecutive chunks each currently-active tile has been "
            "in the dispatch set (top-K by streak; bounded exposition "
            "— the activity hotspots an operator actually wants named)",
            label="tile", cap=16,
        )


_METRICS = _TiledMetrics()


def tileable(height: int, width: int, tile: int,
             halo_words: int = 1) -> bool:
    """A grid tiles iff the tile divides both axes, is whole words,
    and holds its own light cone (32*g <= TILE keeps any k-turn
    change inside the 8-neighbourhood)."""
    return (
        tile > 0 and halo_words >= 1
        and tile % WORD == 0
        and tile >= WORD * halo_words
        and height % tile == 0
        and width % tile == 0
    )


def slab_route(tile: int, halo_words: int = 1) -> str:
    """How the card steps a slab of ghost-extended tiles: "resident"
    (one batched launch of kernel A) when two copies of one ext block
    fit a cluster plan, else "tiled2d" (kernel B's 2-D entry, one launch
    per block — T >= 3072 at g = 1)."""
    ext_h = tile // WORD + 2 * halo_words
    ext_w = tile + 2 * WORD * halo_words
    try:
        cb._cluster_plan(ext_h, ext_w, 2)
    except ValueError:
        return "tiled2d"
    return "resident"


def _dilate8(m: np.ndarray) -> np.ndarray:
    """Toroidal 8-neighbourhood dilation on the tile grid — the
    light-cone closure (k <= 32*g <= TILE, so one ring suffices)."""
    out = m.copy()
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                out |= np.roll(np.roll(m, dr, 0), dc, 1)
    return out


class TiledWorld:
    """The handle a tiled Stepper's entries pass around — the engine
    treats it opaquely (commit/fetch/snapshot all work), but it is a
    HOST object: the packed word universe, the per-tile alive counts,
    and the activity flags. Mutated in place by `_advance` (the same
    handle comes back from step_n), which is why the engine stands its
    cycle detectors down on tiled steppers — an anchor reference would
    alias the moving state."""

    __slots__ = ("words", "alive", "tile_alive", "changed", "last_key")

    def __init__(self, words: np.ndarray, tile_alive: np.ndarray):
        self.words = words
        self.tile_alive = tile_alive
        self.alive = int(tile_alive.sum())
        #: Per-tile "interior changed during the last chunk" flags —
        #: boundary-compare on the fused path, any-turn on diffs.
        self.changed = tile_alive > 0
        #: (mode, k) of the last chunk: flags are only meaningful
        #: against the same chunk shape (see module docstring).
        self.last_key: Optional[tuple] = None


@dataclasses.dataclass
class _Slab:
    """The buffers of one slab capacity: the pinned host staging buffer
    of ext blocks, its device copy, the stepped blocks, their interiors
    on the device, and the interiors' host buffer."""

    host_in: torch.Tensor
    dev_in: torch.Tensor
    dev_out: torch.Tensor
    dev_int: torch.Tensor
    host_out: torch.Tensor


class TiledStepper:
    """Host-side implementation behind the `tiled_stepper` Stepper —
    exposed as `Stepper.tiled` so engines and tests can reach the
    activity plane (slab census, ride cache, gather hook)."""

    def __init__(self, rule: "Rule | str" = LIFE, height: int = 512,
                 width: int = 512, tile: int = 1024, *,
                 halo_words: int = 1, device=None,
                 max_resident: Optional[int] = None,
                 ride_budget_bytes: Optional[int] = None):
        from gol_tpu_torch.parallel.stepper import resolve_device

        rule = get_rule(rule) if isinstance(rule, str) else rule
        if isinstance(rule, GenRule):
            raise ValueError(
                "tiled stepping is two-state only (multi-state planes "
                "would need per-plane ghost slabs — not yet offered)"
            )
        if 0 in rule.birth:
            raise ValueError(
                f"rule {rule} births on 0 neighbours — empty slab "
                "padding and all-zero skipped tiles would seethe, so "
                "B0 rules cannot run the activity-driven path"
            )
        if not tileable(height, width, tile, halo_words):
            raise ValueError(
                f"grid {height}x{width} does not tile into {tile}² "
                f"macro-tiles (tile must divide both axes, be a "
                f"multiple of {WORD}, and hold a {WORD * halo_words}-"
                "cell light cone)"
            )
        self.rule = rule
        self.height, self.width, self.tile = height, width, tile
        self.g = halo_words
        self.tw = tile // WORD                  # word-rows per tile
        self.hw = height // WORD                # word-rows total
        self.gr, self.gc = height // tile, width // tile
        self.ext_h = self.tw + 2 * self.g
        self.ext_w = tile + 2 * WORD * self.g
        #: Exact turns one ghost exchange buys — the per-chunk cap.
        self.max_chunk = WORD * self.g
        self.device = resolve_device(device)
        #: Kernel A batched over the slab, or kernel B per block.
        self.route = slab_route(tile, halo_words)
        if max_resident is None:
            max_resident = (obs_device.max_resident_tiles(
                tile, self.g, self.device) or DEFAULT_MAX_RESIDENT)
        # One launch takes at most cb.MAX_BATCH blocks.
        self.max_resident = max(1, min(int(max_resident),
                                       self.gr * self.gc, cb.MAX_BATCH))
        #: Current slab capacity: starts at 1, grows pow2 on demand
        #: (clamped at max_resident), never shrinks — each capacity
        #: allocates its buffers once, so a warm pool dispatches with
        #: no allocation whatever the active set does.
        self._pool_cap = 1
        self._slab: Optional[_Slab] = None
        #: (capacity, ext_h, ext_w) of every slab allocated so far.
        self._slab_shapes: set = set()
        if ride_budget_bytes is None:
            env = os.environ.get("GOL_TPU_TILE_RIDE_BUDGET_BYTES")
            try:
                ride_budget_bytes = (int(env) if env
                                     else RIDE_BUDGET_BYTES)
            except ValueError:
                ride_budget_bytes = RIDE_BUDGET_BYTES
        self.ride_budget = max(0, int(ride_budget_bytes))
        #: (tile_index, k, ext digest) -> (interior bytes, changed,
        #: alive) — the per-tile period-riding memo (FIFO-bounded).
        self._ride: dict = {}
        self._ride_order: deque = deque()
        self._ride_bytes = 0
        #: Per-tile consecutive-active streaks feeding the TopKGauge.
        self._streaks: dict = {}
        #: Time each chunk's legs into `last_split` (off by default:
        #: CUDA events around every slab and host clocks per leg).
        self.time_split = False
        #: Seconds of each SPLIT_LEGS leg in the last timed chunk.
        self.last_split: dict = dict.fromkeys(SPLIT_LEGS, 0.0)
        _METRICS.tiles.set(self.gr * self.gc)
        _METRICS.resident.set(self._pool_cap)

    # --- Stepper entries -------------------------------------------------

    def put(self, host_world) -> TiledWorld:
        w = np.asarray(host_world, np.uint8)
        if w.shape != (self.height, self.width):
            raise ValueError(
                f"world shape {w.shape} != "
                f"{(self.height, self.width)}"
            )
        words = np.concatenate([
            bitlife.pack_np(w[i:i + HOST_BAND_ROWS])
            for i in range(0, self.height, HOST_BAND_ROWS)
        ])
        world = TiledWorld(words, self._tile_pops(words))
        _METRICS.tiles.set(self.gr * self.gc)
        return world

    def fetch(self, arr):
        if isinstance(arr, TiledWorld):
            out = np.empty((self.height, self.width), np.uint8)
            band = HOST_BAND_ROWS // WORD
            for i in range(0, self.hw, band):
                rows = arr.words[i:i + band]
                out[i * WORD:(i + len(rows)) * WORD] = bitlife.unpack_np(
                    rows, len(rows) * WORD)
            return out
        return np.asarray(arr)

    def step_n(self, world: TiledWorld, k):
        k = max(int(k), 0)
        while k > 0:
            ks = min(k, self.max_chunk)
            self._advance(world, ks, "fused")
            k -= ks
        return world, world.alive

    def step(self, world: TiledWorld) -> TiledWorld:
        return self.step_n(world, 1)[0]

    def step_n_with_diffs(self, world: TiledWorld, k):
        """Per-turn packed XOR stack, exactly the layout every packed
        backend ships. Turns run one at a time (per-turn exactness is
        the contract — a mid-chunk oscillation must flip), with the
        activity skip still pruning settled tiles; the ride cache
        stands down (a memoized boundary replay cannot reconstruct
        intermediate turns)."""
        k = max(int(k), 0)
        diffs = np.zeros((k, self.hw, self.width), np.uint32)
        for t in range(k):
            self._advance(world, 1, "diffs", collect=diffs[t])
        return world, diffs, world.alive

    def step_with_diff(self, world: TiledWorld):
        _, diffs, count = self.step_n_with_diffs(world, 1)
        mask = bitlife.unpack_np(diffs[0], self.height) != 0
        return world, mask, count

    def alive_count_async(self, world: TiledWorld) -> int:
        return world.alive

    def cache_sizes(self) -> dict:
        """Slab census — the warm-pool pin: the (capacity, ext_h,
        ext_w) shapes whose host and device buffers were allocated so
        far (gol_tpu reports its jit cache here; this port compiles
        nothing per shape)."""
        return {"slabs": sorted(self._slab_shapes)}

    def activity(self) -> dict:
        """Host-side snapshot of the activity plane (telemetry/bench)."""
        return {
            "tiles": self.gr * self.gc,
            "pool_cap": self._pool_cap,
            "max_resident": self.max_resident,
            "ride_entries": len(self._ride),
            "ride_bytes": self._ride_bytes,
            "route": self.route,
        }

    # --- internals -------------------------------------------------------

    def _tile_pops(self, words: np.ndarray) -> np.ndarray:
        pops = np.bitwise_count(words).astype(np.int64)
        return pops.reshape(self.gr, self.tw, self.gc,
                            self.tile).sum(axis=(1, 3))

    def _gather(self, words: np.ndarray, r: int, c: int) -> np.ndarray:
        """One tile's ghost-extended block, toroidal (corners come from
        the wrap of both index vectors — the full rectangle, so the
        diagonal light cone is exact)."""
        g, tw, T = self.g, self.tw, self.tile
        rows = np.arange(r * tw - g, (r + 1) * tw + g) % self.hw
        cols = np.arange(c * T - WORD * g,
                         (c + 1) * T + WORD * g) % self.width
        return words[np.ix_(rows, cols)]

    def _write(self, world: TiledWorld, r: int, c: int,
               interior: np.ndarray, alive_new: int) -> None:
        tw, T = self.tw, self.tile
        world.words[r * tw:(r + 1) * tw, c * T:(c + 1) * T] = interior
        world.alive += alive_new - int(world.tile_alive[r, c])
        world.tile_alive[r, c] = alive_new

    def _ride_store(self, tidx: int, ks: int, digest: bytes,
                    interior: np.ndarray, changed: bool,
                    alive_new: int) -> None:
        if self.ride_budget <= 0:
            return
        key = (tidx, ks, digest)
        if key in self._ride:
            return
        blob = interior.tobytes()
        while (self._ride_bytes + len(blob) > self.ride_budget
               and self._ride_order):
            old = self._ride_order.popleft()
            gone = self._ride.pop(old, None)
            if gone is not None:
                self._ride_bytes -= len(gone[0])
        if self._ride_bytes + len(blob) > self.ride_budget:
            return
        self._ride[key] = (blob, changed, alive_new)
        self._ride_order.append(key)
        self._ride_bytes += len(blob)

    def _slab_buffers(self, cap: int) -> _Slab:
        """The buffers of a slab of `cap` ext blocks, allocated once per
        capacity (the capacity never shrinks, so only the current one
        is kept). The host buffers are pinned on a CUDA device, so both
        copies run as DMA."""
        slab = self._slab
        if slab is not None and slab.host_in.shape[0] == cap:
            return slab
        self._slab = None  # release the smaller slab first
        ext = (cap, self.ext_h, self.ext_w)
        interior = (cap, self.tw, self.tile)
        pin = self.device.type == "cuda"
        i32 = torch.int32
        slab = _Slab(
            host_in=torch.empty(ext, dtype=i32, pin_memory=pin),
            dev_in=torch.empty(ext, dtype=i32, device=self.device),
            dev_out=torch.empty(ext, dtype=i32, device=self.device),
            dev_int=torch.empty(interior, dtype=i32, device=self.device),
            host_out=torch.empty(interior, dtype=i32, pin_memory=pin),
        )
        self._slab = slab
        self._slab_shapes.add(ext)
        return slab

    def _step_slab(self, slab: _Slab, exts: list, ks: int,
                   split: Optional[dict]) -> np.ndarray:
        """Step `exts` (ghost-extended blocks) `ks` turns on the device
        as one slab: stage them in the pinned buffer, upload, launch,
        cut the interiors on the device and download them; with a
        `split`, time the upload, launch and download legs into it.
        Returns the (len(exts), TILE/32, TILE) uint32 interiors (a view
        of the host buffer, valid until the next slab)."""
        n = len(exts)
        g, tw, T = self.g, self.tw, self.tile
        staged = slab.host_in[:n].numpy().view(np.uint32)
        for j, ext in enumerate(exts):
            staged[j] = ext
        src, dst = slab.dev_in[:n], slab.dev_out[:n]
        interiors = slab.dev_int[:n]
        timer = None if split is None else _LegTimer(self.device)
        if timer:
            timer.mark()
        src.copy_(slab.host_in[:n], non_blocking=True)
        if timer:
            timer.mark()
        with obs_device.cause("tile-dispatch"):
            if self.route == "resident":
                cb.step_n_packed_batch_cuda_raw(src, ks, self.rule, out=dst)
            else:
                for j in range(n):
                    dst[j].copy_(cb.step_n_packed_tiled2d_raw(
                        src[j], ks, self.rule))
        if timer:
            timer.mark()
        interiors.copy_(dst[:, g:g + tw, WORD * g:WORD * g + T])
        slab.host_out[:n].copy_(interiors, non_blocking=True)
        if timer:
            timer.mark()
            timer.add(split, ("upload", "launch", "download"))
        elif self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return slab.host_out[:n].numpy().view(np.uint32)

    def _advance(self, world: TiledWorld, ks: int, mode: str,
                 collect: Optional[np.ndarray] = None) -> None:
        """One activity chunk of `ks` turns (ks <= 32*g): select the
        dispatch set, gather EVERY active ext block from the chunk-
        start state (paging sub-batches and ride replays must not see
        each other's writes), replay ride hits, step the rest in
        resident-bounded slabs, commit interiors + flags."""
        timed = self.time_split
        clock = time.perf_counter if timed else _no_clock
        split = dict.fromkeys(SPLIT_LEGS, 0.0)
        t_sel = clock()
        key = (mode, ks)
        stale = world.last_key != key
        world.last_key = key
        nonzero = world.tile_alive > 0
        changed_eff = (np.ones_like(world.changed) if stale
                       else world.changed)
        # Dispatch-set selection: inside a change's light cone AND
        # holding (or adjacent to) any live cell — an all-zero ext
        # block stays zero under any non-B0 rule, chunk size be
        # damned, which is what makes a fresh 32k² board with one
        # localized soup cheap from turn 0.
        active = _dilate8(changed_eff) & _dilate8(nonzero)
        idxs = np.flatnonzero(active)
        n_tiles = active.size
        split["select"] = clock() - t_sel
        wall0 = time.time()
        t0 = time.perf_counter()
        new_changed = np.zeros_like(world.changed)
        flat_changed = new_changed.reshape(-1)
        use_ride = mode == "fused" and self.ride_budget > 0
        ride_hits = []      # (tidx, r, c, blob, changed, alive)
        pending = []        # (tidx, r, c, ext, digest)
        t_g = clock()
        places = [(int(t),) + divmod(int(t), self.gc) for t in idxs]
        exts = [np.ascontiguousarray(self._gather(world.words, r, c))
                for _, r, c in places]
        t_d = clock()
        split["gather"] = t_d - t_g
        digests = ([hashlib.blake2b(ext.tobytes(), digest_size=16).digest()
                    for ext in exts] if use_ride else [None] * len(exts))
        split["digest"] = clock() - t_d
        for (tidx, r, c), ext, digest in zip(places, exts, digests):
            if digest is not None:
                hit = self._ride.get((tidx, ks, digest))
                if hit is not None:
                    ride_hits.append((tidx, r, c) + hit)
                    continue
            pending.append((tidx, r, c, ext, digest))
        del exts
        # All chunk-start reads are done — writes may begin. Ride
        # replays never coexist with a diff collector: the cache is
        # fused-path-only (use_ride gates on mode).
        assert collect is None or not ride_hits
        t_c = clock()
        for tidx, r, c, blob, ch, alive_new in ride_hits:
            interior = np.frombuffer(blob, np.uint32).reshape(
                self.tw, self.tile
            )
            self._write(world, r, c, interior, alive_new)
            flat_changed[tidx] = ch
        split["commit"] += clock() - t_c
        if pending:
            need = min(len(pending), self.max_resident)
            while self._pool_cap < need:
                self._pool_cap *= 2
            cap = min(self._pool_cap, self.max_resident)
            self._pool_cap = cap
            slab = self._slab_buffers(cap)
            tw, T = self.tw, self.tile
            for start in range(0, len(pending), cap):
                batch = pending[start:start + cap]
                out = self._step_slab(slab, [b[3] for b in batch], ks,
                                      split if timed else None)
                _METRICS.dispatches.inc()
                _METRICS.paged["in"].inc(
                    len(batch) * self.ext_h * self.ext_w * 4)
                _METRICS.paged["out"].inc(len(batch) * tw * T * 4)
                t_c = clock()
                for j, (tidx, r, c, _ext, digest) in enumerate(batch):
                    new_int = out[j]
                    old_int = world.words[r * tw:(r + 1) * tw,
                                          c * T:(c + 1) * T]
                    xor = old_int ^ new_int
                    ch = bool(xor.any())
                    if collect is not None and ch:
                        collect[r * tw:(r + 1) * tw,
                                c * T:(c + 1) * T] = xor
                    alive_new = int(np.bitwise_count(new_int).sum())
                    self._write(world, r, c, new_int, alive_new)
                    flat_changed[tidx] = ch
                    if digest is not None:
                        self._ride_store(tidx, ks, digest, new_int,
                                         ch, alive_new)
                split["commit"] += clock() - t_c
        world.changed = new_changed
        # Activity plane: counts this chunk, bounded per-tile streaks.
        dt = time.perf_counter() - t0
        _METRICS.active.set(len(idxs))
        _METRICS.resident.set(self._pool_cap)
        _METRICS.tile_steps.inc(len(pending))
        _METRICS.tile_rides.inc(len(ride_hits))
        _METRICS.tile_skips.inc(n_tiles - len(idxs))
        obs_device.observe_memory(self.device)
        live = set()
        for tidx in idxs:
            tidx = int(tidx)
            live.add(tidx)
            streak = self._streaks.get(tidx, 0) + 1
            self._streaks[tidx] = streak
            r, c = divmod(tidx, self.gc)
            _METRICS.per_tile.set_child(f"{r},{c}", streak)
        for tidx in [t for t in self._streaks if t not in live]:
            del self._streaks[tidx]
            r, c = divmod(tidx, self.gc)
            _METRICS.per_tile.remove_child(f"{r},{c}")
        tracing.add_span(
            "engine.tiled_chunk", "engine", wall0, dt,
            {"turns": ks, "active": len(idxs),
             "stepped": len(pending), "rides": len(ride_hits),
             "mode": mode},
        )
        if timed:
            self.last_split = split


def tiled_stepper(rule: "Rule | str" = LIFE, height: int = 512,
                  width: int = 512, tile: int = 1024, *,
                  halo_words: int = 1, device=None,
                  max_resident: Optional[int] = None,
                  ride_budget_bytes: Optional[int] = None):
    """Build the activity-driven tiled backend as a Stepper (the
    `make_stepper(tile=...)` / `--tile` path). Single-device by
    construction: the dispatch SET is the parallelism axis here. The
    device is the CUDA card unless the caller asks for the CPU."""
    from gol_tpu_torch.parallel.stepper import Stepper

    impl = TiledStepper(
        rule, height, width, tile, halo_words=halo_words,
        device=device, max_resident=max_resident,
        ride_budget_bytes=ride_budget_bytes,
    )
    return Stepper(
        name=f"tiled-{tile}",
        shards=1,
        put=impl.put,
        fetch=impl.fetch,
        step=impl.step,
        step_n=impl.step_n,
        step_with_diff=impl.step_with_diff,
        alive_count_async=impl.alive_count_async,
        step_n_with_diffs=impl.step_n_with_diffs,
        fetch_diffs=np.asarray,
        packed_diffs=True,
        tiled=impl,
    )
