"""Background promotion: table-lane links converge to the fused lane.

The live program-table lane buys instant attach by interpreting bytecode
that rides in device *data*, but interpretation costs a multiple of the
fused lane for as long as it runs. So the runtime closes the gap the way a
JIT tier does: every table-lane link with ``promote=True`` is handed to
this engine, which builds the fused-lane step OFF the critical path (a
daemon thread) and swaps it in at the next generation boundary
(``Runtime.sync_live_table``). The loop never blocks on a build and never
observes a half-promoted world:

    interp --schedule--> compiling --> ready --apply_ready--> fused
        |                    |
        +---- detach --------+------> cancelled        (build error
                                                        --> failed)

Eager PyTorch has no ahead-of-time lowering: the port's "compile" is the
``step_builder()`` call under the attach overlay, and ``example_args`` are
kept for the signature only (a CUDA-graph capture of the promoted step is
ROADMAP work). The state machine is the JAX package's.

Correctness rules (tests/test_torch_live.py):

  * the background build sees the FUTURE attach state through a
    thread-local overlay (``runtime._effective_attach``) -- the foreground
    step keeps seeing the present;
  * the built step is keyed on the full post-promotion attach signature;
    if the world moved between build and apply (another attach/detach),
    ``apply_ready`` discards the stale step and re-schedules instead of
    swapping in a wrong one;
  * the swap itself happens entirely between steps: clear the table slot
    (generation bump) + append the static attachment (epoch bump) in one
    host-side critical section, then hand the loop the built step through
    ``runtime.take_promoted_step()`` -- each event is executed by exactly
    one lane on every step, so the map state stays bit-identical across
    the boundary.
"""
from __future__ import annotations

import threading
import traceback


def attach_signature(attach_map: dict) -> tuple:
    """Hashable invariant the fused lane depends on: the exact multiset of
    (site, kind) -> program ids."""
    return tuple(sorted((sk, tuple(pids)) for sk, pids in attach_map.items()
                        if pids))


class PromotionEngine:
    """Owns the background builds and the ready queue for one runtime.

    ``step_builder()`` must return a *fresh* step built against the
    runtime's current (overlaid) attach state; ``example_args`` are the
    arguments the loop will keep calling the step with (unused: eager
    PyTorch has no ahead-of-time lowering)."""

    def __init__(self, runtime, step_builder, example_args,
                 background: bool = True):
        self.runtime = runtime
        self.step_builder = step_builder
        self.example_args = tuple(example_args)
        self.background = background
        self.compiles = 0                 # builds actually run
        # full layout fingerprint -> built step. The key folds the map
        # registry / ctx width / table dims AND the post-promotion attach
        # signature: the same attach set over a different registry is a
        # different step.
        self._cache: dict[str, object] = {}
        self._ready: list = []            # links built + waiting to swap
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ schedule
    def schedule(self, link) -> None:
        """Kick off (or reuse) a build for one table-lane link."""
        if link.lane != "table" or link.promotion_state not in ("interp",
                                                                "failed"):
            return
        link.promotion_state = "compiling"
        if not self.background:
            self._compile(link)
            return
        t = threading.Thread(target=self._compile, args=(link,),
                             name=f"promote-{link.link_id}", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()

    def _target_signature(self, link) -> tuple:
        """Attach signature of the world AFTER this link is promoted."""
        merged = {k: list(v) for k, v in self.runtime.device_attach.items()}
        merged.setdefault(link._parsed, []).append(link.pid)
        return attach_signature(merged)

    def _cache_key(self, link) -> str:
        """The full key for this link's promoted world: layout fingerprint
        (registry, ctx, table dims) + post-promotion attach signature."""
        return self.runtime.layout_fingerprint(
            attach_sig=self._target_signature(link))

    def _compile(self, link) -> None:
        try:
            sig = self._target_signature(link)
            key = self._cache_key(link)
            with self._lock:
                compiled = self._cache.get(key)
            if compiled is None:
                # build against the future: the overlay makes
                # _static_lanes/_effective_attach on THIS thread see the
                # link as a static attachment
                with self.runtime._attach_overlay({link._parsed: [link.pid]}):
                    compiled = self.step_builder()
                with self._lock:
                    self._cache[key] = compiled
                    self.compiles += 1
            if link.promotion_state != "compiling":    # detached mid-build
                return
            link.promotion_state = "ready"
            with self._lock:
                self._ready.append((link, sig, compiled))
        except Exception:
            link.promotion_state = "failed"
            link.promotion_error = traceback.format_exc(limit=4)

    # ------------------------------------------------------------ apply
    def apply_ready(self) -> bool:
        """Called by the runtime at every generation boundary
        (sync_live_table). Swap in every built link whose signature still
        matches the current world; re-schedule the ones the world moved out
        from under. Returns True iff any link was promoted."""
        with self._lock:
            ready, self._ready = self._ready, []
        promoted = False
        for link, sig, compiled in ready:
            if link.promotion_state != "ready":        # detach won the race
                continue
            if self._target_signature(link) != sig:
                # another attach/detach changed the fused lanes since this
                # step was built: build against the new world
                link.promotion_state = "interp"
                self.schedule(link)
                continue
            self.runtime._promote_table_link(link, compiled)
            promoted = True
        return promoted

    # ------------------------------------------------------------ waiting
    def wait(self, timeout: float = 30.0) -> None:
        """Join outstanding build threads (tests / shutdown)."""
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout)

    def pending(self) -> int:
        with self._lock:
            return len(self._ready)
