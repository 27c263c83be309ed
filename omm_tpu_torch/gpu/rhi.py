"""Dispatch-chain consumer: the client-RHI analog of omm-gpu-nvrhi.

The port's copy of `omm_tpu/gpu/rhi.py`.  The reference ships an
integration layer that walks the SDK's dispatch descriptors and
translates them into RHI commands — buffer binds, compute dispatches,
barriers, debug labels — against client-owned transient pools
(omm-gpu-nvrhi.cpp:520-806: pool creation, per-dispatch bind sets,
BeginMarker/EndMarker, barrier placement).  Here `Pipeline` executes the
chain itself: its passes run as torch programs on the dispatch's device,
the exact stage as the hand-written CUDA kernel on the card, so no
external RHI is driven.  What a client still needs is the *command
stream contract*: which labeled dispatches run, in what order, with
which sub-ranges of which transient pools bound, and where the barriers
sit.  This module provides that consumer:

  * `CommandRecorder` — the minimal RHI interface (begin/end label, bind,
    dispatch, barrier) a client backend would implement;
  * `RecordingRHI` — a reference implementation that records the stream
    into an inspectable command list AND validates the resource plan
    (ranges in-bounds, no conflicting overlap within a dispatch, label
    nesting), the moral analog of nvrhi's validation layer;
  * `record_chain` — walks a DispatchChain emitting the stream, with a
    UAV-barrier wherever a pass touches a pool with unflushed writes
    from an earlier pass (omm-gpu-nvrhi.cpp:714-735 places a global UAV
    barrier between dispatches; tracking write hazards keeps the
    recorded barriers informative instead of unconditional).

`Pipeline.dispatch` fills each pass's `detail["resources"]` with concrete
bump-allocated `ResourceRange`s sub-allocated from the ≤4 transient pools
(bake_gpu_impl.cpp:434-516), pool 0 resetting per batch like the
reference's per-batch scratch reuse (:517-584).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ResourceRange", "CommandRecorder", "RecordingRHI",
           "record_chain"]


@dataclass(frozen=True)
class ResourceRange:
    """One bump-allocated sub-range of a transient pool bound to a pass
    (the analog of a buffer-range bind set entry)."""

    pool: int          # transient pool index (0..3)
    offset: int        # byte offset inside the pool
    size: int          # byte size
    usage: str         # e.g. 'bake_result', 'hash_table', 'histograms'
    access: str = "rw"  # 'r' | 'w' | 'rw'

    @property
    def end(self) -> int:
        return self.offset + self.size


class CommandRecorder:
    """Minimal client-RHI interface (what a backend implements)."""

    def begin_label(self, label: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def end_label(self) -> None:  # pragma: no cover
        raise NotImplementedError

    def bind(self, ranges: list[ResourceRange]) -> None:  # pragma: no cover
        raise NotImplementedError

    def dispatch(self, kind: str, detail: dict) -> None:  # pragma: no cover
        raise NotImplementedError

    def barrier(self, pools: tuple[int, ...]) -> None:  # pragma: no cover
        raise NotImplementedError


class RecordingRHI(CommandRecorder):
    """Records the command stream and validates the resource plan.

    Validation rules (the nvrhi-validation-layer analog):
      * every bound range lies inside its transient pool;
      * within one dispatch, two ranges on the same pool must not overlap
        unless both are read-only;
      * labels nest (end_label never underflows; all labels closed).
    Violations raise ValueError immediately — a chain that records clean
    is executable by any conforming client backend.
    """

    def __init__(self, pool_sizes: tuple):
        self.pool_sizes = tuple(int(s) for s in pool_sizes)
        self.commands: list[tuple] = []
        self.high_water = [0] * len(self.pool_sizes)
        self._depth = 0
        self._bound = False

    # -- CommandRecorder --
    def begin_label(self, label: str) -> None:
        self._depth += 1
        self.commands.append(("begin_label", label))

    def end_label(self) -> None:
        if self._depth <= 0:
            raise ValueError("end_label without begin_label")
        self._depth -= 1
        self.commands.append(("end_label",))

    def bind(self, ranges: list[ResourceRange]) -> None:
        for r in ranges:
            if r.pool >= len(self.pool_sizes):
                raise ValueError(f"range {r} binds unknown pool")
            if r.offset < 0 or r.size < 0 \
                    or r.end > self.pool_sizes[r.pool]:
                raise ValueError(
                    f"range {r} out of bounds of pool {r.pool} "
                    f"({self.pool_sizes[r.pool]} bytes)")
            self.high_water[r.pool] = max(self.high_water[r.pool], r.end)
        for i, a in enumerate(ranges):
            for b in ranges[i + 1:]:
                if (a.pool == b.pool and a.offset < b.end
                        and b.offset < a.end
                        and not (a.access == "r" and b.access == "r")):
                    raise ValueError(
                        f"conflicting overlap in one dispatch: {a} / {b}")
        if self._bound:
            raise ValueError("bind without an intervening dispatch")
        self._bound = True
        self.commands.append(("bind", tuple(ranges)))

    def dispatch(self, kind: str, detail: dict) -> None:
        self.commands.append(("dispatch", kind,
                              {k: v for k, v in detail.items()
                               if k != "resources"}))
        self._bound = False

    def barrier(self, pools: tuple[int, ...]) -> None:
        self.commands.append(("barrier", tuple(pools)))

    # -- inspection --
    def finish(self) -> None:
        if self._depth != 0:
            raise ValueError(f"{self._depth} unclosed labels")

    @property
    def dispatch_count(self) -> int:
        return sum(1 for c in self.commands if c[0] == "dispatch")

    @property
    def labels(self) -> list[str]:
        return [c[1] for c in self.commands if c[0] == "begin_label"]


def record_chain(chain, recorder: CommandRecorder,
                 pool_count: int = 4) -> None:
    """Walk a DispatchChain emitting the client command stream: a labeled
    bind+dispatch per pass, with a UAV barrier between passes with a real
    write->read/write hazard — a prior pass WROTE a pool this pass
    touches (the reference integration layer places a barrier after
    every dispatch whose outputs a later pass reads,
    omm-gpu-nvrhi.cpp:714-735).  Read-only and debug (assert-buffer)
    binds do not create hazards, so interior per-level classify passes
    writing disjoint pool-0 sub-ranges still get ordered only against
    genuinely-written pools."""
    unflushed: set = set()   # pools written since their last barrier
    for p in chain.passes:
        ranges = [r for r in p.detail.get("resources", ())
                  if isinstance(r, ResourceRange)]
        touched = {r.pool for r in ranges
                   if r.usage != "assert_buffer"}
        hazard = unflushed & touched
        if hazard:
            recorder.barrier(tuple(sorted(hazard)))
            unflushed -= hazard
        recorder.begin_label(p.label)
        if ranges:
            recorder.bind(ranges)
        recorder.dispatch(p.kind, p.detail)
        recorder.end_label()
        unflushed |= {r.pool for r in ranges
                      if "w" in r.access and r.usage != "assert_buffer"}
    fin = getattr(recorder, "finish", None)
    if fin is not None:
        fin()
