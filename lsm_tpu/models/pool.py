"""Stream-slot pool: the session-management layer for always-on serving.

The engines (StreamingKWS / ContinuousKWS) are fixed-width SPMD programs
over `n_streams` slots; a deployment's sessions come and go. This module
is the thin, fully-tested composition of the primitives the engines
already expose — per-slot recycling (`reset(stream_idx)`),
partial-activity stepping (`step_active`: only connected sessions' audio
crosses H2D), and row-level drain (`serving_state.migrate_streams`) —
into the admit/step/finish lifecycle a server actually runs. No new
device semantics: every path is bit-equal to driving the engine
directly, which is what the tests pin.

Reference has no serving at all (SURVEY.md §0); capacity metrics cite
docs/VALIDATION.md "Partial-activity ingest" (3-4x the full wire at
fleet activity factors).
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Sequence

import numpy as np


class PoolFullError(RuntimeError):
    """No free slots: scale out (another engine/host) or finish sessions."""


class StreamPool:
    """Maps session ids onto engine stream slots.

    - `admit(session_id)` claims a free slot (freshly reset: the engine's
      cold-start state, exactly what a new stream must see).
    - `step(audio_by_session)` advances ALL slots one chunk: connected
      sessions' rows ride the wire (any ingest format), every other slot
      — free or connected-but-silent this hop — advances on
      device-synthesized wire silence. Returns per-session (pred, margin)
      from the compact egress.
    - `finish(session_id)` recycles the slot (masked reset; other slots
      untouched).
    - `drain(session_ids, dst_pool)` migrates live sessions to another
      pool's engine bit-exactly (host rebalancing / rolling restarts),
      then recycles the local slots.

    SPMD note: on a multi-host mesh every process must make the SAME
    calls with the same arguments (the underlying reset/step_active/
    migrate are collectives) — same contract as the engines themselves.
    """

    def __init__(self, kws, chunk_len: Optional[int] = None,
                 wire_dtype=None):
        """`chunk_len`: the deployment's hop size in samples. Defaults to
        the engine's own chunk_len (continuous mode); REQUIRED for the
        exact engine if an all-silent hop can ever occur (the pool must
        know how far to advance time when nobody speaks — guessing a
        length would misalign every ring buffer against the audio
        timeline). Inferred from the first fed hop otherwise.

        `wire_dtype`: the deployment's ingest format (float32, int16, or
        uint8 mu-law). Inferred from the first fed hop; set it explicitly
        if an all-silent hop can precede the first fed one, so the silent
        hop traces the SAME step_active program the fed hops will use (a
        dtype flip mid-serving costs a fresh fused-step compile)."""
        self.kws = kws
        self._free = list(range(kws.n_streams - 1, -1, -1))  # pop -> slot 0 first
        self._slot_of: Dict[Hashable, int] = {}
        self._chunk_len = chunk_len or getattr(kws, "chunk_len", None)
        self._wire_dtype = np.dtype(wire_dtype) if wire_dtype else None

    @property
    def capacity(self) -> int:
        return self.kws.n_streams

    @property
    def n_active(self) -> int:
        return len(self._slot_of)

    def slot_of(self, session_id: Hashable) -> int:
        return self._slot_of[session_id]

    def _claim(self, session_id: Hashable) -> int:
        """Bookkeeping half of admit: take a free slot WITHOUT resetting
        it (drain() overwrites every state leaf via migration, so a reset
        there would be a wasted collective)."""
        if session_id in self._slot_of:
            raise ValueError(f"session {session_id!r} is already admitted")
        if not self._free:
            raise PoolFullError(
                f"all {self.capacity} slots are serving sessions"
            )
        slot = self._free.pop()
        self._slot_of[session_id] = slot
        return slot

    def admit(self, session_id: Hashable) -> int:
        slot = self._claim(session_id)
        # A new session must start from the engine's cold state, whatever
        # the slot's previous tenant (or the silence feed) left behind.
        self.kws.reset(slot)
        return slot

    def finish(self, session_id: Hashable) -> None:
        slot = self._slot_of.pop(session_id)
        self.kws.reset(slot)
        self._free.append(slot)

    def step(self, audio_by_session: Dict[Hashable, np.ndarray]):
        """Advance every slot one chunk; only `audio_by_session`'s rows
        cross H2D. Sessions absent from the dict (and free slots) advance
        on wire silence. Returns {session_id: (pred int, margin float)}
        for the CONNECTED sessions (all of them, not just the fed ones —
        a silent session still emits a decision each hop).

        All rows must share one dtype (one wire format per hop — mixed
        producers should transcode before the pool)."""
        unknown = [s for s in audio_by_session if s not in self._slot_of]
        if unknown:
            raise KeyError(f"sessions not admitted: {unknown[:4]}")
        sessions = sorted(self._slot_of, key=lambda s: self._slot_of[s])
        if audio_by_session:
            fed = sorted(audio_by_session, key=lambda s: self._slot_of[s])
            idx = np.asarray([self._slot_of[s] for s in fed], np.int64)
            arrs = [np.asarray(audio_by_session[s]) for s in fed]
            dtypes = {a.dtype for a in arrs}
            if len(dtypes) > 1:
                # np.stack would silently PROMOTE (int16 rows decoded as
                # f32 enter the featurizer 32768x too loud) — one wire
                # format per hop, enforced loudly.
                raise ValueError(
                    f"mixed wire dtypes in one hop: {sorted(map(str, dtypes))}"
                    " — transcode producers to one format per step"
                )
            rows = np.stack(arrs)
        else:
            # Nothing connected spoke this hop: free/silent slots still
            # advance (state decay is part of the engines' contract) —
            # by exactly one hop of the deployment's cadence, in the
            # deployment's WIRE DTYPE (a float32 guess on a mu-law pool
            # would trace a fresh fused-step program the first time the
            # fleet goes quiet).
            # The zero-row array carries no bytes; only its dtype picks
            # the program, and the engine synthesizes wire_silence(dtype)
            # on device for every slot.
            if self._chunk_len is None:
                raise ValueError(
                    "all-silent hop before any fed hop on an exact-mode "
                    "pool: pass chunk_len to StreamPool so silence "
                    "advances time by the deployment's real hop size"
                )
            dt = np.float32 if self._wire_dtype is None else self._wire_dtype
            rows = np.zeros((0, self._chunk_len), dt)
            idx = np.zeros((0,), np.int64)
        preds, margins = self.kws.step_active(rows, idx, compact=True)
        if rows.shape[0]:
            # Cache the silent-hop geometry only AFTER the engine accepted
            # the rows: a malformed fed hop (wrong length/dtype) raises in
            # step_active's validation, and committing first would corrupt
            # every later all-silent hop (and any save()d checkpoint).
            self._chunk_len = rows.shape[1]
            self._wire_dtype = rows.dtype
        return {
            s: (int(preds[self._slot_of[s]]),
                float(margins[self._slot_of[s]]))
            for s in sessions
        }

    def diagnostics(self):
        """Reservoir health over the CONNECTED sessions only (free slots
        are fed silence and would read sub-critical by nature): the
        serving analogue of the batch `run_network_diagnostics`. Returns
        (report, per_session) — the engine's ServingDiagnosticsReport
        restricted to connected slots, plus {session_id: (participation
        %, spikes/neuron)}. Raises ValueError on an empty pool (no live
        traffic to diagnose). Multi-host: SPMD collective like step —
        every process must call it together."""
        sessions = sorted(self._slot_of, key=lambda s: self._slot_of[s])
        rep = self.kws.diagnostics(
            stream_idx=[self._slot_of[s] for s in sessions]
        )
        per_session = {
            s: (float(rep.participation[i]), float(rep.spikes_per_neuron[i]))
            for i, s in enumerate(sessions)
        }
        return rep, per_session

    def save(self, path, compress: bool = True) -> None:
        """Checkpoint the WHOLE serving unit: the engine's cross-chunk
        stream state (serving_state snapshot, same identity validation on
        restore) plus this pool's session table — slot map, free-slot
        order, hop geometry, wire dtype. A server restarted from an
        engine-only snapshot continues every slot bit-exactly but has
        forgotten which session owns which slot; this closes that hole.

        Session ids must be JSON scalars (str / int / bool / None) to
        survive the file; richer ids should be mapped to strings by the
        caller. Multi-host: snapshot() is a collective — call save() on
        every process, it writes on process 0 only (same contract as
        write_snapshot)."""
        from lsm_tpu.io.serving_state import write_snapshot

        for s in self._slot_of:
            if not isinstance(s, (str, int, bool)) and s is not None:
                raise TypeError(
                    f"session id {s!r} is not a JSON scalar — StreamPool."
                    "save() persists ids as str/int/bool/None; map richer "
                    "ids to strings before admitting them"
                )
        pool_meta = {
            "pool": {
                "sessions": [[s, slot] for s, slot in self._slot_of.items()],
                "free": list(self._free),
                "chunk_len": self._chunk_len,
                "wire_dtype": (str(self._wire_dtype)
                               if self._wire_dtype is not None else None),
            }
        }
        snap = self.kws.snapshot()
        import jax

        if jax.process_index() == 0:
            write_snapshot(path, self.kws, snap, compress=compress,
                           extra_meta=pool_meta)

    @classmethod
    def restore(cls, path, kws) -> "StreamPool":
        """Rebuild a pool from a save()d snapshot onto a fresh engine:
        engine state installs bit-exactly (full load_serving_state
        identity validation) and the session table comes back as written
        — same slot per session, same free-list order (so the next
        admit() lands in the same slot it would have), same silent-hop
        geometry and wire dtype. The session table is validated BEFORE
        the engine install (read_snapshot_meta is engine-free), so a
        rejected file leaves the engine untouched."""
        from lsm_tpu.io.serving_state import (
            load_serving_state, read_snapshot_meta,
        )

        pm = read_snapshot_meta(path).get("pool")
        if pm is None:
            raise ValueError(
                "snapshot has no pool session table (it was written with "
                "save_serving_state, not StreamPool.save) — restore the "
                "engine with load_serving_state and re-admit sessions"
            )
        slot_of = {s: int(slot) for s, slot in pm["sessions"]}
        free = [int(i) for i in pm["free"]]
        # The table must partition the slot space — anything else is a
        # corrupt or hand-edited file and would double-book a slot.
        claimed = list(slot_of.values())
        if sorted(claimed + free) != list(range(kws.n_streams)):
            raise ValueError(
                "pool session table is corrupt: claimed slots "
                f"{sorted(claimed)} + free {sorted(free)} do not "
                f"partition {kws.n_streams} slots"
            )
        load_serving_state(path, kws)
        pool = cls(
            kws,
            chunk_len=pm["chunk_len"],
            wire_dtype=pm["wire_dtype"],
        )
        pool._slot_of = slot_of
        pool._free = free
        return pool

    def drain(self, session_ids: Sequence[Hashable],
              dst_pool: "StreamPool") -> None:
        """Move live sessions to `dst_pool` BIT-exactly (row-level
        migration into claimed destination slots — no reset needed, the
        install overwrites every state leaf) and recycle the local slots
        with ONE vectorized reset. On ANY failure — capacity, duplicate
        ids, engine incompatibility — the claims roll back and nothing
        has moved."""
        from lsm_tpu.io.serving_state import migrate_streams

        session_ids = list(session_ids)
        if not session_ids:
            return          # empty move set: nothing to migrate or reset
        if len(set(session_ids)) != len(session_ids):
            raise ValueError("duplicate session ids in drain()")
        src_idx = [self._slot_of[s] for s in session_ids]  # KeyError early
        claimed = []
        try:
            dst_idx = []
            for s in session_ids:
                dst_idx.append(dst_pool._claim(s))
                claimed.append(s)
            migrate_streams(self.kws, dst_pool.kws, src_idx, dst_idx)
        except Exception:
            # Claims are pure bookkeeping (no state was touched): undo
            # them so a failed drain leaves both pools exactly as before.
            # Unwind in REVERSE claim order — _claim pops from the list
            # tail, so appending back in claim order would permute the
            # free list and a later admit() would land in a different
            # slot than on a pool that never saw the failed drain.
            for s in reversed(claimed):
                dst_pool._free.append(dst_pool._slot_of.pop(s))
            raise
        # Recycle the source slots: one masked reset dispatch, not one
        # per session.
        self.kws.reset(np.asarray(src_idx))
        for s in session_ids:
            self._free.append(self._slot_of.pop(s))
