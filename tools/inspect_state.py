#!/usr/bin/env python
"""Operator CLI: inspect serving-state snapshots without touching an engine.

`stream_kws.py --save-state` / `StreamPool.save` checkpoints are opaque
.npz files; an operator rotating or debugging them needs to know WHAT a
file is (engine kind, stream count, frontend, geometry, weight identity,
pool session table) before deciding whether it can restore into a given
deployment — and `load_serving_state`'s validation error names one
mismatched field at a time. This prints the whole identity header (the
engine-free `read_snapshot_meta` path: no device, no compile) plus the
state-leaf inventory, and can diff two snapshots field by field.

Usage:
  python tools/inspect_state.py snap.npz [more.npz ...]
  python tools/inspect_state.py --diff a.npz b.npz
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def describe(path: Path) -> dict:
    import numpy as np

    from lsm_tpu.io.serving_state import read_snapshot_meta

    meta = read_snapshot_meta(path)
    with np.load(path, allow_pickle=False) as data:
        leaves = {
            k.replace("seg__", "seg:"): (data[k].shape, str(data[k].dtype),
                                         data[k].nbytes)
            for k in data.files if k != "meta"
        }
    return {"meta": meta, "leaves": leaves,
            "file_bytes": path.stat().st_size}


def render(path: Path, info: dict) -> str:
    meta, leaves = info["meta"], info["leaves"]
    fe = meta.get("frontend", {})
    lines = [
        f"{path}  ({info['file_bytes'] / 1e6:.2f} MB on disk)",
        f"  format:      {meta.get('format')}",
        f"  engine:      {meta.get('engine')}  "
        f"({meta.get('n_streams')} streams)",
        f"  frontend:    {fe.get('filterbank')} x{fe.get('n_filters')}",
        f"  feature set: {len(meta.get('feature_keys', []))} keys "
        f"{meta.get('feature_keys')}",
        f"  weights_crc: {meta.get('weights_crc'):#010x}",
    ]
    if meta.get("engine") == "continuous":
        lines.append(
            f"  geometry:    chunk_len={meta.get('chunk_len')} "
            f"norm_decay={meta.get('norm_decay_db_per_bin')}"
        )
    pool = meta.get("pool")
    if pool:
        sess = pool.get("sessions", [])
        lines.append(
            f"  pool:        {len(sess)} connected session(s), "
            f"{len(pool.get('free', []))} free slot(s), "
            f"wire={pool.get('wire_dtype')} chunk_len={pool.get('chunk_len')}"
        )
        for s, slot in sess[:8]:
            lines.append(f"      slot {slot}: session {s!r}")
        if len(sess) > 8:
            lines.append(f"      ... ({len(sess) - 8} more)")
    state_bytes = sum(b for _, _, b in leaves.values())
    lines.append(f"  state:       {len(leaves)} leaves, "
                 f"{state_bytes / 1e6:.2f} MB uncompressed")
    for k in sorted(leaves):
        shape, dt, nb = leaves[k]
        lines.append(f"      {k:14s} {dt}{list(shape)}")
    return "\n".join(lines)


def diff(a: Path, b: Path) -> int:
    ia, ib = describe(a), describe(b)
    keys = sorted(set(ia["meta"]) | set(ib["meta"]))
    n_diff = 0
    for k in keys:
        va, vb = ia["meta"].get(k), ib["meta"].get(k)
        if va != vb:
            n_diff += 1
            print(f"  meta[{k}]: {va!r}  !=  {vb!r}")
    for k in sorted(set(ia["leaves"]) | set(ib["leaves"])):
        la = ia["leaves"].get(k)
        lb = ib["leaves"].get(k)
        if la is None or lb is None or la[:2] != lb[:2]:
            n_diff += 1
            print(f"  leaf {k}: "
                  f"{la and (la[1], list(la[0]))}  !=  "
                  f"{lb and (lb[1], list(lb[0]))}")
    if n_diff == 0:
        print(f"identical identity/geometry: {a} vs {b} "
              "(state VALUES not compared)")
    return 0 if n_diff == 0 else 1


def main() -> None:
    # Piping into `head` closes stdout early — exit quietly like any
    # well-behaved unix filter instead of a BrokenPipeError traceback.
    import signal

    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    ap = argparse.ArgumentParser(
        description="Inspect serving-state snapshot files (engine-free)."
    )
    ap.add_argument("paths", nargs="+", type=Path)
    ap.add_argument("--diff", action="store_true",
                    help="Compare exactly two snapshots' identity headers "
                         "and leaf geometry; exit 1 on any difference.")
    args = ap.parse_args()
    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff takes exactly two snapshot paths")
        sys.exit(diff(*args.paths))
    ok = True
    for p in args.paths:
        try:
            print(render(p, describe(p)))
        except (FileNotFoundError, ValueError) as e:
            ok = False
            print(f"{p}: INVALID — {e}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
