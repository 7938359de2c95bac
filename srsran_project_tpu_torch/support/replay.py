"""Golden-replay determinism harness (SURVEY §5.2 counterpart).

The reference gets concurrency safety structurally (strands, SPSC queues,
TSAN builds); here device compute is functional so races can only creep in
through the *host* pipeline (threaded slot dispatch, buffer reuse, HARQ
state) or a kernel launched from several threads at once.  The replay
harness turns that into a testable property:

- :class:`SlotRecorder` taps a pipeline (``UpperPhy.add_tap`` or any
  ``record(kind, slot, arrays)`` call sites) and captures a content hash
  of every array that crosses a stage boundary, in arrival order per
  (kind, slot) — plus optionally the arrays themselves for full replay.
- :func:`diff_traces` compares two recordings: a live threaded run against
  a sequential golden re-run (or yesterday's golden file).  Any divergence
  (missing slot, different hash, different multiplicity) is reported with
  its (kind, slot) coordinate — a race or nondeterministic reduction shows
  up as a hash mismatch on an otherwise identical schedule.

Traces persist as ``.npz`` so goldens can be committed and replayed across
versions (the reference's vector-file role, applied to runtime behavior).

Port of ``srsran_project_tpu/support/replay.py``.  A tensor hashes its
host copy under the numpy dtype name and the shape tuple the reference
hashes, so equal values give equal digests in both packages, and the two
packages' ``.npz`` traces load into each other.  A dtype with no numpy
twin (bfloat16, the complex32 half) raises instead of converting.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _host(arr) -> np.ndarray:
    """A numpy view of arr: a tensor's host copy (conjugate and negative
    views resolved; ``.numpy()`` raises TypeError for a dtype with no
    numpy twin), anything else through ``np.asarray``."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(arr)


def array_digest(arr) -> str:
    """Stable content hash of an array (device tensors are copied to the
    host)."""
    a = _host(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class TraceEntry:
    kind: str
    slot: int
    digests: Tuple[str, ...]


class SlotRecorder:
    """Thread-safe recorder of per-slot array digests.

    Attach to an UpperPhy via ``phy.add_tap(recorder.tap)`` or call
    ``record`` directly from pipeline stages.
    """

    def __init__(self, keep_arrays: bool = False):
        self._lock = threading.Lock()
        self.entries: List[TraceEntry] = []
        self.keep_arrays = keep_arrays
        self.arrays: List[Tuple[str, int, list]] = []

    def record(self, kind: str, slot, payload) -> None:
        arrays = [_host(a) for a in _flatten_arrays(payload)]
        digests = tuple(array_digest(a) for a in arrays)
        with self._lock:
            self.entries.append(TraceEntry(kind, _slot_key(slot), digests))
            if self.keep_arrays:
                self.arrays.append((kind, _slot_key(slot), arrays))

    # UpperPhy tap signature.
    def tap(self, event: str, slot, payload) -> None:
        self.record(event, slot, payload)

    def canonical(self) -> Dict[Tuple[str, int], List[Tuple[str, ...]]]:
        """Entries grouped by (kind, slot), order-independent across slots
        (a threaded pipeline may interleave slots; per-key order kept)."""
        out: Dict[Tuple[str, int], List[Tuple[str, ...]]] = {}
        for e in self.entries:
            out.setdefault((e.kind, e.slot), []).append(e.digests)
        return out

    def save(self, path: str) -> None:
        kinds = np.array([e.kind for e in self.entries])
        slots = np.array([e.slot for e in self.entries], np.int64)
        digs = np.array([",".join(e.digests) for e in self.entries])
        np.savez_compressed(path, kinds=kinds, slots=slots, digests=digs)

    @classmethod
    def load(cls, path: str) -> "SlotRecorder":
        data = np.load(path, allow_pickle=False)
        rec = cls()
        for kind, slot, digs in zip(data["kinds"], data["slots"], data["digests"]):
            d = tuple(str(digs).split(",")) if str(digs) else ()
            rec.entries.append(TraceEntry(str(kind), int(slot), d))
        return rec


def _slot_key(slot) -> int:
    if hasattr(slot, "count"):
        return int(slot.count)
    return int(slot)


def _flatten_arrays(payload) -> list:
    """Extract arrays from a payload (tensor or array, dict, tuple,
    dataclass)."""
    out = []

    def walk(x):
        if x is None or isinstance(x, (str, bytes, bool)):
            return
        if isinstance(x, (int, float, complex, np.number)):
            out.append(np.asarray(x))
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(payload)
    return out


def diff_traces(golden: SlotRecorder, candidate: SlotRecorder) -> List[str]:
    """Compare two recordings; empty list means bit-identical behavior."""
    g, c = golden.canonical(), candidate.canonical()
    problems: List[str] = []
    for key in sorted(set(g) | set(c)):
        kind, slot = key
        if key not in g:
            problems.append(f"extra entries for ({kind}, slot {slot}) in candidate")
        elif key not in c:
            problems.append(f"missing entries for ({kind}, slot {slot}) in candidate")
        elif g[key] != c[key]:
            if len(g[key]) != len(c[key]):
                problems.append(
                    f"({kind}, slot {slot}): {len(g[key])} golden entries vs "
                    f"{len(c[key])} candidate")
            else:
                for i, (a, b) in enumerate(zip(g[key], c[key])):
                    if a != b:
                        problems.append(
                            f"({kind}, slot {slot}) entry {i}: digest mismatch "
                            f"{a} != {b}")
    return problems


def assert_replay_deterministic(run_fn, n_runs: int = 2) -> SlotRecorder:
    """Run ``run_fn(recorder)`` ``n_runs`` times and raise AssertionError
    unless every run produces identical traces; returns the golden
    recorder."""
    golden: Optional[SlotRecorder] = None
    for i in range(n_runs):
        rec = SlotRecorder()
        run_fn(rec)
        if golden is None:
            golden = rec
        else:
            problems = diff_traces(golden, rec)
            if problems:
                raise AssertionError(
                    f"nondeterministic replay (run {i}):\n  " + "\n  ".join(problems))
    if golden is None:
        raise ValueError("assert_replay_deterministic: n_runs must be at least 1")
    return golden
