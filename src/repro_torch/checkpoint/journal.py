"""Hash-chained training journal (a copy of ``repro/checkpoint/journal.py``;
the format is the same, so either package replays the other's journal):
the step-runner analogue of the paper's TS-as-durable-state, an append-only
JSONL whose replay recovers (step, data cursor, last checkpoint) after a
crash, without a fresh checkpoint per step. Combined with the deterministic data pipeline, a restarted run
re-executes at most the in-flight step (idempotent — same rng, same data,
same result)."""

from __future__ import annotations

import hashlib
import json
import os

GENESIS = "0" * 64


class TrainJournal:
    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, record: dict) -> None:
        prev = GENESIS
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    if line.strip():
                        prev = json.loads(line)["hash"]
        body = dict(record)
        body["prev"] = prev
        digest = hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()).hexdigest()
        body["hash"] = digest
        with open(self.path, "a") as f:
            f.write(json.dumps(body, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def replay(self) -> list[dict]:
        """Verified replay; truncates at the first corrupt entry (torn
        write during a crash) rather than failing."""
        if not os.path.exists(self.path):
            return []
        out = []
        prev = GENESIS
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break
                h = rec.pop("hash", None)
                if rec.get("prev") != prev:
                    break
                digest = hashlib.sha256(
                    json.dumps(rec, sort_keys=True).encode()).hexdigest()
                if digest != h:
                    break
                prev = h
                rec["hash"] = h
                out.append(rec)
        return out

    def latest(self) -> dict | None:
        recs = self.replay()
        return recs[-1] if recs else None
