"""Shared benchmark plumbing: phase timing, ciphertext sizing, CSV/JSONL
output (reference benchmark.py:474-532 timing taxonomy: Init / Encryption
/ Secure Agg / Decryption)."""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np


class PhaseTimer:
    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        yield
        self.phases[name] = self.phases.get(name, 0.0) + (time.time() - t0)

    @property
    def total(self) -> float:
        return sum(self.phases.values())


def results_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results")
    os.makedirs(d, exist_ok=True)
    return d


def append_jsonl(name: str, record: dict) -> str:
    path = os.path.join(results_dir(), name)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return path


def rewrite_jsonl(name: str, records: list[dict]) -> str:
    """Replace a results file with exactly `records` — for benches whose
    committed file should hold only the measured pass (no warm-up rows)."""
    path = os.path.join(results_dir(), name)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


def fake_client_params(n_params: int, n_clients: int, seed: int = 0
                       ) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n_params).astype(np.float32) * 0.1
            for _ in range(n_clients)]
