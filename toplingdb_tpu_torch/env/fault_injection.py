"""Read-fault injection Env (copied from toplingdb_tpu/env/fault_injection.py,
trimmed to FaultInjectionEnv's `corrupt_reads`, the only fault the port's
tests inject): wraps any Env and damages the bytes its random-access and
sequential reads return, while the files on disk stay intact. The role of
RocksDB's utilities/fault_injection_fs.h FaultInjectionTestFS."""

from __future__ import annotations

import threading


class FaultInjectionEnv:
    def __init__(self, base):
        self.base = base
        self._mu = threading.Lock()
        self._corrupt_rules: list[dict] = []
        self._corrupt_tick = 0  # transient-mode read counter
        self.corruptions_injected: list[tuple[str, int, int]] = []

    def __getattr__(self, name):
        return getattr(self.base, name)

    # -- read-side corruption injection (`corrupt_read` kind) ----------

    def corrupt_reads(self, pattern: str = "*", rate: float = 1e-5,
                      seed: int = 0,
                      kinds: tuple = ("bitflip", "byteswap"),
                      transient: bool = False) -> None:
        """Inject seeded read-side corruption: every read whose file's
        BASENAME matches `pattern` (fnmatch; e.g. '*.sst', '000012.*')
        has each returned byte independently damaged with probability
        `rate`. Deterministic in (seed, basename, offset, length) — the
        same read corrupts the same way every time, so integrity soaks
        reproduce from a seed without hand-editing files. `kinds`:
        'bitflip' XORs one random bit, 'byteswap' swaps adjacent bytes.
        `transient=True` additionally mixes a running read counter into
        the seed (still seeded, but a RETRY of the same read draws fresh
        randomness — models transient bus/DMA flips, so detect-and-retry
        paths like compaction can eventually make progress)."""
        with self._mu:
            self._corrupt_rules.append({
                "pattern": pattern, "rate": float(rate), "seed": int(seed),
                "kinds": tuple(kinds), "transient": bool(transient),
            })

    def clear_corrupt_reads(self) -> None:
        with self._mu:
            self._corrupt_rules = []

    def _maybe_corrupt(self, path: str, offset: int, data: bytes) -> bytes:
        if not self._corrupt_rules or not data:
            return data
        import fnmatch
        import hashlib
        import math
        import random

        name = path.rsplit("/", 1)[-1]
        out = None
        for rule in self._corrupt_rules:
            if not fnmatch.fnmatch(name, rule["pattern"]):
                continue
            rate = rule["rate"]
            if rate <= 0:
                continue
            # Stable digest seed (not hash(): per-process salt would break
            # cross-process reproducibility of a corruption scenario).
            tick = ""
            if rule.get("transient"):
                with self._mu:
                    self._corrupt_tick += 1
                    tick = f"|{self._corrupt_tick}"
            material = (f"{rule['seed']}|{name}|{offset}|{len(data)}{tick}"
                        .encode())
            rng = random.Random(int.from_bytes(
                hashlib.blake2s(material, digest_size=8).digest(),
                "little"))
            buf = bytearray(data if out is None else out)
            n_hit = 0
            # Geometric gap sampling: O(corrupted bytes), not O(length).
            log1m = math.log1p(-rate) if rate < 1.0 else None
            pos = 0
            while True:
                if log1m is None:
                    gap = 0
                else:
                    gap = int(math.log(max(rng.random(), 1e-300)) / log1m)
                pos += gap
                if pos >= len(buf):
                    break
                kind = rule["kinds"][rng.randrange(len(rule["kinds"]))] \
                    if rule["kinds"] else "bitflip"
                if kind == "byteswap" and pos + 1 < len(buf):
                    buf[pos], buf[pos + 1] = buf[pos + 1], buf[pos]
                else:
                    buf[pos] ^= 1 << rng.randrange(8)
                n_hit += 1
                pos += 1
                if log1m is None:
                    break
            if n_hit:
                out = bytes(buf)
                with self._mu:
                    self.corruptions_injected.append((name, offset, n_hit))
        return data if out is None else out

    # -- Env interface --------------------------------------------------

    def new_random_access_file(self, path: str):
        return _FIRandom(self, self.base.new_random_access_file(path), path)

    def new_sequential_file(self, path: str):
        return _FISequential(self, self.base.new_sequential_file(path), path)

    def read_file(self, path: str) -> bytes:
        f = self.new_random_access_file(path)
        try:
            return f.read(0, f.size())
        finally:
            f.close()


class _FIRandom:
    def __init__(self, env, base, path: str = ""):
        self._env = env
        self._base = base
        self._path = path

    def read(self, offset, n):
        data = self._base.read(offset, n)
        return self._env._maybe_corrupt(self._path, offset, data)

    def size(self):
        return self._base.size()

    def close(self):
        self._base.close()


class _FISequential:
    def __init__(self, env, base, path: str = ""):
        self._env = env
        self._base = base
        self._path = path
        self._off = 0  # running offset: deterministic corruption keying

    def read(self, n):
        data = self._base.read(n)
        off = self._off
        self._off += len(data)
        return self._env._maybe_corrupt(self._path, off, data)

    def close(self):
        self._base.close()
