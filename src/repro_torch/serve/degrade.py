"""Graceful degradation + calibrated latency prediction (DESIGN.md §17),
the counterpart of the JAX package's `repro/serve/degrade.py`.

Under sustained overload a serving tier has three options: queue without
bound (latency explodes), drop requests (goodput craters), or serve
cheaper answers. KBest's accuracy/latency knobs (nprobe, L,
rescore_factor — the KScaNN-style trade the tuner sweeps) make the third
option principled: `DegradePolicy` walks a pre-tuned ladder of
SearchConfigs (configs.kbest.degrade_ladder) downward while the observed
queue delay sits above a high watermark, and back up once it falls below
the low watermark. Hysteresis (watermark band + `patience` consecutive
observations) prevents rung flapping at the boundary.

`LatencyModel` is the admission controller's ŝ: the static cost model's
predicted batch seconds (analysis.cost.predict_service_s — correct
ORDERING across configs/buckets, arbitrary absolute scale) multiplied by
an EWMA-calibrated measured/predicted ratio per (engine, SearchConfig,
bucket) key, with a global-ratio fallback so unseen keys borrow the
machine's scale instead of trusting the roofline constants. The
admission rule in serve_loop is then

    admit  iff  t_start + slack * ŝ(engine, cfg, bucket) <= t_arrival + D

with D the request deadline and `slack` a safety factor absorbing
prediction noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import SearchConfig
from repro_torch.serve.engine import SearchEngine, bucket_for


@dataclasses.dataclass
class DegradePolicy:
    """Queue-delay-watermark ladder walker. Rung 0 is full quality; every
    further rung is a strictly cheaper standalone SearchConfig
    (configs.kbest.degrade_ladder builds it so)."""

    ladder: Tuple[SearchConfig, ...]
    high_ms: float = 50.0        # sustained delay above this: step down
    low_ms: float = 10.0         # sustained delay below this: step up
    patience: int = 3            # consecutive observations per transition

    def __post_init__(self):
        assert self.ladder, "need at least one rung (the base config)"
        assert self.low_ms <= self.high_ms, \
            f"watermarks inverted: low_ms={self.low_ms} > high_ms={self.high_ms}"
        assert self.patience >= 1, "patience must be >= 1 observation"
        self.level = 0
        self.transitions: List[Tuple[int, int, int]] = []  # (obs#, from, to)
        self.occupancy: Dict[int, int] = {}
        self._n_obs = 0
        self._over = 0
        self._under = 0

    def observe(self, queue_delay_ms: float) -> int:
        """Feed one pre-dispatch queue-delay observation; returns the level
        to serve at. Transitions need `patience` CONSECUTIVE observations
        past a watermark; the band between the watermarks holds the level
        (hysteresis, so a delay oscillating around one threshold cannot
        flap the rung)."""
        self._n_obs += 1
        if queue_delay_ms > self.high_ms:
            self._over += 1
            self._under = 0
        elif queue_delay_ms < self.low_ms:
            self._under += 1
            self._over = 0
        else:
            self._over = 0
            self._under = 0
        if self._over >= self.patience and self.level < len(self.ladder) - 1:
            self.transitions.append((self._n_obs, self.level, self.level + 1))
            self.level += 1
            self._over = 0
        elif self._under >= self.patience and self.level > 0:
            self.transitions.append((self._n_obs, self.level, self.level - 1))
            self.level -= 1
            self._under = 0
        self.occupancy[self.level] = self.occupancy.get(self.level, 0) + 1
        return self.level

    def apply(self, scfg: SearchConfig) -> SearchConfig:
        """Resolve the config to serve at the current level: rung 0 keeps
        the request's own config untouched; deeper rungs substitute the
        rung's knobs but preserve the request's k (a degraded answer still
        has the asked-for shape)."""
        if self.level == 0:
            return scfg
        rung = self.ladder[self.level]
        if rung.k == scfg.k:
            return rung
        return dataclasses.replace(rung, k=scfg.k, L=max(rung.L, scfg.k))


class LatencyModel:
    """EWMA-calibrated per-(engine, config, bucket) service-time model."""

    def __init__(self, alpha: float = 0.3, slack: float = 1.2):
        assert 0.0 < alpha <= 1.0 and slack >= 1.0
        self.alpha = alpha          # EWMA weight of the newest observation
        self.slack = slack          # admission safety factor on ŝ
        self._ratio: Dict[tuple, float] = {}
        self._global: Optional[float] = None

    def _key(self, engine: SearchEngine, scfg: SearchConfig,
             rows: int) -> tuple:
        b = bucket_for(max(rows, 1), engine.min_bucket, engine.max_bucket)
        return (engine.name, scfg, b)

    def _prior_ms(self, engine: SearchEngine, scfg: SearchConfig,
                  rows: int) -> float:
        from repro_torch.analysis.cost import predict_service_s
        b = bucket_for(max(rows, 1), engine.min_bucket, engine.max_bucket)
        n = int(engine.index.db.shape[0])
        return max(predict_service_s(engine.index.config, scfg,
                                     Q=b, n=n) * 1e3, 1e-9)

    @property
    def calibrated(self) -> bool:
        return self._global is not None

    def predict_ms(self, engine: SearchEngine, scfg: SearchConfig,
                   rows: int) -> float:
        """ŝ in milliseconds: cost-model prior x calibrated ratio (per-key
        if seen, global otherwise, 1.0 before any observation)."""
        prior = self._prior_ms(engine, scfg, rows)
        ratio = self._ratio.get(self._key(engine, scfg, rows), self._global)
        return prior * (ratio if ratio is not None else 1.0)

    def observe(self, engine: SearchEngine, scfg: SearchConfig, rows: int,
                measured_ms: float) -> None:
        """Fold one measured dispatch into the per-key and global EWMAs."""
        ratio = measured_ms / self._prior_ms(engine, scfg, rows)
        key = self._key(engine, scfg, rows)
        prev = self._ratio.get(key)
        self._ratio[key] = ratio if prev is None else \
            (1 - self.alpha) * prev + self.alpha * ratio
        self._global = ratio if self._global is None else \
            (1 - self.alpha) * self._global + self.alpha * ratio
