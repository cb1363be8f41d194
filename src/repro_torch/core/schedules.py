"""Step-level parallelism schedules (paper Fig. 2) and the DICE config;
port of ``repro.core.schedules``.

  SYNC         staleness 0   blocking dispatch+combine     (baseline EP)
  DISPLACED    staleness 2   both collectives deferred     (DistriFusion-style)
  INTERWEAVED  staleness 1   dispatch in-step, combine deferred
  DICE         staleness 1   + selective sync + conditional communication

``placements``, ``paging`` and ``resilience`` are kept so a config carries
the same fields as the reference; the port's single-device slice runs
none of them and raises if one is set.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional, Union

from repro_torch.compress.codecs import CompressConfig


class Schedule(enum.Enum):
    SYNC = "sync"
    DISPLACED = "displaced"
    INTERWEAVED = "interweaved"
    DICE = "dice"
    STAGGERED_BATCH = "staggered_batch"


@dataclass(frozen=True)
class DiceConfig:
    schedule: Union[Schedule, str] = Schedule.DICE
    # -- layer level: selective synchronization ------------------------------
    sync_policy: str = "deep"        # none | deep | shallow | staggered
    sync_fraction: float = 0.5
    # -- token level: conditional communication ------------------------------
    cond_comm: bool = True
    cond_stride: int = 2             # non-top-1 pairs refresh every n steps
    cond_policy: str = "low"         # low | high | random
    # -- cold start -----------------------------------------------------------
    warmup_steps: int = 2
    # -- wire level: residual compression of staleness-era payloads -----------
    compress: Optional[CompressConfig] = None
    # -- execution level: "blocking" | "ring" (ring needs an ep mesh, which
    # this slice does not have; normalized to "blocking" on one device)
    overlap: str = "blocking"
    # -- not in this slice: expert placement, paging, resilience -------------
    placements: Optional[Any] = None
    paging: Optional[Any] = None
    resilience: Optional[Any] = None

    def __post_init__(self):
        if self.overlap not in ("blocking", "ring"):
            raise ValueError(f"overlap must be 'blocking' or 'ring', got "
                             f"{self.overlap!r}")
        for name in ("placements", "paging", "resilience"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"DiceConfig.{name} is not ported yet: the single-device "
                    f"PyTorch slice runs without expert placement, paging "
                    f"and resilience")

    @staticmethod
    def sync_ep(*, overlap="blocking") -> "DiceConfig":
        return DiceConfig(schedule=Schedule.SYNC, sync_policy="none",
                          cond_comm=False, warmup_steps=0, overlap=overlap)

    @staticmethod
    def displaced(*, compress=None, overlap="blocking") -> "DiceConfig":
        return DiceConfig(schedule=Schedule.DISPLACED, sync_policy="none",
                          cond_comm=False, compress=compress, overlap=overlap)

    @staticmethod
    def interweaved(*, compress=None, overlap="blocking") -> "DiceConfig":
        return DiceConfig(schedule=Schedule.INTERWEAVED, sync_policy="none",
                          cond_comm=False, compress=compress, overlap=overlap)

    @staticmethod
    def dice(*, sync_policy="deep", cond_stride=2, cond_policy="low",
             compress=None, overlap="blocking") -> "DiceConfig":
        return DiceConfig(schedule=Schedule.DICE, sync_policy=sync_policy,
                          cond_comm=True, cond_stride=cond_stride,
                          cond_policy=cond_policy, compress=compress,
                          overlap=overlap)

    @staticmethod
    def staggered_batch(*, overlap="blocking") -> "DiceConfig":
        return DiceConfig(schedule=Schedule.STAGGERED_BATCH,
                          sync_policy="none", cond_comm=False,
                          overlap=overlap)
