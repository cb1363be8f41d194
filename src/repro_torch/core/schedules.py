"""Step-level parallelism schedules (paper Fig. 2) and the DICE config;
port of ``repro.core.schedules``.

  SYNC         staleness 0   blocking dispatch+combine     (baseline EP)
  DISPLACED    staleness 2   both collectives deferred     (DistriFusion-style)
  INTERWEAVED  staleness 1   dispatch in-step, combine deferred
  DICE         staleness 1   + selective sync + conditional communication

``resilience`` carries the degradation ladder
(:class:`~repro_torch.resilience.faults.ResilienceConfig`), normalized on
construction so an inert one is ``None``.  ``placements`` carries one
:class:`~repro_torch.core.placement.Placement` per MoE layer (the plan
compiler stamps them onto the actions; the entry points strip them where
no ep mesh of more than one rank runs).  ``paging`` is kept so a config
carries the same fields as the reference; expert paging is not ported
(ROADMAP A.9) and a set ``paging`` raises.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

from repro_torch.compress.codecs import CompressConfig
from repro_torch.core.placement import Placement
from repro_torch.resilience.faults import (ResilienceConfig,
                                           normalize_resilience)


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
    # -- execution level: "blocking" | "ring" (the ring runs over an ep mesh
    # of more than one rank; normalized to "blocking" elsewhere)
    overlap: str = "blocking"
    # -- expert level: one placement per MoE layer (None: the original
    # layout); the caller's expert params are re-laid-out to match
    placements: Optional[Tuple[Optional[Placement], ...]] = None
    # -- not ported yet: expert paging (ROADMAP A.9) -------------------------
    paging: Optional[Any] = None
    # -- resilience level: fault injection + the degradation ladder; the
    # planner ignores it, so plans and variants are untouched
    resilience: Optional[ResilienceConfig] = None

    def __post_init__(self):
        if self.overlap not in ("blocking", "ring"):
            raise ValueError(f"overlap must be 'blocking' or 'ring', got "
                             f"{self.overlap!r}")
        if self.paging is not None:
            raise NotImplementedError(
                "DiceConfig.paging is not ported yet (ROADMAP A.9): the "
                "PyTorch port runs without expert paging")
        if self.placements is not None:
            if any(p is not None and not isinstance(p, Placement)
                   for p in self.placements):
                raise TypeError("DiceConfig.placements must hold Placement "
                                "or None entries")
            object.__setattr__(self, "placements", tuple(self.placements))
        if self.resilience is not None and \
                not isinstance(self.resilience, ResilienceConfig):
            raise TypeError(f"DiceConfig.resilience must be a "
                            f"ResilienceConfig, got "
                            f"{type(self.resilience).__name__}")
        object.__setattr__(self, "resilience",
                           normalize_resilience(self.resilience))

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
