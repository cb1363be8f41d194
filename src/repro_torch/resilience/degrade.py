"""Watchdog + variant-demotion controller (a copy of
``repro.resilience.degrade``; DESIGN.md §17, rung 3).

The serving loop feeds every engine tick's measured walltime (and, when
observability is on, the mean in-graph codec reconstruction error) into a
:class:`DegradationController`.  The controller classifies anomalies
against a self-calibrated baseline and, after ``demote_after`` consecutive
anomalies, asks the loop to demote at the next plan-variant boundary:

* repeated step-deadline breaches while the ring engine is live demote
  ``overlap ring -> blocking`` (hop anomalies — see
  :func:`repro_torch.core.overlap.hop_anomaly`);
* repeated codec-error blowups demote ``codec -> none``.

The loop rebuilds its plans and step function with
``dataclasses.replace`` on the schedule config, so a demotion is a
controlled plan swap at a plan boundary, never a crash.  Over an ep mesh
every rank feeds the controller the same (all-reduced) observations, so
every rank takes the same decision at the same tick.
"""
import statistics
from typing import Optional

from repro_torch.core import overlap as overlap_lib
from repro_torch.resilience.faults import ResilienceConfig

# demotion kinds, in ladder order: overlap first (it is reversible purely
# in comm scheduling), codec second (it changes wire numerics)
DEMOTE_OVERLAP = "overlap"
DEMOTE_CODEC = "codec"


class DegradationController:
    """Host-side anomaly accounting for one ``serve_continuous`` run."""

    def __init__(self, res: ResilienceConfig, baseline_window: int = 5):
        self.res = res
        self.baseline_window = max(int(baseline_window), 2)
        self._walls: list = []
        self.baseline_s = 0.0
        self.consecutive_breaches = 0
        self.consecutive_codec_blowups = 0
        self.total_breaches = 0
        self.demotions: list = []  # demotion kinds applied, in order

    # -- per-tick observation ------------------------------------------------
    def observe_step(self, wall_s: float,
                     codec_err: Optional[float] = None) -> bool:
        """Record one engine tick; returns True when the tick breached the
        step deadline.  The first ``baseline_window`` ticks only calibrate
        the baseline (a fresh variant's compile+warmup must not count)."""
        breach = False
        if self.baseline_s <= 0.0:
            self._walls.append(float(wall_s))
            if len(self._walls) >= self.baseline_window:
                self.baseline_s = statistics.median(self._walls)
        else:
            breach = overlap_lib.hop_anomaly(
                wall_s, self.baseline_s, self.res.step_deadline_factor,
                floor_s=self.res.step_deadline_s)
            if breach:
                self.consecutive_breaches += 1
                self.total_breaches += 1
            else:
                self.consecutive_breaches = 0
        if codec_err is not None and self.res.codec_error_limit > 0:
            if codec_err > self.res.codec_error_limit:
                self.consecutive_codec_blowups += 1
            else:
                self.consecutive_codec_blowups = 0
        return breach

    # -- demotion decisions --------------------------------------------------
    def should_demote(self, ring_live: bool,
                      codec_live: bool) -> Optional[str]:
        """Demotion to apply at the next plan-variant boundary, or None.
        Only offers demotions that change something still live."""
        n = self.res.demote_after
        if n <= 0:
            return None
        if ring_live and self.consecutive_breaches >= n:
            return DEMOTE_OVERLAP
        if codec_live and self.consecutive_codec_blowups >= n:
            return DEMOTE_CODEC
        return None

    def record_demotion(self, kind: str) -> None:
        """Reset anomaly state after a demotion: the new variant gets a
        fresh walltime baseline (blocking ticks pace differently)."""
        self.demotions.append(kind)
        self.consecutive_breaches = 0
        self.consecutive_codec_blowups = 0
        self._walls = []
        self.baseline_s = 0.0
