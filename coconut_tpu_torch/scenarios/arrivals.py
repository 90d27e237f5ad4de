"""Deterministic open-loop arrival processes for the population model —
the port's copy of `coconut_tpu/scenarios/arrivals.py`: the same stream
for the same seed.

Real credential traffic is not a constant-rate Poisson stream: it has
a DIURNAL swing (the elastic controller's reason to exist), flash
crowds (a petition goes viral — the brownout ladder's reason to
exist), and heavy tenant skew (a few campaigns dominate). This module
models all three as pure, seeded functions so every stream is
BIT-STABLE under a fixed seed — the unit suite pins exact values, and
a chip run is reproducible by quoting its seed.

  DiurnalCurve   rate(t): raised-cosine day shape between base_rate
                 (trough) and peak_rate, period_s long (benches
                 compress a "day" into seconds).
  FlashCrowd     factor(t): multiplicative spike with linear ramps.
  RateSchedule   curve x crowds composed into one inhomogeneous rate.
  arrival_times  Lewis-Shedler thinning over the schedule: an
                 inhomogeneous Poisson stream as a generator of
                 offsets — O(1) memory however long the run.
  zipf_cdf/pick  Zipf(s) tenant skew as an explicit CDF draw.
"""

import math


class DiurnalCurve:
    """Raised-cosine daily rate: trough `base_rate` at t=phase_s,
    peak `peak_rate` half a period later."""

    def __init__(self, base_rate, peak_rate, period_s, phase_s=0.0):
        if base_rate < 0 or peak_rate < base_rate:
            raise ValueError("need 0 <= base_rate <= peak_rate")
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.period_s = float(period_s)
        self.phase_s = float(phase_s)

    def rate(self, t):
        swing = self.peak_rate - self.base_rate
        x = 2.0 * math.pi * (t - self.phase_s) / self.period_s
        return self.base_rate + swing * 0.5 * (1.0 - math.cos(x))

    def max_rate(self):
        return self.peak_rate


class FlashCrowd:
    """Multiplicative rate spike: factor ramps 1 -> multiplier over
    `ramp_s`, holds for `duration_s`, ramps back down."""

    def __init__(self, at_s, duration_s, multiplier, ramp_s=0.0):
        if multiplier < 1.0:
            raise ValueError("flash-crowd multiplier must be >= 1")
        self.at_s = float(at_s)
        self.duration_s = float(duration_s)
        self.multiplier = float(multiplier)
        self.ramp_s = float(ramp_s)

    def factor(self, t):
        lo = self.at_s
        hi = self.at_s + self.duration_s
        if t < lo - self.ramp_s or t > hi + self.ramp_s:
            return 1.0
        boost = self.multiplier - 1.0
        if t < lo:  # ramp up
            frac = (t - (lo - self.ramp_s)) / self.ramp_s
            return 1.0 + boost * frac
        if t > hi:  # ramp down
            frac = ((hi + self.ramp_s) - t) / self.ramp_s
            return 1.0 + boost * frac
        return self.multiplier

    def window(self):
        """(start, end) of the full-boost plateau — report.py splits
        SLO attainment inside vs outside this window."""
        return (self.at_s, self.at_s + self.duration_s)


class RateSchedule:
    """A diurnal curve with zero or more flash crowds composed in."""

    def __init__(self, curve, crowds=()):
        self.curve = curve
        self.crowds = tuple(crowds)

    def rate(self, t):
        r = self.curve.rate(t)
        for c in self.crowds:
            r *= c.factor(t)
        return r

    def max_rate(self):
        m = self.curve.max_rate()
        for c in self.crowds:
            m *= c.multiplier
        return m


def arrival_times(schedule, duration_s, rng):
    """Inhomogeneous Poisson arrivals over [0, duration_s) by
    Lewis-Shedler thinning: draw a homogeneous stream at the
    schedule's max rate, keep each point with probability
    rate(t)/max_rate. Yields ascending offsets; deterministic for a
    seeded `rng` (bit-stable — tests pin exact streams)."""
    lam = schedule.max_rate()
    if lam <= 0:
        return
    t = 0.0
    while True:
        t += rng.expovariate(lam)
        if t >= duration_s:
            return
        if rng.random() * lam <= schedule.rate(t):
            yield t


def zipf_cdf(n, s):
    """CDF over n ranks with Zipf exponent s: weight(i) ~ 1/(i+1)^s."""
    if n <= 0:
        raise ValueError("need at least one rank")
    weights = [1.0 / ((i + 1) ** s) for i in range(n)]
    total = sum(weights)
    cdf = []
    acc = 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    cdf[-1] = 1.0  # clamp float drift
    return cdf


def zipf_pick(rng, cdf):
    """One rank drawn from a zipf_cdf (deterministic for a seeded rng)."""
    r = rng.random()
    lo, hi = 0, len(cdf) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if cdf[mid] < r:
            lo = mid + 1
        else:
            hi = mid
    return lo
