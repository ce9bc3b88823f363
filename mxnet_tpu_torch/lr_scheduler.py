"""Learning-rate schedules (port of ``mxnet_tpu/lr_scheduler.py``, whole).

Plain Python, so the port keeps its own copy.  As in the JAX package,
every schedule is a *pure function* of ``num_update`` evaluated against
the current ``base_lr`` attribute (the reference's schedulers mutate
their own rate as a side effect of being called): calling twice with the
same step returns the same value, and a resumed job may evaluate steps
out of order.  ``FactorScheduler``, ``MultiFactorScheduler``,
``PolyScheduler`` and ``CosineScheduler``, each with the optional linear
or constant warmup of ``LRScheduler``.

``base_lr`` remains a plain assignable attribute because the optimizer
overwrites it with its own ``learning_rate`` at attach time.
"""

from __future__ import annotations

import bisect
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base class: handles the optional warmup ramp, then delegates the
    post-warmup value to :meth:`schedule`."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("unknown warmup_mode %r" % (warmup_mode,))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode

    # Kept for reference-API compatibility; some callers poke this.
    @property
    def warmup_final_lr(self):
        return self.base_lr

    def get_warmup_lr(self, num_update):
        if num_update >= self.warmup_steps:
            raise ValueError("get_warmup_lr called past warmup")
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        frac = num_update / self.warmup_steps
        return self.warmup_begin_lr + frac * (self.base_lr -
                                              self.warmup_begin_lr)

    def schedule(self, num_update):
        """Post-warmup learning rate at ``num_update`` (pure)."""
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self.schedule(num_update)


class FactorScheduler(LRScheduler):
    """Multiply the lr by ``factor`` once every ``step`` updates, never
    going below ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        if step < 1:
            raise ValueError("step must be >= 1")
        if not 0.0 < factor <= 1.0:
            raise ValueError("factor must be in (0, 1]")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def schedule(self, num_update):
        # the k-th decay fires when num_update first exceeds k*step
        decays = max(0, (num_update - 1)) // self.step
        if decays == 0:
            # the floor only applies to DECAYED values: a base_lr
            # configured below stop_factor_lr must not be raised
            return self.base_lr
        return max(self.base_lr * self.factor ** decays,
                   self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Multiply the lr by ``factor`` as each boundary in ``step`` (a
    sorted list of update counts) is passed."""

    def __init__(self, step, factor=1, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        if not step or list(step) != sorted(step):
            raise ValueError("step must be a non-empty sorted list")
        if not 0.0 < factor <= 1.0:
            raise ValueError("factor must be in (0, 1]")
        self.step = list(step)
        self.factor = factor

    def schedule(self, num_update):
        # boundary b has been passed once num_update > b
        decays = bisect.bisect_left(self.step, num_update)
        return self.base_lr * self.factor ** decays


class _DecayToFinal(LRScheduler):
    """Shared shape for schedules that anneal base_lr -> final_lr over
    ``max_update`` total updates (warmup included in the count)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        if max_update <= self.warmup_steps:
            raise ValueError("max_update must exceed warmup_steps")
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def _progress(self, num_update):
        """Fraction of the decay phase completed, clamped to [0, 1]."""
        done = num_update - self.warmup_steps
        return min(max(done / self.max_steps, 0.0), 1.0)

    def _anneal(self, frac):
        raise NotImplementedError

    def schedule(self, num_update):
        span = self.base_lr - self.final_lr
        return self.final_lr + span * self._anneal(
            self._progress(num_update))


class PolyScheduler(_DecayToFinal):
    """Polynomial decay: remaining fraction ``(1 - t)**pwr``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, **kw):
        super().__init__(max_update, base_lr, final_lr, **kw)
        self.power = pwr

    def _anneal(self, frac):
        return (1.0 - frac) ** self.power


class CosineScheduler(_DecayToFinal):
    """Half-cosine decay: remaining fraction ``(1 + cos(pi t)) / 2``."""

    def _anneal(self, frac):
        return 0.5 * (1.0 + math.cos(math.pi * frac))
