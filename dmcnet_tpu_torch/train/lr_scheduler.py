"""Per-iteration learning-rate schedulers of the I3D trainer (the port's
copy of `dmcnet_tpu/train/lr_scheduler.py`, which imports no JAX).

MultiFactorScheduler mirrors reference train/lr_scheduler.py:22-61 exactly,
including the quirky first-100-steps lr/2 warmup (":59-60") — a behaviour
the released I3D models were trained with, so it is preserved.
"""

from __future__ import annotations


class LRScheduler:
    def __init__(self, step_counter=0, base_lr=0.01):
        self.step_counter = step_counter
        self.base_lr = base_lr
        self.lr = base_lr

    def update(self):
        raise NotImplementedError

    def get_lr(self):
        return self.lr


class MultiFactorScheduler(LRScheduler):
    """Stepwise decay at iteration numbers `steps`, factor `factor`;
    returns lr/2 for the first 100 iterations."""

    def __init__(self, steps, base_lr=0.01, factor=0.1, step_counter=0):
        super().__init__(step_counter, base_lr)
        assert isinstance(steps, list) and steps, "steps must be non-empty"
        for i in range(1, len(steps)):
            if steps[i] <= steps[i - 1]:
                raise ValueError("steps must be increasing")
        if steps[0] < 1:
            raise ValueError("steps must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1")
        self.steps = steps
        self.factor = factor
        self.cursor = 0

    def update(self):
        self.step_counter += 1
        if self.cursor >= len(self.steps):
            return self.lr
        while self.steps[self.cursor] < self.step_counter:
            self.lr *= self.factor
            self.cursor += 1
            if self.cursor >= len(self.steps):
                return self.lr
        if self.step_counter < 100:
            return self.lr / 2.0
        return self.lr


class I3DLRDriver:
    """Reference-exact scheduler advancement for the I3D fit loop
    (code/dmcnet_I3D/train/model.py:354-491).  The reference advances its
    three per-iteration schedulers at DIFFERENT rates and reuses stale
    python locals across phases; all of it is load-bearing for
    released-model fidelity:

      * stage 1 (epoch+1 <= epoch_thre), GAN D microbatch: sched1 (lr),
        sched2 (value discarded — pure side effect, model.py:373) and
        sched3 (lr_d) all advance (:371-375);
      * stage 1, GAN G microbatch: ONLY sched2 advances (:439-441) — the
        generator optimizer is then stepped with `lr`, the STALE value from
        the last D microbatch (:451-452);
      * stage 2 (both phases): only sched2 advances; `lr_d` keeps the value
        of the LAST stage-1 D microbatch forever (:382, stale local);
      * no GAN: every microbatch is a G microbatch and sched1 drives both
        optimizers (:438-441).

    The classifier lr `lr1` is 0 under --detach during stage 1 (:376-379);
    the stage-1 base-layer freeze itself lives in adjust_learning_rate
    (model.py:267-285) and is reproduced by make_i3d_optimizers'
    freeze_base mults, not here.

    `macro_step(epoch, phase_d, iter_size)` consumes one macro step's worth
    of microbatch advances and returns (lr_gf, lr1, lr_d).
    """

    def __init__(self, sched1, sched2, sched3=None, epoch_thre=1,
                 detach=False, has_gan=False):
        self.sched1, self.sched2, self.sched3 = sched1, sched2, sched3
        self.epoch_thre = epoch_thre
        self.detach = detach
        self.has_gan = has_gan
        self.lr = None    # stale-carrying locals, like the reference's
        self.lr_d = None  # `lr` / `lr_d` in fit()

    def macro_step(self, epoch, phase_d, iter_size):
        stage1 = epoch + 1 <= self.epoch_thre
        lr1 = 0.0
        for _ in range(iter_size):
            if self.has_gan and phase_d:
                if stage1:  # model.py:371-379
                    self.lr = self.sched1.update()
                    if self.sched2 is not None:
                        self.sched2.update()  # advanced, value unused
                    self.lr_d = self.sched3.update()
                    lr1 = 0.0 if self.detach else self.lr
                else:  # model.py:381-383; lr_d stays stale
                    self.lr = self.sched2.update()
                    lr1 = self.lr
            else:  # G phase / no GAN (model.py:437-452)
                if stage1:
                    if not self.has_gan:
                        self.lr = self.sched1.update()
                    if self.sched2 is not None:
                        self.sched2.update()
                    lr1 = 0.0 if self.detach else self.lr
                else:
                    self.lr = self.sched2.update()
                    lr1 = self.lr
        if self.lr_d is None and self.has_gan:
            # the reference NameErrors if training starts in stage 2
            # (lr_d never assigned); seed it from sched3 instead
            self.lr_d = self.sched3.update()
        return self.lr, lr1, self.lr_d
