"""Faults planted underneath the timed path, for the check's own tests
and for reading what each fault makes the compared numbers read
(`calibrate.py --faults`). Each is a context manager that patches the
program in this process and undoes it on exit.

- adam_noop:   every optimiser step returns the state unchanged;
- track_adam_noop: the tracker's optimiser step alone does;
- half_batch:  each masked mean of the losses is taken over the first
               half of its rays alone;
- encode_off:  the hash encoding's features come out 2^-10 off (an
               answer altered where it is produced).
One chip, so no cell has an exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def adam_noop():
    return _patched(torch.optim.Adam, "step",
                    lambda orig: lambda self, closure=None: None)


def track_adam_noop():
    from unislam_tpu_torch.engine import tracker

    def make(orig):
        def make_optimizer(tc, pose):
            opt = orig(tc, pose)
            opt.step = lambda closure=None: None
            return opt
        return make_optimizer
    return _patched(tracker, "make_optimizer", make)


def half_batch():
    from unislam_tpu_torch.core import losses

    def make(orig):
        def masked_mean(x, mask, denom=None):
            n = max(x.shape[0] // 2, 1)
            return orig(x[:n], mask[:n], denom)
        return masked_mean
    return _patched(losses, "masked_mean", make)


def encode_off():
    from unislam_tpu_torch.models import hash_encoding

    def make(orig):
        def encode(table, points, spec):
            return orig(table, points, spec) * (1.0 + 2.0 ** -10)
        return encode
    return _patched(hash_encoding, "encode", make)


FAULTS = {"adam_noop": adam_noop, "track_adam_noop": track_adam_noop,
          "half_batch": half_batch,
          "encode_off": encode_off}
