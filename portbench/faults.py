"""Faults planted under the timed path, for the tests and for the readings
of ``portbench.control``: each wraps the program's call and breaks it the way
a wrong optimisation could."""

from __future__ import annotations

import copy


def altered(inpaint):
    """One answer of every request altered where it is produced: its first clip inverted."""
    def call(pre, fol, T):
        out = inpaint(pre, fol, T).copy()
        out[0] = 255 - out[0]
        return out
    return call


def swapped(inpaint):
    """The clips' answers returned in reverse order."""
    def call(pre, fol, T):
        return inpaint(pre, fol, T)[::-1].copy()
    return call


def _restoring(step, parts):
    """``step``, after which the modules and optimizers ``parts(state)`` are set back as they were."""
    def call(state, K, T, F, targets):
        keep = [copy.deepcopy(x.state_dict()) for x in parts(state)]
        state, terms = step(state, K, T, F, targets)
        for x, s in zip(parts(state), keep):
            x.load_state_dict(s)
        return state, terms
    return call


def unchanged(step):
    """A step that computes its terms and returns its state as it was."""
    return _restoring(step, lambda s: (s.generator, s.discriminator, s.g_opt, s.d_opt))


def d_unchanged(step):
    """A step whose discriminator update computes its terms and leaves D's state as it was."""
    return _restoring(step, lambda s: (s.discriminator, s.d_opt))


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def call(state, K, T, F, targets):
        return step(state, K, T, F, targets[: targets.shape[0] // 2])
    return call


def d_half_batch(step):
    """The discriminator's update alone on half of the batch, the mean taken over the rest."""
    env = step.__self__
    d_update = env._d_update

    def half(state, pred, K, T, F, targets):
        n = targets.shape[0] // 2
        return d_update(state, pred[:n], K, T, F, targets[:n])

    def call(state, K, T, F, targets):
        env._d_update = half
        try:
            return step(state, K, T, F, targets)
        finally:
            del env._d_update
    return call


SERVE = {"altered": altered, "swapped": swapped}
TRAIN = {"unchanged": unchanged, "half_batch": half_batch, "d_unchanged": d_unchanged, "d_half_batch": d_half_batch}
